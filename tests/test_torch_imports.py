"""The port stands alone: importing every ``repro_torch`` module and
``chip_smoke.py`` loads neither JAX nor any module of the JAX package
(``repro`` or ``repro.*``; ``repro_torch`` itself only shares the prefix),
and imports compile nothing."""
import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

PROBE = r"""
import importlib, importlib.util, json, pkgutil, sys
import repro_torch
names = ["repro_torch"] + [m.name for m in pkgutil.walk_packages(
    repro_torch.__path__, "repro_torch.")]
for name in names:
    importlib.import_module(name)
spec = importlib.util.spec_from_file_location("chip_smoke", sys.argv[1])
spec.loader.exec_module(importlib.util.module_from_spec(spec))
from repro_torch.kernels import _build
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "jaxlib"
             or m == "repro" or m.startswith("repro."))
import torch.distributed as dist
print(json.dumps({"modules": names, "bad": bad,
                  "group": dist.is_initialized(),
                  "loaded": sorted(_build._LOADED)}))
"""


def test_port_imports_no_jax_and_no_reference_module():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", PROBE,
                           str(ROOT / "chip_smoke.py")],
                          capture_output=True, text=True, env=env,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["bad"] == []
    assert out["loaded"] == []          # no kernel is built at import
    assert not out["group"]             # no process group at import
    for name in ("repro_torch.fl.api", "repro_torch.fl.engine",
                 "repro_torch.kernels.fused_update.kernel",
                 "repro_torch.core.server", "repro_torch.convert",
                 "repro_torch.serving", "repro_torch.serving.server",
                 "repro_torch.serving.transport",
                 "repro_torch.checkpoint", "repro_torch.core.quant",
                 "repro_torch.core.subset", "repro_torch.configs",
                 "repro_torch.configs.base",
                 "repro_torch.configs.mamba2_130m",
                 "repro_torch.kernels.ssd", "repro_torch.kernels.ssd.ref",
                 "repro_torch.kernels.ssd.kernel",
                 "repro_torch.kernels.ssd.ops", "repro_torch.models.layers",
                 "repro_torch.models.mamba2", "repro_torch.models.ssm_lm",
                 "repro_torch.models.api", "repro_torch.launch",
                 "repro_torch.configs.zamba2_1p2b",
                 "repro_torch.kernels.flash_attention",
                 "repro_torch.kernels.flash_attention.ref",
                 "repro_torch.kernels.flash_attention.kernel",
                 "repro_torch.kernels.flash_attention.ops",
                 "repro_torch.models.attention", "repro_torch.models.lm",
                 "repro_torch.configs.gemma2_2b",
                 "repro_torch.configs.codeqwen1p5_7b",
                 "repro_torch.configs.minitron_8b",
                 "repro_torch.configs.qwen1p5_110b",
                 "repro_torch.configs.internvl2_76b",
                 "repro_torch.launch.steps", "repro_torch.launch.serve",
                 "repro_torch.fl.algorithms", "repro_torch.fl.simulator",
                 "repro_torch.fl.scenario", "repro_torch.fl.scenario.spec",
                 "repro_torch.fl.scenario.churn",
                 "repro_torch.fl.scenario.sched", "repro_torch.tune",
                 "repro_torch.tune.space", "repro_torch.tune.stop",
                 "repro_torch.tune.runner", "repro_torch.tune.report",
                 "repro_torch.launch.train", "repro_torch.launch.specs",
                 "repro_torch.optim", "repro_torch.optim.optimizers",
                 "repro_torch.autodiff", "repro_torch.sharding",
                 "repro_torch.sharding.ctx", "repro_torch.sharding.rules",
                 "repro_torch.launch.mesh"):
        assert name in out["modules"]
