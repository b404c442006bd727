"""Repeatability of ``launch/train.py --preset paper-mnist``.

Runs the port's preset (``repro_torch.launch.train.run_paper_preset``) at
the given flags and prints, as one JSON line, its accuracy series, its
timeline and staleness, and a SHA-256 of the final params' bytes, so that
two runs can be told equal or apart:

  CUBLAS_WORKSPACE_CONFIG=:4096:8 PYTHONPATH=src python tools/mnist_spread.py \\
      --deterministic --device cuda --tag card-1

``--deterministic`` sets ``torch.backends.cudnn.deterministic``, turns the
cuDNN autotuner off and calls ``torch.use_deterministic_algorithms(True)``
(cuBLAS then needs ``CUBLAS_WORKSPACE_CONFIG`` in the environment, which
this script does not set).  ``--init NPZ`` starts from the params in an
``.npz`` of flat leaf paths (``tools/mnist_spread_jax.py`` writes the JAX
package's init that way) instead of the port's own seeded draw.  Every
other flag goes to the preset as ``launch/train.py`` takes it.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

from repro_torch.launch import train  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402


def _load_init(path):
    """A params tree from an ``.npz`` whose keys are leaf paths
    (``conv/#0/w``); ``#i`` marks a list index."""
    flat = np.load(path)
    tree = {}
    for key in flat.files:
        node, parts = tree, key.split("/")
        for i, part in enumerate(parts[:-1]):
            nxt = [] if parts[i + 1].startswith("#") else {}
            if part.startswith("#"):
                idx = int(part[1:])
                while len(node) <= idx:
                    node.append(None)
                if node[idx] is None:
                    node[idx] = nxt
                node = node[idx]
            else:
                node = node.setdefault(part, nxt)
        last = parts[-1]
        val = torch.from_numpy(np.array(flat[key]))
        if last.startswith("#"):
            idx = int(last[1:])
            while len(node) <= idx:
                node.append(None)
            node[idx] = val
        else:
            node[last] = val
    return tree


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--deterministic", action="store_true")
    ap.add_argument("--init", default=None, metavar="NPZ")
    ap.add_argument("--tag", default="")
    ap.add_argument("--json-out", default=None)
    args, rest = ap.parse_known_args(argv)
    if args.deterministic:
        torch.backends.cudnn.deterministic = True
        torch.backends.cudnn.benchmark = False
        torch.use_deterministic_algorithms(True)
    targs = train.build_parser().parse_args(
        ["--preset", "paper-mnist"] + rest)
    if args.init is not None:
        init = _load_init(args.init)
        train.init_cnn = lambda cfg, gen: init
    run = train.run_paper_preset(targs)
    digest = hashlib.sha256()
    for x in tree_leaves(run.run.params):
        digest.update(x.detach().float().cpu().numpy().tobytes())
    rec = {"tag": args.tag, "device": targs.device,
           "deterministic": args.deterministic, "init": args.init,
           "acc": run.record["acc"], "rounds_series":
           run.record["rounds_series"], "times": run.record["times"],
           "staleness_max": run.record["staleness_max"],
           "staleness_mean": run.record["staleness_mean"],
           "wall_s": run.record["wall_s"],
           "params_sha256": digest.hexdigest()}
    if torch.cuda.is_available() and targs.device.startswith("cuda"):
        rec["card"] = torch.cuda.get_device_name(0)
    print("SPREAD " + json.dumps(rec), flush=True)
    if args.json_out:
        os.makedirs(os.path.dirname(args.json_out) or ".", exist_ok=True)
        with open(args.json_out, "w") as f:
            json.dump(rec, f, indent=1)
    return rec


if __name__ == "__main__":
    main()
