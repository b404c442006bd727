"""Port of the LM serving path for the moe family (``repro_torch.launch.serve``
over ``PersonalizationServer`` with ``models.lm``'s MoE layers) against the
JAX package, beside ``test_torch_serve_dense_lm.py``: granite-moe-1b-a400m
at ``reduce_for_smoke`` (2 MoE layers of 4 experts, top-2), both servers
from the same init carried across, 3 users with the same 16-token streams
(each user one group of the MoE dispatch inside the cohort's
``vmap(grad)``), mode C (λ = 30, α = 0.01, K = 5, η_in = 0.01, as
launch/serve.py sets them), ``personal_subset="embed/unembed"``, fp32 and
int8 banking.  Then ``launch.serve.main`` on the CPU for granite (subset,
int8) and for deepseek-v3-671b (the whole model personalized: the dense
prefix's list of layers and the MTP block stacked per user, the loss with
its MTP term in the cohort; absorbed-MLA decode under ``vmap``).

Tolerances, as ``test_torch_serve_dense_lm.py``: fp32 heads within 1e-5;
int8 heads within 1e-5 plus one code step (the largest row scale).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.configs import reduce_for_smoke as j_reduce
from repro.core import PersAFLConfig as JConfig
from repro.core.subset import SubsetSpec as JSubsetSpec
from repro.models import api as japi
from repro.serving import PersonalizationServer as JServer
from repro_torch.configs import get_config, reduce_for_smoke
from repro_torch.core import PersAFLConfig
from repro_torch.core.subset import merge_subset
from repro_torch.launch import serve
from repro_torch.models import api
from repro_torch.serving import PersonalizationServer
from repro_torch.tree import tree_leaves, tree_map

USERS, PLEN = 3, 16
PCFG = dict(option="C", lam=30.0, alpha=0.01, inner_steps=5, inner_eta=0.01)
SUBSET = ("embed/unembed",)
ATOL = 1e-5
ARCH = "granite-moe-1b-a400m"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _users():
    return [f"user{u}" for u in range(USERS)]


def _max_scale(srv):
    """The largest row scale of the int8 banks either package's ring holds."""
    return max(float(np.max(np.asarray(sc)))
               for bs in srv.ring._banks.values() for b in bs
               for sc in jax.tree.leaves(b.stacked.scales))


@pytest.fixture(scope="module")
def gref():
    """granite on the JAX side, once: the subset heads of an fp32 and an
    int8 server."""
    jcfg = j_reduce(j_get_config(ARCH))
    cfg = reduce_for_smoke(get_config(ARCH))
    jparams = jax.jit(lambda k: japi.init_params(jcfg, k))(
        jax.random.PRNGKey(2))
    np_params = jax.tree.map(np.asarray, jparams)
    batches = [serve._user_batch(cfg, 20 + u, PLEN) for u in range(USERS)]
    heads, servers = {}, {}
    for codec in ("fp32", "int8"):
        js = JServer(jparams, lambda p, b: japi.loss_fn(jcfg, p, b),
                     JConfig(**PCFG), modes=("C",), max_pending=USERS,
                     personal_subset=SUBSET, delta_dtype=codec)
        for user, b in zip(_users(), batches):
            js.submit(user, {k: jnp.asarray(v) for k, v in b.items()})
        js.flush()
        heads[codec] = jax.tree.map(np.asarray, js.stacked_heads(_users()))
        servers[codec] = js
    return dict(cfg=cfg, np_params=np_params, batches=batches, heads=heads,
                servers=servers)


@pytest.mark.parametrize("codec", ["fp32", "int8"])
def test_granite_server_subset_heads_match_reference(gref, codec):
    """Both packages' servers personalize granite's unembedding (mode C)
    through the MoE layers: heads within the tolerance, each moved well
    past it, and every user's head below the global loss on their own
    stream."""
    cfg = gref["cfg"]
    ts = PersonalizationServer(gref["np_params"],
                               lambda p, b: api.loss_fn(cfg, p, b),
                               PersAFLConfig(**PCFG), modes=("C",),
                               max_pending=USERS, delta_dtype=codec,
                               personal_subset=SUBSET, device="cpu")
    for user, b in zip(_users(), gref["batches"]):
        ts.submit(user, b)
    heads = ts.stacked_heads(_users())
    st = ts.stats
    assert st["host_materializations"] == 0 and st["cohort_calls"] == 1
    js = gref["servers"][codec]
    assert st["ring_bytes_per_user"] == js.stats["ring_bytes_per_user"]
    assert list(heads) == ["embed"] and list(heads["embed"]) == ["unembed"]
    tol = ATOL
    if codec == "int8":
        tol += max(_max_scale(js), _max_scale(ts))
    base = JSubsetSpec.resolve(SUBSET, gref["np_params"]).extract(
        gref["np_params"])
    moved = 0.0
    for a, b, p in zip(tree_leaves(heads), jax.tree.leaves(
            gref["heads"][codec]), jax.tree.leaves(base)):
        np.testing.assert_allclose(a.numpy(), b, atol=tol, rtol=0)
        moved = max(moved, float(np.abs(b - p[None]).max()))
    assert moved > 10 * tol
    for u, b in enumerate(gref["batches"]):
        tb = {k: torch.from_numpy(v) for k, v in b.items()}
        head = merge_subset(ts.params, tree_map(lambda x: x[u], heads))
        assert float(api.loss_fn(cfg, head, tb)) < \
            float(api.loss_fn(cfg, ts.params, tb))


@pytest.mark.parametrize("arch,extra", [
    ("granite-moe-1b-a400m", ["--personal-subset", "embed/unembed",
                              "--delta-dtype", "int8", "--tokens", "6"]),
    ("deepseek-v3-671b", ["--tokens", "4"]),
])
def test_serve_main_moe_on_cpu(arch, extra, tmp_path):
    """``launch/serve.py`` end to end on the CPU: granite with its subset
    and int8 banking; deepseek personalizing the whole model (the dense
    prefix's list and the MTP block among the stacked heads)."""
    run = serve.main(["--arch", arch, "--smoke", "--personalize",
                      "--requests", "2", "--device", "cpu",
                      "--out", str(tmp_path)] + extra)
    rec = run.record
    assert rec["arch"] == arch and rec["users"] == 2
    assert rec["host_materializations"] == 0 and rec["tok_per_s"] > 0
    assert run.server.stats["cohort_calls"] == 1
    assert (tmp_path / f"serve_{arch}.json").is_file()
    tokens = int(extra[extra.index("--tokens") + 1])
    assert tuple(run.out_tokens.shape) == (2, tokens)
    assert all(bool(torch.isfinite(x).all()) for x in tree_leaves(run.heads))
    if arch == "deepseek-v3-671b":
        assert isinstance(run.heads["dense_prefix"], list)
        assert tuple(run.heads["mtp"]["proj"].shape)[0] == 2
        # each user's head is its own, and lowers that user's loss
        for u, b in enumerate(run.batches):
            tb = {k: torch.from_numpy(v) for k, v in b.items()}
            head = tree_map(lambda x: x[u], run.heads)
            assert float(api.loss_fn(run.cfg, head, tb)) < \
                float(api.loss_fn(run.cfg, run.params, tb))
    else:
        assert list(run.heads) == ["embed"]
        assert rec["personal_subset"] == ["embed/unembed"]
