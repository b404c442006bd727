"""Port of the LM serving path for the dense and vlm families
(``repro_torch.launch.serve`` over ``PersonalizationServer`` with
``models.lm``) against the JAX package, beside ``test_torch_serve_lm.py``:
gemma2-2b at ``reduce_for_smoke`` (2 layers, layer 0 local with a window of
16 and layer 1 global, softcaps 50 and 30, post-block norms), both servers
from the same init carried across, 3 users with the same 16-token streams,
mode C (λ = 30, α = 0.01, K = 5, η_in = 0.01, as launch/serve.py sets
them), ``personal_subset="embed/unembed"``, fp32 and int8 banking; then the
personalized decode of 8 prompt and 12 decoded positions, past the window.
internvl2-76b goes through ``launch.serve.main`` with its zero ``visual``
leaf.

Tolerances, as ``test_torch_serve_lm.py``: fp32 heads within 1e-5; int8
heads within 1e-5 plus one code step (the largest row scale); decoded tokens
equal, each decode step's logits within LOGIT_TOL (1e-5), with every
decoded position's top-2 margin above twice that.
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
from repro.core.subset import merge_subset as merge_jsubset
from repro.launch import serve as jserve
from repro.models import api as japi
from repro.serving import PersonalizationServer as JServer
from repro_torch.configs import get_config, reduce_for_smoke
from repro_torch.convert import params_from_jax
from repro_torch.core import PersAFLConfig
from repro_torch.core.subset import SubsetSpec, merge_subset
from repro_torch.launch import serve
from repro_torch.models import api
from repro_torch.serving import PersonalizationServer
from repro_torch.tree import tree_leaves, tree_map

USERS, PLEN, PROMPT, TOKENS = 3, 16, 8, 12
PCFG = dict(option="C", lam=30.0, alpha=0.01, inner_steps=5, inner_eta=0.01)
SUBSET = ("embed/unembed",)
ATOL = LOGIT_TOL = 1e-5


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
    """gemma2 on the JAX side, once: the subset heads of an fp32 and an
    int8 server, and the fp32 heads' personalized decode."""
    jcfg = j_reduce(j_get_config("gemma2-2b"))
    cfg = reduce_for_smoke(get_config("gemma2-2b"))
    jparams = japi.init_params(jcfg, jax.random.PRNGKey(2))
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
    prompt = np.random.RandomState(2).randint(0, cfg.vocab, (USERS, PROMPT)
                                              ).astype(np.int32)
    tokens = jserve._decode_personalized(
        jcfg, jax.tree.map(jnp.asarray, heads["fp32"]), jnp.asarray(prompt),
        PROMPT + TOKENS, PROMPT, params=jparams,
        spec=JSubsetSpec.resolve(SUBSET, jparams))
    return dict(jcfg=jcfg, cfg=cfg, jparams=jparams, np_params=np_params,
                batches=batches, heads=heads, servers=servers, prompt=prompt,
                tokens=np.asarray(tokens))


@pytest.mark.parametrize("codec", ["fp32", "int8"])
def test_gemma2_server_subset_heads_match_reference(gref, codec):
    """Both packages' servers personalize gemma2's unembedding (mode C):
    heads within the tolerance, each moved well past it, and every user's
    head below the global loss on their own stream."""
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


def test_gemma2_decode_tokens_match_reference(gref):
    """The JAX fp32 subset heads carried across decode the same tokens
    through the port's ``_decode_personalized`` (backbone shared, in_dims
    None) as through the reference's, 20 positions past the window of 16,
    with every decoded position's top-2 margin above twice LOGIT_TOL."""
    jcfg, cfg, prompt = gref["jcfg"], gref["cfg"], gref["prompt"]
    params = params_from_jax(gref["np_params"], device="cpu")
    heads = params_from_jax(gref["heads"]["fp32"], device="cpu")
    spec = SubsetSpec.resolve(",".join(SUBSET), params)
    max_len = PROMPT + TOKENS
    got = serve._decode_personalized(cfg, heads, torch.from_numpy(prompt),
                                     max_len, PROMPT, params=params,
                                     spec=spec)
    assert got.dtype == torch.int32 and tuple(got.shape) == (USERS, TOKENS)
    np.testing.assert_array_equal(got.numpy(), gref["tokens"])
    # the logits behind each decoded token, user by user, in both packages
    seq = np.concatenate([prompt, got.numpy()], axis=1)[:, :-1]
    jstep = jax.jit(lambda p, c, t, pos: japi.decode_step(
        jcfg, p, c, t, jnp.int32(pos)))
    t_rows, j_rows = [], []
    for u in range(USERS):
        jp = merge_jsubset(gref["jparams"], jax.tree.map(
            lambda x: jnp.asarray(x[u]), gref["heads"]["fp32"]))
        tp = merge_subset(params, tree_map(lambda x: x[u], heads))
        jc = japi.init_cache(jcfg, jp, {"tokens": jnp.asarray(
            seq[u:u + 1, :1])}, max_len, jnp.float32)
        tc = api.init_cache(cfg, tp, {"tokens": torch.from_numpy(
            seq[u:u + 1, :1])}, max_len, torch.float32)
        for t in range(seq.shape[1]):
            tok = seq[u:u + 1, t:t + 1]
            jl, jc = jstep(jp, jc, jnp.asarray(tok), t)
            tl, tc = api.decode_step(cfg, tp, tc, torch.from_numpy(tok), t)
            j_rows.append(np.asarray(jl)[0, 0])
            t_rows.append(tl.numpy()[0, 0])
    dec = np.stack(t_rows).reshape(USERS, seq.shape[1], -1)[:, PROMPT - 1:]
    want = np.stack(j_rows).reshape(USERS, seq.shape[1], -1)[:, PROMPT - 1:]
    np.testing.assert_allclose(dec, want, atol=LOGIT_TOL, rtol=0)
    np.testing.assert_array_equal(dec.argmax(-1), got.numpy())
    top2 = np.sort(dec, axis=-1)[..., -2:]
    assert float((top2[..., 1] - top2[..., 0]).min()) > 2 * LOGIT_TOL


def test_user_batch_matches_reference():
    """``_user_batch`` gives the reference's leaves: the token streams
    bit-equal and, for a vlm arch, the zero ``visual`` leaf (1,
    n_visual_tokens, d_model): numpy f32 zeros, which ``lm_hidden`` casts
    to the activation dtype, bf16 at full width, as the reference's
    leaf is."""
    for arch in ("gemma2-2b", "internvl2-76b"):
        cfg = reduce_for_smoke(get_config(arch))
        got = serve._user_batch(cfg, 5, PLEN)
        want = jserve._user_batch(j_reduce(j_get_config(arch)), 5, PLEN)
        assert sorted(got) == sorted(want)
        for k in want:
            assert tuple(got[k].shape) == want[k].shape
            np.testing.assert_array_equal(np.asarray(got[k]),
                                          np.asarray(want[k]))
    assert got["visual"].dtype == np.float32
    full = get_config("internvl2-76b")
    assert full.activation_dtype == torch.bfloat16
    vis = serve._user_batch(full, 5, 4)["visual"]
    assert vis.dtype == np.float32 and not vis.any()


@pytest.mark.parametrize("arch,extra", [
    ("gemma2-2b", ["--personal-subset", "embed/unembed", "--delta-dtype",
                   "int8", "--tokens", "20"]),
    ("internvl2-76b", ["--tokens", "4"]),
])
def test_serve_main_dense_and_vlm_on_cpu(arch, extra, tmp_path):
    """``launch/serve.py`` end to end on the CPU: gemma2 with its subset and
    int8 banking, decoding past the window; internvl2 personalizing the
    whole model on streams that carry the visual leaf."""
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
    if arch == "internvl2-76b":
        cfg = run.cfg
        for b in run.batches:
            assert tuple(b["visual"].shape) == (1, cfg.n_visual_tokens,
                                                cfg.d_model)
        assert "vis_proj" in run.heads
    else:
        assert list(run.heads) == ["embed"]
        assert rec["personal_subset"] == ["embed/unembed"]
