"""Port of the LM serving path (``repro_torch.launch.serve`` over
``PersonalizationServer``) against the JAX package on the smoke mamba2
(``reduce_for_smoke(mamba2-130m)``): both servers from the same init, the
same 3 users with the same token streams, mode C (λ = 30, α = 0.01, K = 5,
η_in = 0.01, as the serve driver sets them), fp32 and int8 banking.  The
hybrid (``reduce_for_smoke(zamba2-1.2b)``, one shared attention block) goes
through the same path with ``personal_subset=("shared", "embed/unembed")``,
fp32, its personalized decode carrying the attention ring and the
``emb0: None`` cache entry through the port's vmap.

Tolerances.  fp32 heads within 1e-5 (each is K gradient steps on the same
params, summed in other orders; heads move about 6e-3 from the global
params, so a no-op fails).  int8 heads within 1e-5 plus one code step (the
largest row scale) wherever the two packages' deltas fall on opposite sides
of a rounding boundary.  Decoded tokens must be equal; each decode step's
logits agree within LOGIT_TOL (1e-5), and the test checks that the top-2
logit margin at every decoded position exceeds twice that -- the most two
logits within LOGIT_TOL of the reference's can trade places by -- so an
argmax tie cannot flip a token silently.
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

USERS, PLEN, PROMPT, TOKENS = 3, 16, 8, 4
PCFG = dict(option="C", lam=30.0, alpha=0.01, inner_steps=5, inner_eta=0.01)
ATOL = 1e-5
# the decode logits' absolute tolerance, as test_torch_ssm_lm's (observed
# differences up to 3.1e-6 at these logits of order 2)
LOGIT_TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _users():
    return [f"user{u}" for u in range(USERS)]


def _max_scale(srv):
    """The largest row scale of the int8 banks either package's ring holds
    (``jax.tree.leaves`` walks the port's dict trees of tensors too)."""
    return max(float(np.max(np.asarray(sc)))
               for bs in srv.ring._banks.values() for b in bs
               for sc in jax.tree.leaves(b.stacked.scales))


@pytest.fixture(scope="module")
def ref():
    """The JAX side, once: config, init, the users' streams, and the heads
    of an fp32 and an int8 server."""
    jcfg = j_reduce(j_get_config("mamba2-130m"))
    cfg = reduce_for_smoke(get_config("mamba2-130m"))
    jparams = japi.init_params(jcfg, jax.random.PRNGKey(0))
    np_params = jax.tree.map(np.asarray, jparams)
    assert serve._personalize_len(cfg, PROMPT) == \
        jserve._personalize_len(jcfg, PROMPT) == PLEN
    batches = [serve._user_batch(cfg, u, PLEN) for u in range(USERS)]
    heads, servers = {}, {}
    for codec in ("fp32", "int8"):
        js = JServer(jparams, lambda p, b: japi.loss_fn(jcfg, p, b),
                     JConfig(**PCFG), modes=("C",), max_pending=USERS,
                     delta_dtype=codec)
        for user, b in zip(_users(), batches):
            js.submit(user, {k: jnp.asarray(v) for k, v in b.items()})
        js.flush()
        heads[codec] = jax.tree.map(np.asarray,
                                    js.stacked_heads(_users()))
        servers[codec] = js
    prompt = np.random.RandomState(0).randint(0, cfg.vocab, (USERS, PROMPT)
                                              ).astype(np.int32)
    return dict(jcfg=jcfg, cfg=cfg, jparams=jparams, np_params=np_params,
                batches=batches, heads=heads, servers=servers, prompt=prompt)


@pytest.mark.parametrize("impl", ["map", "vmap"])
@pytest.mark.parametrize("codec", ["fp32", "int8"])
def test_server_heads_match_reference(ref, codec, impl):
    cfg = ref["cfg"]
    ts = PersonalizationServer(ref["np_params"],
                               lambda p, b: api.loss_fn(cfg, p, b),
                               PersAFLConfig(**PCFG), modes=("C",),
                               max_pending=USERS, delta_dtype=codec,
                               device="cpu", cohort_impl=impl)
    for user, b in zip(_users(), ref["batches"]):
        ts.submit(user, b)
    assert ts.flush() == 0            # the 3rd submit flushed the queue
    heads = ts.stacked_heads(_users())
    st = ts.stats
    assert st["host_materializations"] == 0
    assert st["cohort_calls"] == 1 and st["padding_waste"] == 1  # bucket 4
    js = ref["servers"][codec]
    assert st["ring_bytes_per_user"] == js.stats["ring_bytes_per_user"]
    tol = ATOL
    if codec == "int8":
        tol += max(_max_scale(js), _max_scale(ts))
    want = ref["heads"][codec]
    for a, b, p in zip(tree_leaves(heads), jax.tree.leaves(want),
                       jax.tree.leaves(ref["np_params"])):
        np.testing.assert_allclose(a.numpy(), b, atol=tol, rtol=0)
    # the check fails a head that did not move (a zero delta)
    moved = max(float(np.abs(b - p[None]).max()) for b, p in
                zip(jax.tree.leaves(want), jax.tree.leaves(ref["np_params"])))
    assert moved > 10 * tol
    # every user's personalized head fits their own stream better than the
    # global params: a backward that returned zeros would not
    params = ts.params
    for u, b in enumerate(ref["batches"]):
        tb = {k: torch.from_numpy(v) for k, v in b.items()}
        head = tree_map(lambda x: x[u], heads)
        assert float(api.loss_fn(cfg, head, tb)) < \
            float(api.loss_fn(cfg, params, tb))


def _replay(step, init, heads, seq, n_users):
    """Teacher-forced decode of ``seq`` per user with their own head:
    logits (U, L, V) after each token."""
    out = []
    for u in range(n_users):
        p = jax.tree.map(lambda x: x[u], heads) if init is None \
            else tree_map(lambda x: x[u], heads)
        cache = init(p, seq[u:u + 1]) if init is not None else None
        rows = []
        for t in range(seq.shape[1]):
            logits, cache = step(p, cache, seq[u:u + 1, t:t + 1], t)
            rows.append(np.asarray(logits)[0, 0])
        out.append(np.stack(rows))
    return np.stack(out)


@pytest.mark.parametrize("personalized", [True, False])
def test_decode_tokens_match_reference(ref, personalized):
    """``_decode_personalized`` (the JAX heads, carried across) and
    ``_decode_shared`` decode the same tokens in both packages, with every
    decoded position's top-2 margin above twice the logit tolerance."""
    jcfg, cfg, prompt = ref["jcfg"], ref["cfg"], ref["prompt"]
    max_len = PROMPT + TOKENS
    if personalized:
        jheads = ref["heads"]["fp32"]
        want = jserve._decode_personalized(
            jcfg, jax.tree.map(jnp.asarray, jheads), jnp.asarray(prompt),
            max_len, PROMPT)
        got = serve._decode_personalized(
            cfg, params_from_jax(jheads, device="cpu"),
            torch.from_numpy(prompt), max_len, PROMPT)
    else:
        jheads = jax.tree.map(lambda x: np.repeat(x[None], USERS, 0),
                              ref["np_params"])
        want = jserve._decode_shared(jcfg, ref["jparams"],
                                     jnp.asarray(prompt), max_len, PROMPT)
        got = serve._decode_shared(
            cfg, params_from_jax(ref["np_params"], device="cpu"),
            torch.from_numpy(prompt), max_len, PROMPT)
    assert got.dtype == torch.int32 and tuple(got.shape) == (USERS, TOKENS)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # the logits behind each decoded token, in both packages
    seq = np.concatenate([prompt, got.numpy()], axis=1)[:, :-1]
    jstep = jax.jit(lambda p, c, t, pos: japi.decode_step(
        jcfg, p, c, t, jnp.int32(pos)))
    j_logits = _replay(
        lambda p, c, t, pos: jstep(
            p, c if c is not None else japi.init_cache(
                jcfg, p, {"tokens": jnp.asarray(t)}, max_len, jnp.float32),
            jnp.asarray(t), pos),
        None, jax.tree.map(jnp.asarray, jheads), seq, USERS)
    t_heads = params_from_jax(jheads, device="cpu")
    t_logits = _replay(
        lambda p, c, t, pos: api.decode_step(cfg, p, c, torch.from_numpy(t),
                                             pos),
        lambda p, s: api.init_cache(cfg, p, {"tokens": torch.from_numpy(
            s[:, :1])}, max_len, torch.float32),
        t_heads, seq, USERS)
    dec = t_logits[:, PROMPT - 1:]                       # decoded positions
    np.testing.assert_allclose(dec, j_logits[:, PROMPT - 1:],
                               atol=LOGIT_TOL, rtol=0)
    np.testing.assert_array_equal(dec.argmax(-1), got.numpy())
    top2 = np.sort(dec, axis=-1)[..., -2:]
    assert float((top2[..., 1] - top2[..., 0]).min()) > 2 * LOGIT_TOL


HYBRID_SUBSET = ("shared", "embed/unembed")


@pytest.fixture(scope="module")
def zref():
    """The hybrid on the JAX side, once: the fp32 server's subset heads
    (the shared block and the unembedding per user) and its decode."""
    jcfg = j_reduce(j_get_config("zamba2-1.2b"))
    cfg = reduce_for_smoke(get_config("zamba2-1.2b"))
    jparams = japi.init_params(jcfg, jax.random.PRNGKey(1))
    np_params = jax.tree.map(np.asarray, jparams)
    batches = [serve._user_batch(cfg, 10 + u, PLEN) for u in range(USERS)]
    js = JServer(jparams, lambda p, b: japi.loss_fn(jcfg, p, b),
                 JConfig(**PCFG), modes=("C",), max_pending=USERS,
                 personal_subset=HYBRID_SUBSET)
    for user, b in zip(_users(), batches):
        js.submit(user, {k: jnp.asarray(v) for k, v in b.items()})
    js.flush()
    heads = js.stacked_heads(_users())
    prompt = np.random.RandomState(1).randint(0, cfg.vocab, (USERS, PROMPT)
                                              ).astype(np.int32)
    spec = JSubsetSpec.resolve(HYBRID_SUBSET, jparams)
    tokens = jserve._decode_personalized(
        jcfg, heads, jnp.asarray(prompt), PROMPT + TOKENS, PROMPT,
        params=jparams, spec=spec)
    return dict(jcfg=jcfg, cfg=cfg, jparams=jparams, np_params=np_params,
                batches=batches, heads=jax.tree.map(np.asarray, heads),
                prompt=prompt, tokens=np.asarray(tokens))


def test_hybrid_server_subset_heads_match_reference(zref):
    """Both packages' servers personalize the hybrid's shared block and
    unembedding (fp32, mode C): heads within ATOL, each moved well past it,
    and every user's head below the global loss on their own stream."""
    cfg = zref["cfg"]
    ts = PersonalizationServer(zref["np_params"],
                               lambda p, b: api.loss_fn(cfg, p, b),
                               PersAFLConfig(**PCFG), modes=("C",),
                               max_pending=USERS, device="cpu",
                               personal_subset=HYBRID_SUBSET)
    for user, b in zip(_users(), zref["batches"]):
        ts.submit(user, b)
    heads = ts.stacked_heads(_users())
    assert ts.stats["host_materializations"] == 0
    assert sorted(heads) == ["embed", "shared"]
    assert list(heads["embed"]) == ["unembed"]
    want = zref["heads"]
    spec = SubsetSpec.resolve(HYBRID_SUBSET, zref["np_params"])
    base_leaves = jax.tree.leaves(spec.extract(zref["np_params"]))
    moved = 0.0
    for a, b, p in zip(tree_leaves(heads), jax.tree.leaves(want),
                       base_leaves):
        np.testing.assert_allclose(a.numpy(), b, atol=ATOL, rtol=0)
        moved = max(moved, float(np.abs(b - p[None]).max()))
    assert moved > 10 * ATOL
    for u, b in enumerate(zref["batches"]):
        tb = {k: torch.from_numpy(v) for k, v in b.items()}
        head = merge_subset(ts.params, tree_map(lambda x: x[u], heads))
        assert float(api.loss_fn(cfg, head, tb)) < \
            float(api.loss_fn(cfg, ts.params, tb))


def test_hybrid_decode_tokens_match_reference(zref):
    """The JAX subset heads carried across decode the same tokens through
    the port's ``_decode_personalized`` (backbone shared, in_dims None),
    past the end of the ring (8 + 12 positions > the window of 16), with
    every decoded position's top-2 margin above twice LOGIT_TOL."""
    jcfg, cfg, prompt = zref["jcfg"], zref["cfg"], zref["prompt"]
    params = params_from_jax(zref["np_params"], device="cpu")
    heads = params_from_jax(zref["heads"], device="cpu")
    spec = SubsetSpec.resolve(HYBRID_SUBSET, params)
    max_len = PROMPT + TOKENS
    got = serve._decode_personalized(cfg, heads, torch.from_numpy(prompt),
                                     max_len, PROMPT, params=params,
                                     spec=spec)
    assert tuple(got.shape) == (USERS, TOKENS)
    np.testing.assert_array_equal(got.numpy(), zref["tokens"])
    # the logits behind each decoded token, user by user, in both packages
    seq = np.concatenate([prompt, got.numpy()], axis=1)[:, :-1]
    jstep = jax.jit(lambda p, c, t, pos: japi.decode_step(
        jcfg, p, c, t, jnp.int32(pos)))
    t_rows, j_rows = [], []
    for u in range(USERS):
        jp = merge_jsubset(zref["jparams"], jax.tree.map(
            lambda x: jnp.asarray(x[u]), zref["heads"]))
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


def test_serve_main_smoke_on_cpu(tmp_path):
    run = serve.main(["--arch", "mamba2-130m", "--smoke", "--personalize",
                      "--requests", "3", "--tokens", "4", "--device", "cpu",
                      "--delta-dtype", "int8", "--out", str(tmp_path)])
    rec = run.record
    assert rec["arch"] == "mamba2-130m" and rec["users"] == 3
    assert rec["personalized"] and rec["delta_dtype"] == "int8"
    assert rec["host_materializations"] == 0
    assert rec["ring_bytes_per_user"] > 0 and rec["tok_per_s"] > 0
    assert sorted(rec) == sorted([
        "arch", "tok_per_s", "personalized", "mode", "users", "model_axis",
        "personal_subset", "delta_dtype", "ring_bytes_per_user",
        "ring_bytes_saved_per_user", "host_materializations"])
    assert (tmp_path / "serve_mamba2-130m.json").is_file()
    assert tuple(run.out_tokens.shape) == (3, 4)
    assert run.server.stats["cohort_calls"] == 1
    # head-only personalization: the unembedding only, decoded with the
    # backbone shared (in_dims None)
    run = serve.main(["--arch", "mamba2-130m", "--smoke", "--personalize",
                      "--requests", "2", "--tokens", "2", "--device", "cpu",
                      "--personal-subset", "embed/unembed",
                      "--out", str(tmp_path)])
    assert run.record["personal_subset"] == ["embed/unembed"]
    assert list(run.heads) == ["embed"] and \
        list(run.heads["embed"]) == ["unembed"]
    assert tuple(run.out_tokens.shape) == (2, 2)
    # the hybrid through the same entry point, with its subset and int8
    run = serve.main(["--arch", "zamba2-1.2b", "--smoke", "--personalize",
                      "--requests", "2", "--tokens", "12", "--device", "cpu",
                      "--delta-dtype", "int8", "--personal-subset",
                      "shared,embed/unembed", "--out", str(tmp_path)])
    assert run.record["arch"] == "zamba2-1.2b"
    assert run.record["host_materializations"] == 0
    assert sorted(run.heads) == ["embed", "shared"]
    assert tuple(run.out_tokens.shape) == (2, 12)
    assert (tmp_path / "serve_zamba2-1.2b.json").is_file()


# --listen is ported (tests/test_torch_transport.py), and so are the mesh
# and multi-process flags (tests/test_torch_cohort_train_step.py runs them
# on a spawned rank); here each flag's bad value raises before any process
# group starts, so none leaks into this process
@pytest.mark.parametrize("flag", [["--process-id", "1"], ["--model-axis", "2"],
                                  ["--coordinator", "127.0.0.1"],
                                  ["--num-processes", "0"]])
def test_serve_flags_not_ported_raise(flag, tmp_path):
    import torch.distributed as dist
    with pytest.raises(ValueError):
        serve.main(["--arch", "mamba2-130m", "--smoke", "--device", "cpu",
                    "--out", str(tmp_path)] + flag)
    assert not dist.is_initialized()
