"""Port of the LM serving path for the encdec family (``repro_torch.launch.
serve`` over ``PersonalizationServer`` with ``models.encdec``) against the
JAX package, beside ``test_torch_serve_dense_lm.py``: whisper-large-v3 at
``reduce_for_smoke`` (2 encoder and 2 decoder layers, d 256, enc_len 16),
both servers from the same init carried across, 3 users with the same
16-token streams and the reference's zero ``frames`` leaf, mode C (λ = 30,
α = 0.01, K = 5, η_in = 0.01, as launch/serve.py sets them), with
``personal_subset="embed/unembed"`` (fp32 and int8 banking) and the whole
model personalized (fp32: every user's own encoder); then the personalized
decode of 8 prompt and 10 decoded positions from each server's heads.

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

ARCH = "whisper-large-v3"
USERS, PLEN, PROMPT, TOKENS = 3, 16, 8, 10
PCFG = dict(option="C", lam=30.0, alpha=0.01, inner_steps=5, inner_eta=0.01)
SUBSET = ("embed/unembed",)
# (name, personal subset or None for the whole model, banking codec)
SERVERS = (("subset-fp32", SUBSET, "fp32"), ("subset-int8", SUBSET, "int8"),
           ("full-fp32", None, "fp32"))
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
def wref():
    """whisper on the JAX side, once: the heads of each of SERVERS and the
    personalized decode of the fp32 ones."""
    jcfg = j_reduce(j_get_config(ARCH))
    cfg = reduce_for_smoke(get_config(ARCH))
    jparams = japi.init_params(jcfg, jax.random.PRNGKey(3))
    np_params = jax.tree.map(np.asarray, jparams)
    batches = [serve._user_batch(cfg, 30 + u, PLEN) for u in range(USERS)]
    prompt = np.random.RandomState(4).randint(0, cfg.vocab, (USERS, PROMPT)
                                              ).astype(np.int32)
    heads, servers, tokens = {}, {}, {}
    for name, subset, codec in SERVERS:
        js = JServer(jparams, lambda p, b: japi.loss_fn(jcfg, p, b),
                     JConfig(**PCFG), modes=("C",), max_pending=USERS,
                     personal_subset=subset, delta_dtype=codec)
        for user, b in zip(_users(), batches):
            js.submit(user, {k: jnp.asarray(v) for k, v in b.items()})
        js.flush()
        heads[name] = jax.tree.map(np.asarray, js.stacked_heads(_users()))
        servers[name] = js
        if codec == "fp32":
            spec = JSubsetSpec.resolve(subset, jparams) if subset else None
            tokens[name] = np.asarray(jserve._decode_personalized(
                jcfg, jax.tree.map(jnp.asarray, heads[name]),
                jnp.asarray(prompt), PROMPT + TOKENS, PROMPT,
                params=jparams, spec=spec))
    return dict(jcfg=jcfg, cfg=cfg, jparams=jparams, np_params=np_params,
                batches=batches, heads=heads, servers=servers, prompt=prompt,
                tokens=tokens)


@pytest.mark.parametrize("name,subset,codec", SERVERS)
def test_whisper_server_heads_match_reference(wref, name, subset, codec):
    """Both packages' servers personalize whisper (mode C) on streams with
    the zero frames: heads within the tolerance, each moved well past it,
    and every user's head below the global loss on their own stream."""
    cfg = wref["cfg"]
    ts = PersonalizationServer(wref["np_params"],
                               lambda p, b: api.loss_fn(cfg, p, b),
                               PersAFLConfig(**PCFG), modes=("C",),
                               max_pending=USERS, delta_dtype=codec,
                               personal_subset=subset, device="cpu")
    for user, b in zip(_users(), wref["batches"]):
        ts.submit(user, b)
    heads = ts.stacked_heads(_users())
    st = ts.stats
    assert st["host_materializations"] == 0 and st["cohort_calls"] == 1
    js = wref["servers"][name]
    assert st["ring_bytes_per_user"] == js.stats["ring_bytes_per_user"]
    tol = ATOL
    if codec == "int8":
        tol += max(_max_scale(js), _max_scale(ts))
    base = JSubsetSpec.resolve(subset, wref["np_params"]).extract(
        wref["np_params"]) if subset else wref["np_params"]
    moved = 0.0
    for a, b, p in zip(tree_leaves(heads), jax.tree.leaves(
            wref["heads"][name]), jax.tree.leaves(base)):
        np.testing.assert_allclose(a.numpy(), b, atol=tol, rtol=0)
        moved = max(moved, float(np.abs(b - p[None]).max()))
    assert moved > 10 * tol
    for u, b in enumerate(wref["batches"]):
        tb = {k: torch.from_numpy(v) for k, v in b.items()}
        one = tree_map(lambda x: x[u], heads)
        head = merge_subset(ts.params, one) if subset else one
        assert float(api.loss_fn(cfg, head, tb)) < \
            float(api.loss_fn(cfg, ts.params, tb))


@pytest.mark.parametrize("name,subset", [("subset-fp32", SUBSET),
                                         ("full-fp32", None)])
def test_whisper_decode_tokens_match_reference(wref, name, subset):
    """The JAX fp32 heads carried across decode the same tokens through the
    port's ``_decode_personalized`` as through the reference's (the cross
    K/V of each user's cache from their own encoder where the whole model
    is personal), with the logits behind every decoded token within
    LOGIT_TOL and every top-2 margin above twice that."""
    jcfg, cfg, prompt = wref["jcfg"], wref["cfg"], wref["prompt"]
    params = params_from_jax(wref["np_params"], device="cpu")
    heads = params_from_jax(wref["heads"][name], device="cpu")
    spec = SubsetSpec.resolve(",".join(subset), params) if subset else None
    max_len = PROMPT + TOKENS
    got = serve._decode_personalized(cfg, heads, torch.from_numpy(prompt),
                                     max_len, PROMPT, params=params,
                                     spec=spec)
    assert got.dtype == torch.int32 and tuple(got.shape) == (USERS, TOKENS)
    np.testing.assert_array_equal(got.numpy(), wref["tokens"][name])
    # the logits behind each decoded token, user by user, in both packages
    seq = np.concatenate([prompt, got.numpy()], axis=1)[:, :-1]
    jstep = jax.jit(lambda p, c, t, pos: japi.decode_step(
        jcfg, p, c, t, jnp.int32(pos)))
    t_rows, j_rows = [], []
    for u in range(USERS):
        jh = jax.tree.map(lambda x: jnp.asarray(x[u]), wref["heads"][name])
        th = tree_map(lambda x: x[u], heads)
        jp = merge_jsubset(wref["jparams"], jh) if subset else jh
        tp = merge_subset(params, th) if subset else th
        tok0 = seq[u:u + 1, :1]
        jc = japi.init_cache(jcfg, jp, jserve._init_batch(
            jcfg, jnp.asarray(tok0)), max_len, jnp.float32)
        tc = api.init_cache(cfg, tp, serve._init_batch(
            cfg, torch.from_numpy(tok0)), max_len, torch.float32)
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


def test_user_and_init_batches_match_reference():
    """``_user_batch`` gives the reference's leaves, the zero ``frames``
    (1, enc_len, d_model) among them (numpy f32 zeros, which the encoder
    casts to the activation dtype); ``_init_batch`` the reference's zero
    frames beside the tokens, in the activation dtype."""
    cfg, jcfg = reduce_for_smoke(get_config(ARCH)), j_reduce(
        j_get_config(ARCH))
    got = serve._user_batch(cfg, 5, PLEN)
    want = jserve._user_batch(jcfg, 5, PLEN)
    assert sorted(got) == sorted(want) == ["frames", "labels", "tokens"]
    for k in want:
        assert tuple(got[k].shape) == want[k].shape
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]))
    full = get_config(ARCH)
    frames = serve._user_batch(full, 5, 4)["frames"]
    assert frames.dtype == np.float32 and frames.shape == (1, 1500, 1280)
    assert not frames.any()
    tok = np.zeros((2, 1), np.int32)
    ib = serve._init_batch(cfg, torch.from_numpy(tok))
    jb = jserve._init_batch(jcfg, jnp.asarray(tok))
    assert sorted(ib) == sorted(jb) == ["frames", "tokens"]
    assert tuple(ib["frames"].shape) == jb["frames"].shape
    assert ib["frames"].dtype == cfg.activation_dtype and \
        not ib["frames"].any()


@pytest.mark.parametrize("extra", [
    ["--personal-subset", "embed/unembed", "--delta-dtype", "int8"],
    [],
])
def test_serve_main_whisper_on_cpu(extra, tmp_path):
    """``launch/serve.py`` end to end on the CPU: whisper with its subset
    and int8 banking, and with the whole model personalized; the streams
    carry the frames leaf."""
    run = serve.main(["--arch", ARCH, "--smoke", "--personalize",
                      "--requests", "2", "--tokens", "5", "--device", "cpu",
                      "--out", str(tmp_path)] + extra)
    rec, cfg = run.record, run.cfg
    assert rec["arch"] == ARCH and rec["users"] == 2
    assert rec["host_materializations"] == 0 and rec["tok_per_s"] > 0
    assert run.server.stats["cohort_calls"] == 1
    assert (tmp_path / f"serve_{ARCH}.json").is_file()
    assert tuple(run.out_tokens.shape) == (2, 5)
    for b in run.batches:
        assert tuple(b["frames"].shape) == (1, cfg.enc_len, cfg.d_model)
    if extra:
        assert list(run.heads) == ["embed"]
        assert rec["personal_subset"] == ["embed/unembed"]
    else:
        assert "enc_layers" in run.heads
