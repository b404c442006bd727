"""What each spawned rank of the port's multi-device tests runs (see
``tests/torch_ranks.py``).  Every rank runs the same body on the same numpy
inputs; a body returns plain Python and numpy values, which the test reads
back and holds against the JAX package and the port's one-device path.
Imports ``torch`` and ``repro_torch`` only."""
import numpy as np
import torch

from torch_ranks import init


def quad_loss(w, batch):
    r = batch["a"] @ w["w"] - batch["y"]
    return 0.5 * torch.mean(r ** 2)


def client_batches(seed, q3=6, m=8, d=5):
    rng = np.random.RandomState(seed)
    return {"a": rng.randn(q3, m, d).astype(np.float32),
            "y": rng.randn(q3, m).astype(np.float32)}


def quad_pcfg(option):
    from repro_torch.core import PersAFLConfig
    return PersAFLConfig(option=option, q_local=2, eta=0.05, alpha=0.05,
                         lam=20.0, inner_steps=5, inner_eta=0.02,
                         maml_mode="full")


def quad_params():
    return {"w": torch.arange(1.0, 6.0) * 0.1}


def _np(x):
    return x.detach().cpu().numpy()


def engine(rank, world, out):
    """The shard_map cohort on the 1-D mesh (and the 2x4 one with the
    params' one leaf split unevenly over "model"): rows, the masked mean,
    bucket padding, SCAFFOLD's state stacks, a flush from a sharded bank."""
    from repro_torch.core import apply_buffered_rows, init_server_state
    from repro_torch.fl import CohortEngine, strategy
    from repro_torch.kernels.fused_update import kernel as K
    from repro_torch.kernels.fused_update.ref import apply_rows_seq_ref
    from repro_torch.sharding import ctx
    from repro_torch.sharding.rules import NamedSharding, P
    from repro_torch.tree import tree_leaves
    init(rank, world, out)
    res = {}
    params = quad_params()
    bl = [client_batches(seed) for seed in range(32)]
    for opt in "ABC":
        eng = CohortEngine(quad_pcfg(opt), quad_loss,
                           cohort_impl="shard_map", device="cpu")
        bank = eng.update_cohort(params, bl)
        res[f"rows_{opt}"] = _np(ctx.gather(bank.stacked)["w"])
        res[f"local_rows_{opt}"] = tuple(bank.stacked["w"].to_local().shape)
    res["ndev"] = eng._ndev
    eng = CohortEngine(quad_pcfg("A"), quad_loss, cohort_impl="shard_map",
                       device="cpu")
    res["mean13"] = _np(eng.update_cohort_mean(params, bl[:13])["w"])
    for k in (5, 13, 17):
        eng = CohortEngine(quad_pcfg("A"), quad_loss,
                           cohort_impl="shard_map", device="cpu")
        bank = eng.update_cohort(params, bl[:k])
        res[f"waste_{k}"] = eng.stats["padding_waste"]
        res[f"cap_{k}"] = bank.capacity
    # SCAFFOLD: the state stack stays split over "cohort"
    strat = strategy("scaffold").bind(quad_pcfg("A"), quad_loss)
    eng = CohortEngine(quad_pcfg("A"), quad_loss, cohort_impl="shard_map",
                       strategy=strat, device="cpu")
    cstates = [strat.dispatch_state(strat.init_client_state(params))
               for _ in range(8)]
    bank = eng.update_cohort(params, bl[:8], cstate_list=cstates)
    res["scaffold_sharded"] = all(ctx.is_sharded(x)
                                  for x in tree_leaves(bank._cstates))
    res["scaffold_states"] = [
        {k: _np(v) for k, v in _flat_named(bank.client_state(i))}
        for i in range(8)]
    res["scaffold_rows"] = _np(ctx.gather(bank.stacked)["w"])
    # a buffered flush straight from a sharded bank: the sequential apply,
    # no host materialization until a row is asked for
    eng = CohortEngine(quad_pcfg("A"), quad_loss, cohort_impl="shard_map",
                       device="cpu")
    state = init_server_state(params, "cpu")
    bank = eng.update_cohort(state.params, bl[:6])
    weights = np.zeros(bank.capacity, np.float32)
    weights[:6] = 0.5 / 6
    order = np.random.RandomState(3).permutation(bank.capacity)
    new = apply_buffered_rows(state, bank.stacked, weights, 6,
                              staleness_max=0, order=order)
    res["flush"] = _np(new.params["w"])
    res["flush_seq_ref"] = _np(apply_rows_seq_ref(
        params["w"], ctx.gather(bank.stacked)["w"], weights, order))
    res["flush_launches"] = K.LAUNCHES["apply_rows"]
    res["hm_before_row"] = eng.stats["host_materializations"]
    before = _np(ctx.gather(bank.stacked)["w"])
    res["row0"] = _np(bank.row(0)["w"])
    res["hm_after_row"] = eng.stats["host_materializations"]
    # the device copy was released; asking for the stack places it again
    res["restacked_equal"] = bool(np.array_equal(
        _np(ctx.gather(bank.stacked)["w"]), before))
    res["restacked_sharded"] = ctx.is_sharded(bank.stacked["w"])
    # the 2x4 mesh, w split over "model" in chunks of 2, 2, 1 and 0: the
    # rows are the 1-D mesh's bits, stored split on both axes
    m24 = ctx.cohort_model_mesh(4)
    eng = CohortEngine(quad_pcfg("A"), quad_loss, cohort_impl="shard_map",
                       device="cpu", mesh=m24,
                       param_shardings={"w": NamedSharding(m24, P("model"))})
    bank = eng.update_cohort(params, bl[:16])
    res["rows_A_24"] = _np(ctx.gather(bank.stacked)["w"])
    res["local_rows_A_24"] = tuple(bank.stacked["w"].to_local().shape)
    res["placements_24"] = repr(bank.stacked["w"].placements)
    # the masked mean on 2x4: one all_reduce over "cohort" only (one that
    # crossed "model" would add every row 4 times)
    res["mean13_24"] = _np(eng.update_cohort_mean(params, bl[:13])["w"])
    return res


def _flat_named(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flat_named(tree[k], f"{prefix}{k}/")
    else:
        yield prefix[:-1], tree


def flrun_clients():
    """tests/test_mesh_parity.py's six clients (numpy)."""
    rng = np.random.RandomState(0)
    out = []
    for _ in range(6):
        x = rng.randn(64, 8).astype(np.float32)
        y = rng.randint(0, 4, 64).astype(np.int32)
        out.append((x, y))
    return out


def softmax_loss(classes):
    def loss(p, b):
        logits = b["images"] @ p["w"]
        if "b" in p:
            logits = logits + p["b"]
        logp = torch.log_softmax(logits, -1)
        onehot = torch.nn.functional.one_hot(b["labels"].long(),
                                             classes).float()
        return -torch.mean(torch.sum(onehot * logp, -1))
    return loss


SERVE_USERS = ["user000", "user004", "user003", "user007"]


def serve_inputs():
    """tests/test_mesh_parity.py's serving inputs: params (64, 64) + (64,)
    and one batch a user."""
    rng = np.random.RandomState(0)
    d = classes = 64
    params = {"w": (rng.randn(d, classes) * 0.1).astype(np.float32),
              "b": np.zeros((classes,), np.float32)}
    batches = {u: {"images": rng.randn(8, d).astype(np.float32),
                   "labels": rng.randint(0, classes, 8).astype(np.int32)}
               for u in SERVE_USERS}
    return params, batches


def _local_bytes(srv):
    """Bytes this rank holds of the ring's banks, its snapshots and the
    params (each DTensor's local piece)."""
    from repro_torch.sharding import ctx
    from repro_torch.tree import tree_leaves
    trees = [b.stacked for banks in srv.ring._banks.values() for b in banks]
    trees += list(srv.ring._snapshots.values()) + [srv.params]
    return sum(ctx.local(x).numel() * x.element_size()
               for t in trees for x in tree_leaves(t))


def parity(rank, world, out):
    """tests/test_mesh_parity.py's two contracts on 8 ranks: FLRun and
    PersonalizationServer over the 1-D, (8, 1) and (2, 4) meshes; plus the
    mesh cache, its validation and the use_mesh context."""
    from repro_torch.core import PersAFLConfig
    from repro_torch.data.federated import ClientData
    from repro_torch.fl import CohortEngine, DelayModel, FLRun, buffered
    from repro_torch.serving import PersonalizationServer
    from repro_torch.sharding import ctx
    from repro_torch.sharding.rules import NamedSharding, P
    init(rank, world, out)
    res = {}
    # -- the mesh cache and context
    ctx.reset_mesh_cache()
    m1 = ctx.cohort_mesh()
    res["memo_same"] = ctx.cohort_mesh() is m1
    res["memo_spellings"] = ctx.cohort_model_mesh(None) is m1
    res["cache_len"] = len(ctx._MESH_CACHE)
    ctx.reset_mesh_cache()
    res["cache_len_reset"] = len(ctx._MESH_CACHE)
    m1 = ctx.cohort_mesh()
    res["cache_len_rebuilt"] = len(ctx._MESH_CACHE)
    for bad in (world + 1, 0, 3):
        try:
            ctx.cohort_model_mesh(bad)
            res[f"validate_{bad}"] = None
        except ValueError as e:
            res[f"validate_{bad}"] = str(e)
    m81 = ctx.cohort_model_mesh(1)
    res["m81"] = (tuple(m81.mesh_dim_names), tuple(m81.shape),
                  ctx.cohort_axis_size(m81), ctx.cohort_model_mesh(1) is m81,
                  m81 is not m1)
    m24 = ctx.cohort_model_mesh(4)
    res["m24_cohort"] = ctx.cohort_axis_size(m24)
    res["active_before"] = ctx.active_mesh() is None
    with ctx.use_mesh(m24):
        eng = CohortEngine(quad_pcfg("A"), quad_loss,
                           cohort_impl="shard_map", device="cpu")
        res["use_mesh"] = (ctx.active_mesh() is m24, eng._mesh is m24,
                           eng._ndev)
    res["active_after"] = ctx.active_mesh() is None
    e1 = CohortEngine(quad_pcfg("A"), quad_loss, cohort_impl="shard_map",
                      device="cpu")
    e2 = CohortEngine(quad_pcfg("A"), quad_loss, cohort_impl="shard_map",
                      device="cpu")
    res["engines_share_mesh"] = e1._mesh is e2._mesh is m1

    # -- FLRun across layouts
    clients = [ClientData(train_x=x, train_y=y, test_x=x[:8], test_y=y[:8],
                          classes=(0, 1, 2, 3)) for x, y in flrun_clients()]
    pcfg = PersAFLConfig(option="A", q_local=2, eta=0.05)

    def drive(mesh, shardings=None):
        run = FLRun(clients=clients, loss_fn=softmax_loss(4),
                    init_params={"w": np.zeros((8, 4), np.float32)},
                    pcfg=pcfg, delays=DelayModel(6, seed=1),
                    strategy="persafl", schedule=buffered(2), batch_size=8,
                    seed=0, cohort_impl="shard_map", mesh=mesh,
                    param_shardings=shardings, device="cpu")
        hist = run.run(max_rounds=4)
        return {"w": _np(ctx.gather(run.params)["w"]),
                "staleness": list(hist.staleness),
                "times": list(hist.times), "rounds": list(hist.rounds),
                "active_times": list(hist.active_times),
                "active_ratio": list(hist.active_ratio),
                "end_time": hist.end_time,
                "t": int(run.state.t),
                "hm": run.engine.stats["host_materializations"],
                "placements": repr(run.params["w"].placements)
                if ctx.is_sharded(run.params["w"]) else None}

    res["flrun"] = {
        "1d": drive(m1), "81": drive(m81),
        "24": drive(m24, {"w": NamedSharding(m24, P(None, "model"))})}

    # -- the server across layouts
    np_params, batches = serve_inputs()
    spcfg = PersAFLConfig(option="C", eta=0.05, alpha=0.05, lam=20.0,
                          inner_steps=2, inner_eta=0.02)

    def serve(mesh, shardings, windows=4, **kw):
        srv = PersonalizationServer(np_params, softmax_loss(64), spcfg,
                                    windows=windows, cohort_impl="shard_map",
                                    mesh=mesh, param_shardings=shardings,
                                    device="cpu", **kw)
        heads = {}
        for _ in range(windows):        # fill the ring to steady state
            tickets = {u: srv.submit(u, batches[u], mode="C")
                       for u in SERVE_USERS}
            srv.flush()
            heads = {u: {k: _np(v) for k, v in srv.poll(t).items()}
                     for u, t in tickets.items()}
            srv.advance_window()
        return {"heads": heads,
                "clipped": srv.stats["ring_robust_clipped"],
                "windows": srv.stats["ring_windows"],
                "params": {k: _np(v) for k, v in
                           ctx.gather(srv.params).items()},
                "hm": srv.stats["host_materializations"],
                "shard_padding": srv.stats["batcher_shard_padding"],
                "bytes": _local_bytes(srv),
                "placements": repr(srv.params["w"].placements)
                if ctx.is_sharded(srv.params["w"]) else None}

    sh24 = {"w": NamedSharding(m24, P(None, "model")),
            "b": NamedSharding(m24, P("model"))}
    res["serve"] = {"1d": serve(m1, None), "24": serve(m24, sh24)}
    # int8 banking with error feedback, and the robust clip window, over
    # both layouts (2 windows: the ring demotes a snapshot, residuals carry)
    res["serve_int8"] = {
        "1d": serve(m1, None, windows=2, delta_dtype="int8"),
        "24": serve(m24, sh24, windows=2, delta_dtype="int8")}
    res["serve_clip"] = {
        "1d": serve(m1, None, windows=2, robust="clip", clip_norm=0.05),
        "24": serve(m24, sh24, windows=2, robust="clip", clip_norm=0.05)}
    return res


def cohort_step(rank, world, out):
    """``make_cohort_train_step`` at mamba2-130m's smoke config over a
    ``(world, 1)`` ("data", "model") mesh: each rank one client on its row
    of the batch (the inputs come from the test, ``inputs.pkl``)."""
    import os
    import pickle

    from repro_torch import configs
    from repro_torch.convert import params_from_jax, params_to_numpy
    from repro_torch.core import PersAFLConfig
    from repro_torch.launch import steps
    from repro_torch.sharding import ctx
    init(rank, world, out)
    with open(os.path.join(out, "inputs.pkl"), "rb") as f:
        inp = pickle.load(f)
    cfg = configs.reduce_for_smoke(configs.get_config(inp["arch"]))
    params = params_from_jax(inp["params"], device="cpu")
    mesh = ctx.device_mesh((world, 1), ("data", "model"))
    step = steps.make_cohort_train_step(cfg, PersAFLConfig(**inp["pcfg"]),
                                        mesh, 1)
    new, m = step(params, params, {k: torch.from_numpy(v)
                                   for k, v in inp["batch"].items()})
    return {"new": params_to_numpy(new),
            "metrics": {k: float(v) for k, v in m.items()}}


def one_rank(rank, world, out):
    """On one rank: ``launch/serve.py`` with the mesh and process-group
    flags (the group started and destroyed by ``serve.main``) against the
    same command without them; then, in a group of its own,
    ``make_cohort_train_step`` on ``make_host_mesh()`` against
    ``make_train_step`` at mamba2-130m's smoke config."""
    import socket

    import torch.distributed as dist

    from repro_torch import configs
    from repro_torch.core import PersAFLConfig
    from repro_torch.launch import mesh as lmesh
    from repro_torch.launch import serve, steps
    from repro_torch.models import api
    from repro_torch.tree import tree_leaves
    res = {}
    base = ["--arch", "mamba2-130m", "--smoke", "--personalize",
            "--requests", "3", "--tokens", "4", "--device", "cpu",
            "--out", out]
    plain = serve.main(base)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    meshed = serve.main(base + ["--model-axis", "1", "--coordinator",
                                f"127.0.0.1:{port}", "--num-processes", "1",
                                "--process-id", "0"])
    res["group_left"] = dist.is_initialized()
    for tag, run in (("plain", plain), ("mesh", meshed)):
        res[tag] = {"tokens": _np(run.out_tokens),
                    "heads": [_np(x) for x in tree_leaves(run.heads)],
                    "record": run.record,
                    "cohort_calls": run.server.stats["cohort_calls"],
                    "impl": run.server.engines["C"].cohort_impl}
    init(rank, world, out)
    cfg = configs.reduce_for_smoke(configs.get_config("mamba2-130m"))
    params = api.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    toks = torch.randint(0, cfg.vocab, (2, 16),
                         generator=torch.Generator().manual_seed(1),
                         dtype=torch.int32)
    batch = {"tokens": toks, "labels": toks}
    pcfg = PersAFLConfig(option="A", q_local=2, eta=0.01)
    p1, m1 = steps.make_train_step(cfg, pcfg, 1)(params, params, batch)
    p2, m2 = steps.make_cohort_train_step(cfg, pcfg, lmesh.make_host_mesh(),
                                          1)(params, params, batch)
    res["step_equal"] = all(torch.equal(a, b) for a, b in
                            zip(tree_leaves(p1), tree_leaves(p2)))
    res["metrics_equal"] = all(torch.equal(m1[k], m2[k]) for k in m1)
    res["step_moved"] = not all(torch.equal(a, b) for a, b in
                                zip(tree_leaves(p1), tree_leaves(params)))
    # the production meshes need their world size
    for multi in (False, True):
        try:
            lmesh.make_production_mesh(multi_pod=multi)
            res[f"production_{multi}"] = None
        except ValueError as e:
            res[f"production_{multi}"] = str(e)
    host = lmesh.make_host_mesh()
    res["host_mesh"] = (tuple(host.mesh_dim_names), tuple(host.shape),
                        lmesh.make_host_mesh() is host)
    return res
