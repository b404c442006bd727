"""Port of the scenario engine (``repro_torch.fl.scenario`` and the churn
hooks of ``repro_torch.fl.delays``) against ``repro.fl.scenario`` on the
same inputs; ``FLRun``'s scheduler and corruption paths are in
``tests/test_torch_scenario_flrun.py``.

Everything numpy or integer must be equal: hash draws (numpy, ``jnp`` and
the torch twins), spec JSON, ``ChurnModel`` fields, event streams, cohort
ids and scheduler counters.  Floats: the device scheduler's f32 arrival
times bit-equal to the JAX scheduler's without a diurnal curve (both fuse
the same multiply-adds); with one, the two sines differ by an ulp now and
then, and the times are held at rel 1e-4, as the reference's own test
holds them against the float64 stream (the largest difference seen here
is under 1e-6).
"""
import heapq
import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.fl import delays as jdelays
from repro.fl import scenario as jsc
from repro_torch.fl import (Adversarial, ChurnModel, DelayModel,
                            DeviceScheduler, EventStream, ScenarioSpec)
from repro_torch.fl import delays as tdelays
from repro_torch.fl import scenario as tsc
from repro_torch.fl.scenario import KIND_DOWN, KIND_UP
from repro_torch.fl.scenario.sched import heap_events

DIURNAL_RTOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # the shapes are small: one intra-op thread runs them faster and leaves
    # the cores to the other test workers
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _spec_kw(n, seed=3, diurnal=True, dropout=0.15, adversarial=None):
    """A churn spec for either package, made by ``build(mod)`` with
    ``mod`` ``repro.fl.scenario`` or ``repro_torch.fl.scenario``."""
    def build(mod):
        return mod.ScenarioSpec(
            n_clients=n, seed=seed,
            tiers=(mod.Tier("fast", 0.5, 0.7), mod.Tier("slow", 0.5, 1.6)),
            diurnal=mod.Diurnal(period=40.0, floor=0.3) if diurnal
            else None,
            dropout=dropout,
            adversarial=None if adversarial is None
            else mod.Adversarial(*adversarial))
    return build


def _both(build):
    return build(jsc), build(tsc)


# ---------------------------------------------------------------------------
# counter-based hash streams
# ---------------------------------------------------------------------------

IDS = np.concatenate([np.arange(257),
                      [2 ** 31 - 1, 2 ** 31, 2 ** 32 - 2, 2 ** 32 - 1]])


@pytest.mark.parametrize("counter", [0, 1000, 2 ** 31, 2 ** 32 - 1])
def test_torch_hash_bit_equal_to_numpy_and_jnp(counter):
    """The torch twins give the numpy and ``jnp`` hashes' bits for ids and
    counters across the whole uint32 range, also with a per-client counter
    tensor and a precomputed client word."""
    ids32 = IDS.astype(np.uint32)
    for seed in (7, 2 ** 40 + 3):
        for tag in (1, 5, 8):
            h_np = tdelays.hash_u32(seed, IDS, counter, tag)
            np.testing.assert_array_equal(
                h_np, jdelays.hash_u32(seed, IDS, counter, tag))
            np.testing.assert_array_equal(h_np, np.asarray(jdelays.hash_u32(
                seed, jnp.asarray(ids32), np.uint32(counter), tag, jnp)))
            h_t = tdelays.hash_u32_torch(seed, torch.tensor(IDS), counter,
                                         tag)
            assert h_t.dtype == torch.int64
            np.testing.assert_array_equal(h_t.numpy(),
                                          h_np.astype(np.int64))
            k = torch.full((len(IDS),), counter, dtype=torch.int64)
            cw = tdelays.client_word_torch(seed, torch.tensor(IDS))
            u_t = tdelays.hash_u01_torch(seed, None, k, tag, client_word=cw)
            assert u_t.dtype == torch.float32
            u_np = tdelays.hash_u01(seed, IDS, counter, tag)
            np.testing.assert_array_equal(u_t.numpy(),
                                          u_np.astype(np.float32))
            np.testing.assert_array_equal(u_t.numpy(), np.asarray(
                jdelays.hash_u01(seed, jnp.asarray(ids32),
                                 np.uint32(counter), tag, jnp)))


def test_tags_match_reference():
    for name in ("TAG_DOWN", "TAG_UP", "TAG_MEAN", "TAG_FACTOR", "TAG_DROP",
                 "TAG_TIER", "TAG_PHASE", "TAG_ADV"):
        assert getattr(tdelays, name) == getattr(jdelays, name), name


# ---------------------------------------------------------------------------
# ScenarioSpec and ChurnModel
# ---------------------------------------------------------------------------

SPECS = {
    "default": lambda mod: mod.ScenarioSpec(n_clients=40),
    "churn": _spec_kw(400, adversarial=(0.1, ("scale", "sign_flip"), 50.0)),
    "nan": _spec_kw(400, seed=5, diurnal=False, dropout=0.0,
                    adversarial=(0.25, ("nan",), 50.0)),
    "scale_row": lambda mod: mod.ScenarioSpec(
        n_clients=1000, seed=0,
        tiers=(mod.Tier("fast", 0.5, 0.7), mod.Tier("slow", 0.5, 1.6)),
        diurnal=mod.Diurnal(period=400.0, floor=0.25), dropout=0.02,
        adversarial=mod.Adversarial(frac=0.05,
                                    kinds=("scale", "sign_flip")),
        scale=1.5, jitter=(0.25, 1.75)),
}


@pytest.mark.parametrize("name", sorted(SPECS))
def test_spec_json_equal_to_reference(name):
    """``to_json`` is the reference's string byte for byte (tuner
    fingerprints hash it), and both packages read each other's JSON."""
    jspec, tspec = _both(SPECS[name])
    assert tspec.to_json() == jspec.to_json()
    assert ScenarioSpec.from_json(jspec.to_json()) == tspec
    assert jsc.ScenarioSpec.from_json(tspec.to_json()) == jspec


@pytest.mark.parametrize("bad", [
    dict(n_clients=0), dict(dropout=1.0), dict(tiers=()),
    dict(diurnal=("d", 0.0)), dict(adversarial=("a", 1.0)),
    dict(adversarial=("k", "bogus"))])
def test_spec_validation_matches_reference(bad):
    def build(mod):
        kw = dict(n_clients=4)
        kw.update(bad)
        if "diurnal" in kw:
            kw["diurnal"] = mod.Diurnal(period=10.0, floor=kw["diurnal"][1])
        if "adversarial" in kw:
            what, val = kw["adversarial"]
            kw["adversarial"] = mod.Adversarial(frac=val) if what == "a" \
                else mod.Adversarial(frac=0.1, kinds=(val,))
        return mod.ScenarioSpec(**kw)
    with pytest.raises(ValueError) as want:
        build(jsc)
    with pytest.raises(ValueError) as got:
        build(tsc)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("name", sorted(SPECS))
def test_churn_model_bit_equal_to_reference(name):
    jspec, tspec = _both(SPECS[name])
    jm, tm = jspec.build(), tspec.build()
    assert isinstance(tm, ChurnModel) and isinstance(tm, DelayModel)
    n = tm.n_clients
    ids = np.arange(n)
    for field in ("mean_down", "up_factor", "tier_index", "tier_mult",
                  "phase", "adversary_ids"):
        np.testing.assert_array_equal(getattr(tm, field),
                                      getattr(jm, field), err_msg=field)
    fj, ft = jm.corruption_factors(ids), tm.corruption_factors(ids)
    assert (fj is None) == (ft is None)
    if ft is not None:
        assert ft.dtype == np.float32
        np.testing.assert_array_equal(ft, fj)
    for t in (0.0, 13.7, 1234.5):
        np.testing.assert_array_equal(np.asarray(tm.availability(ids, t)),
                                      np.asarray(jm.availability(ids, t)))
    for k in (0, 3, 77):
        np.testing.assert_array_equal(tm.drops_at(ids, k),
                                      jm.drops_at(ids, k))
        np.testing.assert_array_equal(tm.download_delay(ids, k, 9.25),
                                      jm.download_delay(ids, k, 9.25))
        np.testing.assert_array_equal(tm.upload_delay(ids, k, 9.25),
                                      jm.upload_delay(ids, k, 9.25))
    assert ChurnModel.from_spec(tspec).n_clients == n


# ---------------------------------------------------------------------------
# EventStream
# ---------------------------------------------------------------------------

def _heap_oracle(model, n_events):
    """The per-event heap under the (time, client, kind) total order, the
    loop ``repro_torch.fl.scenario.sched.heap_events`` runs."""
    heap = []
    for i in range(model.n_clients):
        heapq.heappush(heap, (model.sample_download(i, 0.0), i, KIND_DOWN))
    out = []
    while len(out) < n_events:
        now, i, kind = heapq.heappop(heap)
        if kind == KIND_DOWN:
            dropped = model.drops(i)
            t_up = now + model.sample_upload(i, now)
            if dropped:
                heapq.heappush(heap, (t_up + model.sample_download(i, t_up),
                                      i, KIND_DOWN))
            else:
                heapq.heappush(heap, (t_up, i, KIND_UP))
            out.append((now, i, KIND_DOWN, dropped, t_up))
        else:
            heapq.heappush(heap, (now + model.sample_download(i, now), i,
                                  KIND_DOWN))
            out.append((now, i, KIND_UP, False, now))
    return out


@pytest.mark.parametrize("dropout", [0.0, 0.2])
def test_eventstream_bit_equal_to_reference_and_heap(dropout):
    """The first 5,000 events: the port's stream equals the JAX stream, a
    heap oracle and the port's heap (``heap_events``), tuple for tuple."""
    build = _spec_kw(150, dropout=dropout,
                     adversarial=(0.2, ("scale", "sign_flip"), 50.0))
    jspec, tspec = _both(build)
    want = jsc.EventStream(jspec.build(), chunk=3).events()
    got = EventStream(tspec.build(), chunk=3).events()
    evs = [next(got) for _ in range(5000)]
    assert evs == [next(want) for _ in range(5000)]
    assert evs == _heap_oracle(tspec.build(), 5000)
    assert evs == list(itertools.islice(
        heap_events(tspec.build(), tspec.n_clients), 5000))
    assert (sum(e[3] for e in evs) > 0) == (dropout > 0)
    with pytest.raises(ValueError):
        EventStream(tspec.build(), chunk=0)


# ---------------------------------------------------------------------------
# DeviceScheduler
# ---------------------------------------------------------------------------

def _schedulers(build, **kw):
    jspec, tspec = _both(build)
    return (jsc.DeviceScheduler.from_spec(jspec, **kw),
            DeviceScheduler.from_spec(tspec, device="cpu", **kw))


@pytest.mark.parametrize("diurnal", [False, True])
def test_device_scheduler_matches_reference(diurnal):
    """Cohort ids, stats and the window log exactly; arrival times and the
    clients' state bit-equal without a diurnal curve, within DIURNAL_RTOL
    with one."""
    a, b = _schedulers(_spec_kw(2000, diurnal=diurnal,
                                adversarial=(0.05, ("scale",), 50.0)),
                       window_len=10.0, cohort_cap=50)
    assert a.cohort_cap == b.cohort_cap == 64
    for _ in range(5):
        ia, ta = a.next_window()
        ib, tb = b.next_window()
        np.testing.assert_array_equal(ib, ia)
        assert tb.dtype == np.float32 and ib.dtype == np.int32
        if diurnal:
            np.testing.assert_allclose(tb, ta, rtol=DIURNAL_RTOL, atol=0)
        else:
            np.testing.assert_array_equal(tb, ta)
    assert b.stats == a.stats
    assert b.window_log == a.window_log
    assert b.stats["overflow_arrivals"] > 0 and b.stats["dropouts"] > 0
    np.testing.assert_array_equal(b._k.numpy(), np.asarray(a._k))
    if not diurnal:
        np.testing.assert_array_equal(b._t.numpy(), np.asarray(a._t))
    assert b._t.dtype == torch.float32 and b._k.dtype == torch.int32


def test_device_scheduler_breaks_ties_as_top_k():
    """Every client has the same delays (one mean, no jitter): all arrive
    at once, and the cap keeps the lowest ids, as ``lax.top_k`` does."""
    def build(mod):
        return mod.ScenarioSpec(n_clients=300, seed=1, down_range=(2.0, 2.0),
                                up_factor_range=(5.0, 5.0),
                                jitter=(1.0, 1.0))
    a, b = _schedulers(build, window_len=13.0, cohort_cap=64)
    for _ in range(3):
        ia, ta = a.next_window()
        ib, tb = b.next_window()
        np.testing.assert_array_equal(ib, ia)
        np.testing.assert_array_equal(tb, ta)
    np.testing.assert_array_equal(ib, np.arange(64))
    assert b.stats == a.stats and b.stats["overflow_arrivals"] > 0


def test_device_scheduler_matches_eventstream_oracle():
    """First-window cohort = the clients whose first non-dropped upload
    lands inside the window, times f32-close to the float64 stream."""
    spec = ScenarioSpec(n_clients=64, seed=4, dropout=0.1)
    window = 60.0
    sched = DeviceScheduler.from_spec(spec, window_len=window,
                                      cohort_cap=64, cycles_per_window=8,
                                      device="cpu")
    ids, times = sched.next_window()
    first = {}
    for t, i, kind, _, _ in EventStream(spec.build()).events():
        if t >= window:
            break
        if kind == KIND_UP and i not in first:
            first[i] = t
    # boundary completions (f32 against f64 at the window's edge) excluded
    certain = [(i, t) for i, t in first.items() if abs(t - window) > 1e-3]
    got = dict(zip(ids.tolist(), times.tolist()))
    assert len(certain) > 10
    for i, t in certain:
        assert i in got, (i, t)
        assert got[i] == pytest.approx(t, rel=1e-4)


def test_device_scheduler_surface():
    spec = ScenarioSpec(n_clients=256, seed=7, dropout=0.3)
    with pytest.raises(ValueError):
        DeviceScheduler.from_spec(spec, window_len=0.0, device="cpu")
    sched = DeviceScheduler.from_spec(spec, window_len=100.0, cohort_cap=16,
                                      device="cpu", window_log_cap=1)
    ids, _ = sched.next_window()
    sched.next_window()
    st = sched.stats
    assert len(ids) <= 16 and st["arrivals"] > 16 and st["dropouts"] > 0
    assert st["overflow_arrivals"] == st["arrivals"] - st["cohort_fill_sum"]
    assert len(sched.window_log) == 1 and sched.window_log[0]["window"] == 1
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            DeviceScheduler.from_spec(spec, window_len=1.0)


def test_removed_simulator_names_raise_with_their_replacement():
    import repro_torch.fl as fl
    from repro_torch.fl import simulator
    for name in ("AsyncSimulator", "BufferedAsyncSimulator",
                 "SyncSimulator"):
        with pytest.raises(ImportError, match=r"FLRun\(\.\.\., "):
            getattr(fl, name)
        with pytest.raises(ImportError, match="repro_torch.fl.api"):
            getattr(simulator, name)
    with pytest.raises(AttributeError):
        fl.bogus  # noqa: B018
