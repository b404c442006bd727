"""Port of the tuner (``repro_torch.tune``) against ``repro.tune`` on the
same sweeps.

Equal, exactly: ``SweepSpec`` JSON, arm fingerprints and trial keys, the
parsed schedules, every stop rule's decision on the same traces, and the
journal rows of one sweep run by both runners on a tiny linear problem
(key, status, stop reason and rule, rounds, simulated time, eval times,
staleness, host materializations, run counters).  Floats: accuracy, a
fraction of the 8 test rows of each client, exactly; losses 1e-5 relative
(f32 softmax cross-entropy of the two packages after a few server rounds,
at most ~1e-6 apart here).  Reports built from the same trials are equal as
JSON and markdown, and the promoted winners byte for byte.
"""
import dataclasses
import json
import math
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.tune as jtune
from repro.core import PersAFLConfig as JConfig
from repro.data.federated import ClientData as JClientData
from repro.fl import scenario as jsc
from repro_torch.core import PersAFLConfig
from repro_torch.data.federated import ClientData
from repro_torch.fl import DelayModel, FLRun, buffered, immediate, strategy
from repro_torch.fl import api as tapi
from repro_torch.fl import scenario as tsc
from repro_torch.tune import (AccPlateau, AnyOf, Arm, LossSpike, MedianLoss,
                              SweepSpec, Trial, TuneRunner, default_rules,
                              make_report, parse_schedule, promote,
                              promote_winners, rule_from_dict, rule_to_dict,
                              rung_arms, to_markdown, trial_key)

ROOT = Path(__file__).resolve().parents[1]
LOSS_RTOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # the shapes are small: one intra-op thread runs them faster and leaves
    # the cores to the other test workers
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# a tiny linear problem in both packages (as the reference's tests/test_tune)
# ---------------------------------------------------------------------------

def _j_loss(p, b):
    logp = jax.nn.log_softmax(b["images"] @ p["w"])
    return -jnp.mean(jnp.sum(jax.nn.one_hot(b["labels"], 4) * logp, -1))


def _loss(p, b):
    logp = torch.log_softmax(b["images"] @ p["w"], -1)
    return -torch.mean(torch.gather(logp, -1, b["labels"].long()[..., None]))


def _clients(cls, n=6, d=5, seed=0):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        x = rng.randn(64, d).astype(np.float32)
        y = rng.randint(0, 4, 64).astype(np.int32)
        out.append(cls(train_x=x, train_y=y, test_x=x[:8], test_y=y[:8],
                       classes=(0, 1, 2, 3)))
    return out


PCFG = dict(option="A", q_local=2, eta=0.05, alpha=0.05, lam=20.0,
            inner_steps=3, inner_eta=0.02)


def _eval_fn(clients, to_array, loss):
    """Mean test accuracy and loss over the clients' test sets."""
    test = [{"images": c.test_x, "labels": c.test_y} for c in clients]

    def ev(params):
        w = np.asarray(params["w"])
        accs = [float(np.mean(np.argmax(b["images"] @ w, -1) == b["labels"]))
                for b in test]
        losses = [float(loss(params, {k: to_array(v) for k, v in b.items()}))
                  for b in test]
        return {"acc": float(np.mean(accs)), "loss": float(np.mean(losses))}
    return ev


def _problem(port: bool, eval_every=2):
    clients = _clients(ClientData if port else JClientData)
    prob = {"clients": clients,
            "loss_fn": _loss if port else _j_loss,
            "init_params": {"w": np.zeros((5, 4), np.float32)},
            "eval_fn": _eval_fn(clients, torch.as_tensor, _loss) if port
            else _eval_fn(clients, jnp.asarray, _j_loss),
            "pcfg": (PersAFLConfig if port else JConfig)(**PCFG),
            "batch_size": 8, "eval_every": eval_every}
    return lambda arm: prob


def _arm_kw(**kw):
    base = dict(strategy="persafl", strategy_kwargs={"option": "A"},
                schedule="immediate", seed=0, max_rounds=6, group="g")
    base.update(kw)
    return base


def _spec(mod):
    return mod.ScenarioSpec(n_clients=6, seed=2, dropout=0.2,
                            tiers=(mod.Tier("a", 0.5, 0.8),
                                   mod.Tier("b", 0.5, 1.4)))


def _sweep(mod, sweep_cls):
    return sweep_cls(
        strategies=({"name": "persafl", "option": "A"},
                    {"name": "fedprox", "mu": 0.1}),
        schedules=("immediate", "buffered(3, robust=clip)"),
        pcfg={"beta": 0.5}, pcfg_grid={"eta": [0.02, 0.05]},
        scenario=_spec(mod), seeds=(0, 3), group="mnist/grid")


# ---------------------------------------------------------------------------
# sweep space: JSON, fingerprints, trial keys, schedules
# ---------------------------------------------------------------------------

def test_sweepspec_json_fingerprints_and_trial_keys_equal_reference():
    js, ts = _sweep(jsc, jtune.SweepSpec), _sweep(tsc, SweepSpec)
    assert ts.to_json() == js.to_json()
    assert SweepSpec.from_json(js.to_json()) == ts
    jarms = js.arms(max_rounds=40, budget=120.0)
    tarms = ts.arms(max_rounds=40, budget=120.0)
    assert len(tarms) == len(jarms) == 16
    rules = (None, default_rules(), AnyOf((LossSpike(2.0),)))
    jrules = (None, jtune.default_rules(),
              jtune.AnyOf((jtune.LossSpike(2.0),)))
    for ja, ta in zip(jarms, tarms):
        assert ta.name == ja.name
        assert ta.to_dict() == ja.to_dict()
        assert ta.fingerprint() == ja.fingerprint()
        assert Arm.from_dict(ja.to_dict()) == ta
        for tr, jr in zip(rules, jrules):
            assert trial_key(ta, tr) == jtune.trial_key(ja, jr)
    assert len({a.fingerprint() for a in tarms}) == 16
    # re-budgeting re-fingerprints, as the reference's
    for ja, ta in zip(jtune.rung_arms(jarms[:3], 60.0, 10),
                      rung_arms(tarms[:3], 60.0, 10)):
        assert ta.fingerprint() == ja.fingerprint()
    ja, ta = jtune.Arm(**_arm_kw()), Arm(**_arm_kw())
    assert ta.fingerprint() == ja.fingerprint()
    with pytest.raises(ValueError):
        SweepSpec(strategies=())
    with pytest.raises(ValueError):
        Arm(**_arm_kw(strategy="bogus"))


SPELLINGS = ("immediate", "buffered(8)", " buffered( 4 , robust=clip ) ",
             "buffered(4, robust='trim', trim_frac=0.2)",
             "buffered(robust=\"clip\", clip_norm=1.5)", "buffered(None)",
             "sync(10)", "sync_barrier(3)")


@pytest.mark.parametrize("spelling", SPELLINGS)
def test_parse_schedule_spellings_match_reference(spelling):
    want, got = jtune.parse_schedule(spelling), parse_schedule(spelling)
    assert type(got).__name__ == type(want).__name__
    assert got.kind == want.kind
    for attr in ("m", "robust", "clip_norm", "trim_frac"):
        assert getattr(got, attr, None) == getattr(want, attr, None), attr
    assert isinstance(got, tapi.ApplyPolicy)
    assert parse_schedule(spelling) is not got     # a fresh policy per call


@pytest.mark.parametrize("bad", ["", "bogus(3)", "buffered(4", "9lives"])
def test_parse_schedule_refusals_match_reference(bad):
    with pytest.raises(ValueError) as want:
        jtune.parse_schedule(bad)
    with pytest.raises(ValueError) as got:
        parse_schedule(bad)
    assert str(got.value) == str(want.value)


# ---------------------------------------------------------------------------
# stop rules on the same traces
# ---------------------------------------------------------------------------

TRACES = {
    "empty": ([], []),
    "nan": ([0.1, 0.2], [1.0, float("nan")]),
    "spike": ([0.3, 0.4, 0.4], [1.0, 0.9, 3.5]),
    "creep": ([0.5] * 10, [1.0, 0.8, 0.7, 0.6, 0.6, 0.6, 0.6, 0.6, 0.65,
                           0.9]),
    "noise": ([0.5] * 10, [1.0, 0.8, 0.82, 0.79, 0.81, 0.8, 0.78, 0.8, 0.8,
                           0.84]),
    "plateau": ([0.2, 0.5, 0.6, 0.6, 0.6, 0.601, 0.6, 0.6, 0.599],
                [1.0] * 9),
    "improver": ([0.05 * i for i in range(12)],
                 [2.0 / (1 + i) for i in range(12)]),
    "nan_acc": ([float("nan")] * 7, [float("nan")] * 7),
}
RULES = {
    "median": (MedianLoss(), jtune.MedianLoss()),
    "median_tight": (MedianLoss(window=3, factor=1.05, warmup=2),
                     jtune.MedianLoss(window=3, factor=1.05, warmup=2)),
    "spike": (LossSpike(), jtune.LossSpike()),
    "spike_warm": (LossSpike(factor=1.5, warmup=3),
                   jtune.LossSpike(factor=1.5, warmup=3)),
    "plateau": (AccPlateau(), jtune.AccPlateau()),
    "plateau_short": (AccPlateau(patience=2, min_delta=0.01),
                      jtune.AccPlateau(patience=2, min_delta=0.01)),
    "default": (default_rules(), jtune.default_rules()),
    "default_warm1": (default_rules(warmup=1), jtune.default_rules(warmup=1)),
}


@pytest.mark.parametrize("rule", sorted(RULES))
def test_stop_rules_decide_as_reference(rule):
    """Every rule gives the reference's decision, reason string included,
    on every prefix of every trace."""
    tr, jr = RULES[rule]
    assert rule_to_dict(tr) == jtune.rule_to_dict(jr)
    assert rule_from_dict(jtune.rule_to_dict(jr)) == tr
    fired = 0
    for acc, loss in TRACES.values():
        for end in range(len(acc) + 1):
            trace = SimpleNamespace(acc=acc[:end], loss=loss[:end])
            got = tr.check(trace)
            assert got == jr.check(trace)
            fired += got is not None
    assert fired > 0


def test_stop_rule_refusal():
    with pytest.raises(ValueError, match="unknown stop rule"):
        rule_from_dict({"kind": "bogus"})
    assert rule_to_dict(None) is None and rule_from_dict(None) is None


# ---------------------------------------------------------------------------
# the runner: one sweep through both packages
# ---------------------------------------------------------------------------

SWEEP_ARMS = (
    _arm_kw(),
    _arm_kw(strategy="fedprox", strategy_kwargs={"mu": 0.1},
            schedule="buffered(3)", max_rounds=9),
    _arm_kw(pcfg={"eta": 50.0}, max_rounds=30),          # diverges: stops
    _arm_kw(schedule="buffered(2, robust=clip)", max_rounds=8,
            budget=25.0, seed=1),
)
SWEEP_ARMS_SCENARIO = _arm_kw(schedule="buffered(2)", max_rounds=6)


def _run_sweep(port: bool, journal):
    if port:
        mod, arm_cls = tsc, Arm
        runner = TuneRunner(_problem(True, eval_every=1), journal=journal,
                            stop_rule=default_rules(warmup=1), device="cpu")
    else:
        mod, arm_cls = jsc, jtune.Arm
        runner = jtune.TuneRunner(_problem(False, eval_every=1),
                                  journal=journal,
                                  stop_rule=jtune.default_rules(warmup=1))
    arms = [arm_cls(**kw) for kw in SWEEP_ARMS]
    arms.append(arm_cls(scenario=_spec(mod), **SWEEP_ARMS_SCENARIO))
    return arms, runner.run_sweep(arms)


@pytest.fixture(scope="module")
def sweeps(tmp_path_factory):
    d = tmp_path_factory.mktemp("sweeps")
    return {port: (str(d / f"{port}.jsonl"), *_run_sweep(
        port, str(d / f"{port}.jsonl"))) for port in (True, False)}


def test_sweep_journal_rows_equal_reference(sweeps):
    _, _, got = sweeps[True]
    _, _, want = sweeps[False]
    assert [t.status for t in got] == [t.status for t in want]
    assert "stopped" in [t.status for t in got]
    assert "completed" in [t.status for t in got]
    for g, w in zip(got, want):
        gd, wd = g.to_dict(), w.to_dict()
        assert gd.keys() == wd.keys()
        for key in gd:
            if key == "wall_s":
                continue
            if key in ("loss", "final_loss"):
                np.testing.assert_allclose(gd[key], wd[key],
                                           rtol=LOSS_RTOL)
            else:
                assert gd[key] == wd[key], key
        assert g.params_finite == w.params_finite
    assert got[3].sim_time <= 25.0
    assert got[4].stats["windows"] > 0 and "dropouts" in got[4].stats


def test_sweep_resumes_by_fingerprint_skip(sweeps):
    """A fresh runner over the journal executes nothing: the problem
    factory raising proves resume never rebuilds a run."""
    journal, arms, first = sweeps[True]

    def exploding_problem(arm):
        raise AssertionError("resumed trial must not re-execute")

    again = TuneRunner(exploding_problem, journal=journal,
                       stop_rule=default_rules(warmup=1),
                       device="cpu").run_sweep(arms)
    assert all(t.resumed for t in again)
    assert [dataclasses.replace(t, resumed=False) for t in again] == first
    rows = Path(journal).read_text().splitlines()
    assert [Trial.from_dict(json.loads(r)) for r in rows] == first
    # the reference's runner reads the port's journal and skips it too
    jagain = jtune.TuneRunner(exploding_problem, journal=journal,
                              stop_rule=jtune.default_rules(warmup=1))
    assert set(jagain.completed_keys) == {t.key for t in first}


def test_report_and_winners_equal_reference(sweeps, tmp_path):
    """The report of the same trials, built by each package, is the same
    JSON and markdown, and the promoted winners the same file."""
    _, _, trials = sweeps[True]
    jtrials = [jtune.Trial.from_dict(json.loads(json.dumps(t.to_dict())))
               for t in trials]
    for group in (None, lambda t: t.arm.schedule):
        rep = make_report(trials, group=group)
        jrep = jtune.make_report(jtrials, group=group)
        assert json.dumps(rep, sort_keys=True) \
            == json.dumps(jrep, sort_keys=True)
        assert to_markdown(rep) == jtune.to_markdown(jrep)
    rep = make_report(trials)
    assert rep["n_stopped"] >= 1
    blob = promote_winners(rep, str(tmp_path / "t" / "w.json"),
                           extra={"note": "t"})
    jblob = jtune.promote_winners(jtune.make_report(jtrials),
                                  str(tmp_path / "j" / "w.json"),
                                  extra={"note": "t"})
    assert blob == jblob
    assert (tmp_path / "t" / "w.json").read_bytes() \
        == (tmp_path / "j" / "w.json").read_bytes()


def test_promote_matches_reference():
    scores = [0.1, float("nan"), 0.9, 0.5, 0.9]
    arms = [Arm(**_arm_kw(seed=s)) for s in range(5)]
    jarms = [jtune.Arm(**_arm_kw(seed=s)) for s in range(5)]
    for eta in (1.0, 2.0, 3.0):
        got = promote(list(zip(arms, scores)), eta=eta)
        want = jtune.promote(list(zip(jarms, scores)), eta=eta)
        assert [a.fingerprint() for a in got] \
            == [a.fingerprint() for a in want]
    assert promote([]) == [] and promote([(arms[0], math.nan)]) == arms[:1]


def test_fig2_winners_recipe_loads():
    """The promoted recipes of ``examples/tuned/fig2_winners.json`` load
    through the port: strategies, schedules and arms, with the reference's
    fingerprints."""
    blob = json.loads((ROOT / "examples" / "tuned" / "fig2_winners.json")
                      .read_text())
    assert blob["winners"]
    for group, win in sorted(blob["winners"].items()):
        strategy(win["strategy"], **win["strategy_kwargs"])
        assert isinstance(parse_schedule(win["schedule"]), tapi.ApplyPolicy)
        kw = dict(strategy=win["strategy"],
                  strategy_kwargs=win["strategy_kwargs"],
                  schedule=win["schedule"], seed=win["seed"], group=group)
        arm = Arm(**kw)
        assert arm.name == win["arm"]
        assert arm.fingerprint() == jtune.Arm(**kw).fingerprint()


# ---------------------------------------------------------------------------
# paired streams: the contract the tuner's comparisons rely on
# ---------------------------------------------------------------------------

class _RecordingDelays(DelayModel):
    """DelayModel that logs every realized draw."""

    def __post_init__(self):
        super().__post_init__()
        self.log = []

    def sample_download(self, i, t=0.0):
        v = super().sample_download(i, t)
        self.log.append(("down", int(i), float(v)))
        return v

    def sample_upload(self, i, t=0.0):
        v = super().sample_upload(i, t)
        self.log.append(("up", int(i), float(v)))
        return v


@pytest.mark.parametrize("schedule_mk", [immediate, lambda: buffered(3)])
def test_paired_streams_bit_identical_across_strategies(schedule_mk):
    """Two runs with different strategies (stateless and stateful) on one
    delay seed see bit-identical draws, apply times and staleness."""
    clients = _clients(ClientData)
    logs, timelines, staleness = [], [], []
    for strat in ("persafl", "scaffold"):
        delays = _RecordingDelays(len(clients), seed=7)
        run = FLRun(clients=clients, loss_fn=_loss,
                    init_params={"w": np.zeros((5, 4), np.float32)},
                    pcfg=PersAFLConfig(**PCFG), delays=delays,
                    strategy=strat, schedule=schedule_mk(), batch_size=8,
                    seed=0, device="cpu")
        hist = run.run(max_rounds=9)
        logs.append(delays.log)
        timelines.append([(w["window"], w["time"]) for w in run.window_log])
        staleness.append(hist.staleness)
    assert logs[0] == logs[1] and len(logs[0]) > 0
    assert timelines[0] == timelines[1]
    assert staleness[0] == staleness[1]


def test_runner_raises_without_a_gpu_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TuneRunner(_problem(True)).run_arm(Arm(**_arm_kw()))
