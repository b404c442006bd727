"""Fig2-style sweep report (as in ``src/repro/tune/report.py``): accuracy at
equal simulated time, staleness,
server rounds and host traffic per arm, grouped (typically per dataset ×
grid), with the winning configuration per group — emitted as JSON and as
a markdown table, and promotable into ``examples/`` as plain config
records a script can re-run.

Winner selection is deterministic: best final accuracy, ties broken by
less simulated time consumed (a stopped arm that matched the leader did
it cheaper), then arm name.  Arms whose accuracy is NaN (diverged, or
never evaluated) can never win.
"""
from __future__ import annotations

import json
import math
import os
from typing import Callable, Dict, List, Optional, Sequence

from repro_torch.tune.runner import Trial

_COLS = ("arm", "status", "final_acc", "sim_time", "rounds",
         "staleness_mean", "staleness_max", "host_mat", "stop_reason")


def _row(t: Trial) -> Dict:
    return {
        "arm": t.arm.name,
        "strategy": t.arm.strategy,
        "strategy_kwargs": dict(t.arm.strategy_kwargs),
        "schedule": t.arm.schedule,
        "seed": t.arm.seed,
        "status": t.status + (" (resumed)" if t.resumed else ""),
        "stop_reason": t.stop_reason,
        "final_acc": t.final_acc,
        "final_loss": t.final_loss,
        "sim_time": t.sim_time,
        "budget": t.arm.budget,
        "rounds": t.rounds,
        "staleness_mean": t.staleness_mean,
        "staleness_max": t.staleness_max,
        "host_mat": t.host_materializations,
        "params_finite": t.params_finite,
        "wall_s": t.wall_s,
    }


def _winner_key(t: Trial):
    acc = t.final_acc
    finite = isinstance(acc, (int, float)) and math.isfinite(acc)
    return (-(acc if finite else float("-inf")), t.sim_time, t.arm.name)


def make_report(trials: Sequence[Trial], *,
                group: Optional[Callable[[Trial], str]] = None) -> Dict:
    """Group trials (default: by ``arm.group``) into table rows + a
    winner per group, plus sweep-level cost accounting: total simulated
    time consumed vs the total budget an exhaustive pass would have
    spent (``cost_fraction`` is the self-stopping saving)."""
    group = group or (lambda t: t.arm.group)
    groups: Dict[str, Dict] = {}
    for t in trials:
        groups.setdefault(group(t), {"trials": []})["trials"].append(t)
    out_groups = {}
    for gname, g in sorted(groups.items()):
        ts: List[Trial] = g["trials"]
        win = min(ts, key=_winner_key)
        budget_total = sum(t.arm.budget if t.arm.budget is not None
                           else t.sim_time for t in ts)
        spent = sum(t.sim_time for t in ts)
        out_groups[gname] = {
            "rows": [_row(t) for t in ts],
            "winner": _row(win),
            "n_arms": len(ts),
            "n_stopped": sum(1 for t in ts if t.status == "stopped"),
            "n_resumed": sum(1 for t in ts if t.resumed),
            "sim_time_spent": spent,
            "sim_time_budget": budget_total,
            "cost_fraction": spent / budget_total if budget_total else 1.0,
        }
    return {"groups": out_groups,
            "n_trials": len(trials),
            "n_stopped": sum(1 for t in trials if t.status == "stopped"),
            "n_resumed": sum(1 for t in trials if t.resumed)}


def to_markdown(report: Dict, title: str = "Sweep report") -> str:
    """Render the report as fig2-style markdown tables, one per group."""
    lines = [f"# {title}", ""]
    for gname, g in report["groups"].items():
        lines += [f"## {gname}", ""]
        lines.append(
            f"{g['n_arms']} arms, {g['n_stopped']} stopped early, "
            f"{g['n_resumed']} resumed from journal; simulated time spent "
            f"{g['sim_time_spent']:.0f}s of {g['sim_time_budget']:.0f}s "
            f"budget ({100 * g['cost_fraction']:.0f}%).")
        lines += ["", "| " + " | ".join(_COLS) + " |",
                  "|" + "---|" * len(_COLS)]
        for r in g["rows"]:
            win = " **(winner)**" if r["arm"] == g["winner"]["arm"] \
                and r["schedule"] == g["winner"]["schedule"] else ""
            lines.append(
                "| " + " | ".join([
                    r["arm"] + win, r["status"],
                    f"{r['final_acc']:.3f}",
                    f"{r['sim_time']:.0f}", str(r["rounds"]),
                    f"{r['staleness_mean']:.2f}",
                    str(r["staleness_max"]), str(r["host_mat"]),
                    (r["stop_reason"] or "—").split(":")[0],
                ]) + " |")
        lines.append("")
    return "\n".join(lines)


def promote_winners(report: Dict, path: str, *,
                    extra: Optional[Dict] = None) -> Dict:
    """Write the per-group winning configurations (strategy, kwargs,
    schedule, seed + scores) as JSON at ``path`` — the record
    ``examples/run_tuned.py`` replays."""
    winners = {g: {k: v for k, v in info["winner"].items()
                   if k in ("arm", "strategy", "strategy_kwargs",
                            "schedule", "seed", "final_acc", "sim_time",
                            "rounds")}
               for g, info in report["groups"].items()}
    blob = {"winners": winners, **(extra or {})}
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        json.dump(blob, f, indent=2, sort_keys=True)
    return blob
