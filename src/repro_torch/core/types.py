"""PersA-FL typed containers: the hyper-parameter config (Algorithms 1 & 2)
and the server state (Algorithm 1's (w, t) + Assumption 1's staleness
accounting), as in ``src/repro/core/types.py``."""
from __future__ import annotations

import dataclasses
from typing import Any


@dataclasses.dataclass(frozen=True)
class PersAFLConfig:
    """Hyper-parameters of Algorithms 1 & 2.

    option: "A" (FedAsync), "B" (PersA-FL-MAML), "C" (PersA-FL-ME).
    """
    option: str = "A"
    q_local: int = 10          # Q local steps (paper §5 uses Q=10)
    eta: float = 0.01          # local stepsize η (paper Appendix D)
    beta: float = 1.0          # server stepsize β (Theorems use β=1)

    # Option B (MAML)
    alpha: float = 0.01        # personalization stepsize α
    maml_mode: str = "full"    # full | fo | hf
    hf_delta: float = 1e-2     # finite-difference δ (paper Eq. D1)

    # Option C (Moreau envelope)
    lam: float = 30.0          # λ regularization (paper picks from {20,25,30})
    inner_steps: int = 10      # K inner SGD steps for θ̃ (paper Appendix D)
    inner_eta: float = 0.03    # inner solver stepsize
    nu_target: float = 1e-3    # ν accuracy target (reported, not enforced)

    # beyond-paper: buffered server aggregation (FedBuff) — M deltas are
    # summed and applied as one w ← w − β/M ΣΔ server round
    buffer_size: int = 1
    # beyond-paper: FedAsync-style polynomial staleness damping a in
    # β/(1+τ)^a on async applies; 0 = paper-faithful constant β
    staleness_damping: float = 0.0
    # delta accumulator dtype ("float32" faithful; "bfloat16" halves the
    # client-delta memory)
    delta_dtype: str = "float32"

    def personalize_budget(self) -> str:
        return {"A": "none", "B": f"1 SGD step @ alpha={self.alpha}",
                "C": f"{self.inner_steps} prox steps @ lambda={self.lam}"}[
                    self.option]


@dataclasses.dataclass
class ServerState:
    """Algorithm 1's server state.

    ``params`` (w) is a tree of tensors on the run's device.  The version
    counter ``t`` (int32) and the staleness accounting Σ τ (float32) and
    max τ (int32) are numpy scalars on the host: every apply updates them
    with the reference's dtypes and never touches the device for them.
    """
    params: Any
    t: Any
    staleness_sum: Any
    staleness_max: Any

    def __getitem__(self, key: str):
        return getattr(self, key)

    def keys(self):
        return (f.name for f in dataclasses.fields(self))

    def as_dict(self) -> dict:
        """Shallow field dict (leaves not copied) — checkpoint layout."""
        return {f.name: getattr(self, f.name)
                for f in dataclasses.fields(self)}

    @classmethod
    def from_dict(cls, d) -> "ServerState":
        return cls(**{f.name: d[f.name] for f in dataclasses.fields(cls)})

    def replace(self, **kw) -> "ServerState":
        return dataclasses.replace(self, **kw)
