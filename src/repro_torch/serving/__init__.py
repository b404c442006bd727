"""Live-traffic serving of personalized heads, as in ``src/repro/serving``.

Batcher **modes** are the paper's personalization options:

  * mode ``"B"`` -- Option B / Per-FedAvg: one-step MAML fine-tune,
    ``head_i = w − α ∇f_i(w; D_i)``;
  * mode ``"C"`` -- Option C / pFedMe: Moreau-envelope prox solve,
    ``head_i = θ̃_i(w) ≈ argmin_θ f_i(θ) + λ/2‖θ − w‖²`` by K inner steps.

Both compose with ``personal_subset`` (only a subset of the params is
personalized and banked) and with ``delta_dtype="int8"`` (quantized
banking with per-user error feedback, window applies through the
``apply_rows_q`` kernel).

Parts: :mod:`repro_torch.serving.batcher` (request queue, micro-batcher),
:mod:`repro_torch.serving.bank` (:class:`DeltaRing`, the ring of retained
banks and snapshots), :mod:`repro_torch.serving.server`
(:class:`PersonalizationServer`) and :mod:`repro_torch.serving.transport`
(the socket front-end, wire protocol v1: :class:`TransportServer` and its
clients).
"""
from repro_torch.serving.bank import DeltaRing  # noqa: F401
from repro_torch.serving.batcher import (MODES, MicroBatcher,  # noqa: F401
                                         Ticket, personalize_strategy)
from repro_torch.serving.server import PersonalizationServer  # noqa: F401
from repro_torch.serving.transport import (  # noqa: F401
    AsyncTransportClient, TransportBusy, TransportClient, TransportError,
    TransportServer)


def __getattr__(name: str):
    if name == "personalize_delta_fn":
        # removed; the batcher module raises the full breadcrumb
        from repro_torch.serving import batcher
        return getattr(batcher, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
