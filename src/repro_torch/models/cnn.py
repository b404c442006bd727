"""The paper's experimental models (§5, Appendix D): small CNNs with
pooling + dropout + cross-entropy for MNIST / CIFAR-10 classification, as in
``src/repro/models/cnn.py``.

The params keep the reference's layout (conv ``w`` HWIO, ``fc.w``
``(d_in, d_out)``) and the images arrive NHWC.  Inside, the convolutions run
NCHW/OIHW as PyTorch wants them, and the activations return to NHWC before
the flatten, so ``fc[0]`` sees features in the reference's (H, W, C) order.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.paper_models import CNNConfig
from repro_torch.models.layers import cross_entropy, dense_init


def init_cnn(cfg: CNNConfig, generator: torch.Generator) -> Dict:
    """Params on the CPU, drawn from ``generator`` (other numbers than the
    reference's ``init_cnn`` gives for any key; see :func:`dense_init`)."""
    params: Dict = {"conv": [], "fc": []}
    c_in = cfg.channels
    for c_out in cfg.conv_channels:
        params["conv"].append({
            "w": dense_init(generator, (3, 3, c_in, c_out), scale=0.1),
            "b": torch.zeros((c_out,), dtype=torch.float32),
        })
        c_in = c_out
    # spatial size after len(conv) stride-2 maxpools
    side = cfg.image_size
    for _ in cfg.conv_channels:
        side = side // 2
    d = side * side * c_in
    for width in cfg.fc_sizes:
        params["fc"].append({
            "w": dense_init(generator, (d, width)),
            "b": torch.zeros((width,), dtype=torch.float32),
        })
        d = width
    return params


def cnn_logits(cfg: CNNConfig, params, images: torch.Tensor, *,
               generator: Optional[torch.Generator] = None,
               train: bool = False) -> torch.Tensor:
    """images: (B, H, W, C) -> (B, n_classes).

    Dropout runs only with ``train=True`` and a ``generator``; its masks are
    not the reference's bits (the main path trains with ``train=False``)."""
    h = images.float().permute(0, 3, 1, 2)                  # NHWC -> NCHW
    for cp in params["conv"]:
        # "SAME" for a 3x3 stride-1 kernel is one pixel of padding
        h = F.conv2d(h, cp["w"].permute(3, 2, 0, 1), padding=1)  # HWIO->OIHW
        h = F.relu(h + cp["b"][:, None, None])
        h = F.max_pool2d(h, 2, 2)
    h = h.permute(0, 2, 3, 1).reshape(h.shape[0], -1)      # flatten (H, W, C)
    n_fc = len(params["fc"])
    for j, fp in enumerate(params["fc"]):
        h = h @ fp["w"] + fp["b"]
        if j < n_fc - 1:
            h = F.relu(h)
            if train and generator is not None and cfg.dropout > 0:
                keep = torch.rand(h.shape, generator=generator,
                                  device=h.device) >= cfg.dropout
                h = torch.where(keep, h / (1.0 - cfg.dropout),
                                torch.zeros_like(h))
    return h


def cnn_loss(cfg: CNNConfig, params, batch: Dict, *,
             generator: Optional[torch.Generator] = None,
             train: bool = True) -> torch.Tensor:
    """batch: images (B,H,W,C), labels (B,) integer."""
    logits = cnn_logits(cfg, params, batch["images"], generator=generator,
                        train=train)
    return cross_entropy(logits, batch["labels"])


def cnn_accuracy(cfg: CNNConfig, params, batch: Dict) -> torch.Tensor:
    logits = cnn_logits(cfg, params, batch["images"], train=False)
    return (logits.argmax(-1) == batch["labels"]).float().mean()
