"""The paper's own experimental models (§5 / Appendix D), as in
``src/repro/configs/paper_models.py``.

MNIST: 2-layer CNN + 2 FC layers; CIFAR-10: 3-layer CNN + 3 FC layers,
pooling + dropout + cross-entropy.  ``MNIST_CNN`` has 52,138 f32 parameters
in 8 leaves.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class CNNConfig:
    name: str
    image_size: int
    channels: int
    n_classes: int
    conv_channels: Tuple[int, ...]
    fc_sizes: Tuple[int, ...]
    dropout: float = 0.25


MNIST_CNN = CNNConfig(
    name="paper-mnist-cnn",
    image_size=28,
    channels=1,
    n_classes=10,
    conv_channels=(8, 16),      # ell = 2 conv layers
    fc_sizes=(64, 10),          # 2 fully connected layers
)

CIFAR_CNN = CNNConfig(
    name="paper-cifar-cnn",
    image_size=32,
    channels=3,
    n_classes=10,
    conv_channels=(16, 32, 32),  # ell = 3 conv layers
    fc_sizes=(128, 64, 10),      # 3 fully connected layers
)
