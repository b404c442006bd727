"""Heterogeneous federated data pipeline (paper §5 / Appendix D), a numpy
copy of ``src/repro/data/federated.py`` that gives bit-identical arrays.

The container is offline, so MNIST/CIFAR-10 are replaced by *synthetic*
datasets with matched statistics: 10 classes, 28×28×1 ("mnist-like") or
32×32×3 ("cifar-like") images drawn as class prototype + noise.  What the
paper's claims exercise is the *heterogeneity mechanism* — each client holds
samples from only ``c`` of the 10 classes (c=5 MNIST, c=3 CIFAR) with
unbalanced sizes — which is reproduced exactly.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import numpy as np


@dataclasses.dataclass
class ClientData:
    """Per-client train/test arrays."""
    train_x: np.ndarray
    train_y: np.ndarray
    test_x: np.ndarray
    test_y: np.ndarray
    classes: Tuple[int, ...]

    @property
    def n_train(self) -> int:
        return len(self.train_y)


def make_synthetic_images(seed: int, kind: str = "mnist",
                          per_class: int = 400):
    """-> (x (N,H,W,C) f32, y (N,) int32), 10 classes."""
    rng = np.random.RandomState(seed)
    if kind == "mnist":
        h, w, c = 28, 28, 1
        noise = 1.0
        n_dict = 16
    elif kind == "cifar":
        h, w, c = 32, 32, 3
        noise = 1.3
        n_dict = 24
    else:
        raise ValueError(kind)
    # Classes are sparse combinations of a SHARED feature dictionary
    # ("strokes"), so low-level conv features transfer across classes —
    # collaboration helps (like real MNIST) — while heavy noise keeps the
    # global 10-class problem hard relative to each client's c-class
    # subproblem — personalization pays.
    dictionary = rng.randn(n_dict, h, w, c).astype(np.float32)
    coeffs = rng.randn(10, n_dict).astype(np.float32)
    coeffs *= (rng.rand(10, n_dict) < 0.3)          # sparse class mixtures
    coeffs /= np.maximum(np.linalg.norm(coeffs, axis=1, keepdims=True), 1e-6)
    protos = np.einsum("kd,dhwc->khwc", coeffs * 2.0, dictionary)
    xs, ys = [], []
    for k in range(10):
        n = per_class
        x = protos[k][None] + noise * rng.randn(n, h, w, c).astype(np.float32)
        xs.append(x)
        ys.append(np.full((n,), k, np.int32))
    x = np.concatenate(xs)
    y = np.concatenate(ys)
    perm = rng.permutation(len(y))
    return x[perm], y[perm]


def partition_heterogeneous(x, y, *, n_clients: int, classes_per_client: int,
                            seed: int, test_frac: float = 0.2,
                            unbalance: float = 0.6) -> List[ClientData]:
    """Label-skew partition: client i sees only ``classes_per_client`` of the
    10 classes, with log-normal unbalanced sample counts (paper §5)."""
    rng = np.random.RandomState(seed)
    by_class = {k: list(np.where(y == k)[0]) for k in range(10)}
    for k in by_class:
        rng.shuffle(by_class[k])
    clients: List[ClientData] = []
    sizes = np.exp(unbalance * rng.randn(n_clients))
    sizes = sizes / sizes.sum()
    total = len(y)
    for i in range(n_clients):
        cls = tuple(sorted(rng.choice(10, classes_per_client, replace=False)))
        want = max(int(sizes[i] * total), 8 * classes_per_client)
        per_cls = max(want // classes_per_client, 8)
        idx: List[int] = []
        for k in cls:
            pool = by_class[k]
            if len(pool) < per_cls:   # recycle with replacement if exhausted
                take = list(rng.choice(np.where(y == k)[0], per_cls))
            else:
                take = [pool.pop() for _ in range(per_cls)]
            idx.extend(take)
        idx = np.array(idx)
        rng.shuffle(idx)
        n_test = max(int(test_frac * len(idx)), classes_per_client)
        clients.append(ClientData(
            train_x=x[idx[n_test:]], train_y=y[idx[n_test:]],
            test_x=x[idx[:n_test]], test_y=y[idx[:n_test]],
            classes=cls))
    return clients


def sample_batches(client: ClientData, rng: np.random.RandomState,
                   n_batches: int, batch_size: int) -> Dict[str, np.ndarray]:
    """Sample ``n_batches`` iid batches -> leaves (n_batches, B, ...).

    Always samples with replacement at the *fixed* ``batch_size`` so every
    client produces identically-shaped batches (one jit compilation total —
    per-client shapes would recompile per client).
    """
    idx = rng.randint(0, client.n_train, size=(n_batches, batch_size))
    return {"images": client.train_x[idx], "labels": client.train_y[idx]}


def eval_batch(client: ClientData, size: int, seed: int = 0):
    """Fixed-size test batch (resampled with replacement if the client's
    test set is smaller) — keeps the eval jit shape-stable across clients."""
    rng = np.random.RandomState(seed)
    n = len(client.test_y)
    if n >= size:
        idx = rng.choice(n, size, replace=False)
    else:
        idx = rng.choice(n, size, replace=True)
    return {"images": client.test_x[idx], "labels": client.test_y[idx]}


def make_federated_dataset(kind: str, n_clients: int, classes_per_client: int,
                           seed: int = 0) -> List[ClientData]:
    x, y = make_synthetic_images(seed, kind)
    return partition_heterogeneous(x, y, n_clients=n_clients,
                                   classes_per_client=classes_per_client,
                                   seed=seed + 1)


# ---------------------------------------------------------------------------
# token stream for LM smoke tests / examples
# ---------------------------------------------------------------------------

def synthetic_token_batch(seed: int, batch: int, seq: int, vocab: int):
    rng = np.random.RandomState(seed)
    # a learnable synthetic language: tokens follow a noisy linear recurrence
    toks = np.zeros((batch, seq + 1), np.int32)
    toks[:, 0] = rng.randint(0, vocab, batch)
    mult = 31
    for t in range(seq):
        nxt = (toks[:, t] * mult + 7) % vocab
        noise = rng.rand(batch) < 0.1
        toks[:, t + 1] = np.where(noise, rng.randint(0, vocab, batch), nxt)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
