"""The JAX package's paper-mnist preset on the CPU: the oracle for
``tools/mnist_spread.py`` (never run on the card).

Writes the reference's init (``init_cnn(MNIST_CNN, PRNGKey(seed))``) as an
``.npz`` of flat leaf paths, which ``tools/mnist_spread.py --init`` loads,
then runs ``repro.launch.train``'s preset at the given flags and prints its
accuracy series as one JSON line:

  JAX_PLATFORMS=cpu PYTHONPATH=src python tools/mnist_spread_jax.py \\
      --init-out init.npz --eval-every 10
"""
from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs.paper_models import MNIST_CNN  # noqa: E402
from repro.launch import train  # noqa: E402
from repro.models.cnn import init_cnn  # noqa: E402


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flat(tree[k], f"{prefix}{k}/")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _flat(v, f"{prefix}#{i}/")
    else:
        yield prefix[:-1], np.asarray(tree)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--init-out", required=True)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--option", default="C")
    ap.add_argument("--out", default="experiments/train")
    args, rest = ap.parse_known_args(argv)
    init = init_cnn(MNIST_CNN, jax.random.PRNGKey(args.seed))
    np.savez(args.init_out, **dict(_flat(init)))
    sys.argv = [sys.argv[0], "--preset", "paper-mnist", "--seed",
                str(args.seed), "--option", args.option, "--out",
                args.out] + rest
    train.main()
    with open(os.path.join(args.out, f"paper-mnist_opt{args.option}"
                           ".history.json")) as f:
        rec = json.load(f)
    print("SPREAD " + json.dumps({"tag": "jax-cpu", "acc": rec["acc"],
                                  "rounds_series": rec["rounds_series"],
                                  "staleness_max": rec["staleness_max"],
                                  "staleness_mean": rec["staleness_mean"]}),
          flush=True)


if __name__ == "__main__":
    main()
