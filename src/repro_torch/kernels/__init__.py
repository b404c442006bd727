"""Hand-written Hopper kernels, each beside its plain PyTorch version
(``kernel.py`` / ``ref.py`` / ``ops.py``, as in ``repro.kernels``)."""
