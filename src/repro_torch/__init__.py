"""PersA-FL in PyTorch and CUDA: the port of :mod:`repro` to an NVIDIA H100.

The package mirrors ``src/repro``'s relative paths and public names and
keeps its params layout (conv ``w`` HWIO, ``fc.w`` ``(d_in, d_out)``, NHWC
images), so each module can be held against its reference leaf for leaf.  It
imports ``torch`` and numpy, never JAX and nothing of ``repro``.  Entry points
(``FLRun``, ``CohortEngine``, ``init_server_state``) run on the card unless
the caller passes ``device="cpu"``.  Nothing is compiled at import: the CUDA
kernels are built from ``csrc/`` at their first launch.
"""
