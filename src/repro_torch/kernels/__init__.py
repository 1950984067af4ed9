"""PASTA device-resident kernels (paper Fig. 2b) for Hopper.

Layout: ``csrc/<name>.cu`` (hand-written CUDA, one shared library each),
``build.py`` (nvcc at first use + ctypes loading), ``ops.py`` (dispatch of
the trace reductions, launch counts), ``ref.py`` (their plain PyTorch
versions), ``instrumented_matmul.py`` (the matmul that writes its own trace
records, with its plain version).
"""

from . import instrumented_matmul, ops, ref  # noqa: F401
