"""PASTA device-resident analysis kernels (paper Fig. 2b) for Hopper.

Layout: ``csrc/<name>.cu`` (hand-written CUDA, one shared library each),
``build.py`` (nvcc at first use + ctypes loading), ``ops.py`` (dispatch,
launch counts), ``ref.py`` (plain PyTorch versions).
"""

from . import ops, ref  # noqa: F401
