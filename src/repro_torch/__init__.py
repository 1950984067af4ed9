"""PASTA on PyTorch and CUDA: the port of the ``repro`` (JAX) package.

It imports neither ``jax`` nor ``repro``.  Entry points run on the GPU
(``device="cuda"``) unless the caller asks for ``device="cpu"``.
"""
