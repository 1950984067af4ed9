"""The benchmark of the PyTorch and CUDA port (``src/repro_torch``): see
``run.py`` for the command and ``harness.py`` for what a run does."""
