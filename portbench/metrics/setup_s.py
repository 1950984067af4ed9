"""Seconds from the start of the process to the first timed step:
imports, weights drawn on the card, kernels built or loaded, the session
and one warm-up step at the cell's shape."""


def read(run):
    return run.setup_s
