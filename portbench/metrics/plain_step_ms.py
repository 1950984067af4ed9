"""The same forward on the same shape with no session open: host clock
around a few steps after one warm-up, ending in ``synchronize()``."""


def read(run):
    return None if run.plain_step_s is None else run.plain_step_s * 1e3
