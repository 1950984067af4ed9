"""The port's own ``analysis_s`` (host clock around the copy in, the
reduction and the copy back of one trace buffer), summed over the
window's buffers, over their number."""


def read(run):
    if not run.window_buffers:
        return None
    return run.analysis_s / run.window_buffers * 1e3
