"""Prompt tokens of the instrumented steps completed in the window over
the window's time (host clock, ending after ``torch.cuda.synchronize()``
at the end of the first step that finishes at or after ``--seconds``)."""


def read(run):
    return run.tokens / run.window_s if run.window_s > 0 else None
