"""Mean instrumented step of the window over the plain forward's step."""


def read(run):
    if not run.plain_step_s or not run.steps:
        return None
    return sum(run.step_s) / run.steps / run.plain_step_s
