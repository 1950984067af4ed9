"""Model FLOPs of one step (the configuration's ``step_flops``, in
``configs/<name>.py``) over the mean instrumented step of the window times
the card's bf16 dense peak."""


def read(run):
    if not run.peaks or not run.steps:
        return None
    mean = sum(run.step_s) / run.steps
    return 100.0 * run.flops_per_step / (mean * run.peaks["bf16_flops_per_s"])
