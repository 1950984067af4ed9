"""Self time of ``EagerInstrumenter.op`` (operand registration, operator
events and their tools) a window step, the spans it calls subtracted."""


def read(run):
    if run.spans is None or not run.steps:
        return None
    return run.spans.get("op", 0.0) / run.steps * 1e3
