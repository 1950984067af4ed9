"""Self time of ``EagerInstrumenter._emit_trace`` (records, the live
object table, the buffer's dispatch and its tools) a window step, the
reduction subtracted."""


def read(run):
    if run.spans is None or not run.steps:
        return None
    return run.spans.get("trace emission", 0.0) / run.steps * 1e3
