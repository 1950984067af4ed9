"""The port's probe (``repro_torch.probe``) as the metrics read it: the
rows of its snapshot that a run's window and its profiled steps left.
Each function returns None where the port has no probe or the rows are
not there."""


def _step_rows():
    try:
        from repro_torch import probe
    except ImportError:
        return None
    return [r for r in probe.snapshot() if r["step"] is not None]


def window(run):
    """The rows of the window's steps, the last ``run.steps``: counters
    only, spans are off there."""
    rows = _step_rows()
    if not rows or not run.steps:
        return None
    return rows[-run.steps:]


def profiled_ms(run, pick, key="self_ns"):
    """``key`` ("self_ns" or "total_ns") of the spans whose name ``pick``
    accepts, in ms a profiled step: the steps just before the window whose
    spans were on (under ``torch.profiler`` in a traced run)."""
    rows = _step_rows()
    if rows is None:
        return None
    spans = []
    for r in reversed(rows[:len(rows) - run.steps]):
        if not r["spans_on"]:
            break
        spans.append(r["spans"])
    if not spans:
        return None
    ns = sum(v[key] for s in spans for name, v in s.items() if pick(name))
    return ns / len(spans) / 1e6
