"""The self time of the port's ``emit live objects`` span
(``pool.live_tensors()``, the sort and the sizes in
``EagerInstrumenter._emit_trace``), a profiled step."""

from portbench import probe_rows


def read(run):
    return probe_rows.profiled_ms(run, lambda name: name == "emit live objects")
