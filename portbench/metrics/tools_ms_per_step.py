"""The self time of the port's ``tool <name>`` spans (each call into a
tool's ``on_batch`` or ``on_event``), all tools together, a profiled
step."""

from portbench import probe_rows


def read(run):
    return probe_rows.profiled_ms(run, lambda name: name.startswith("tool "))
