"""The time of the port's ``gc`` spans (the garbage collections while spans
were on), a profiled step."""

from portbench import probe_rows


def read(run):
    return probe_rows.profiled_ms(run, lambda name: name == "gc", "total_ns")
