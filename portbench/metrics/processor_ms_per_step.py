"""The self time of the port's ``processor`` span
(``EventProcessor._on_batch``: normalisation, events, the choice of
tools) plus that of its ``handler dispatch`` span
(``EventHandler._dispatch``'s loop over the subscribers), a profiled
step."""

from portbench import probe_rows


def read(run):
    return probe_rows.profiled_ms(
        run, lambda name: name in ("processor", "handler dispatch"))
