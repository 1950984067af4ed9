"""Host time inside the reduction's copies (``kernels/ops.py``'s ``_on``
and ``_host``, each of which waits for the stream's queued work), from the
port's always-on ``reduction wait ns`` counter, over the window's trace
buffers (its ``trace buffers`` counter)."""

from portbench import probe_rows


def read(run):
    rows = probe_rows.window(run)
    if rows is None:
        return None
    buffers = sum(r["counts"].get("trace buffers", 0) for r in rows)
    if not buffers:
        return None
    wait = sum(r["counts"].get("reduction wait ns", 0) for r in rows)
    return wait / buffers / 1e6
