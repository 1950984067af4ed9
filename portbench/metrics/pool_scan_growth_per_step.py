"""How many more pool handles each ``MemoryPool.live_tensors()`` call
visits a step: the least-squares slope, over the window's steps, of the
port's ``pool handles scanned`` over its ``trace buffers`` against the
step's index.  About 0 where the pool keeps a live set."""

from portbench import probe_rows


def read(run):
    rows = probe_rows.window(run)
    if rows is None:
        return None
    pts = [(r["step"], r["counts"]["pool handles scanned"]
            / r["counts"]["trace buffers"]) for r in rows
           if r["counts"].get("trace buffers")
           and "pool handles scanned" in r["counts"]]
    if len(pts) < 2:
        return None
    mx = sum(x for x, _y in pts) / len(pts)
    my = sum(y for _x, y in pts) / len(pts)
    sxx = sum((x - mx) ** 2 for x, _y in pts)
    if not sxx:
        return None
    return sum((x - mx) * (y - my) for x, y in pts) / sxx
