"""The comparison that decides ``correct``.

Four parts, each against a plain reference that takes nothing the port
computed:

* **operators** (model, instrumenter): every step's operators, each with
  the bytes of its operands, in order, must be those the configuration's
  reference (``configs/<name>.py``, ``operators``) works out from the
  configuration and the (batch, seq) shape.
* **trace buffers** (instrumenter, processor, trace kernels): a recorder
  subscribed to the session keeps every batch of events the port
  dispatched.  After the window a replay rebuilds, from the operator's
  own operands (the ``(address, size)`` pairs of its OPERATOR_START),
  the access records the instrumenter's rule makes (one every
  ``stride`` bytes of each operand, at most ``max_records`` over all of
  them), the live-object table from the TENSOR_ALLOC / TENSOR_FREE
  stream, and from those the per-object counts and the time x block
  hotness map in NumPy.  A buffer is wrong when its object table, counts
  or map differ in any entry.  A fine-grained session makes one buffer
  for each operator, a coarse one none.
* **reports**: the working set, peak live bytes, hotness classification
  and memory timeline peak, recomputed from the replay's own counts,
  maps and live bytes (in a coarse session, from the operands' bytes),
  must equal the session's.
* **logits**: the timed path's last step, at a sample of positions
  drawn from the seed, against the configuration's plain reference on
  the same weights and tokens.

The replay follows the port's event stream: it checks what the
instrumenter emitted against its own operands and lifetimes, and the
operands' sizes against the shapes, not whether the stream itself saw
every tensor the framework allocated.
"""

from __future__ import annotations

import math

import numpy as np
import torch

ROWS_PER_SEQUENCE = 8


class Recorder:
    """A batch subscriber that keeps every dispatched batch with the step
    it belongs to (``clock[0]``); nothing is computed in the window."""

    def __init__(self, clock: list):
        self.clock = clock
        self.log: list = []

    def __call__(self, batch) -> None:
        self.log.append((self.clock[0], batch.kinds, batch.addrs, batch.sizes,
                         batch.attrs, batch.name_ids, batch.name_table))


def records(tensors, stride: int, max_records: int) -> np.ndarray:
    """The access records of one operator over its operands ``tensors``
    = [(address, bytes)]: ``n = max(1, min(bytes // stride, max_records //
    len(tensors)))`` addresses a tensor, ``addr + (i * stride) % bytes``."""
    parts = []
    for addr, size in tensors:
        n = max(1, min(size // stride, max_records // max(len(tensors), 1)))
        parts.append(addr + (np.arange(n, dtype=np.int64) * stride) % size)
    return np.concatenate(parts) if parts else np.zeros(0, np.int64)


def object_counts(recs: np.ndarray, table: np.ndarray) -> np.ndarray:
    """Records falling in each [start, end) of the sorted ``table``."""
    k = len(table)
    if k == 0:
        return np.zeros(0, np.int64)
    idx = np.searchsorted(table[:, 0], recs, side="right") - 1
    ok = idx >= 0
    ok[ok] &= recs[ok] < table[idx[ok], 1]
    return np.bincount(idx[ok], minlength=k).astype(np.int64)


def hotness_row(recs: np.ndarray, hot: dict) -> np.ndarray:
    """Records in each block of ``512 << block_shift`` bytes from
    ``base``; those outside the map drop."""
    blk = ((recs >> 9) - (hot["base"] >> 9)) >> hot["block_shift"]
    ok = (blk >= 0) & (blk < hot["n_blocks"])
    return np.bincount(blk[ok], minlength=hot["n_blocks"]).astype(np.int64)


def time_bin(step: int, hot: dict) -> int:
    tb = int(float(step) / max(hot["t_max"], 1e-12) * hot["n_tbins"])
    return min(tb, hot["n_tbins"] - 1)


def classify(hot_sum: np.ndarray, hot_frac: float) -> dict:
    touched = hot_sum > 0
    presence = touched.mean(axis=0)
    total = hot_sum.sum(axis=0)
    return {"persistent_blocks": np.where((presence >= hot_frac) & (total > 0))[0].tolist(),
            "bursty_blocks": np.where((presence < hot_frac) & (total > 0))[0].tolist(),
            "cold_blocks": int((total == 0).sum()),
            "total_accesses": int(hot_sum.sum())}


def replay(log, codes: dict, hot: dict | None, stride: int, max_records: int,
           marks=()):
    """Check every trace buffer of ``log`` (see the module docstring).
    ``codes``: the event kind codes ``tensor_alloc``, ``tensor_free``,
    ``operator_start``, ``trace_buffer``.  ``marks``: log positions whose
    buffer index is wanted back.  Returns a dict: ``buffers`` (each a
    dict of records ``n``, objects ``k`` and map ``cells``), ``bad`` (the
    wrong ones), ``operators`` (each step's operators as ``(name,
    [operand bytes])``), the recomputed report values and ``marked``
    (buffers before each mark)."""
    ta, tf = codes["tensor_alloc"], codes["tensor_free"]
    op, tb = codes["operator_start"], codes["trace_buffer"]
    live: dict = {}
    cur = peak = 0
    last_op = None
    buffers, ws, bad, lost = [], [], [], 0
    marked = []
    hot_sum = None if hot is None else np.zeros((hot["n_tbins"], hot["n_blocks"]),
                                                np.int64)
    marks = list(marks)
    operators: dict = {}
    for pos, (step, kinds, addrs, sizes, attrs, name_ids, names) in enumerate(log):
        while marks and marks[0] <= pos:
            marked.append(len(buffers))
            marks.pop(0)
        for i in range(len(kinds)):
            kind = kinds[i]
            if kind == ta:
                live[int(addrs[i])] = abs(int(sizes[i]))
                cur += abs(int(sizes[i]))
                peak = max(peak, cur)
            elif kind == tf:
                size = live.pop(int(addrs[i]), None)
                if size is None:
                    lost += 1
                else:
                    cur -= size
            elif kind == op:
                last_op = attrs[i].get("tensors") if attrs is not None else None
                operand_bytes = [int(n) for _a, n in last_op or ()]
                operators.setdefault(step, []).append(
                    (names[name_ids[i]], operand_bytes))
                if last_op is not None and not attrs[i].get("traced"):
                    ws.append(sum(operand_bytes))     # a coarse session's working set
            elif kind == tb:
                a = attrs[i]
                table = np.asarray(sorted((s, s + n) for s, n in live.items()),
                                   np.int64).reshape(-1, 2)
                recs = records(last_op or (), stride, max_records)
                counts = object_counts(recs, table)
                wrong = []
                got_table = np.asarray(a.get("objects", ()), np.int64).reshape(-1, 2)
                if not np.array_equal(got_table, table):
                    wrong.append("objects")
                got = a.get("object_counts")
                if got is None or not np.array_equal(np.asarray(got), counts):
                    wrong.append("counts")
                cells = 0
                if hot is not None:
                    row = hotness_row(recs, hot)
                    want = np.zeros_like(hot_sum)
                    want[time_bin(step, hot)] = row
                    hot_sum += want
                    cells = want.size
                    got = a.get("hotness_map")
                    if got is None or not np.array_equal(np.asarray(got), want):
                        wrong.append("hotness")
                sizes_t = table[:, 1] - table[:, 0]
                ws.append(int(np.sum(np.where(counts > 0, sizes_t, 0))))
                buffers.append({"n": len(recs), "k": len(table), "cells": cells,
                                "step": step})
                if wrong:
                    bad.append((len(buffers) - 1, step, a.get("kernel", ""), wrong))
                last_op = None
    marked.extend([len(buffers)] * len(marks))
    mb = 1024.0 ** 2
    wsa = np.asarray(ws, np.float64) if ws else np.zeros(1)
    report = {"workingset.operator_count": len(ws),
              "workingset.working_set_mb": float(wsa.max()) / mb,
              "workingset.median_ws_mb": float(np.median(wsa)) / mb,
              "workingset.peak_live_mb": peak / mb,
              "timeline.peak_bytes": peak}
    if hot_sum is not None:
        report.update({f"hotness.{k}": v for k, v in classify(
            hot_sum, hot["hot_frac"]).items()})
    return {"buffers": buffers, "bad": bad, "lost_frees": lost,
            "operators": operators, "report": report, "marked": marked}


def wrong_steps(operators: dict, want: list, steps: int) -> list:
    """Steps among the first ``steps`` whose operators, with their operand
    bytes, are not ``want``: ``(step, index of the first difference, what
    came, what was wanted)``."""
    wrong = []
    for step in range(steps):
        got = operators.get(step, [])
        if got != want:
            i = next((j for j, (g, w) in enumerate(zip(got, want)) if g != w),
                     min(len(got), len(want)))
            wrong.append((step, i, got[i] if i < len(got) else None,
                          want[i] if i < len(want) else None))
    return wrong


def report_values(reports) -> dict:
    """The session's values of the reports the replay recomputes."""
    out = {}
    if "workingset" in reports:
        w = reports["workingset"]
        for key in ("operator_count", "working_set_mb", "median_ws_mb",
                    "peak_live_mb"):
            out[f"workingset.{key}"] = w[key]
    if "timeline" in reports:
        t = reports["timeline"]
        peaks = list(t["peak_bytes"].values())
        out["timeline.peak_bytes"] = peaks[0] if len(peaks) == 1 else peaks
    if "hotness" in reports:
        h = reports["hotness"]
        for key in ("persistent_blocks", "bursty_blocks", "cold_blocks",
                    "total_accesses"):
            out[f"hotness.{key}"] = h[key]
    return out


def wrong_reports(got: dict, want: dict) -> list:
    """Keys of ``got`` whose value differs from ``want``'s."""
    wrong = []
    for key, value in got.items():
        ref = want.get(key)
        if isinstance(value, float) or isinstance(ref, float):
            same = ref is not None and math.isclose(value, ref, rel_tol=1e-12,
                                                    abs_tol=1e-12)
        else:
            same = value == ref
        if not same:
            wrong.append(key)
    return wrong


def sample_rows(seed: int, batch: int, seq: int):
    """(batch index, position) of the logits compared: in each sequence
    its last position and ROWS_PER_SEQUENCE - 1 others drawn from the
    seed."""
    rng = np.random.default_rng(int(seed) % 2 ** 63)
    b_idx, s_idx = [], []
    for b in range(batch):
        others = rng.choice(seq - 1, size=min(ROWS_PER_SEQUENCE - 1, seq - 1),
                            replace=False)
        for s in sorted(others.tolist()) + [seq - 1]:
            b_idx.append(b)
            s_idx.append(s)
    return np.asarray(b_idx), np.asarray(s_idx)


def logit_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """The largest, over the compared rows, of the root-mean-square gap of
    a row's logits relative to the reference row's root mean square."""
    got, want = got.to(torch.float64), want.to(torch.float64)
    num = torch.linalg.vector_norm(got - want, dim=-1)
    den = torch.linalg.vector_norm(want, dim=-1).clamp(min=1e-30)
    return float((num / den).max())
