"""One run of one cell of the port's benchmark.

A cell of ``BENCHMARK.json`` names a configuration (``configs/<name>.json``
with its plain reference ``configs/<name>.py``, which also gives the
weight layout, a step's FLOPs and the operators a forward reports) and a
traffic mix (``traffic/<name>.json``), which names the loop that drives
it (``loops/<loop>.py``) and the PASTA session it runs under
(``sessions/<name>.json``).  The limits of its comparison are in
``limits/<cell>.json`` and each metric is read by ``metrics/<metric>.py``.
Adding a cell or a metric adds files; nothing here names one.
"""

from __future__ import annotations

import importlib.util
import json
import subprocess
import sys
import types
from pathlib import Path

import torch

BENCH = Path(__file__).resolve().parent
WINDOW_SPAN = "profiled window"


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def load_module(path: Path):
    spec = importlib.util.spec_from_file_location(
        "portbench_" + path.stem.replace("-", "_").replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(root: Path, workload: str, model_overrides: dict | None = None,
              traffic_overrides: dict | None = None):
    """The cell ``workload`` of ``root/BENCHMARK.json`` with its files."""
    spec = json.loads((root / "BENCHMARK.json").read_text())
    cell = next((w for w in spec["workloads"] if w["name"] == workload), None)
    if cell is None:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")
    conf = next(c for c in spec["configs"] if c["name"] == cell["config"])
    config = json.loads((root / conf["file"]).read_text())
    traffic = json.loads((BENCH / "traffic" / f"{cell['traffic']}.json").read_text())
    traffic.update(traffic_overrides or {})
    model = {**config["model"], **(model_overrides or {})}
    return types.SimpleNamespace(
        name=workload, chips=cell["chips"], model=model,
        ref_cfg=types.SimpleNamespace(**model), traffic=traffic,
        session=json.loads((BENCH / "sessions" / f"{traffic['session']}.json")
                           .read_text()),
        limits=json.loads((BENCH / "limits" / f"{workload}.json").read_text()),
        reference=load_module((root / conf["file"]).with_suffix(".py")),
        end_to_end=[m for m in spec["end_to_end"] if _applies(m, workload)],
        per_layer=[m for m in spec["per_layer"] if _applies(m, workload)])


def card() -> str:
    """The card's name and power limit, as ``nvidia-smi`` gives them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30, check=True).stdout.strip().splitlines()
        return out[0] if out else "nvidia-smi printed nothing"
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi failed: {e}"


def _union(intervals) -> list:
    merged: list = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def profile_summary(prof, span_names) -> dict:
    """Device activity of the profiled sub-window: every device operation
    (name, start, end) in microseconds, their union, the sub-window's
    length, and each idle gap between device operations named by the
    innermost host span open at its middle."""
    dev, ann, window = [], [], None
    for e in prof.events():
        tr = e.time_range
        # the profiler mirrors each host range on the device's timeline
        # too; those are annotations, not device work
        annotation = e.name == WINDOW_SPAN or e.name in span_names \
            or getattr(e, "is_user_annotation", False)
        if e.device_type == torch.autograd.DeviceType.CUDA:
            if not annotation:
                dev.append((e.name, tr.start, tr.end))
        elif e.name == WINDOW_SPAN:
            window = (tr.start, tr.end)
        elif e.name in span_names:
            ann.append((e.name, tr.start, tr.end))
    if window is None:
        window = (min((s for _n, s, _e in dev), default=0.0),
                  max((e for _n, _s, e in dev), default=0.0))
    w0, w1 = window
    busy = _union((max(s, w0), min(e, w1)) for _n, s, e in dev if e > w0 and s < w1)
    gaps, cursor = [], w0
    for s, e in busy:
        if s > cursor:
            gaps.append((cursor, s))
        cursor = max(cursor, e)
    if w1 > cursor:
        gaps.append((cursor, w1))
    ann.sort(key=lambda a: a[1])
    idle: dict = {}
    for g0, g1 in gaps:
        mid = (g0 + g1) / 2
        name = "outside the spans"
        for n, s, e in ann:
            if s > mid:
                break
            if e >= mid:
                name = n
        idle[name] = idle.get(name, 0.0) + (g1 - g0) / 1e6
    ops_s: dict = {}
    for n, s, e in dev:
        ops_s[n] = ops_s.get(n, 0.0) + (e - s) / 1e6
    return {"device": dev, "window_us": w1 - w0,
            "busy_us": sum(e - s for s, e in busy), "idle_by_span": idle,
            "ops_s": ops_s}


def _top(d: dict, n: int = 10) -> list:
    """The ``n`` largest entries, names cut to 160 characters."""
    return [[k[:160], v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:n]]


def run_cell(cell, seed: int, seconds: float, trace: bool, device: str,
             t0: float) -> dict:
    """One run of the cell's traffic loop (``loops/<loop>.py``); returns the
    result object (``correct`` ... ``checks``)."""
    loop = load_module(BENCH / "loops" / f"{cell.traffic['loop']}.py")
    run, checks = loop.run(cell, seed, seconds, trace, device, t0)
    correct = all(v <= lim for v, lim in checks.values())
    wanted = cell.per_layer if trace else cell.end_to_end
    metrics = {}
    for m in wanted:
        value = load_module(BENCH / "metrics" / f"{m['name']}.py").read(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if run.on_card else "cpu", "kind": run.device_name,
           "count": cell.chips, "memory_peak_bytes": run.memory_peak_bytes}
    result = {"correct": correct, "attempted": run.steps, "failed": 0,
              "metrics": metrics, "device": dev}
    if run.profile is not None:
        dev["busy_s"] = run.profile["busy_us"] / 1e6
        dev["window_s"] = run.profile["window_us"] / 1e6
        result["breakdown"] = {"device_ops": _top(run.profile["ops_s"]),
                               "idle_gaps": _top(run.profile["idle_by_span"])}
    result["checks"] = {k: {"value": v, "limit": lim} for k, (v, lim) in checks.items()}
    return result
