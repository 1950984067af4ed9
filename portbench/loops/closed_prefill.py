"""The traffic loop ``closed_prefill``: one caller, prefill forward steps
back to back, each on a fresh (``batch``, ``seq_len``) batch of token ids
drawn from the seed, under ``torch.inference_mode()`` and the cell's
``Session`` with ``instrument=True``, logits at every position kept until
the next step (as ``launch/analyze.py`` runs it).

A run: set-up (weights and tokens drawn on the device, the session, one
warm-up step at the cell's shape: ``setup_s``), then the window: steps
until one ends at or after ``seconds``.  With ``trace`` the run first
times the plain forward, then profiles a short sub-window right after the
warm-up, and holds host spans around the port's layers in the window.
Then the comparison (:mod:`portbench.check`).
"""

from __future__ import annotations

import contextlib
import gc
import time
import types

import numpy as np
import torch

from portbench import check, flops, reflib, spans as spans_mod, weights
from portbench.harness import BENCH, WINDOW_SPAN, card, load_module, log, \
    profile_summary

PROFILED_STEPS = 2
PLAIN_STEPS = 3


def run(cell, seed: int, seconds: float, trace: bool, device: str,
        t0: float):
    """One run; returns what the metric readers read and the numbers
    compared, ``{name: [value, limit]}``."""
    t_imp = time.perf_counter()
    import repro_torch.core as pasta
    from repro_torch.core.events import EventKind, KIND_CODE
    from repro_torch.core.tools.base import resolve_tools
    from repro_torch.kernels import ops
    from repro_torch.launch.analyze import hotness_config
    from repro_torch.models import lm
    from repro_torch.models.config import ModelConfig

    t_imp = time.perf_counter() - t_imp
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    on_card = torch.device(device).type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    cfg, rcfg, tr, ss = ModelConfig(**cell.model), cell.ref_cfg, cell.traffic, \
        cell.session
    ref = cell.reference
    batch, seq = tr["batch"], tr["seq_len"]
    card_name = torch.cuda.get_device_name(0) if on_card else "cpu"
    if on_card:
        t_card = time.perf_counter()
        log(f"card: {card()}")
        torch.zeros(1, device=device)
        log(f"the port's imports {t_imp:.3f} s; nvidia-smi and the CUDA "
            f"context {time.perf_counter() - t_card:.3f} s")

    t_w = time.perf_counter()
    gen = weights.generator(seed, device)
    params = weights.draw(ref.layout(rcfg), gen, device)
    sync()
    t_w = time.perf_counter() - t_w
    hot = None
    overrides = {}
    if ss.get("hotness"):
        hot = hotness_config(cfg, ss["hotness"]["n_tbins"])
        overrides["hotness"] = {"n_tbins": hot["n_tbins"], "n_blocks": hot["n_blocks"]}
    tools = resolve_tools([(t["name"], {k: v for k, v in t.items() if k != "name"})
                           for t in ss["tools"]], overrides=overrides)
    hot_frac = next((t.get("hot_frac", 0.5) for t in ss["tools"]
                     if t["name"] == "hotness"), None)

    plain_step_s = None
    if trace:
        with torch.inference_mode():
            x = weights.tokens(rcfg, gen, batch, seq, device)
            lm.forward(params, x, cfg)
            sync()
            t_plain = time.perf_counter()
            for _ in range(PLAIN_STEPS):
                lm.forward(params, x, cfg)
            sync()
            plain_step_s = (time.perf_counter() - t_plain) / PLAIN_STEPS
            del x

    clock = [0]
    session = pasta.Session(
        tools=tools, instrument=True, fine=ss["fine"], buffered=ss["buffered"],
        stride=ss["stride"], pool_chunk=ss["pool_chunk"],
        pool_align=ss["pool_align"], hotness=hot, torch_device=device,
        name=cell.name)
    session.instrumenter.max_records = ss["max_records"]
    session.instrumenter.time_source = lambda: float(clock[0])
    handler = session.handler
    recorder = check.Recorder(clock)
    spans = spans_mod.HostSpans()
    handler.subscribe_batch(spans.wrap("recorder", recorder) if trace else recorder)

    def step(i):
        clock[0] = i
        handler.step_start(i)
        x = weights.tokens(rcfg, gen, batch, seq, device)
        logits = torch.clone(lm.forward(params, x, cfg)[0])
        handler.step_end(i)
        return x, logits

    marks = []
    summary = None
    with torch.inference_mode(), session:
        t_warm = time.perf_counter()
        x, logits = step(0)
        sync()
        setup_s = time.perf_counter() - t0
        log(f"set-up: {setup_s:.3f} s, of which weights {t_w:.3f} s and the "
            f"warm-up step {time.perf_counter() - t_warm:.3f} s")
        i = 1
        with spans if trace else contextlib.nullcontext():
            if trace:
                from torch.profiler import ProfilerActivity, profile
                acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                                 if on_card else [])
                prof = profile(activities=acts)
                prof.start()
                spans.annotate = True
                marks.append(len(recorder.log))
                with torch.profiler.record_function(WINDOW_SPAN):
                    for _ in range(PROFILED_STEPS):
                        with spans.span("step"):
                            x, logits = step(i)
                        i += 1
                    sync()
                marks.append(len(recorder.log))
                prof.stop()
                spans.annotate = False
                spans.reset()
            peak_before = torch.cuda.max_memory_allocated() if on_card else 0
            if on_card:
                torch.cuda.reset_peak_memory_stats()
            ops.reset_launches()
            marks.append(len(recorder.log))
            step_s = []
            t_start = time.perf_counter()
            while True:
                ts = time.perf_counter()
                with spans.span("step") if trace else contextlib.nullcontext():
                    x, logits = step(i)
                sync()
                te = time.perf_counter()
                step_s.append(te - ts)
                i += 1
                if te - t_start >= seconds:
                    break
            window_s = te - t_start
            marks.append(len(recorder.log))
            span_self = dict(spans.self_s) if trace else None
    launches = dict(ops.launches)
    peak_window = torch.cuda.max_memory_allocated() if on_card else 0
    memory_peak = max(peak_before, peak_window)
    steps_run = i
    if trace:
        summary = profile_summary(prof, {n for n, *_ in spans_mod.PORT_SPANS}
                                  | {"step", "recorder"})
        del prof

    # ---- the program's state goes before the reference runs
    t_rep = time.perf_counter()
    reports = session.reports()
    report_s = time.perf_counter() - t_rep
    session.close()
    rows = check.sample_rows(seed, batch, seq)
    got = logits[torch.as_tensor(rows[0]), torch.as_tensor(rows[1])].float().cpu()
    del logits, session, tools
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()

    t_check = time.perf_counter()
    codes = {k: int(KIND_CODE[getattr(EventKind, k.upper())])
             for k in ("tensor_alloc", "tensor_free", "operator_start",
                       "trace_buffer")}
    hot_spec = None if hot is None else {**hot, "hot_frac": hot_frac}
    rep = check.replay(recorder.log, codes, hot_spec, ss["stride"],
                       ss["max_records"], marks=marks)
    tb = codes["trace_buffer"]
    analysis_s = 0.0
    w0, w1 = marks[-2], marks[-1]
    for _step, kinds, _a, _s, attrs, _n, _t in recorder.log[w0:w1]:
        for j in np.nonzero(kinds == tb)[0]:
            analysis_s += attrs[j].get("analysis_s", 0.0)
    b0, b1 = rep["marked"][-2], rep["marked"][-1]
    window_records = sum(b["n"] for b in rep["buffers"][b0:b1])
    want_ops = ref.operators(rcfg, batch, seq)
    bad_steps = check.wrong_steps(rep["operators"], want_ops, steps_run)
    expected = len(want_ops) * steps_run if ss["fine"] else 0
    wrong_reports = check.wrong_reports(check.report_values(reports), rep["report"])
    del recorder
    t_replay = time.perf_counter() - t_check

    with torch.inference_mode():
        h = ref.hidden(params, x, rcfg, "bf16")
        idx = tuple(torch.as_tensor(r, device=device) for r in rows)
        want = reflib.head_rows(params, h, idx, rcfg, "bf16").float().cpu()
        del h
    err = check.logit_err(got, want)
    log(f"check: replay of {len(rep['buffers'])} buffers {t_replay:.3f} s, "
        f"reference {time.perf_counter() - t_check - t_replay:.3f} s")

    profile = None
    if summary is not None:
        p0, p1 = rep["marked"][0], rep["marked"][1]
        profile = {**summary, "buffers": rep["buffers"][p0:p1]}
    result = types.SimpleNamespace(
        cell=cell.name, cfg=rcfg, traffic=tr, session=ss, device_name=card_name,
        on_card=on_card, peaks=flops.peaks(card_name), setup_s=setup_s,
        window_s=window_s, steps=len(step_s), tokens=len(step_s) * batch * seq,
        step_s=step_s, peak_window_bytes=peak_window,
        memory_peak_bytes=memory_peak, plain_step_s=plain_step_s,
        spans=span_self, tools=[t["name"] for t in ss["tools"]],
        window_buffers=b1 - b0, window_records=window_records,
        analysis_s=analysis_s, report_s=report_s, launches=launches,
        profile=profile, flops_per_step=ref.step_flops(rcfg, batch, seq))

    log(f"window: {result.steps} steps of {batch} x {seq} tokens in "
        f"{window_s:.3f} s (steps {', '.join(f'{s:.3f}' for s in step_s)} s); "
        f"{b1 - b0} trace buffers, {window_records} records, analysis_s "
        f"{analysis_s:.4f} s; kernel launches {launches}; peak "
        f"{peak_window} B in the window, {memory_peak} B in the run; "
        f"reports {report_s:.3f} s")
    if span_self is not None:
        log(f"window spans, self seconds: "
            f"{ {k: round(v, 4) for k, v in sorted(span_self.items())} }")
    if profile is not None:
        names = load_module(BENCH / "metrics" / "trace_kernels_roofline.py").KERNELS
        kernels = [n for n, _s, _e in profile["device"]
                   if any(k in n for k in names)]
        by_name: dict = {}
        for n in kernels:
            base = next(k for k in names if k in n)
            by_name[base] = by_name.get(base, 0) + 1
        log(f"profiled steps: {len(profile['buffers'])} trace buffers "
            f"(handler), {len(kernels)} trace-kernel launches (profiler) "
            f"{by_name}, {len(profile['device'])} device operations, "
            f"device busy {profile['busy_us'] / 1e6:.4f} s of "
            f"{profile['window_us'] / 1e6:.4f} s")
    for b in rep["bad"][:5]:
        log(f"wrong buffer #{b[0]} (step {b[1]}, {b[2]}): {', '.join(b[3])}")
    for s in bad_steps[:5]:
        log(f"wrong operators in step {s[0]} at #{s[1]}: {s[2]} where "
            f"{s[3]} was wanted")
    if wrong_reports:
        log(f"wrong reports: {wrong_reports}")
    if rep["lost_frees"]:
        log(f"{rep['lost_frees']} frees of tensors never allocated")

    checks = {
        "logit_err": [err, cell.limits["logit_err"]],
        "bad_operators": [len(bad_steps), 0],
        "bad_buffers": [len(rep["bad"]), 0],
        "buffer_gap": [abs(len(rep["buffers"]) - expected), 0],
        "bad_reports": [len(wrong_reports), 0],
    }
    return result, checks
