"""Drive the PyTorch port of PASTA on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases, one line of findings each (a failed phase makes the script exit
non-zero and print no result):

  1. build    — compile the four CUDA kernels from
                ``src/repro_torch/kernels/csrc``, in parallel;
  2. main     — the analysis path (``repro_torch.launch.analyze.run``) on
                glm4-9b at full width and depth for 4 steps, on the card; the
                fused kernel must launch once per TRACE_BUFFER event; then
                the same forward uninstrumented, for the slowdown;
  3. families — the same path on zamba2-7b (hybrid) and mamba2-2.7b (ssm) at
                full width and depth, and dbrx-132b (moe) at full width with
                its depth cut to 4 of 40 layers (one card's memory); then the
                eager half of examples/quickstart.py (kernel_freq,
                workingset, timeline) on zamba2-7b;
  4. in-kernel — the fine-grained tier: ``matmul_traced`` on glm4-9b's
                layer-0 projections (bf16) against a 128-token activation,
                each trace handed to a session as one TRACE_BUFFER, as
                tests/test_instrumented_kernel.py does; all four on the
                wgmma body; traces equal to the plain version's, products
                within the float32 bound of the float64 product and
                bitwise equal across two calls; timed with a cold L2 (a
                256 MiB write between calls) and warm, against the plain
                version, ``torch.mm(out_dtype=float32)`` on the bf16
                operands and ``torch.matmul`` in float32; then the same
                products with float32 operands on the simt body, checked
                and timed cold;
  5. fallback — a fine session without a hotness map (launches the object
                histogram kernel) and one whose hotness map is too large to
                fuse (launches the object and hotness kernels), each held
                against the same session on the CPU; notes the largest
                trace buffer;
  6. kernels  — each trace kernel against its plain PyTorch version on the
                card, at the main path's shapes and at edge cases (equal
                counts required; also the worst contention, 2**24 - 1
                records over several clusters, out-of-range bins and
                blocks, and for the hotness kernel maps just within and
                just beyond one block's shared memory and 8 MiB); one call
                of each kernel at the shapes it runs at must be one device
                operation (no fill); timed on the device with
                ``torch.profiler`` and per call with CUDA events: the object
                and fused kernels at the main path's largest buffer, records
                in ascending runs and shuffled, the hotness kernel at phase
                5's map and largest buffer and at the main path's map;
  7. cpu      — the same ``run`` on reduced glm4-9b, zamba2-7b, mamba2-2.7b
                and dbrx-132b on the card and on the CPU: equal reports; and
                each model's logits on the card against the CPU on the same
                weights;
  8. profile  — one more step of glm4-9b and of zamba2-7b under
                ``torch.profiler``, with host spans around the
                instrumenter's layers: where the host and device time go and
                the device's idle share (a traced run, so its wall time
                includes the tracing);
  9. archs    — (run after phase 3) the analysis path, as phase 2, on
                the six other architectures in bf16 compute: stablelm-1.6b,
                gemma-7b and musicgen-large at full width and depth,
                qwen3-32b and qwen2-vl-72b at full width with their depth
                cut to keep the float32 weights under 60 GB, kimi-k2 at full
                width with one MoE layer (384 experts, bf16);
 10. train    — (run after phase 9) three steps of ``make_train_step`` on
                stablelm-1.6b at full width and depth (batch 2 x 64,
                float32 weights and moments): finite loss, grad_norm > 0,
                moved weights, step time and peak memory; then one float32
                step of reduced stablelm-1.6b on the card against the same
                step on the CPU;
 11. quickstart — (run last) ``repro_torch.launch.quickstart`` on reduced
                and then full paper-gpt2: the eager half launches the
                object-histogram kernel, the compiled half captures the
                train step's device kernels (cuBLAS GEMMs and elementwise
                kernels, not aten names), the roofline report has bytes and
                FLOPs; and the capture's own cost, the profiled step against
                the plain one.

Every time and memory size of phases 9-11 is printed beside the card's
name and power limit.  Then one JSON line of kernels, the card's name and
power limit, and the result line.  Launch counts are reset just before
each path runs and read just after; the comparisons of phases 4 and 6 run
outside those windows.
"""

from __future__ import annotations

import dataclasses
import gc
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12       # H100 SXM device memory rate (data sheet)
BF16_FLOPS = 989e12             # H100 SXM dense bf16 tensor-core peak
FP32_FLOPS = 67e12              # H100 SXM float32 peak outside the tensor cores
STEPS = 4
SEED = 0
DBRX_LAYERS = 4                 # of 40: 57 GB of float32 weights at width
#: depth cuts of phase 9 (float32 weights under 60 GB; kimi-k2: one MoE
#: layer, 38.8 GB of bf16 weights)
ARCH_LAYERS = {"stablelm-1.6b": None, "gemma-7b": None,
               "musicgen-large": None, "qwen3-32b": 24, "qwen2-vl-72b": 14,
               "kimi-k2-1t-a32b": 1}
CARD = ""                       # "name, power limit", set by main()


def fail(msg: str) -> None:
    print(f"FAIL {msg}", flush=True)
    sys.exit(1)


if not torch.cuda.is_available():
    fail("torch.cuda.is_available() is false: this script needs a CUDA card")

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "src"))
import repro_torch.configs as configs                      # noqa: E402
import repro_torch.core as pasta                           # noqa: E402
from repro_torch.core.instrument import EagerInstrumenter  # noqa: E402
from repro_torch.core.pool import MemoryPool               # noqa: E402
from repro_torch.core.processor import EventProcessor      # noqa: E402
from repro_torch.core.tools import LocatorTool             # noqa: E402
from repro_torch.kernels import build, ops, ref            # noqa: E402
from repro_torch.kernels import instrumented_matmul as im  # noqa: E402
from repro_torch.launch import analyze                     # noqa: E402
from repro_torch.core import capture                       # noqa: E402
from repro_torch.launch import quickstart as qs             # noqa: E402
from repro_torch.models import forward, init_params        # noqa: E402
from repro_torch.train import OptConfig, make_train_step   # noqa: E402
from repro_torch.train.optimizer import (init_opt_state,   # noqa: E402
                                         tree_paths)


def cuda_ms(fn, iters: int = 50) -> float:
    """Time per call of ``fn()`` over ``iters`` back-to-back calls between
    two CUDA events, after a warm-up.  At these sizes it includes the host's
    work per call (launch, allocation) where that is slower than the
    device."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(iters):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / iters


def device_ms(fn, iters: int = 50, tries: int = 3):
    """Device time per call of everything ``fn()`` launches (kernels,
    memsets, copies), from the CUPTI records of ``torch.profiler``.  Every
    call runs the same device operations, so a window whose record count is
    not a multiple of ``iters`` lost records and is taken again; None when
    no window of ``tries`` was whole or the profiler saw no device
    activity."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        dev = [e.time_range.elapsed_us() for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
        if dev and len(dev) % iters == 0:
            return sum(dev) / iters / 1e3
    return None


def timed(kern, plain, lib, iters: int = 50) -> dict:
    """Device and per-call times of a kernel's wrapper, its plain version
    and its library yardstick (None when there is none), in the order
    plain, kernel, kernel, plain; device times fall back to CUDA events
    when the profiler records no device activity."""
    calls = [cuda_ms(f, iters) for f in (plain, kern, kern, plain)]
    dev = [device_ms(f, iters) for f in (plain, kern, kern, plain)]
    lib_call = cuda_ms(lib, iters) if lib is not None else None
    lib_dev = device_ms(lib, iters) if lib is not None else None
    timing = "profiler"
    if None in dev or (lib is not None and lib_dev is None):
        timing, dev, lib_dev = "cuda_events", calls, lib_call
    return {"ms": min(dev[1], dev[2]), "plain_ms": min(dev[0], dev[3]),
            "library_ms": lib_dev, "timing": timing,
            "call_ms": min(calls[1], calls[2]),
            "plain_call_ms": min(calls[0], calls[3]),
            "library_call_ms": lib_call}


def free_card() -> None:
    gc.collect()
    torch.cuda.empty_cache()


class TraceShapes:
    """Observer of a run: counts TRACE_BUFFER events, sums their analysis
    time, keeps the largest one's object table (N = sum of its object
    counts, since every record lies in a live tensor) and notes when the
    steps start (after the weights are made)."""

    def __init__(self):
        self.events = 0
        self.records = 0
        self.analysis_s = 0.0
        self.largest = None          # (n_records, objects)
        self.t_steps = None

    def __call__(self, session):
        session.handler.subscribe(self._on, kinds=("trace_buffer",))
        torch.cuda.synchronize()
        self.t_steps = time.perf_counter()

    def _on(self, ev):
        self.events += 1
        self.analysis_s += ev.attrs["analysis_s"]
        n = int(np.sum(ev.attrs["object_counts"]))
        self.records += n
        objs = ev.attrs["objects"]
        if self.largest is None or (n, len(objs)) > (self.largest[0],
                                                     len(self.largest[1])):
            self.largest = (n, list(objs))


# ------------------------------------------------------------------ phase 1
def phase_build() -> None:
    t0 = time.perf_counter()
    built = build.build_all()
    for name in ops.launches:
        build.load(name)
    print(f"build: {len(built)} kernels compiled by nvcc for sm_90a in "
          f"{time.perf_counter() - t0:.1f} s ({', '.join(built) or 'cached'})",
          flush=True)
    if len(ops.launches) != 4:
        fail(f"build: expected four kernels, have {list(ops.launches)}")


# ---------------------------------------------------------------- phases 2-3
def drive(cfg, label: str):
    """The analysis path on ``cfg`` at full width for STEPS steps, its
    checks, and the same forward uninstrumented.  Returns (facts, params,
    tokens); the caller frees the weights."""
    hot = analyze.hotness_config(cfg, STEPS)
    shapes = TraceShapes()
    free_card()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    ops.reset_launches()
    t0 = time.perf_counter()
    reports, logits, schedule = analyze.run(cfg, STEPS, "cuda", hot,
                                            seed=SEED, observe=shapes)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    launched = dict(ops.launches)
    wall, steps_s = t1 - t0, t1 - shapes.t_steps
    w, h = reports["workingset"], reports["hotness"]
    print(f"{label}: {cfg.name} full width, {cfg.n_layers} layers, d_model "
          f"{cfg.d_model}, vocab {cfg.vocab_size}, {cfg.n_params / 1e9:.2f} B "
          f"params, {STEPS} steps in {wall:.2f} s ({steps_s:.2f} s after "
          f"making the weights); {shapes.events} trace buffers, analysis_s "
          f"{shapes.analysis_s:.3f}; launches {launched}; hotness "
          f"{hot['n_tbins']}x{hot['n_blocks']} blocks of "
          f"{(512 << hot['block_shift']) >> 20} MiB", flush=True)
    print(f"{label} report: working set max={w['working_set_mb']:.2f}MB "
          f"median={w['median_ws_mb']:.2f}MB footprint="
          f"{w['footprint_mb']:.1f}MB; hotness persistent="
          f"{len(h['persistent_blocks'])} bursty={len(h['bursty_blocks'])} "
          f"cold={h['cold_blocks']} accesses={h['total_accesses']}; "
          f"locator {reports['locator'].get('kernel')}; "
          f"{len(schedule)} scheduled operators", flush=True)
    if launched["trace_aggregate"] != shapes.events or shapes.events == 0:
        fail(f"{label}: fused kernel launched {launched['trace_aggregate']} "
             f"times for {shapes.events} trace buffers")
    if launched["object_histogram"] or launched["hotness_histogram"] \
            or launched["instrumented_matmul"]:
        fail(f"{label}: other kernels launched on the fused path {launched}")
    if tuple(logits.shape) != (2, 64, cfg.vocab_size) \
            or not bool(torch.isfinite(logits).all()):
        fail(f"{label}: logits {tuple(logits.shape)} not finite or "
             "misshapen")
    if not 0 < h["total_accesses"] or w["working_set_mb"] <= 0:
        fail(f"{label}: empty reports")
    # the map covers the parameter bytes, so no record falls outside it
    if h["total_accesses"] != shapes.records:
        fail(f"{label}: hotness map holds {h['total_accesses']} of "
             f"{shapes.records} records")
    del logits, reports
    free_card()
    # the same forward without instrumentation: the analysis overhead
    params, x = analyze.make_inputs(cfg, SEED, "cuda")
    plain = []
    with torch.inference_mode():
        for _ in range(STEPS + 1):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            forward(params, x, cfg)
            torch.cuda.synchronize()
            plain.append(time.perf_counter() - t0)
    plain_step = float(np.median(plain[1:]))         # first one warms up
    step = steps_s / STEPS
    print(f"{label} overhead: instrumented step {step * 1e3:.1f} ms vs "
          f"uninstrumented forward {plain_step * 1e3:.2f} ms (median of "
          f"{STEPS}): {step / plain_step:.1f}x; analysis_s per trace buffer "
          f"{shapes.analysis_s / shapes.events * 1e3:.3f} ms; peak device "
          f"memory {torch.cuda.max_memory_allocated() / 1e9:.1f} GB",
          flush=True)
    facts = {"launches": launched["trace_aggregate"], "hot": hot,
             "largest": shapes.largest}
    return facts, params, x


def phase_main():
    """glm4-9b; returns the path's facts and layer 0's four projection
    weights in bf16, with a 2 x 64-token activation for each width."""
    cfg = configs.get("glm4-9b")
    facts, params, x = drive(cfg, "main")
    dt = torch.bfloat16
    with torch.inference_mode():
        lay = params["layers"]
        wq = lay["attn"]["wq"][0].reshape(cfg.d_model, cfg.q_dim).to(dt)
        w_gate = lay["mlp"]["w_gate"][0].to(dt)
        w_up = lay["mlp"]["w_up"][0].to(dt)
        w_down = lay["mlp"]["w_down"][0].to(dt)
        lm_head = params["lm_head"].to(dt)
        h = params["embed"][x].to(dt).reshape(-1, cfg.d_model)
        f = (torch.nn.functional.silu(h @ w_gate) * (h @ w_up)).contiguous()
    del params, x, w_up
    free_card()
    proj = [("wq", h, wq), ("w_gate", h, w_gate), ("w_down", f, w_down),
            ("lm_head", h, lm_head)]
    return facts, proj


def quickstart(cfg, params, x) -> int:
    """The eager half of examples/quickstart.py on the card; returns the
    object-histogram launches, which must equal its trace buffers."""
    buffers = []
    torch.cuda.synchronize()
    ops.reset_launches()
    with torch.inference_mode():
        with pasta.Session(tools="kernel_freq,workingset,timeline",
                           instrument=True, fine=True, buffered=True,
                           torch_device="cuda",
                           name="quickstart") as session:
            session.handler.subscribe(buffers.append,
                                      kinds=("trace_buffer",))
            with pasta.region("forward"):
                logits, _ = forward(params, x, cfg)
    torch.cuda.synchronize()
    launched = dict(ops.launches)
    del logits
    reports = session.reports()
    tl, ws, kf = reports["timeline"], reports["workingset"], \
        reports["kernel_freq"]
    d = tl["devices"][0]
    print(f"quickstart: {cfg.name} full width, one forward in a "
          f"kernel_freq,workingset,timeline session: timeline peak "
          f"{tl['peak_bytes'][d]} B, allocs {tl['alloc_events'][d]}, frees "
          f"{tl['free_events'][d]}; workingset footprint="
          f"{ws['footprint_mb']:.1f}MB ws={ws['working_set_mb']:.2f}MB "
          f"median={ws['median_ws_mb']:.2f}MB; kernel_freq total "
          f"{kf['total_invocations']}; {len(buffers)} trace buffers; "
          f"launches {launched}", flush=True)
    if launched["object_histogram"] != len(buffers) or not buffers \
            or launched["trace_aggregate"] or launched["hotness_histogram"]:
        fail(f"quickstart: launches {launched} for {len(buffers)} trace "
             "buffers")
    if tl["peak_bytes"][d] <= 0 or ws["working_set_mb"] <= 0:
        fail("quickstart: empty reports")
    return launched["object_histogram"]


def phase_families() -> dict:
    """zamba2-7b, mamba2-2.7b at full width and depth, dbrx-132b at full
    width and DBRX_LAYERS layers; the quickstart session on zamba2-7b."""
    out = {"launches": {}, "quickstart": 0}
    runs = [(configs.get("zamba2-7b"), "hybrid"),
            (configs.get("mamba2-2.7b"), "ssm"),
            (dataclasses.replace(configs.get("dbrx-132b"),
                                 n_layers=DBRX_LAYERS), "moe")]
    for cfg, label in runs:
        if cfg.name == "dbrx-132b":
            print(f"moe: dbrx-132b depth cut to {cfg.n_layers} of 40 layers "
                  f"({cfg.n_params * 4 / 1e9:.1f} GB of float32 weights)",
                  flush=True)
        facts, params, x = drive(cfg, label)
        out["launches"][cfg.name] = facts["launches"]
        if cfg.name == "zamba2-7b":
            out["quickstart"] = quickstart(cfg, params, x)
        del params, x
        free_card()
    return out


# ------------------------------------------------------------------ phase 4
FLUSH_BYTES = 256 << 20         # written between calls: five times the L2
FLUSH_KERNEL = "bitwise_not"    # in the name of the flush's kernel


def cold_ms(fn, flush, iters: int = 10, tries: int = 3):
    """Device time per call of ``fn()`` with a cold L2: before each call
    ``flush()`` rewrites FLUSH_BYTES with a ``bitwise_not`` kernel.  Only
    ``fn``'s own device records count: the flush's are known by their
    kernel's name, and records that start before the first flush (late
    ones from calls outside the window) are left out.  A window that did
    not record every flush, or nothing of ``fn``, lost records and is taken
    again, as in ``device_ms``; None when no window of ``tries`` was
    whole."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                flush()
                fn()
            torch.cuda.synchronize()
        dev = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
        flushes = [e for e in dev if FLUSH_KERNEL in e.name]
        if len(flushes) != iters:
            continue
        t0 = min(e.time_range.start for e in flushes)
        us = sum(e.time_range.elapsed_us() for e in dev
                 if FLUSH_KERNEL not in e.name and e.time_range.start >= t0)
        if us > 0:
            return us / iters / 1e3
    return None


def mm_bf16(x, w):
    """The library call computing the kernel's function: bf16 operands,
    float32 accumulation and result (``aten::mm.dtype``)."""
    return torch.mm(x, w, out_dtype=torch.float32)


def phase_in_kernel(proj) -> dict:
    """The in-kernel tier's path, then its checks and times."""
    seen = []
    torch.cuda.synchronize()
    ops.reset_launches()
    results = []
    with pasta.Session(tools=(), torch_device="cuda",
                       name="in-kernel") as session:
        session.handler.subscribe(seen.append, kinds=("trace_buffer",))
        for name, x, w in proj:
            out, trace = im.matmul_traced(x, w)
            tr = trace.cpu().numpy()
            session.handler.trace_buffer(
                tr, name=name, kernel="matmul_traced",
                bytes_read=int(tr[:, 2].sum()),
                bytes_written=int(tr[:, 3].sum()))
            results.append((out, trace))
    torch.cuda.synchronize()
    launches = ops.launches["instrumented_matmul"]
    bodies = dict(im.bodies)
    plans = {name: im._plan(x.shape[0], x.shape[1], w.shape[1], x.dtype,
                            im._resident(x.device))
             for name, x, w in proj}
    print(f"in-kernel: {len(proj)} matmul_traced calls on glm4-9b layer-0 "
          f"projections, {len(seen)} trace buffers, launches {launches}, "
          f"bodies {bodies}, plans (body, split) {plans}; clusters the card "
          f"holds at once by split {im._resident(proj[0][1].device)}",
          flush=True)
    if launches != len(proj) or len(seen) != len(proj):
        fail(f"in-kernel: {launches} launches and {len(seen)} trace "
             f"buffers for {len(proj)} calls")
    if bodies != {"wgmma": len(proj), "simt": 0}:
        fail(f"in-kernel: bodies {bodies}; every bf16 product of the path "
             "must run on the wgmma body")

    flush_buf = torch.empty(FLUSH_BYTES // 4, dtype=torch.int32,
                            device="cuda")

    def flush():
        flush_buf.bitwise_not_()

    err_max, timings, by_product = 0.0, set(), {}
    keys = ["ms", "plain_ms", "library_ms", "library_f32_ms", "warm_ms",
            "plain_warm_ms", "library_warm_ms", "library_f32_warm_ms",
            "call_ms", "plain_call_ms", "library_call_ms", "bound_ms"]
    sums = dict.fromkeys(keys, 0.0)
    for (name, x, w), (out, trace), ev in zip(proj, results, seen):
        m, k = x.shape
        n = w.shape[1]
        gi, gj = m // im.BM, n // im.BN
        want_read = gi * gj * (im.BM * k * x.itemsize + k * im.BN * w.itemsize)
        if ev.attrs["bytes_read"] != want_read:
            fail(f"in-kernel {name}: bytes_read {ev.attrs['bytes_read']} != "
                 f"{want_read}")
        if not torch.equal(trace, im.matmul_traced_ref(x, w)[1]):
            fail(f"in-kernel {name}: trace differs from the plain version's")
        if not torch.equal(out, im.matmul_traced(x, w)[0]):
            fail(f"in-kernel {name}: two calls on the same operands differ")
        # float64 product on the card; the kernel's float32 FMA sum over K
        # terms is within gamma_K * |x|@|w|, gamma_K = K*u / (1 - K*u)
        exact = x.double() @ w.double()
        err = (out.double() - exact).abs()
        del exact
        gamma = k * 2.0**-24 / (1 - k * 2.0**-24)
        bound = gamma * (x.double().abs() @ w.double().abs())
        within = bool((err <= bound).all())
        worst = float((err / bound.clamp_min(1e-300)).max())
        e = float(err.max())
        del err, bound
        err_max = max(err_max, e)
        if not within or not bool(torch.isfinite(out).all()):
            fail(f"in-kernel {name}: out off the float64 product by {e} "
                 f"({worst:.3f} of the float32 bound)")
        xf, wf = x.float(), w.float()
        kern = lambda: im.matmul_traced(x, w)            # noqa: E731
        plain = lambda: im.matmul_traced_ref(x, w)       # noqa: E731
        lib = lambda: mm_bf16(x, w)                      # noqa: E731
        lib32 = lambda: torch.matmul(xf, wf)             # noqa: E731
        warm = timed(kern, plain, lib, iters=10)
        warm32 = timed(lib32, lib32, None, iters=10)
        cold = {key: cold_ms(f, flush) for key, f in
                (("ms", kern), ("plain_ms", plain), ("library_ms", lib),
                 ("library_f32_ms", lib32))}
        if None in cold.values():
            fail(f"in-kernel {name}: the profiler did not record the cold-L2 "
                 f"calls ({cold})")
        # the SIMT body on the same operands in float32 (the body float32
        # operands take): its trace exact, its product within the float32
        # bound, timed cold like the rest
        out32, trace32 = im.matmul_traced(xf, wf)
        err32 = (out32.double() - xf.double() @ wf.double()).abs()
        bound32 = gamma * (xf.double().abs() @ wf.double().abs())
        if not torch.equal(trace32, im.matmul_traced_ref(xf, wf)[1]) \
                or not bool((err32 <= bound32).all()):
            fail(f"in-kernel {name}: the float32 (simt) body is off its "
                 "plain version's trace or the float32 bound")
        del out32, trace32, err32, bound32
        simt = cold_ms(lambda: im.matmul_traced(xf, wf), flush)
        if simt is None:
            fail(f"in-kernel {name}: the profiler did not record the "
                 "float32 calls")
        del xf, wf
        flops = 2 * m * n * k
        nbytes = x.numel() * x.itemsize + w.numel() * w.itemsize \
            + m * n * 4 + gi * gj * 16
        bound_ms = max(flops / BF16_FLOPS, nbytes / HBM_BYTES_PER_S) * 1e3
        nbytes32 = 4 * (x.numel() + w.numel()) + m * n * 4 + gi * gj * 16
        simt_bound = max(flops / FP32_FLOPS, nbytes32 / HBM_BYTES_PER_S) * 1e3
        row = {**cold, "warm_ms": warm["ms"], "plain_warm_ms": warm["plain_ms"],
               "library_warm_ms": warm["library_ms"],
               "library_f32_warm_ms": warm32["ms"],
               "call_ms": warm["call_ms"], "plain_call_ms": warm["plain_call_ms"],
               "library_call_ms": warm["library_call_ms"], "bound_ms": bound_ms,
               "split": plans[name][1],
               "simt_f32": {"ms": simt, "bound_ms": simt_bound,
                            "bound_by": "operations",
                            "library_ms": cold["library_f32_ms"]}}
        by_product[name] = row
        timings.add(f"cold profiler, warm {warm['timing']}")
        for key in sums:
            sums[key] += row[key]
        l2 = " (below the HBM bound: an L2 reading)" \
            if row["warm_ms"] < bound_ms else ""
        print(f"in-kernel {name} ({m}, {k}) @ ({k}, {n}) bf16, split "
              f"{plans[name][1]}: cold-L2 device ms kernel {row['ms']:.5f} "
              f"bound {bound_ms:.5f} (bytes; {row['ms'] / bound_ms:.2f}x) "
              f"plain {row['plain_ms']:.5f} torch.mm bf16->f32 "
              f"{row['library_ms']:.5f} torch.matmul f32 "
              f"{row['library_f32_ms']:.5f} (profiler); warm-L2 device "
              f"ms kernel {row['warm_ms']:.5f}{l2} plain "
              f"{row['plain_warm_ms']:.5f} torch.mm {row['library_warm_ms']:.5f}"
              f" torch.matmul f32 {row['library_f32_warm_ms']:.5f} "
              f"({warm['timing']}); per call (events) kernel "
              f"{row['call_ms']:.5f}; max abs err {e:.3e} vs float64, "
              f"{worst:.4f} of the float32 bound; bitwise equal across two "
              f"calls; {flops / row['ms'] / 1e9:.1f} TFLOP/s cold; float32 "
              f"operands on the simt body: cold-L2 device ms {simt:.5f} bound "
              f"{simt_bound:.5f} (operations at 67 TFLOP/s) torch.matmul f32 "
              f"{row['library_f32_ms']:.5f}", flush=True)
        free_card()
    del flush_buf
    free_card()
    shapes = ", ".join(f"{nm} ({x.shape[0]}x{x.shape[1]}x{w.shape[1]})"
                       for nm, x, w in proj)
    return {"name": "instrumented_matmul", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/instrumented_matmul.cu",
            "replaces": "src/repro/kernels/instrumented_matmul.py:29",
            "launches": launches, "max_abs_err": err_max, **sums,
            "bound_by": "bytes", "timing": "/".join(sorted(timings)),
            "aggregate": "sum over the four products; ms, plain_ms, "
                         "library_ms and library_f32_ms with a cold L2",
            "library": "torch.mm(x, w, out_dtype=torch.float32) on the bf16 "
                       "operands; library_f32_ms: torch.matmul on the "
                       "operands widened to float32",
            "bodies": bodies, "by_product": by_product,
            "path": "in-kernel tier (glm4-9b layer-0 projections)",
            "shapes": shapes}


# ------------------------------------------------------------------ phase 5
def _fine_session(cfg, device, hotness):
    """A fine-grained session over reduced glm4-9b; returns its reports and
    the largest trace buffer's record count."""
    params, x = analyze.make_inputs(cfg, SEED, "cpu")
    tools = ["workingset"]
    if hotness is not None:
        tools.append(pasta.HotnessTool(n_tbins=hotness["n_tbins"],
                                       n_blocks=hotness["n_blocks"]))
    moved, xd = _to(params, device), x.to(device)
    session = pasta.Session(tools=tools, hotness=hotness, instrument=True,
                            fine=True, torch_device=device,
                            name=f"fallback/{device}")
    # time bins from the step, not the wall clock, so card and CPU agree
    session.instrumenter.time_source = \
        lambda: float(max(session.handler._step, 0))
    sizes = [0]
    session.handler.subscribe(
        lambda ev: sizes.append(int(np.sum(ev.attrs["object_counts"]))),
        kinds=("trace_buffer",))
    with torch.inference_mode(), session:
        for s in range(2):
            session.handler.step_start(s)
            forward(moved, xd, cfg)
            session.handler.step_end(s)
    return session.reports().data, max(sizes)


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    return tree.to(device)


def phase_fallback() -> dict:
    cfg = configs.reduced(configs.get("glm4-9b"))
    big = {"base": pasta.CHUNK_ALIGN, "n_blocks": 32768, "n_tbins": 64,
           "t_max": 2.0, "block_shift": 5}
    if ops.can_fuse(64, big["n_blocks"], big["n_tbins"], device="cuda"):
        fail("fallback: can_fuse accepted an 8 MiB hotness map")
    counts = {"largest": 0, "map": big}
    for label, hotness in (("no-hotness", None), ("unfusable", big)):
        torch.cuda.synchronize()
        ops.reset_launches()
        got, largest = _fine_session(cfg, "cuda", hotness)
        torch.cuda.synchronize()
        launched = dict(ops.launches)
        want, _ = _fine_session(cfg, "cpu", hotness)
        counts["largest"] = max(counts["largest"], largest)
        print(f"fallback {label}: launches {launched}; largest trace buffer "
              f"{largest} records; reports equal to the CPU's: "
              f"{got == want}", flush=True)
        if got != want:
            fail(f"fallback {label}: card {got} != cpu {want}")
        if launched["object_histogram"] == 0 or launched["trace_aggregate"]:
            fail(f"fallback {label}: wrong kernels launched {launched}")
        if hotness is not None and launched["hotness_histogram"] == 0:
            fail(f"fallback {label}: hotness kernel never launched")
        for k, v in launched.items():
            counts[k] = counts.get(k, 0) + v
    # every record of a buffer lies in a live tensor, so N is its counts' sum
    if counts["largest"] <= 0:
        fail("fallback: no trace buffer with records")
    return counts


# ------------------------------------------------------------------ phase 6
def _units(x) -> torch.Tensor:
    return torch.from_numpy(np.asarray(x, dtype=np.int32)).cuda()


def _trace(rng, n, objects, misses=True):
    """``n`` records inside ``objects`` (unit ranges) plus edge records:
    below the first start, at/after the last end, negative, and in the gaps
    and empty ranges."""
    starts = np.asarray([s for s, _ in objects], dtype=np.int64)
    sizes = np.asarray([max(e - s, 1) for s, e in objects], dtype=np.int64)
    pick = rng.integers(0, len(objects), size=n)
    a = starts[pick] + rng.integers(0, sizes[pick])
    if misses and n >= 16:
        a[::7] = starts[0] - 1 - rng.integers(0, 1000, size=a[::7].shape)
        a[3::11] = objects[-1][1] + rng.integers(0, 1000,
                                                 size=a[3::11].shape)
        a[5::13] = -1 - rng.integers(0, 1 << 20, size=a[5::13].shape)
        a[1::17] = objects[-1][1]
    return a


def _objects(rng, k, empty_every=0):
    """``k`` sorted disjoint unit ranges; every ``empty_every``-th is empty
    and gaps are 0 or 64 units, so empty ranges may share a start with the
    next object."""
    sizes = rng.integers(1, 8192, size=k)
    if empty_every:
        sizes[::empty_every] = 0
    gaps = rng.integers(0, 2, size=k) * 64
    starts = 4096 + np.cumsum(np.concatenate([[0], (sizes + gaps)[:-1]]))
    return [(int(s), int(s + z)) for s, z in zip(starts, sizes)]


def _compare(name, got, want) -> int:
    got = [g.cpu() for g in (got if isinstance(got, tuple) else (got,))]
    want = [w.cpu() for w in (want if isinstance(want, tuple) else (want,))]
    if any(g.shape != w.shape for g, w in zip(got, want)):
        fail(f"kernels: {name} has another shape than its plain version")
    err = max(int((g.long() - w.long()).abs().max()) if g.numel() else 0
              for g, w in zip(got, want))
    if err:
        fail(f"kernels: {name} differs from its plain version by {err}")
    return err


def fused_cases(rng, objs, base, shift, n_blocks) -> int:
    """The fused kernel's own edge cases: every record in one object and
    one map cell (the worst contention), the largest buffer the wrapper
    takes (several clusters merging), and time bins and blocks out of
    range.  Returns the number of cases."""
    s = _units([o[0] for o in objs])
    e = _units([o[1] for o in objs])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    big = max(range(len(objs)), key=lambda i: objs[i][1] - objs[i][0])
    cases = []
    for n in (1, 45878, 300000):
        cases.append((f"one object, one cell, n={n}",
                      np.full(n, objs[big][0]), np.full(n, 3), n_blocks,
                      shift))
    n = 2**24 - 1
    cases.append((f"n={n}, {ops.fused_plan(n, sms)[0]} clusters",
                  _trace(rng, n, objs), rng.integers(0, 4, size=n), n_blocks,
                  shift))
    for n in (7, 65537):
        a = _trace(rng, n, objs)
        a[::5] = -2**31
        a[1::5] = 2**31 - 1
        cases.append((f"out-of-range bins and blocks, n={n}", a,
                      rng.integers(-3, 7, size=n), 300, 4))
    for label, a, tb, nb, sh in cases:
        a, tb = _units(a), _units(tb)
        _compare(f"trace_aggregate {label}",
                 ops.trace_aggregate_t(a, tb, s, e, base, nb, 4, sh),
                 ref.trace_aggregate_ref(a, tb, s, e, base, nb, 4, sh))
    return len(cases)


def _spread_shift(objs, n_blocks) -> int:
    """The least block shift at which ``n_blocks`` blocks from the first
    object's start cover every object."""
    span = objs[-1][1] - objs[0][0]
    return max(0, (span // n_blocks).bit_length())


def histogram_cases(rng, objs) -> int:
    """The object and hotness kernels' own edge cases, each kernel against
    its plain version: every record in one object and one map cell (the
    worst contention); maps just within and just beyond one block's shared
    memory and the fallback's 8 MiB map (one cluster, owner tiles or global
    atomics); time bins and blocks out of range; the largest buffer the
    wrapper takes.  Returns the number of cases."""
    s = _units([o[0] for o in objs])
    e = _units([o[1] for o in objs])
    base = objs[0][0]
    per_block = torch.cuda.get_device_properties(
        0).shared_memory_per_block_optin // 4
    maps = ((4, 2241), (1, per_block), (1, per_block + 1), (64, 32768))
    big = max(range(len(objs)), key=lambda i: objs[i][1] - objs[i][0])
    cases = []
    for n in (1, 45878, 300000):
        for tb_n, nb in (maps[0], maps[3]):
            cases.append((f"one object, one cell, n={n} {tb_n}x{nb}",
                          np.full(n, objs[big][0]), np.full(n, 3), tb_n, nb,
                          base, 15))
    for n in (1000, 45878):
        for tb_n, nb in maps:
            cases.append((f"n={n} {tb_n}x{nb}", _trace(rng, n, objs),
                          rng.integers(0, tb_n, size=n), tb_n, nb, base,
                          _spread_shift(objs, nb)))
    for n in (7, 65537):
        for tb_n, nb in ((4, 300), (4, 14529), (64, 32768)):
            a = _trace(rng, n, objs)
            a[::5] = -2**31
            a[1::5] = 2**31 - 1
            cases.append((f"out-of-range bins and blocks, n={n} {tb_n}x{nb}",
                          a, rng.integers(-3, tb_n + 3, size=n), tb_n, nb,
                          base + 6000, 4))
    n = 2**24 - 1
    a = _trace(rng, n, objs)
    for tb_n, nb in (maps[0], maps[3]):
        cases.append((f"n={n} {tb_n}x{nb}", a, rng.integers(0, tb_n, size=n),
                      tb_n, nb, base, _spread_shift(objs, nb)))
    for label, a, tb, tb_n, nb, hbase, sh in cases:
        a, tb = _units(a), _units(tb)
        _compare(f"object_histogram {label}", ops.object_histogram_t(a, s, e),
                 ref.object_histogram_ref(a, s, e))
        _compare(f"hotness_histogram {label}",
                 ops.hotness_histogram_t(a, tb, hbase, nb, tb_n, sh),
                 ref.hotness_histogram_ref(a, tb, hbase, nb, tb_n, sh))
    return 2 * len(cases)


def device_ops(fn) -> list:
    """Names of the device operations (kernels, memsets, copies) one call
    of ``fn()`` runs, from the profiler's records."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                          ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [e.name for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA]


def _variant(label, kern, plain, lib, nbytes) -> dict:
    """Times of a kernel at one more input, with its bound."""
    t = timed(kern, plain, lib)
    t["bound_ms"] = nbytes / HBM_BYTES_PER_S * 1e3
    print(f"kernel {label}: device ms kernel={t['ms']:.5f} plain="
          f"{t['plain_ms']:.5f} library={t['library_ms']} bound="
          f"{t['bound_ms']:.6f}; per call (events) kernel={t['call_ms']:.5f}",
          flush=True)
    return t


def phase_kernels(main, fallback, families) -> list:
    rng = np.random.default_rng(SEED)
    hot = main["hot"]
    base = hot["base"] >> ops.UNIT_SHIFT
    shift, n_blocks, n_tbins = hot["block_shift"], hot["n_blocks"], \
        hot["n_tbins"]
    n_main, objs_bytes = main["largest"]
    objs_main = [(int(s) >> ops.UNIT_SHIFT, int(e) >> ops.UNIT_SHIFT)
                 for s, e in objs_bytes]

    # edge cases first: counts must be equal, nothing is timed
    cases = 0
    for n in (0, 1, 1000, 65536, 65537):
        for k in (1, 16, 300, 3000, 25000):      # 12*25000 B > shared memory
            objs = _objects(rng, k, empty_every=5 if k > 4 else 0)
            a = _units(_trace(rng, n, objs))
            s = _units([o[0] for o in objs])
            e = _units([o[1] for o in objs])
            _compare(f"object_histogram n={n} k={k}",
                     ops.object_histogram_t(a, s, e),
                     ref.object_histogram_ref(a, s, e))
            cases += 1
        for tb_n, nb, sh in ((1, 1, 0), (4, 2241, 15), (16, 512, 5),
                             (64, 32768, 5), (4, 4096, 12)):
            a = _units(_trace(rng, n, objs_main))
            tb = _units(rng.integers(-1, tb_n + 1, size=n))
            _compare(f"hotness_histogram n={n} {tb_n}x{nb}",
                     ops.hotness_histogram_t(a, tb, base, nb, tb_n, sh),
                     ref.hotness_histogram_ref(a, tb, base, nb, tb_n, sh))
            cases += 1
            k = len(objs_main)
            if not ops.can_fuse(k, nb, tb_n):
                continue            # the two kernels above cover it
            s = _units([o[0] for o in objs_main])
            e = _units([o[1] for o in objs_main])
            _compare(f"trace_aggregate n={n} k={k} {tb_n}x{nb}",
                     ops.trace_aggregate_t(a, tb, s, e, base, nb, tb_n, sh),
                     ref.trace_aggregate_ref(a, tb, s, e, base, nb, tb_n,
                                             sh))
            cases += 1
    cases += fused_cases(rng, objs_main, base, shift, n_blocks)
    cases += histogram_cases(rng, objs_main)
    print(f"kernels: {cases} edge cases equal to the plain versions "
          "(counts compared exactly)", flush=True)

    # timing at the main path's largest trace buffer: records in ascending
    # runs, the order in which the instrumenter emits a buffer (consecutive
    # addresses of one tensor after another), and the same records in
    # random order
    k = len(objs_main)
    a_np = _trace(rng, n_main, objs_main, misses=False)
    a = _units(a_np)
    a_runs = _units(np.sort(a_np))
    tb = _units(np.full(n_main, n_tbins - 1))
    s = _units([o[0] for o in objs_main])
    e = _units([o[1] for o in objs_main])
    cells = n_tbins * n_blocks

    def obj_bins(x):           # what torch.bincount counts for the objects
        idx = torch.searchsorted(s, x, right=True) - 1
        return idx[(idx >= 0) & (x < e[idx.clamp(0, k - 1)])].long()

    blk = (a_runs - base) >> shift
    okb = (blk >= 0) & (blk < n_blocks)
    hot_bins = (tb[okb].long() * n_blocks + blk[okb])
    bins_runs, bins_random = obj_bins(a_runs), obj_bins(a)
    shapes = f"N={n_main} K={k} map {n_tbins}x{n_blocks}"
    # the hotness kernel's own launches: phase 5's unfusable map at its
    # largest buffer, records in runs spread over the map
    fb = fallback["map"]
    n_fb, fb_tbins, fb_blocks = fallback["largest"], fb["n_tbins"], \
        fb["n_blocks"]
    fb_base, fb_shift = objs_main[0][0], _spread_shift(objs_main, fb_blocks)
    a_fb = _units(np.sort(_trace(rng, n_fb, objs_main, misses=False)))
    tb_fb = _units(np.full(n_fb, fb_tbins - 1))
    fb_cells = fb_tbins * fb_blocks
    fb_bins = (fb_tbins - 1) * fb_blocks + ((a_fb - fb_base) >> fb_shift).long()
    fb_shapes = f"N={n_fb} map {fb_tbins}x{fb_blocks}"
    fb_plan = ops.hotness_plan(n_fb, fb_tbins, fb_blocks,
                               ops._sms(a.device), ops._smem_optin(a.device))
    fused_paths = {"glm4-9b": main["launches"], **families["launches"]}
    obj_call = lambda: ops.object_histogram_t(a_runs, s, e)      # noqa: E731
    hot_call = lambda: ops.hotness_histogram_t(                  # noqa: E731
        a_fb, tb_fb, fb_base, fb_blocks, fb_tbins, fb_shift)
    hot_main = lambda: ops.hotness_histogram_t(                  # noqa: E731
        a_runs, tb, base, n_blocks, n_tbins, shift)
    fused_call = lambda: ops.trace_aggregate_t(                  # noqa: E731
        a_runs, tb, s, e, base, n_blocks, n_tbins, shift)
    rows = [
        ("object_histogram", "src/repro_torch/kernels/csrc/object_histogram.cu",
         "src/repro/kernels/trace_aggregate.py:35", shapes, obj_call,
         lambda: ref.object_histogram_ref(a_runs, s, e),
         lambda: torch.bincount(bins_runs, minlength=k),
         4 * n_main + 8 * k + 4 * k,
         {"fallback": fallback["object_histogram"],
          "quickstart zamba2-7b": families["quickstart"]}),
        ("hotness_histogram",
         "src/repro_torch/kernels/csrc/hotness_histogram.cu",
         "src/repro/kernels/hotness.py:30", f"{fb_shapes} ({fb_plan.kind})",
         hot_call,
         lambda: ref.hotness_histogram_ref(a_fb, tb_fb, fb_base, fb_blocks,
                                           fb_tbins, fb_shift),
         lambda: torch.bincount(fb_bins, minlength=fb_cells),
         8 * n_fb + 4 * fb_cells,
         {"fallback (can_fuse false)": fallback["hotness_histogram"]}),
        ("trace_aggregate", "src/repro_torch/kernels/csrc/trace_aggregate.cu",
         "src/repro/kernels/trace_aggregate.py:73", shapes, fused_call,
         lambda: ref.trace_aggregate_ref(a_runs, tb, s, e, base, n_blocks,
                                         n_tbins, shift),
         None, 8 * n_main + 8 * k + 4 * k + 4 * cells, fused_paths),
    ]
    # one device operation per call: no fill in front of a kernel that
    # writes its whole output
    for name, call, where in (("object_histogram_t", obj_call, shapes),
                              ("hotness_histogram_t", hot_call, fb_shapes),
                              ("hotness_histogram_t", hot_main,
                               f"N={n_main} map {n_tbins}x{n_blocks}"),
                              ("trace_aggregate_t", fused_call, shapes)):
        one = device_ops(call)
        print(f"kernels: one {name} call at {where} runs {len(one)} device "
              f"operation(s): {one}", flush=True)
        if len(one) != 1:
            fail(f"kernels: one {name} call ran {len(one)} device operations")
    # N = 0: the launch, set-up and write-out alone, what no buffer avoids
    none = a_runs[:0]
    variants = {
        "object_histogram": {"random order": (
            lambda: ops.object_histogram_t(a, s, e),
            lambda: ref.object_histogram_ref(a, s, e),
            lambda: torch.bincount(bins_random, minlength=k),
            4 * n_main + 8 * k + 4 * k), "N=0": (
            lambda: ops.object_histogram_t(none, s, e),
            lambda: ref.object_histogram_ref(none, s, e),
            lambda: torch.bincount(bins_runs[:0], minlength=k), 8 * k + 4 * k)},
        "hotness_histogram": {f"N={n_main} map {n_tbins}x{n_blocks}": (
            hot_main,
            lambda: ref.hotness_histogram_ref(a_runs, tb, base, n_blocks,
                                              n_tbins, shift),
            lambda: torch.bincount(hot_bins, minlength=cells),
            8 * n_main + 4 * cells), f"N=0 map {fb_tbins}x{fb_blocks}": (
            lambda: ops.hotness_histogram_t(none, none, fb_base, fb_blocks,
                                            fb_tbins, fb_shift),
            lambda: ref.hotness_histogram_ref(none, none, fb_base, fb_blocks,
                                              fb_tbins, fb_shift),
            lambda: torch.bincount(fb_bins[:0], minlength=fb_cells),
            4 * fb_cells)},
        "trace_aggregate": {"random order": (
            lambda: ops.trace_aggregate_t(a, tb, s, e, base, n_blocks,
                                          n_tbins, shift),
            lambda: ref.trace_aggregate_ref(a, tb, s, e, base, n_blocks,
                                            n_tbins, shift),
            None, 8 * n_main + 8 * k + 4 * k + 4 * cells)},
    }
    out = []
    for name, src, replaces, where, kern, plain, lib, nbytes, paths in rows:
        err = _compare(f"{name} at {where}", kern(), plain())
        row = {"name": name, "route": "cuda", "source": src,
               "replaces": replaces, "launches": sum(paths.values()),
               "max_abs_err": err}
        row.update(timed(kern, plain, lib))
        bound = nbytes / HBM_BYTES_PER_S * 1e3
        row.update({"bound_ms": bound, "bound_by": "bytes",
                    "launches_by_path": paths, "shapes": where,
                    "order": "records in ascending runs, as emitted"})
        print(f"kernel {name} at {where}: device ms kernel={row['ms']:.5f} "
              f"plain={row['plain_ms']:.5f} library={row['library_ms']} "
              f"bound={bound:.6f}; per call (events) kernel="
              f"{row['call_ms']:.5f} plain={row['plain_call_ms']:.5f} "
              f"library={row['library_call_ms']}; launches {paths}",
              flush=True)
        row["variants"] = {}
        for label, (vk, vp, vl, vb) in variants[name].items():
            _compare(f"{name} {label}", vk(), vp())
            row["variants"][label] = _variant(f"{name} {label}", vk, vp, vl,
                                              vb)
        out.append(row)
    return out


# ------------------------------------------------------------------ phase 7
def phase_cpu() -> None:
    for arch in ("glm4-9b", "zamba2-7b", "mamba2-2.7b", "dbrx-132b"):
        cfg = configs.reduced(configs.get(arch))
        buffers = []
        ops.reset_launches()
        card, _l, sched_card = analyze.run(
            cfg, STEPS, "cuda", seed=SEED,
            observe=lambda s: s.handler.subscribe(buffers.append,
                                                  kinds=("trace_buffer",)))
        torch.cuda.synchronize()
        fused = ops.launches["trace_aggregate"]
        cpu, _l, sched_cpu = analyze.run(cfg, STEPS, "cpu", seed=SEED)
        same = card.data == cpu.data and \
            [(k.name, k.tensors) for k in sched_card] == \
            [(k.name, k.tensors) for k in sched_cpu]
        # model numerics: the same weights on the card and on the CPU
        params, x = analyze.make_inputs(cfg, SEED, "cpu")
        with torch.inference_mode():
            want = forward(params, x, cfg)[0]
            got = forward(_to(params, "cuda"), x.cuda(), cfg)[0].cpu()
        # float32 throughout (TF32 off); sums are ordered differently
        err = float((got - want).abs().max())
        close = torch.allclose(got, want, rtol=1e-4, atol=1e-4)
        print(f"cpu: reduced {arch} reports card == cpu: {same} (fused "
              f"launches {fused} for {len(buffers)} trace buffers); logits "
              f"max abs diff card vs cpu {err:.3e} (rtol=atol=1e-4: "
              f"{close})", flush=True)
        if not same:
            fail(f"cpu {arch}: reports differ: card {card.data} cpu "
                 f"{cpu.data}")
        if fused != len(buffers):
            fail(f"cpu {arch}: {fused} fused launches for {len(buffers)} "
                 "trace buffers")
        if not close:
            fail(f"cpu {arch}: logits differ by {err}")


# ------------------------------------------------------------------ phase 8
def _busy_us(intervals) -> float:
    """Length of the union of (start, end) intervals."""
    busy, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e > end:
            busy += e - max(s, end)
            end = e
    return busy


class HostSpans:
    """Wall-clock totals of the analysis path's layers, by wrapping their
    methods for the duration of a ``with`` block."""

    LAYERS = (("forward", analyze, "forward"),
              ("op", EagerInstrumenter, "op"),
              ("pool alloc", MemoryPool, "alloc"),
              ("trace emission", EagerInstrumenter, "_emit_trace"),
              ("trace reduction", EventProcessor, "_preprocess_trace"),
              ("locator stack capture", LocatorTool, "_capture_stack"),
              ("frees", EagerInstrumenter, "_on_free"))

    def __init__(self):
        self.totals = dict.fromkeys([name for name, *_ in self.LAYERS], 0.0)
        self._orig = []

    def _wrap(self, name, fn):
        def timed_fn(*args, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kw)
            finally:
                self.totals[name] += time.perf_counter() - t0
        return timed_fn

    def __enter__(self):
        for name, cls, attr in self.LAYERS:
            fn = getattr(cls, attr)
            self._orig.append((cls, attr, fn))
            setattr(cls, attr, self._wrap(name, fn))
        return self

    def __exit__(self, *exc):
        for cls, attr, fn in self._orig:
            setattr(cls, attr, fn)


def phase_profile(cfg) -> None:
    from torch.profiler import ProfilerActivity, profile
    hot = analyze.hotness_config(cfg, STEPS)
    shapes = TraceShapes()
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    t = []

    def observe(session):        # after set-up, before the first step
        shapes(session)
        prof.start()
        t.append(time.perf_counter())
    free_card()
    with HostSpans() as spans:
        analyze.run(cfg, 1, "cuda", hot, seed=SEED, observe=observe)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t[0]) * 1e6
        prof.stop()
    free_card()
    dev = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    groups = {"trace kernels": ("_histogram_", "trace_aggregate_kernel"),
              "memcpy": ("memcpy",), "memset": ("memset",)}
    sums = dict.fromkeys([*groups, "model and other"], 0.0)
    for e in dev:
        name = e.name.lower()
        key = next((g for g, keys in groups.items()
                    if any(k in name for k in keys)), "model and other")
        sums[key] += e.time_range.elapsed_us()
    busy = _busy_us((e.time_range.start, e.time_range.end) for e in dev)
    parts = ", ".join(f"{k} {v / 1e3:.2f} ms" for k, v in sums.items())
    host = ", ".join(f"{k} {v * 1e3:.1f} ms"
                     for k, v in spans.totals.items())
    print(f"profile: one {cfg.name} full-width step (traced), wall "
          f"{wall_us / 1e3:.1f} ms, {shapes.events} trace buffers; host "
          f"spans: {host}, analysis_s {shapes.analysis_s * 1e3:.1f} ms; "
          f"device busy {busy / 1e3:.2f} ms, idle share "
          f"{1 - busy / wall_us:.4f}; device time by kind: {parts}",
          flush=True)
    if not dev:
        print("profile: the profiler recorded no device activity",
              flush=True)


# ------------------------------------------------------------------ phase 9
def phase_archs() -> dict:
    """stablelm-1.6b, gemma-7b, musicgen-large, qwen3-32b, qwen2-vl-72b and
    kimi-k2 on the analysis path (ARCH_LAYERS: depth cuts)."""
    launches = {}
    for arch, n_layers in ARCH_LAYERS.items():
        cfg = configs.get(arch)
        if n_layers is not None:
            itemsize = torch.tensor([], dtype=getattr(
                torch, cfg.param_dtype)).element_size()
            cfg = dataclasses.replace(cfg, n_layers=n_layers)
            print(f"archs: {arch} depth cut to {n_layers} of "
                  f"{configs.get(arch).n_layers} layers (at most "
                  f"{cfg.n_params * itemsize / 1e9:.1f} GB of "
                  f"{cfg.param_dtype} weights)", flush=True)
        facts, params, x = drive(cfg, f"archs {cfg.family}")
        print(f"archs {arch}: the times above on {CARD}", flush=True)
        launches[arch] = facts["launches"]
        del params, x
        free_card()
    return launches


# ----------------------------------------------------------------- phase 10
#: card against CPU, reduced float32, two steps at lr 1e-3 from step 1: the
#: update of every weight leaf within this share of its norm on the CPU
#: (float32 against float64 on the CPU: 3.3e-4 at most)
UPDATE_RTOL = 1e-3


def _sample(params) -> list:
    """Copies of at most 4096 evenly strided elements of each weight leaf:
    enough to see a leaf move, without a second copy of the weights."""
    return [leaf.detach().flatten()[::max(1, leaf.numel() // 4096)].clone()
            for _p, leaf in tree_paths(params)]


def _train(cfg, device, steps, init_on="cpu", opt_cfg=None, sample=False):
    """``steps`` train steps of ``cfg`` on ``device`` from weights seeded on
    ``init_on`` and a seeded 2 x 64 batch: (the first weights on the CPU,
    or with ``sample`` a sample of each leaf; the last weights; metrics per
    step; seconds per step)."""
    opt_cfg = opt_cfg or OptConfig()
    params = _to(init_params(cfg, SEED, init_on), device)
    gen = torch.Generator().manual_seed(SEED + 1)
    x = torch.randint(0, cfg.vocab_size, (2, 64), generator=gen,
                      dtype=torch.int32).to(device)
    labels = torch.randint(0, cfg.vocab_size, (2, 64), generator=gen,
                           dtype=torch.int32).to(device)
    step = make_train_step(cfg, opt_cfg, microbatches=1)
    state = init_opt_state(params, opt_cfg)
    first = _sample(params) if sample else _to(params, "cpu")
    metrics, secs = [], []
    for _ in range(steps):
        if device == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, state, m = step(params, state,
                                {"inputs": x, "labels": labels})
        m = {k: float(v) for k, v in m.items()}
        secs.append(time.perf_counter() - t0)
        metrics.append(m)
    return first, params, metrics, secs


def phase_train() -> None:
    cfg = configs.get("stablelm-1.6b")
    free_card()
    torch.cuda.reset_peak_memory_stats()
    first, last, metrics, secs = _train(cfg, "cuda", 3, init_on="cuda",
                                        sample=True)
    peak = torch.cuda.max_memory_allocated()
    moved = sum(not torch.equal(a, b) for a, b in zip(first, _sample(last)))
    n_leaves = len(first)
    del first, last
    free_card()
    losses = [m["loss"] for m in metrics]
    print(f"train: {cfg.name} full width and depth ({cfg.n_params / 1e9:.2f} "
          f"B params, float32 weights and moments, bf16 compute), 3 steps "
          f"of batch 2 x 64: loss {losses}, grad_norm "
          f"{[m['grad_norm'] for m in metrics]}, lr "
          f"{[m['lr'] for m in metrics]}; {moved} of {n_leaves} weight "
          f"leaves moved (a sample of each); step times "
          f"{[round(t * 1e3, 1) for t in secs]} ms (the first includes "
          f"warm-up), peak device memory of the steps {peak / 1e9:.2f} GB, "
          f"on {CARD}", flush=True)
    if not all(np.isfinite(losses)) or not all(m["grad_norm"] > 0
                                               for m in metrics):
        fail(f"train: loss {losses} or grad_norm not finite and positive")
    if moved == 0:
        fail("train: no weight moved")
    # two float32 steps of the reduced model, card against CPU: both losses
    # (the second reads the updated weights) and every leaf's update
    small = configs.reduced(cfg)
    opt_cfg = OptConfig(lr=1e-3, warmup_steps=1)
    w0, card_w, card, _s = _train(small, "cuda", 2, opt_cfg=opt_cfg)
    _w, cpu_w, cpu, _s = _train(small, "cpu", 2, opt_cfg=opt_cfg)
    rel = [abs(c["loss"] / h["loss"] - 1) for c, h in zip(card, cpu)]
    worst, worst_abs = 0.0, 0.0
    for (path, w), (_q, got), (_r, want) in zip(
            tree_paths(w0), tree_paths(card_w), tree_paths(cpu_w)):
        got = got.cpu().double()
        want, w = want.double(), w.double()
        diff, update = float((got - want).norm()), float((want - w).norm())
        worst = max(worst, diff / update if update else
                    (0.0 if diff == 0 else float("inf")))
        worst_abs = max(worst_abs, float((got - want).abs().max()))
    print(f"train: reduced {cfg.name} two float32 steps at lr 1e-3, loss "
          f"card {[c['loss'] for c in card]} cpu {[h['loss'] for h in cpu]} "
          f"(relative {max(rel):.3e}), grad_norm card "
          f"{[c['grad_norm'] for c in card]} cpu "
          f"{[h['grad_norm'] for h in cpu]}; weights after both steps: "
          f"largest |update(card) - update(cpu)| / |update(cpu)| of a leaf "
          f"{worst:.3e} (limit {UPDATE_RTOL:g}), largest element "
          f"difference {worst_abs:.3e}", flush=True)
    if max(rel) > 1e-4:
        fail(f"train: reduced loss card vs cpu differs by {max(rel):.3e}")
    if not worst <= UPDATE_RTOL:
        fail(f"train: reduced weights' update card vs cpu differs by "
             f"{worst:.3e} of its norm")


# ----------------------------------------------------------------- phase 11
def phase_quickstart() -> dict:
    """The port's quickstart on the card, reduced then full paper-gpt2;
    returns the object-histogram launches of each eager half."""
    out = {}
    for label, cfg in (("reduced", configs.reduced(
            configs.get("paper-gpt2"))), ("full", configs.get("paper-gpt2"))):
        buffers = []
        torch.cuda.synchronize()
        ops.reset_launches()
        reports, artifact, stats = qs.run(
            cfg, "cuda", observe=lambda s: s.handler.subscribe(
                buffers.append, kinds=("trace_buffer",)))
        torch.cuda.synchronize()
        launched = dict(ops.launches)
        kf = reports["kernel_freq"]
        names = [m["opcode"] for m in stats.kernel_meta.values()]
        print(f"quickstart {label} paper-gpt2 ({cfg.n_params / 1e6:.1f} M "
              f"params): eager half {len(buffers)} trace buffers, launches "
              f"{launched}; compiled half: total_invocations "
              f"{kf['total_invocations']}, distinct {kf['distinct_kernels']}, "
              f"{len(names)} kernel records, warnings {stats.warnings}, "
              f"top {[(n[:60], c) for n, c in kf['top'][:5]]}; FLOPs "
              f"{stats.flops:.4g}, bytes {stats.hbm_bytes:.4g}; timeline "
              f"peak {reports['timeline']['peak_bytes']}", flush=True)
        if launched["object_histogram"] != len(buffers) or not buffers \
                or launched["trace_aggregate"] \
                or launched["hotness_histogram"]:
            fail(f"quickstart {label}: launches {launched} for "
                 f"{len(buffers)} trace buffers")
        if artifact.device != "cuda" or not names \
                or any(n.startswith("aten::") for n in names) \
                or not any("gemm" in n.lower() for n in names) \
                or not any("elementwise" in n.lower() for n in names):
            fail(f"quickstart {label}: captured kernel names are not the "
                 f"device's cuBLAS GEMMs and elementwise kernels: "
                 f"{sorted(set(names))[:20]}")
        if kf["total_invocations"] != sum(stats.kernel_counts.values()) * 5:
            fail(f"quickstart {label}: kernel_freq total "
                 f"{kf['total_invocations']} is not 5 x the launches")
        with pasta.Session(tools="roofline", torch_device="cuda",
                           name="roofline") as session:
            session.capture_compiled(
                artifact, label="train_step", steps=5,
                cost_analysis={"flops": stats.flops * 5})
        rl = session.reports()["roofline"]
        print(f"quickstart {label} roofline (H100 data-sheet peaks, 5 "
              f"steps): {rl.data}", flush=True)
        if not rl["hbm_bytes"] > 0 or not rl["flops"] > 0:
            fail(f"quickstart {label}: roofline without bytes or FLOPs "
                 f"{rl.data}")
        out[f"quickstart paper-gpt2 {label}"] = launched["object_histogram"]
        del reports, artifact
        free_card()
    # the capture's own cost on full paper-gpt2: the plain step against
    # the profiled one, on the same weights and batch
    cfg = configs.get("paper-gpt2")
    params = init_params(cfg, SEED, "cuda")
    opt_cfg = OptConfig()
    state = init_opt_state(params, opt_cfg)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    batch = {k: torch.randint(0, cfg.vocab_size, (2, 64), generator=gen,
                              dtype=torch.int32, device="cuda")
             for k in ("inputs", "labels")}
    step = make_train_step(cfg, opt_cfg, microbatches=1)
    plain = []
    for _ in range(4):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(params, state, batch)
        torch.cuda.synchronize()
        plain.append(time.perf_counter() - t0)
    profiled = []
    for _ in range(2):
        t0 = time.perf_counter()
        artifact = capture.capture_step(step, params, state, batch)
        t1 = time.perf_counter()
        capture.analyze(artifact)
        profiled.append((artifact.seconds, t1 - t0,
                         time.perf_counter() - t1, artifact.lost,
                         len(artifact.launches)))
    plain_s = float(np.median(plain[1:]))
    call_s = min(p[0] for p in profiled)
    print(f"quickstart capture cost, full paper-gpt2 train step: plain "
          f"{plain_s * 1e3:.2f} ms (median of 3 after one warm-up), "
          f"profiled call {call_s * 1e3:.2f} ms ({call_s / plain_s:.1f}x), "
          f"capture with profiler teardown "
          f"{min(p[1] for p in profiled) * 1e3:.1f} ms, analyze "
          f"{min(p[2] for p in profiled) * 1e3:.2f} ms; (lost, recorded) "
          f"device operations per capture {[p[3:] for p in profiled]}; on "
          f"{CARD}",
          flush=True)
    del params, state, artifact
    free_card()
    return out


def profiler_probe(when: str) -> None:
    """Print how many of one fill's and one negation's two device records
    a profiler session keeps (a short session late in this process has
    been seen to keep fewer: PERF.md section 7)."""
    n = len(device_ops(lambda: torch.ones(1 << 20, device="cuda").neg_()))
    print(f"profiler {when}: one fill and one negation record {n} device "
          "operations (2 expected)", flush=True)


def main() -> None:
    global CARD
    CARD = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True, timeout=60).stdout.strip()
    # float32 stays float32 on the card (cuDNN would default to TF32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    phase_build()
    main_run, proj = phase_main()
    families = phase_families()
    profiler_probe("before phase 4")
    in_kernel = phase_in_kernel(proj)
    del proj
    free_card()
    fallback = phase_fallback()
    kernels = phase_kernels(main_run, fallback, families) + [in_kernel]
    phase_cpu()
    phase_profile(configs.get("glm4-9b"))
    phase_profile(configs.get("zamba2-7b"))
    # phases 9-11 run after the phases timed by the profiler; their
    # launches join the fused kernel's and the object histogram's paths
    rows = {r["name"]: r for r in kernels}
    rows["trace_aggregate"]["launches_by_path"].update(phase_archs())
    phase_train()
    profiler_probe("before the captures")
    rows["object_histogram"]["launches_by_path"].update(phase_quickstart())
    profiler_probe("after the captures")
    for name in ("trace_aggregate", "object_histogram"):
        rows[name]["launches"] = sum(rows[name]["launches_by_path"].values())
    print(f"total: {time.perf_counter() - t0:.1f} s", flush=True)
    print(json.dumps({"kernels": kernels}))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    print(smi.stdout.strip())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
