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
                products with float32 operands on the simt body (its split
                and loader printed), each trace equal to the plain
                version's, within the float32 bound and bitwise equal
                across two calls, timed cold with its sum pass apart,
                beside the plain version and ``torch.matmul`` in float32;
                and the simt body's other branches (float32 K = 4098 and
                K = 4, bf16 K = 100, a misaligned float32 x) held the same
                way;
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
                the plain one; before and after it, how many of one fill's
                and one negation's device records a short profiler session
                keeps, by this script's probe and by plain
                ``torch.profiler`` with no code of the port;
 12. serving  — (run after phase 11) ``repro_torch.launch.serve`` on
                glm4-9b at full width and depth with the example's traffic
                (8 requests at 2 req/s on 4 slots, a 16-token shared
                prefix, 24 new tokens at temperature 0.8): every request
                finishes, prefix hits, no bytes copied, only the prefix
                store holds blocks after the drain, the ``serving`` and
                ``kernel_freq`` reports are there and the latter names
                device kernels; the same trace at rate 0 twice gives the
                same tokens; one 12280-token prompt (prefill in the
                blocked attention, decodes over a 12k paged window), its
                layer-0 blocked attention held against the dense one on
                one KV-head group; zamba2-7b at full width and depth (4
                requests, 2 slots, the slot pool); then reduced paper-gpt2
                (paged), mamba2-2.7b, zamba2-7b and dbrx-132b in float32,
                the card's tokens against the CPU's;
 13. dist     — (run after phase 12) distributed training on one NCCL
                rank per card, spawned with a ``FileStore`` and a timeout on the
                join; the ranks' launches of the four kernels must be 0.
                With one card: each collective of ``dist/collectives.py``
                on the world-1 group against its plain version (exact),
                one stablelm-1.6b step on a (1, 1) mesh against the plain
                step (bit for bit), and ``repro_torch.launch.train`` on
                stablelm-1.6b (full width and depth unless the disk cannot
                hold two checkpoints or write them in 240 s, which its
                probe measures first), 4 steps with a checkpoint every 2
                and a failure at step 3, whose losses must equal an
                uninterrupted run's bit for bit (deterministic algorithms);
                the multi-rank collectives are not exercised at world 1.
                With four: glm4-9b at full width and depth on data 2 x
                model 2 (3 steps, one captured step's NCCL kernels and
                wire bytes) and on data 1 x model 4 (its 2 KV heads stay
                whole on every card, its 32 query heads split 8 a card;
                the first step's loss and grad norm within
                ``MODEL4_RTOL`` of the 2 x 2 step's), stablelm-1.6b on pod
                2 x data 2 in the three explicit sync modes against the
                single-card step, and the GPipe ring on pipe 4 against the
                layers in sequence.
 15. mesh serving — (run after phase 13, before phase 14) the engine on
                a mesh, one NCCL rank per card, spawned with a
                ``FileStore`` and a timeout on the join.  With four cards:
                ``python3 -m repro_torch.launch.serve --devices 4 --mesh
                1x4 --arch qwen3-32b`` at full width and depth with
                phase 12's traffic (every request finishes, the prefix
                store hits, no bytes copied, ``config.mesh`` is "1x4",
                the captured decode's collectives are NCCL kernels;
                tokens/s, TTFT and TPOT, decode ticks and the placement's
                peak a card); glm4-9b on data 2 x model 2 and zamba2-7b on
                data 1 x model 4, float32 compute, 4 requests at rate 0,
                8 greedy tokens each, against the same on one card: equal
                tokens, the first decode tick's logits within
                ``MESH_LOGIT_RTOL``; the phase within 300 s.  With one
                card: glm4-9b on a (1, 1) mesh (DTensor weights and
                pools, the engine's clock and plan messages on a world-1
                group) against the plain engine.  No trace kernel may
                launch.
 16. speculative decoding on a mesh — (run after phase 15, before phase
                14) ``spec_decode=2`` with ``draft="model"``, one NCCL rank
                per card.  With four cards: glm4-9b at full width and
                depth, float32 compute, on data 2 x model 2, phase 15's
                4 requests at rate 0, once drafting for itself and once
                with a 2-layer draft drawn placed from seed 1, against
                the same two on one card and the plain engine there: equal
                greedy tokens, drafted and accepted counts equal to one
                card's on every rank; then ``python3 -m
                repro_torch.launch.serve --devices 4 --mesh 1x4 --arch
                qwen3-32b`` with phase 12's flags followed by 4 requests,
                16 greedy tokens, ``--spec-decode 2 --draft model`` (the
                target drafts for itself): every request finishes, a
                draft is accepted, the placement peak within 2 GB of
                phase 15's; the phase within 240 s.  With one card:
                glm4-9b on a (1, 1) mesh with both drafts against the
                plain engine with the same drafts.  No trace kernel may
                launch.
 14. static   — (run last, in a child process: phase 13 ran real process
                groups) the static half: ``repro_torch.launch.lint``'s
                smoke grid with fake CUDA tensors must exit 0 green and 1
                with each seeded defect (reshard, blocking); dry-run cells
                on the fake 16 x 16 mesh (qwen3-32b train_4k, prefill_32k,
                decode_32k; mamba2-2.7b long_500k) print their trace time,
                state bytes per device and roofline terms, and their
                FLOPs, HBM bytes and collective bytes per device beside
                the reference's (XLA:CPU, ROADMAP.md section 3), qwen3-32b
                train_4k and prefill_32k at most 1.25x its FLOPs; kimi-k2
                train_4k on 2 x 16 x 16 runs in a child of its own, kept
                if it ends within 10 minutes; the peak estimate of a
                full-width stablelm-1.6b train step against
                ``torch.cuda.max_memory_allocated`` of the step run (0.8 to
                1.2), at one microbatch and at two, whose measured peak
                may be at most 1.01x the one-microbatch step's (a step
                freeing each microbatch's gradients once summed); glm4-9b
                at full width, 16 greedy decodes through the
                two-tier KV cache against the dense one (equal tokens).
                No trace kernel may launch.

Every time and memory size of phases 9-16 is printed beside the card's
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
    # on both streams: a caller that keeps only the end of one still sees it
    print(f"FAIL {msg}", flush=True)
    print(f"FAIL {msg}", file=sys.stderr, flush=True)
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
from repro_torch.launch import serve                       # noqa: E402
from repro_torch.models import layers                      # noqa: E402
from repro_torch.serve import SamplingParams, ServeEngine  # noqa: E402
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


def cold_parts_ms(fn, flush, iters: int = 10, tries: int = 3):
    """Device time per call of ``fn()`` with a cold L2, by kernel name:
    before each call ``flush()`` rewrites FLUSH_BYTES with a
    ``bitwise_not`` kernel.  Only ``fn``'s own device records count: the
    flush's are known by their kernel's name, and records that start
    before the first flush (late ones from calls outside the window) are
    left out.  A window that did not record every flush, or nothing of
    ``fn``, lost records and is taken again, as in ``device_ms``; None when
    no window of ``tries`` was whole."""
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
        parts: dict = {}
        for e in dev:
            if FLUSH_KERNEL not in e.name and e.time_range.start >= t0:
                parts[e.name] = parts.get(e.name, 0.0) \
                    + e.time_range.elapsed_us() / iters / 1e3
        if sum(parts.values()) > 0:
            return parts
    return None


def cold_ms(fn, flush, iters: int = 10, tries: int = 3):
    """The sum of :func:`cold_parts_ms`: every device record of one call."""
    parts = cold_parts_ms(fn, flush, iters, tries)
    return None if parts is None else sum(parts.values())


def simt_check(label: str, x, w) -> float:
    """Two calls of ``matmul_traced`` on the simt body: the trace equal to
    the plain version's, ``out`` finite and within gamma_K * |x|@|w| of the
    float64 product (gamma_K = K*u / (1 - K*u), u = 2**-24: a float32 FMA
    sum over K terms in any order, split or not), the two calls bitwise
    equal.  Fails on a miss; returns the largest |err| / bound."""
    out, trace = im.matmul_traced(x, w)
    again, _ = im.matmul_traced(x, w)
    k = x.shape[1]
    if not torch.equal(trace, im.matmul_traced_ref(x, w)[1]):
        fail(f"{label}: trace differs from the plain version's")
    if not torch.equal(out, again):
        fail(f"{label}: two calls on the same operands differ")
    err = (out.double() - x.double() @ w.double()).abs()
    gamma = k * 2.0**-24 / (1 - k * 2.0**-24)
    bound = gamma * (x.double().abs() @ w.double().abs())
    worst = float((err / bound.clamp_min(1e-300)).max())
    if not bool((err <= bound).all()) or not bool(torch.isfinite(out).all()):
        fail(f"{label}: out off the float64 product ({worst:.3f} of the "
             "float32 bound)")
    return worst


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
        # operands take): its plan, its checks (simt_check), timed cold like
        # the rest, the split's sum pass apart
        split32, loader32 = im._simt_plan(m, k, n, ops._sms(xf.device),
                                          xf.dtype)
        worst32 = simt_check(f"in-kernel {name} float32 (simt)", xf, wf)
        parts = cold_parts_ms(lambda: im.matmul_traced(xf, wf), flush)
        plain32 = cold_ms(lambda: im.matmul_traced_ref(xf, wf), flush)
        if parts is None or plain32 is None:
            fail(f"in-kernel {name}: the profiler did not record the "
                 "float32 calls")
        simt = sum(parts.values())
        simt_sum = sum(v for kname, v in parts.items()
                       if "matmul_traced_sum" in kname)
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
                            "library_ms": cold["library_f32_ms"],
                            "plain_ms": plain32,
                            "split": split32, "loader": loader32,
                            "sum_ms": simt_sum,
                            "sum_share": simt_sum / simt,
                            "worst_of_bound": worst32}}
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
              f"operands on the simt body (split {split32}, loader "
              f"{loader32}): cold-L2 device ms {simt:.5f} (sum pass "
              f"{simt_sum:.5f}, {simt_sum / simt:.4f} of it) bound "
              f"{simt_bound:.5f} (operations at 67 TFLOP/s; "
              f"{simt / simt_bound:.2f}x) plain {plain32:.5f} torch.matmul f32 "
              f"{row['library_f32_ms']:.5f} "
              f"({simt / row['library_f32_ms']:.2f}x); {worst32:.4f} of the "
              f"float32 bound, bitwise equal across two calls", flush=True)
        free_card()
    del flush_buf
    free_card()
    branches = simt_branches()
    simt_sums = {key: sum(r["simt_f32"][key] for r in by_product.values())
                 for key in ("ms", "bound_ms", "plain_ms", "library_ms",
                             "sum_ms")}
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
            "simt_f32": simt_sums, "simt_branches": branches,
            "path": "in-kernel tier (glm4-9b layer-0 projections)",
            "shapes": shapes}


def simt_branches() -> dict:
    """The simt body's branches off the four float32 products, each
    through :func:`simt_check`: float32 with K = 4098 (scalar loader,
    split), K = 4 (one slab), bf16 with K = 100 (scalar, widened) and a
    float32 x at a 16-byte-misaligned address (storage offset 1, scalar);
    with the compiler's and the occupancy API's facts of each instance."""
    dev = torch.device("cuda")
    info = {f"{dt}/{loader}": im._simt_info(dev, dt, loader)
            for dt, loader in ((torch.float32, "async"),
                               (torch.float32, "scalar"),
                               (torch.bfloat16, "scalar"))}
    print(f"in-kernel simt instances (registers, spilled bytes, shared "
          f"bytes a block, blocks an SM): {info}", flush=True)
    g = torch.Generator(device="cuda").manual_seed(SEED)

    def rnd(shape, dt=torch.float32):
        return torch.randn(shape, generator=g, device="cuda").to(dt)

    m, n = 128, 512
    cases = [("float32 K=4098", rnd((m, 4098)), rnd((4098, n)), "scalar"),
             ("float32 K=4", rnd((m, 4)), rnd((4, n)), "async"),
             ("bf16 K=100", rnd((m, 100), torch.bfloat16),
              rnd((100, n), torch.bfloat16), "scalar"),
             ("float32 x misaligned", rnd((m * 4096 + 1,))[1:].view(m, 4096),
              rnd((4096, n)), "scalar")]
    out = {"instances": info}
    for label, x, w, want in cases:
        k = x.shape[1]
        aligned = x.data_ptr() % 16 == 0 and w.data_ptr() % 16 == 0
        split, loader = im._simt_plan(m, k, n, ops._sms(dev), x.dtype,
                                      aligned)
        body = im._plan(m, k, n, x.dtype, im._resident(dev), aligned)[0]
        if loader != want or body != "simt":
            fail(f"in-kernel simt {label}: body {body}, loader {loader}; "
                 f"expected simt, {want}")
        worst = simt_check(f"in-kernel simt {label}", x, w)
        out[label] = {"split": split, "loader": loader,
                      "worst_of_bound": worst}
        print(f"in-kernel simt {label} ({m}, {k}) @ ({k}, {n}): split "
              f"{split}, loader {loader}; trace equal to the plain version's,"
              f" {worst:.4f} of the float32 bound, bitwise equal across two "
              f"calls", flush=True)
    return out


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


# ----------------------------------------------------------------- phase 12
#: the example's traffic (examples/serve_lm.py) without --reduced
SERVE_EXAMPLE = ["--num-requests", "8", "--max-slots", "4", "--rate", "2",
                 "--prompt-len", "32", "--shared-prefix", "16",
                 "--prefix-block", "8", "--max-new-tokens", "24",
                 "--temperature", "0.8"]
LONG_PROMPT = 12280             # max_seq 12288 = 12 chunks of 1024
#: bf16 blocked against dense attention, relative to max|v|
#: (tests/test_torch_decode.py: BF16_BLOCKED_REL)
BF16_BLOCKED_REL = 2 ** -6
#: phase 7's float32 logit tolerance (rtol = atol)
F32_LOGIT_TOL = 1e-4


def _serve(arch: str, argv: list, params):
    """One run of the port's serve launcher on the card; returns its result,
    engine and reports after checking that every request finished with
    its tokens, that the reports are there and that no trace kernel ran
    (the serving path reduces no trace buffer)."""
    torch.cuda.synchronize()
    ops.reset_launches()
    res = serve.run(serve.parse_args(["--arch", arch, "--device", "cuda",
                                      *argv]), params=params)
    torch.cuda.synchronize()
    launched = dict(ops.launches)
    out, reports = res["result"], res["reports"]
    n, new = out["config"]["num_requests"], out["config"]["max_new_tokens"]
    states = set(out["request_states"].values())
    if states != {"finished"} or len(out["tokens"]) != n \
            or any(len(t) != new for t in out["tokens"].values()):
        fail(f"serving {arch}: states {states}, "
             f"{len(out['tokens'])} of {n} requests with {new} tokens")
    if "serving" not in reports or "kernel_freq" not in reports:
        fail(f"serving {arch}: reports {list(reports)}")
    if any(launched.values()):
        fail(f"serving {arch}: trace kernels launched {launched}")
    return res


def _serve_line(label: str, out: dict) -> None:
    s = out["summary"]
    print(f"serving {label}: wall {s['wall_s']:.3f} s, "
          f"{s['generated_tokens']} tokens, {s['tok_per_s']:.2f} tok/s, "
          f"TTFT p50 {s['ttft_s']['p50'] * 1e3:.1f} p90 "
          f"{s['ttft_s']['p90'] * 1e3:.1f} ms, TPOT p50 "
          f"{s['tpot_s']['p50'] * 1e3:.2f} p90 "
          f"{s['tpot_s']['p90'] * 1e3:.2f} ms, {s['decode_steps']} decode "
          f"ticks, mean occupancy {s['occupancy_mean']:.2f}, warm-up "
          f"{s['compile_s']:.2f} s; on {CARD}", flush=True)


def _blocked_check(cfg, params, tokens) -> None:
    """Layer 0's blocked attention at the long prompt's bucket against
    the dense one on one KV-head group (dense scores of every group would
    take 19 GB), in query slices of 2048."""
    dt = torch.bfloat16
    with torch.no_grad():
        attn = {k: v[0] for k, v in params["layers"]["attn"].items()}
        h = params["embed"].to(dt)[tokens]
        x = layers.rmsnorm(h, params["layers"]["ln1"][0], cfg.rmsnorm_eps)
        s = tokens.shape[1]
        pos = torch.arange(s, device="cuda")[None, :]
        q, k, v = layers._qkv(attn, x, cfg, pos)
        qg = layers._group(q, cfg.n_kv_heads)[:, :, :1]
        k, v = k[:, :, :1].contiguous(), v[:, :, :1].contiguous()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        blocked = layers._sdpa_blocked(qg, k, v, True)
        torch.cuda.synchronize()
        t_blocked = time.perf_counter() - t0
        err = 0.0
        for q0 in range(0, s, 2048):
            dense = layers._sdpa_dense(qg[:, q0:q0 + 2048], k, v, True,
                                       q_offset=q0)
            err = max(err, float((blocked[:, q0:q0 + 2048].float()
                                  - dense.float()).abs().max()))
        bound = BF16_BLOCKED_REL * float(v.float().abs().max())
    print(f"serving long prompt: layer-0 blocked attention at {s} tokens "
          f"(one KV-head group of {qg.shape[3]} heads, {s // 1024} chunks "
          f"of 1024) in {t_blocked * 1e3:.1f} ms; max |blocked - dense| "
          f"{err:.3e} within the bf16 bound {bound:.3e} "
          f"(2**-6 of max|v|): {err <= bound}; on {CARD}", flush=True)
    if not err <= bound:
        fail(f"serving: blocked attention differs from dense by {err}")


def _engine_tokens(cfg, params, prompts, margins=None):
    """Greedy tokens of a staggered ragged trace (one submit per tick);
    ``margins`` collects each sampled row's top-2 logit margin, keyed by
    (prompt index, position)."""
    eng = ServeEngine(cfg, params, max_seq=64, max_slots=3, prefix_block=8)
    if margins is not None:
        real = eng._sample_one
        index = {}

        def sample(req, row, position=None):
            top = np.sort(row)[-2:]
            pos = len(req.tokens) if position is None else position
            margins[(index[req.rid], pos)] = float(top[1] - top[0])
            return real(req, row, position)
        eng._sample_one = sample
    out, rids, pending = {}, {}, list(enumerate(prompts))
    while pending or eng.has_work:
        if pending:
            i, p = pending.pop(0)
            rid = eng.submit(p, SamplingParams(max_new_tokens=8))
            rids[rid] = i
            if margins is not None:
                index[rid] = i
        for rid in eng.step()["finished"]:
            out[rids[rid]] = list(eng.requests[rid].tokens)
    return out, eng


def phase_serving() -> None:
    # glm4-9b, full width and depth, one set of weights for four runs
    cfg = configs.get("glm4-9b")
    free_card()
    torch.cuda.reset_peak_memory_stats()
    params = init_params(cfg, SEED, "cuda")
    res = _serve("glm4-9b", SERVE_EXAMPLE, params)
    out, eng, reports = res["result"], res["engine"], res["reports"]
    s = out["summary"]
    pool = eng.pool.stats()
    names = [n for n, _c in reports["kernel_freq"]["top"]]
    _serve_line("glm4-9b example traffic (rate 2)", out)
    print(f"serving glm4-9b: prefix hit rate {s['prefix_hit_rate']:.3f}, "
          f"pool {pool}, duplicate_copy_bytes "
          f"{s['pool']['duplicate_copy_bytes']}; kernel_freq "
          f"{reports['kernel_freq']['total_invocations']} invocations of "
          f"{reports['kernel_freq']['distinct_kernels']} kernels, top "
          f"{[(n[:50], c) for n, c in reports['kernel_freq']['top'][:4]]}",
          flush=True)
    if not s["prefix_hit_rate"] > 0:
        fail("serving glm4-9b: no prefix hit")
    if s["pool"]["duplicate_copy_bytes"] != 0:
        fail("serving glm4-9b: prefix store copied bytes")
    if pool["blocks_live"] != 0 or pool["blocks_used"] != \
            pool["blocks_evictable"]:
        fail(f"serving glm4-9b: blocks held after the drain {pool}")
    # cuBLAS names its decode-shaped GEMMs nvjet_* on Hopper
    if not names or any(n.startswith("aten::") for n in names) \
            or not any(k in n.lower() for n in names
                       for k in ("gemm", "nvjet", "cublas")):
        fail(f"serving glm4-9b: kernel_freq names no device GEMM: "
             f"{[n[:60] for n in names]}")
    del res, out, eng, reports
    rate0 = SERVE_EXAMPLE[:]
    rate0[rate0.index("--rate") + 1] = "0"
    runs = [_serve("glm4-9b", rate0, params)["result"] for _ in range(2)]
    for i, r in enumerate(runs):
        _serve_line(f"glm4-9b same trace at rate 0, run {i + 1}", r)
    same = runs[0]["tokens"] == runs[1]["tokens"]
    print(f"serving glm4-9b rate 0: tokens identical across two runs: "
          f"{same}", flush=True)
    if not same:
        fail("serving glm4-9b: the keyed sampler gave different tokens")
    del runs
    free_card()
    # one long prompt: blocked prefill, decodes over a 12k window
    calls = []
    real_blocked = layers._sdpa_blocked

    def counted(q, *a, **kw):
        calls.append(q.shape[1])
        return real_blocked(q, *a, **kw)
    layers._sdpa_blocked = counted
    try:
        res = _serve("glm4-9b", ["--num-requests", "1", "--max-slots", "1",
                                 "--prompt-len", str(LONG_PROMPT),
                                 "--prompt-len-min", str(LONG_PROMPT),
                                 "--max-new-tokens", "8", "--temperature",
                                 "0", "--no-warmup"], params)
    finally:
        layers._sdpa_blocked = real_blocked
    out, eng = res["result"], res["engine"]
    _serve_line(f"glm4-9b one {LONG_PROMPT}-token prompt", out)
    print(f"serving long prompt: max_seq {eng.max_seq}, prefill (TTFT) "
          f"{out['summary']['ttft_s']['p50'] * 1e3:.1f} ms through "
          f"{len(calls)} blocked-attention calls at {sorted(set(calls))} "
          f"tokens, then {out['summary']['decode_steps']} decodes over a "
          f"{eng.pool.blocks_per_seq * eng.pool.block_size}-token paged "
          f"window; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 1e9:.1f} GB; on {CARD}",
          flush=True)
    if eng.max_seq != 12288 or calls != [12288] * cfg.n_layers:
        fail(f"serving long prompt: max_seq {eng.max_seq}, blocked calls "
             f"{calls}")
    prompt = np.zeros((1, 12288), np.int32)
    prompt[0, :LONG_PROMPT] = eng.requests[0].prompt
    del res, out, eng
    free_card()
    _blocked_check(cfg, params, torch.from_numpy(prompt).cuda())
    del params
    free_card()
    # zamba2-7b: hybrid, the slot pool, exact-length prefills
    cfg = configs.get("zamba2-7b")
    params = init_params(cfg, SEED, "cuda")
    res = _serve("zamba2-7b", ["--num-requests", "4", "--max-slots", "2",
                               "--max-new-tokens", "16", "--temperature",
                               "0"], params)
    _serve_line("zamba2-7b (4 requests, 2 slots)", res["result"])
    if res["engine"].paged or res["engine"].prefix_cache is not None:
        fail("serving zamba2-7b: not on the slot pool")
    del res, params
    free_card()
    # reduced, float32: the card's tokens against the CPU's
    for arch in ("paper-gpt2", "mamba2-2.7b", "zamba2-7b", "dbrx-132b"):
        cfg = configs.reduced(configs.get(arch))
        params = init_params(cfg, SEED, "cpu")
        rng = np.random.default_rng(SEED)
        prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
                   for n in (5, 17, 9, 30, 12, 3)]
        margins: dict = {}
        want, _e = _engine_tokens(cfg, params, prompts, margins)
        got, eng = _engine_tokens(cfg, _to(params, "cuda"), prompts)
        first = [(i, next((j for j, (a, b) in enumerate(zip(want[i], got[i]))
                           if a != b), None)) for i in want]
        diff = [(i, j) for i, j in first if j is not None]
        if diff:
            margin = margins[diff[0]]
            note = f"first differing (request, position) {diff[0]}"
        else:
            margin = min(margins.values())
            note = "smallest margin of the run"
        pool = "paged" if eng.paged else "slot pool"
        print(f"serving card vs cpu: reduced {arch} ({pool}), "
              f"{len(prompts)} staggered requests, tokens identical: "
              f"{not diff}; top-2 logit margin {margin:.3e} ({note}; "
              f"tolerance {F32_LOGIT_TOL:g})", flush=True)
        if diff and not margin < F32_LOGIT_TOL:
            fail(f"serving card vs cpu {arch}: tokens differ at {diff[0]} "
                 f"with a top-2 margin of {margin}")
        del params, eng
        free_card()


# ----------------------------------------------------------------- phase 13
DIST_TIMEOUT_S = 900            # the ranks' join, every part included
#: card against itself, float32 weights and moments: stablelm-1.6b's
#: checkpoint is its weights and two moments, 12 bytes a parameter
CKPT_BYTES_PER_PARAM = 12
#: the full-size restart writes two checkpoints (2 x 19.7 GB); where the
#: checkpoint directory's disk would take longer than this for them, or
#: cannot hold them with a quarter to spare, the restart runs the reduced
#: model, so that the phase stays well inside the script's time
CKPT_WRITE_BUDGET_S = 240
CKPT_PROBE_BYTES = 1 << 30      # the write-rate probe: 1 GiB, fsync'ed
#: tests/test_torch_dist.py's bounds on an explicit sync mode's step
#: against the single-device step (the reference's, tests/test_dist.py)
SYNC_LOSS_ATOL, SYNC_GNORM_RTOL = 2e-3, 2e-2
PIPE_ATOL = 1e-5                # the reference's pipeline bound
#: glm4-9b's first step on data 1 x model 4 against data 2 x model 2,
#: relative, on the loss and the grad norm: bf16 compute (8 bits of
#: mantissa, 2**-8 a rounding) whose partial sums fall on other ranks in
#: another order; a step whose attention lost heads or a K/V gradient
#: its sum over ranks moves both by far more
MODEL4_RTOL = 1e-2


def _card_batch(cfg, device, batch=2, seq=64) -> dict:
    gen = torch.Generator(device=device).manual_seed(SEED + 1)
    return {k: torch.randint(0, cfg.vocab_size, (batch, seq), generator=gen,
                             dtype=torch.int32, device=device)
            for k in ("inputs", "labels")}


def _max_err(a, b) -> float:
    return float((a.double() - b.double()).abs().max()) if a.numel() else 0.


def _dist_collectives() -> dict:
    """Each collective of ``dist/collectives.py`` on the world-1 NCCL
    group against its plain version: the payload itself, or the numpy
    mirror of the int8 round trip (``simulate_compressed_psum``, n = 1)."""
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.dist import collectives as C
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    errs = {}
    for name, shape in (("grad", (2048, 2048)), ("ragged", (1000, 37))):
        x = torch.randn(shape, generator=gen, device="cuda")
        sim = torch.from_numpy(C.simulate_compressed_psum(
            x.cpu().numpy()[None])).cuda()
        errs[f"{name} compressed_psum"] = _max_err(C.compressed_psum(x, None),
                                                   sim)
        errs[f"{name} plain_psum"] = _max_err(C.plain_psum(x, None), x)
        errs[f"{name} psum_start/wait"] = _max_err(
            C.psum_wait(C.psum_start(x, None), None), x)
        errs[f"{name} psum_start/wait int8"] = _max_err(
            C.psum_wait(C.psum_start(x, None, compressed=True), None), sim)
    mesh = init_device_mesh("cuda", (1, 1), mesh_dim_names=("pod", "data"))
    tree = {"g": torch.ones(3, device="cuda")}
    errs["make_pod_sync (pod 1) is the identity"] = float(
        C.make_pod_sync(mesh, compressed=True)(tree)["g"] is not tree["g"])
    return errs


def _mesh_step_equals_plain(cfg) -> dict:
    """One train step of ``cfg`` plain and on a (1, 1) data × model mesh
    (DTensor parameters, optimizer state and batch), from the same
    weights: metrics and every updated weight compared bit for bit."""
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.dist.sharding import set_mesh
    from repro_torch.train.trainer import (batch_shardings, place,
                                           train_shardings)
    opt_cfg = OptConfig()
    batch = _card_batch(cfg, "cuda")
    params = init_params(cfg, SEED, "cuda")
    t0 = time.perf_counter()
    p1, o1, m1 = make_train_step(cfg, opt_cfg)(
        params, init_opt_state(params, opt_cfg), batch)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    del params, o1
    free_card()
    mesh = init_device_mesh("cuda", (1, 1), mesh_dim_names=("data", "model"))
    set_mesh(mesh)
    try:
        p_sh, _o, _p, _q = train_shardings(mesh, cfg, opt_cfg)
        params = place(init_params(cfg, SEED, "cuda"), p_sh, mesh)
        db = place(batch, batch_shardings(mesh, batch), mesh)
        t0 = time.perf_counter()
        p2, o2, m2 = make_train_step(cfg, opt_cfg)(
            params, init_opt_state(params, opt_cfg), db)
        torch.cuda.synchronize()
        mesh_s = time.perf_counter() - t0
        differ = [".".join(path) for (path, a), (_q, b) in zip(
            tree_paths(p1), tree_paths(p2)) if not torch.equal(a, b.to_local())]
        metrics = [k for k in m1 if not torch.equal(m1[k], m2[k])]
    finally:
        set_mesh(None)
    del params, p1, p2, o2
    free_card()
    return {"differ": differ,
            "metrics_differ": metrics, "loss": float(m1["loss"]),
            "plain_s": plain_s, "mesh_s": mesh_s}


def _write_rate(d: str) -> float:
    """Bytes a second that the disk under ``d`` takes: CKPT_PROBE_BYTES of
    random bytes written and fsync'ed, then removed."""
    chunk = np.random.default_rng(SEED).bytes(64 << 20)
    path = os.path.join(d, "write_probe")
    t0 = time.perf_counter()
    with open(path, "wb") as f:
        for _ in range(CKPT_PROBE_BYTES // len(chunk)):
            f.write(chunk)
        f.flush()
        os.fsync(f.fileno())
    secs = time.perf_counter() - t0
    os.remove(path)
    return CKPT_PROBE_BYTES / secs


def _driver_restart(tmp: str) -> dict:
    """``repro_torch.launch.train`` on stablelm-1.6b (full unless the disk
    cannot hold two checkpoints, or would take more than
    CKPT_WRITE_BUDGET_S to write them): 4 steps with a checkpoint every 2
    and a failure injected at step 3, then 4 uninterrupted steps."""
    import shutil
    from repro_torch.launch import train as tl
    from repro_torch.train import checkpoint as ckpt
    cfg = configs.get("stablelm-1.6b")
    need = 2 * CKPT_BYTES_PER_PARAM * cfg.n_params
    free = shutil.disk_usage(tmp).free
    rate = _write_rate(tmp)
    reduced = free < 1.25 * need or need / rate > CKPT_WRITE_BUDGET_S
    common = ["--arch", cfg.name, "--device", "cuda", "--steps", "4",
              "--seq-len", "64", "--global-batch", "2",
              "--pasta-tools", "kernel_freq"] + (["--reduced"] if reduced
                                                 else [])
    times = {"save": [], "restore": []}
    orig = {"save": ckpt.save, "restore": ckpt.restore}

    def timed_io(name):
        def call(*a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = orig[name](*a, **kw)
            times[name].append(time.perf_counter() - t0)
            return out
        return call

    d = os.path.join(tmp, "ckpt")
    ckpt.save, ckpt.restore = timed_io("save"), timed_io("restore")
    try:
        hit = tl.run(tl.parse_args(common + [
            "--ckpt-dir", d, "--ckpt-every", "2", "--inject-failure-at",
            "3"]))
    finally:
        ckpt.save, ckpt.restore = orig["save"], orig["restore"]
    step_dir = os.path.join(d, "step_00000002")
    nbytes = sum(os.path.getsize(os.path.join(step_dir, f))
                 for f in os.listdir(step_dir))
    shutil.rmtree(d)
    restarts, seen = hit["restarts"], hit["losses"]
    names = [n[:72] for n, _c in hit["reports"]["kernel_freq"]["top"][:3]]
    del hit
    free_card()
    whole = tl.run(tl.parse_args(common))
    want = whole["losses"]
    del whole
    free_card()
    by_step, replay_equal = {}, True
    for s, loss in seen:
        replay_equal &= by_step.setdefault(s, loss) == loss
    return {"reduced": reduced, "free_gb": free / 1e9, "need_gb": need / 1e9,
            "write_gb_s": rate / 1e9,
            "restarts": restarts, "seen": seen, "uninterrupted": want,
            "replay_equal": replay_equal,
            "equal": [by_step.get(s) for s, _l in want] == [l for _s, l
                                                           in want],
            "save_s": times["save"], "restore_s": times["restore"],
            "ckpt_bytes": nbytes, "top_kernels": names}


def _dist_one_card(tmp: str) -> dict:
    return {"collectives": _dist_collectives(),
            "mesh_step": _mesh_step_equals_plain(
                configs.get("stablelm-1.6b")),
            "driver": _driver_restart(tmp)}


def _sync_barrier() -> None:
    torch.cuda.synchronize()
    torch.distributed.barrier()


def _four_glm4(rank: int, shape=(2, 2), captured: bool = True) -> dict:
    """glm4-9b at full width and depth on data × model ``shape``: three
    steps, then (``captured``) one captured step (its NCCL kernels and
    wire bytes)."""
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.dist.sharding import set_mesh
    from repro_torch.train.trainer import (batch_shardings, place,
                                           train_shardings)
    cfg = configs.get("glm4-9b")
    dev = f"cuda:{rank}"
    mesh = init_device_mesh("cuda", shape, mesh_dim_names=("data", "model"))
    set_mesh(mesh)
    try:
        opt_cfg = OptConfig()
        p_sh, _o, _p, _q = train_shardings(mesh, cfg, opt_cfg)
        params = place(init_params(cfg, SEED, dev), p_sh, mesh)
        free_card()
        opt = init_opt_state(params, opt_cfg)
        batch = _card_batch(cfg, dev)
        db = place(batch, batch_shardings(mesh, batch), mesh)
        step = make_train_step(cfg, opt_cfg)
        torch.cuda.reset_peak_memory_stats()
        secs, losses, norms = [], [], []
        for _ in range(3):
            _sync_barrier()
            t0 = time.perf_counter()
            params, opt, m = step(params, opt, db)
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
            _sync_barrier()
            secs.append(time.perf_counter() - t0)
        out = {"secs": secs, "losses": losses, "grad_norms": norms,
               "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
        if captured:
            with pasta.Session(tools="kernel_freq", name="dist") as session:
                art = capture.capture_step(step, params, opt, db)
                stats = session.capture_compiled(art, label="train_step",
                                                 default_trip=cfg.n_layers,
                                                 steps=1)
                kf = session.reports()["kernel_freq"]
            nccl = {}
            for inst in stats.collective_instances:
                nccl[inst["name"]] = nccl.get(inst["name"], 0) + 1
            out.update(nccl_kernels=nccl,
                       wire_bytes=dict(stats.collective_wire_bytes),
                       collective_bytes=dict(stats.collective_bytes),
                       kernel_freq_total=kf["total_invocations"],
                       kernel_freq_distinct=kf["distinct_kernels"],
                       capture_s=art.seconds, lost=art.lost)
    finally:
        set_mesh(None)
    del params, opt
    free_card()
    return out


def _four_sync(rank: int) -> dict:
    """stablelm-1.6b on pod 2 × data 2 in the three explicit sync modes,
    each against the single-card step on the same weights and batch."""
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.dist.sharding import set_mesh
    from repro_torch.train.trainer import (batch_shardings, place,
                                           train_shardings)
    cfg = configs.get("stablelm-1.6b")
    dev = f"cuda:{rank}"
    opt_cfg = OptConfig()
    batch = _card_batch(cfg, dev)
    params = init_params(cfg, SEED, dev)
    step = make_train_step(cfg, opt_cfg)
    _p, _o, m = step(params, init_opt_state(params, opt_cfg), batch)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    p0, _o, m0 = step(params, init_opt_state(params, opt_cfg), batch)
    torch.cuda.synchronize()
    out = {"single": {"loss": float(m0["loss"]),
                      "grad_norm": float(m0["grad_norm"]),
                      "s": time.perf_counter() - t0}}
    del _p, _o, m, params
    free_card()
    mesh = init_device_mesh("cuda", (2, 2), mesh_dim_names=("pod", "data"))
    set_mesh(mesh)
    try:
        p_sh, _s, _a, _b = train_shardings(mesh, cfg, opt_cfg)
        dp = place(init_params(cfg, SEED, dev), p_sh, mesh)
        db = place(batch, batch_shardings(mesh, batch, include_pod=False),
                   mesh)
        for name, ov, comp in (("blocking", False, False),
                               ("overlap", True, False),
                               ("overlap_int8", True, True)):
            step = make_train_step(cfg, opt_cfg, overlap_sync=ov,
                                   sync_compressed=comp)
            secs = []
            for _ in range(2):
                opt = init_opt_state(dp, opt_cfg)
                _sync_barrier()
                t0 = time.perf_counter()
                p2, _o2, m2 = step(dp, opt, db)
                _sync_barrier()
                secs.append(time.perf_counter() - t0)
            dparam = max(_max_err(p2_leaf.full_tensor(), p0_leaf)
                         for (_q, p2_leaf), (_r, p0_leaf)
                         in zip(tree_paths(p2), tree_paths(p0)))
            out[name] = {"loss": float(m2["loss"]),
                         "grad_norm": float(m2["grad_norm"]),
                         "secs": secs, "max_param_diff": dparam}
            del p2, _o2, opt
            free_card()
    finally:
        set_mesh(None)
    return out


def _four_pipeline(rank: int) -> dict:
    """The GPipe ring on pipe 4 (8 layers of tanh(x @ w), 2048 wide, 8
    microbatches of 16 rows) against the same layers run in sequence on
    one card, forward and gradients."""
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.dist.pipeline import make_pipelined_fn
    dev = f"cuda:{rank}"
    gen = torch.Generator(device=dev).manual_seed(SEED)
    ws0 = torch.randn((8, 2048, 2048), generator=gen, device=dev) * 0.02
    xs = torch.randn((8, 16, 2048), generator=gen, device=dev)

    def block(w, x):
        return torch.tanh(x @ w)

    mesh = init_device_mesh("cuda", (4,), mesh_dim_names=("pipe",))
    fn = make_pipelined_fn(mesh, block, 4, 2)
    ws = ws0.clone().requires_grad_(True)
    _sync_barrier()
    t0 = time.perf_counter()
    ys = fn(ws, xs)
    ys.sum().backward()
    _sync_barrier()
    pipe_s = time.perf_counter() - t0
    grad = ws.grad.clone()
    torch.distributed.all_reduce(grad)
    wseq = ws0.clone().requires_grad_(True)
    want = []
    for mb in xs:
        y = mb
        for i in range(8):
            y = block(wseq[i], y)
        want.append(y)
    want = torch.stack(want)
    want.sum().backward()
    return {"fwd_err": _max_err(ys.detach(), want.detach()),
            "grad_err": _max_err(grad, wseq.grad), "s": pipe_s}


def _dist_rank(rank: int, world: int, tmp: str) -> None:
    # deterministic kernels, so that two runs of a step agree bit for bit
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    from repro_torch.launch import train as tl
    tl.init_rank(rank, world, os.path.join(tmp, "store"), "cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        if world == 1:
            out = _dist_one_card(tmp)
        else:
            out = {"glm4": _four_glm4(rank),
                   "glm4_model4": _four_glm4(rank, (1, 4), captured=False),
                   "sync": _four_sync(rank),
                   "pipeline": _four_pipeline(rank)}
        out["launches"] = dict(ops.launches)
        out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
        with open(os.path.join(tmp, f"rank{rank}.json"), "w") as f:
            json.dump(out, f)
    finally:
        torch.distributed.destroy_process_group()


def phase_dist() -> dict:
    """Phase 13: distributed training on one NCCL rank per card (4 when
    the machine has four, else 1).  Returns the kernels' launches on this
    path, summed over the ranks."""
    import shutil
    import tempfile
    global CARD
    if not CARD:
        CARD = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True,
                              text=True, check=True,
                              timeout=60).stdout.strip().splitlines()[0]
    world = 4 if torch.cuda.device_count() >= 4 else 1
    free_card()
    card_free, card_total = torch.cuda.mem_get_info()
    print(f"dist: this process holds {torch.cuda.memory_allocated() / 1e9:.2f}"
          f" GB ({torch.cuda.memory_reserved() / 1e9:.2f} GB reserved) on "
          f"card 0, which has {card_free / 1e9:.2f} of "
          f"{card_total / 1e9:.2f} GB free for the ranks", flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        print(f"dist: {world} NCCL rank(s), one per card; free disk "
              f"{shutil.disk_usage(tmp).free / 1e9:.1f} GB at the "
              f"checkpoint directory", flush=True)
        secs = _spawn_ranks(_dist_rank, world, (tmp,), DIST_TIMEOUT_S,
                            "dist")
        res = []
        for r in range(world):
            with open(os.path.join(tmp, f"rank{r}.json")) as f:
                res.append(json.load(f))
    launches = {}
    for r in res:
        for k, n in r["launches"].items():
            launches[k] = launches.get(k, 0) + n
    print(f"dist: the ranks took {secs:.1f} s; trace kernel launches on "
          f"this path {launches}; peak device memory per card "
          f"{[round(r['peak_gb'], 2) for r in res]} GB, on {CARD}",
          flush=True)
    if any(launches.values()):
        fail(f"dist: a trace kernel launched on the train path: {launches}")
    (_dist_report_one if world == 1 else _dist_report_four)(res)
    return launches


def _dist_report_one(res) -> None:
    r = res[0]
    errs = r["collectives"]
    print(f"dist collectives on a world-1 NCCL group, each against its "
          f"plain version (max |difference|): {errs}; world size 1: the "
          f"multi-rank collectives (more than one participant) were not "
          f"exercised", flush=True)
    if any(errs.values()):
        fail(f"dist: a world-1 collective differs from its plain version: "
             f"{errs}")
    ms = r["mesh_step"]
    print(f"dist: stablelm-1.6b full width and depth, one train step on a "
          f"(1, 1) data x model mesh (DTensors) against the plain step: "
          f"{len(ms['differ'])} weight leaves and metrics "
          f"{ms['metrics_differ']} differ (bit for bit); loss "
          f"{ms['loss']!r}; step {ms['plain_s'] * 1e3:.1f} ms plain, "
          f"{ms['mesh_s'] * 1e3:.1f} ms on the mesh (first calls), on "
          f"{CARD}", flush=True)
    if ms["differ"] or ms["metrics_differ"]:
        fail(f"dist: the (1, 1) mesh step differs from the plain step: "
             f"{ms['differ'][:5]} {ms['metrics_differ']}")
    d = r["driver"]
    size = ("REDUCED (cut: two full checkpoints, "
            f"{d['need_gb']:.1f} GB, need 1.25 x their size free and "
            f"{CKPT_WRITE_BUDGET_S} s at the disk's rate)"
            if d["reduced"] else "full width and depth")
    print(f"dist: the checkpoint directory's disk has {d['free_gb']:.1f} GB "
          f"free and wrote {d['write_gb_s']:.3f} GB/s (1 GiB, fsync'ed): "
          f"{d['need_gb'] / d['write_gb_s']:.1f} s for two full-size "
          f"checkpoints", flush=True)
    print(f"dist: repro_torch.launch.train on stablelm-1.6b {size}, batch "
          f"2 x 64, 4 steps, checkpoint every 2, failure injected at step "
          f"3: restarts {d['restarts']}, losses as logged {d['seen']}, "
          f"uninterrupted {d['uninterrupted']}; replayed step equal "
          f"{d['replay_equal']}, equal to the uninterrupted run bit for bit "
          f"{d['equal']}; checkpoint {d['ckpt_bytes'] / 1e9:.3f} GB, save "
          f"{[round(t, 2) for t in d['save_s']]} s, restore "
          f"{[round(t, 2) for t in d['restore_s']]} s; captured step's top "
          f"kernels {d['top_kernels']}; on {CARD}", flush=True)
    if d["restarts"] != 1 or not d["replay_equal"] or not d["equal"]:
        fail("dist: the restarted run's losses differ from the "
             "uninterrupted run's")


def _dist_report_four(res) -> None:
    g = [r["glm4"] for r in res]
    print(f"dist: glm4-9b full width and depth on data 2 x model 2, batch "
          f"2 x 64, 3 steps: losses {g[0]['losses']}, step times per card "
          f"{[[round(t * 1e3, 1) for t in x['secs']] for x in g]} ms, peak "
          f"memory per card over the steps "
          f"{[round(x['peak_gb'], 2) for x in g]} GB; one captured step: "
          f"NCCL kernels {g[0]['nccl_kernels']} (COLLECTIVE events), "
          f"collective_wire_bytes {g[0]['wire_bytes']}, collective_bytes "
          f"{g[0]['collective_bytes']}, kernel_freq total "
          f"{g[0]['kernel_freq_total']} distinct "
          f"{g[0]['kernel_freq_distinct']} (compute kernels: collectives "
          f"are not kernel launches, as in the reference's walker); "
          f"capture {g[0]['capture_s']:.2f} "
          f"s, lost records {g[0]['lost']}; on {CARD}", flush=True)
    if not all(np.isfinite(x["losses"]).all() for x in g):
        fail("dist: glm4-9b losses not finite")
    if not g[0]["nccl_kernels"] or not g[0]["wire_bytes"]:
        fail("dist: the captured sharded step recorded no NCCL kernel")
    h = [r["glm4_model4"] for r in res]
    dloss = abs(h[0]["losses"][0] - g[0]["losses"][0]) / g[0]["losses"][0]
    dnorm = abs(h[0]["grad_norms"][0] - g[0]["grad_norms"][0]) \
        / g[0]["grad_norms"][0]
    print(f"dist: glm4-9b full width and depth on data 1 x model 4 (32 "
          f"query heads, 8 a card; 2 KV heads, replicated on model), batch "
          f"2 x 64, 3 steps: losses {h[0]['losses']}, grad norms "
          f"{h[0]['grad_norms']}; first step against data 2 x model 2 "
          f"(loss {g[0]['losses'][0]!r}, grad norm "
          f"{g[0]['grad_norms'][0]!r}): relative difference loss "
          f"{dloss:.3e}, grad norm {dnorm:.3e} (limit {MODEL4_RTOL:g}); "
          f"step times per card "
          f"{[[round(t * 1e3, 1) for t in x['secs']] for x in h]} ms, peak "
          f"memory per card over the steps "
          f"{[round(x['peak_gb'], 2) for x in h]} GB; on {CARD}",
          flush=True)
    if dloss > MODEL4_RTOL or dnorm > MODEL4_RTOL:
        fail("dist: glm4-9b on data 1 x model 4 differs from data 2 x "
             "model 2")
    s = res[0]["sync"]
    single = s["single"]
    for name in ("blocking", "overlap", "overlap_int8"):
        m = s[name]
        print(f"dist: stablelm-1.6b full width and depth on pod 2 x data "
              f"2, {name} pod sync: loss {m['loss']!r} (single card "
              f"{single['loss']!r}), grad_norm {m['grad_norm']!r} (single "
              f"{single['grad_norm']!r}), largest weight difference after "
              f"the step {m['max_param_diff']:.3e}; step "
              f"{[round(t * 1e3, 1) for t in m['secs']]} ms (single card "
              f"{single['s'] * 1e3:.1f} ms); on {CARD}", flush=True)
        if abs(m["loss"] - single["loss"]) >= SYNC_LOSS_ATOL or \
                abs(m["grad_norm"] - single["grad_norm"]) >= \
                SYNC_GNORM_RTOL * max(single["grad_norm"], 1):
            fail(f"dist: {name} sync step outside the bounds")
    p = res[0]["pipeline"]
    print(f"dist: GPipe ring on pipe 4 (8 layers of tanh(x @ w) at 2048, 8 "
          f"microbatches of 16): forward max |difference| from the layers "
          f"in sequence {p['fwd_err']:.3e}, gradient {p['grad_err']:.3e} "
          f"(limit {PIPE_ATOL:g}); forward and backward "
          f"{p['s'] * 1e3:.1f} ms; on {CARD}", flush=True)
    if p["fwd_err"] >= PIPE_ATOL or p["grad_err"] >= PIPE_ATOL:
        fail("dist: the pipeline differs from the sequential layers")


# ----------------------------------------------------------------- phase 15
MESH_TIMEOUT_S = 480            # one spawn of phase 15, its join included
MESH_BUDGET_S = 300             # the phase on four cards
#: the first decode tick's logits on a mesh against one card, largest
#: |difference| over largest |logit|: float32 compute, whose partial
#: sums fall on other ranks in another order (2**-24 a rounding, summed
#: over d_model and d_ff terms); a lost head or a wrong block moves them
#: by far more
MESH_LOGIT_RTOL = 1e-4
#: the comparison runs: these prompt lengths at rate 0, greedy
MESH_PROMPTS = (9, 17, 5, 30)
MESH_NEW = 8
#: qwen3-32b's placement peak a card in phase 15 (max over the cards), for
#: phase 16's check (not made when phase 15 did not run in this process)
MESH_PEAK_GB: list = []


def _mesh_prompts(vocab: int) -> list:
    rng = np.random.default_rng(SEED)
    return [rng.integers(0, vocab, n).astype(np.int32) for n in MESH_PROMPTS]


def _mesh_engine_run(cfg, params) -> dict:
    """The comparison trace through ``ServeEngine`` (on a mesh where one
    is registered): its greedy tokens and its first decode tick's logits
    (gathered whole)."""
    from torch.distributed.tensor import DTensor
    eng = ServeEngine(cfg, params, max_seq=64, max_slots=len(MESH_PROMPTS),
                      prefix_block=8)
    first = []
    real = eng._decode

    def decode(*a):
        logits, cache = real(*a)
        if not first:
            whole = logits.full_tensor() if isinstance(logits, DTensor) \
                else logits
            first.append(whole.float().cpu().numpy())
        return logits, cache
    eng._decode = decode
    rids = [eng.submit(p, SamplingParams(max_new_tokens=MESH_NEW))
            for p in _mesh_prompts(cfg.vocab_size)]
    t0 = time.perf_counter()
    out = eng.run()
    torch.cuda.synchronize()
    return {"tokens": [out[r].tolist() for r in rids], "logits": first[0],
            "s": time.perf_counter() - t0, "ticks": eng.ticks,
            "paged": eng.paged}


def _mesh_rank(rank: int, world: int, tmp: str, arch: str,
               shape: tuple) -> None:
    """One NCCL rank of ``arch`` (float32 compute) on data x model
    ``shape``: weights placed leaf by leaf, the comparison trace."""
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.dist.sharding import set_mesh
    from repro_torch.launch import train as tl
    from repro_torch.train.trainer import serve_shardings
    # a store of its own: a FileStore keeps the last group's keys
    tl.init_rank(rank, world, os.path.join(tmp, f"store_{arch}"), "cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        mesh = init_device_mesh("cuda", shape,
                                mesh_dim_names=("data", "model"))
        set_mesh(mesh)
        cfg = dataclasses.replace(configs.get(arch), dtype="float32")
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        p_sh = serve_shardings(mesh, cfg, len(MESH_PROMPTS), 64)[0]
        params = init_params(cfg, SEED, f"cuda:{rank}", shardings=p_sh)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        init_peak = torch.cuda.max_memory_allocated() / 1e9
        ops.reset_launches()
        res = _mesh_engine_run(cfg, params)
        res.update(launches=dict(ops.launches), init_s=init_s,
                   init_peak_gb=init_peak,
                   peak_gb=torch.cuda.max_memory_allocated() / 1e9)
        if rank == 0:
            np.save(os.path.join(tmp, f"{arch}_logits.npy"),
                    res["logits"])
        del res["logits"]
        with open(os.path.join(tmp, f"{arch}_rank{rank}.json"), "w") as f:
            json.dump(res, f)
    finally:
        set_mesh(None)
        torch.distributed.destroy_process_group()


def _spawn_ranks(fn, world: int, args: tuple, timeout: float,
                 what: str) -> float:
    """``fn(rank, world, *args)`` on ``world`` spawned ranks, joined
    within ``timeout`` (a rank still running then is killed and the
    script fails); returns the seconds they took."""
    import torch.multiprocessing as mp
    from torch.multiprocessing.spawn import ProcessException
    t0 = time.perf_counter()
    ctx = mp.start_processes(fn, args=(world, *args), nprocs=world,
                             join=False, start_method="spawn")
    deadline = time.monotonic() + timeout
    try:
        while not ctx.join(timeout=max(1.0, deadline - time.monotonic())):
            if time.monotonic() > deadline:
                fail(f"{what}: ranks still running after {timeout} s")
    except ProcessException as e:
        fail(f"{what}: a rank failed: {e}")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
    return time.perf_counter() - t0


def _mesh_against_one_card(arch: str, shape: tuple, tmp: str) -> dict:
    """``arch`` in float32 compute on the mesh ``shape`` (one NCCL rank
    per card) and then alone on card 0, the card freed between them:
    tokens, the first decode tick's logits, launches and memory."""
    world = shape[0] * shape[1]
    free_card()
    secs = _spawn_ranks(_mesh_rank, world, (tmp, arch, shape),
                        MESH_TIMEOUT_S, f"mesh serving {arch}")
    ranks = []
    for r in range(world):
        with open(os.path.join(tmp, f"{arch}_rank{r}.json")) as f:
            ranks.append(json.load(f))
    mesh_logits = np.load(os.path.join(tmp, f"{arch}_logits.npy"))
    cfg = dataclasses.replace(configs.get(arch), dtype="float32")
    t0 = time.perf_counter()
    params = init_params(cfg, SEED, "cuda")
    one = _mesh_engine_run(cfg, params)
    one_s = time.perf_counter() - t0
    del params
    free_card()
    rel = float(np.abs(mesh_logits - one["logits"]).max()
                / np.abs(one["logits"]).max())
    return {"ranks": ranks, "secs": secs, "one": one, "one_s": one_s,
            "rel": rel, "same_ranks": all(r["tokens"] == ranks[0]["tokens"]
                                          for r in ranks)}


def _mesh_line(arch: str, shape: tuple, res: dict) -> None:
    r0, one = res["ranks"][0], res["one"]
    same = r0["tokens"] == one["tokens"]
    print(f"mesh serving: {arch} full width and depth, float32 compute, "
          f"{'paged' if r0['paged'] else 'slot'} pool, "
          f"{len(MESH_PROMPTS)} requests at rate 0, {MESH_NEW} greedy "
          f"tokens each, on data {shape[0]} x model {shape[1]} (one NCCL "
          f"rank per card) against one card: tokens equal {same} (every "
          f"rank the same: {res['same_ranks']}); first decode tick's "
          f"largest |logit difference| / largest |logit| "
          f"{res['rel']:.3e} (limit {MESH_LOGIT_RTOL:g}); mesh serve "
          f"{r0['s']:.2f} s in {r0['ticks']} ticks, placement "
          f"{r0['init_s']:.2f} s at peak "
          f"{[round(r['init_peak_gb'], 2) for r in res['ranks']]} GB a "
          f"card, peak over the run "
          f"{[round(r['peak_gb'], 2) for r in res['ranks']]} GB; one card "
          f"serve {one['s']:.2f} s ({res['one_s']:.2f} s with its init); "
          f"the ranks' spawn {res['secs']:.1f} s; on {CARD}", flush=True)
    if not same or not res["same_ranks"]:
        fail(f"mesh serving {arch}: tokens differ from one card's")
    if not res["rel"] <= MESH_LOGIT_RTOL:
        fail(f"mesh serving {arch}: logits differ by {res['rel']:.3e}")


def _mesh_launcher(tmp: str) -> dict:
    """``python3 -m repro_torch.launch.serve --devices 4 --mesh 1x4 --arch
    qwen3-32b`` with the example's traffic, at full width and depth."""
    here = os.path.dirname(os.path.abspath(__file__))
    path = os.path.join(tmp, "qwen3-32b.json")
    env = dict(os.environ, PYTHONPATH=os.path.join(here, "src"))
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-m", "repro_torch.launch.serve",
                        "--devices", "4", "--mesh", "1x4", "--arch",
                        "qwen3-32b", *SERVE_EXAMPLE, "--json", path],
                       cwd=here, env=env, capture_output=True, text=True,
                       timeout=MESH_TIMEOUT_S)
    secs = time.perf_counter() - t0
    for line in r.stdout.splitlines():
        if line.startswith("[serve]"):
            print(f"mesh serving qwen3-32b launcher: {line[:400]}",
                  flush=True)
    if r.returncode != 0:
        print(r.stderr[-4000:], flush=True)
        fail(f"mesh serving: the qwen3-32b launcher exited {r.returncode}")
    with open(path) as f:
        return {"out": json.load(f), "s": secs}


def phase_mesh_serving() -> dict:
    """Phase 15: the engine on a mesh.  Four cards: qwen3-32b through the
    launcher on data 1 x model 4; glm4-9b (2 x 2) and zamba2-7b (1 x 4)
    against one card.  One card: glm4-9b on a (1, 1) mesh against the
    plain engine.  Returns the trace kernels' launches, summed."""
    import tempfile
    global CARD
    if not CARD:
        CARD = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True,
                              text=True, check=True,
                              timeout=60).stdout.strip().splitlines()[0]
    four = torch.cuda.device_count() >= 4
    t0 = time.perf_counter()
    launches: dict = {}

    def add(counts: dict) -> None:
        for k, n in counts.items():
            launches[k] = launches.get(k, 0) + n

    with tempfile.TemporaryDirectory() as tmp:
        if four:
            free_card()
            q = _mesh_launcher(tmp)
            out = q["out"]
            s, m = out["summary"], out["mesh"]
            add(m["trace_kernel_launches"])
            states = set(out["request_states"].values())
            print(f"mesh serving: qwen3-32b full width and depth (64 "
                  f"layers, d_model 5120, 64/8 heads; float32 weights, "
                  f"bf16 compute) through the launcher on data 1 x model "
                  f"4, the example's traffic: config.mesh "
                  f"{out['config']['mesh']!r}, states {sorted(states)}; "
                  f"wall {s['wall_s']:.3f} s, {s['generated_tokens']} "
                  f"tokens, {s['tok_per_s']:.2f} tok/s, TTFT p50 "
                  f"{s['ttft_s']['p50'] * 1e3:.1f} p90 "
                  f"{s['ttft_s']['p90'] * 1e3:.1f} ms, TPOT p50 "
                  f"{s['tpot_s']['p50'] * 1e3:.2f} p90 "
                  f"{s['tpot_s']['p90'] * 1e3:.2f} ms, "
                  f"{s['decode_steps']} decode ticks, warm-up "
                  f"{s['compile_s']:.2f} s, prefix hit rate "
                  f"{s['prefix_hit_rate']:.3f}, duplicate_copy_bytes "
                  f"{s['pool']['duplicate_copy_bytes']}; placement peak "
                  f"{m['init_peak_gb']} GB a card; captured decode's "
                  f"collectives {m['decode_collectives']}; the command "
                  f"{q['s']:.1f} s; on {CARD}", flush=True)
            if states != {"finished"} or out["config"]["mesh"] != "1x4":
                fail(f"mesh serving qwen3-32b: states {states}, mesh "
                     f"{out['config']['mesh']!r}")
            if not s["prefix_hit_rate"] > 0 or \
                    s["pool"]["duplicate_copy_bytes"] != 0:
                fail("mesh serving qwen3-32b: no prefix hit, or bytes "
                     "copied")
            if not any("nccl" in n.lower() for n in m["decode_collectives"]):
                fail(f"mesh serving qwen3-32b: the captured decode names "
                     f"no NCCL kernel: {m['decode_collectives']}")
            MESH_PEAK_GB.append(max(m["init_peak_gb"]))
            for arch, shape in (("glm4-9b", (2, 2)), ("zamba2-7b", (1, 4))):
                res = _mesh_against_one_card(arch, shape, tmp)
                for r in res["ranks"]:
                    add(r["launches"])
                _mesh_line(arch, shape, res)
        else:
            res = _mesh_against_one_card("glm4-9b", (1, 1), tmp)
            for r in res["ranks"]:
                add(r["launches"])
            _mesh_line("glm4-9b", (1, 1), res)
            print(f"mesh serving: this machine has "
                  f"{torch.cuda.device_count()} card(s): the four-card "
                  f"parts (qwen3-32b through the launcher on 1 x 4, "
                  f"glm4-9b on 2 x 2 and zamba2-7b on 1 x 4 against one "
                  f"card) were not run", flush=True)
    secs = time.perf_counter() - t0
    print(f"mesh serving: phase 15 took {secs:.1f} s; trace kernel "
          f"launches over the ranks {launches}; on {CARD}", flush=True)
    if any(launches.values()):
        fail(f"mesh serving: a trace kernel launched: {launches}")
    if four and secs > MESH_BUDGET_S:
        fail(f"mesh serving: phase 15 took {secs:.1f} s, over "
             f"{MESH_BUDGET_S} s")
    return launches


# ----------------------------------------------------------------- phase 16
SPEC_BUDGET_S = 240             # the phase on four cards
SPEC_K = 2
#: the 2 x 2 comparison's draft: the target's config cut to this depth,
#: its weights drawn placed from the proposer's seed (1)
SPEC_DRAFT_LAYERS = 2
#: the draft shares the target's weights: the placement peak a card may
#: pass phase 15's by no more than this
SPEC_PEAK_SLACK_GB = 2.0
#: phase 12's flags, then the speculative run's own (the later ones win)
SPEC_ARGV = ["--num-requests", "4", "--max-new-tokens", "16",
             "--temperature", "0", "--spec-decode", str(SPEC_K), "--draft",
             "model"]


def _spec_engine_run(cfg, params, draft_cfg=None) -> dict:
    """Phase 15's comparison trace through a speculative ``ServeEngine``
    (``draft="model"``; on a mesh where one is registered): greedy tokens
    and the draft counts."""
    eng = ServeEngine(cfg, params, max_seq=64, max_slots=len(MESH_PROMPTS),
                      prefix_block=8, spec_decode=SPEC_K, draft="model",
                      draft_cfg=draft_cfg)
    rids = [eng.submit(p, SamplingParams(max_new_tokens=MESH_NEW))
            for p in _mesh_prompts(cfg.vocab_size)]
    t0 = time.perf_counter()
    out = eng.run()
    torch.cuda.synchronize()
    return {"tokens": [out[r].tolist() for r in rids],
            "drafted": eng.drafted_tokens, "accepted": eng.accepted_tokens,
            "s": time.perf_counter() - t0, "ticks": eng.ticks}


def _spec_runs(cfg, params) -> dict:
    """Both drafts: the target itself, then ``SPEC_DRAFT_LAYERS`` layers."""
    return {"self": _spec_engine_run(cfg, params),
            "layers": _spec_engine_run(cfg, params, dataclasses.replace(
                cfg, n_layers=SPEC_DRAFT_LAYERS))}


def _spec_rank(rank: int, world: int, tmp: str, arch: str,
               shape: tuple) -> None:
    """One NCCL rank of ``arch`` (float32 compute) on data x model
    ``shape``: weights placed leaf by leaf, the two speculative runs."""
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.dist.sharding import set_mesh
    from repro_torch.launch import train as tl
    from repro_torch.train.trainer import serve_shardings
    tl.init_rank(rank, world, os.path.join(tmp, f"spec_store_{arch}"),
                 "cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        mesh = init_device_mesh("cuda", shape,
                                mesh_dim_names=("data", "model"))
        set_mesh(mesh)
        cfg = dataclasses.replace(configs.get(arch), dtype="float32")
        torch.cuda.reset_peak_memory_stats()
        p_sh = serve_shardings(mesh, cfg, len(MESH_PROMPTS), 64)[0]
        params = init_params(cfg, SEED, f"cuda:{rank}", shardings=p_sh)
        torch.cuda.synchronize()
        init_peak = torch.cuda.max_memory_allocated() / 1e9
        ops.reset_launches()
        res = _spec_runs(cfg, params)
        res.update(launches=dict(ops.launches), init_peak_gb=init_peak,
                   peak_gb=torch.cuda.max_memory_allocated() / 1e9)
        with open(os.path.join(tmp, f"spec_{arch}_rank{rank}.json"),
                  "w") as f:
            json.dump(res, f)
    finally:
        set_mesh(None)
        torch.distributed.destroy_process_group()


def _spec_against_one_card(arch: str, shape: tuple, tmp: str) -> dict:
    """Both speculative runs of ``arch`` (float32 compute) on the mesh
    ``shape`` and then on card 0 alone, with the plain engine there."""
    world = shape[0] * shape[1]
    free_card()
    secs = _spawn_ranks(_spec_rank, world, (tmp, arch, shape),
                        MESH_TIMEOUT_S, f"speculative mesh serving {arch}")
    ranks = []
    for r in range(world):
        with open(os.path.join(tmp, f"spec_{arch}_rank{r}.json")) as f:
            ranks.append(json.load(f))
    cfg = dataclasses.replace(configs.get(arch), dtype="float32")
    params = init_params(cfg, SEED, "cuda")
    one = _spec_runs(cfg, params)
    plain = _mesh_engine_run(cfg, params)["tokens"]
    del params
    free_card()
    return {"ranks": ranks, "secs": secs, "one": one, "plain": plain}


def _spec_line(arch: str, shape: tuple, res: dict) -> None:
    r0, one = res["ranks"][0], res["one"]
    for key, label in (("self", "the target drafting for itself"),
                       ("layers", f"a {SPEC_DRAFT_LAYERS}-layer draft "
                                  f"drawn placed from seed 1")):
        m, o = r0[key], one[key]
        same = m["tokens"] == o["tokens"] == res["plain"]
        counts = (m["drafted"], m["accepted"]) == (o["drafted"],
                                                   o["accepted"])
        ranks = all((r[key]["tokens"], r[key]["drafted"], r[key]["accepted"])
                    == (m["tokens"], m["drafted"], m["accepted"])
                    for r in res["ranks"])
        print(f"speculative mesh serving: {arch} full width and depth, "
              f"float32 compute, k={SPEC_K}, {label}, "
              f"{len(MESH_PROMPTS)} requests at rate 0, {MESH_NEW} greedy "
              f"tokens each, on data {shape[0]} x model {shape[1]} (one "
              f"NCCL rank per card) against one card: tokens equal to one "
              f"card's and to the plain engine's {same}; accepted/drafted "
              f"{m['accepted']}/{m['drafted']} (one card "
              f"{o['accepted']}/{o['drafted']}); every rank the same "
              f"{ranks}; mesh {m['s']:.2f} s in {m['ticks']} ticks, one "
              f"card {o['s']:.2f} s in {o['ticks']} ticks; placement peak "
              f"{[round(r['init_peak_gb'], 2) for r in res['ranks']]} GB a "
              f"card, peak over the runs "
              f"{[round(r['peak_gb'], 2) for r in res['ranks']]} GB; the "
              f"ranks' spawn {res['secs']:.1f} s; on {CARD}", flush=True)
        if not (same and counts and ranks):
            fail(f"speculative mesh serving {arch} ({key}): tokens or "
                 f"draft counts differ from one card's")


def _spec_launcher(tmp: str) -> dict:
    """qwen3-32b through the launcher on data 1 x model 4, drafting for
    itself."""
    here = os.path.dirname(os.path.abspath(__file__))
    path = os.path.join(tmp, "qwen3-32b-spec.json")
    env = dict(os.environ, PYTHONPATH=os.path.join(here, "src"))
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-m", "repro_torch.launch.serve",
                        "--devices", "4", "--mesh", "1x4", "--arch",
                        "qwen3-32b", *SERVE_EXAMPLE, *SPEC_ARGV, "--json",
                        path], cwd=here, env=env, capture_output=True,
                       text=True, timeout=MESH_TIMEOUT_S)
    secs = time.perf_counter() - t0
    for line in r.stdout.splitlines():
        if line.startswith("[serve]"):
            print(f"speculative mesh serving qwen3-32b launcher: "
                  f"{line[:400]}", flush=True)
    if r.returncode != 0:
        print(r.stderr[-4000:], flush=True)
        fail(f"speculative mesh serving: the qwen3-32b launcher exited "
             f"{r.returncode}")
    with open(path) as f:
        return {"out": json.load(f), "s": secs}


def phase_spec_mesh() -> dict:
    """Phase 16: speculative decoding with a draft model on a mesh.  Four
    cards: glm4-9b on 2 x 2 with both drafts against one card, then
    qwen3-32b drafting for itself through the launcher on 1 x 4.  One
    card: glm4-9b on a (1, 1) mesh with both drafts against the plain
    engine.  Returns the trace kernels' launches, summed."""
    import tempfile
    global CARD
    if not CARD:
        CARD = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True,
                              text=True, check=True,
                              timeout=60).stdout.strip().splitlines()[0]
    four = torch.cuda.device_count() >= 4
    t0 = time.perf_counter()
    launches: dict = {}

    def add(counts: dict) -> None:
        for k, n in counts.items():
            launches[k] = launches.get(k, 0) + n

    with tempfile.TemporaryDirectory() as tmp:
        shape = (2, 2) if four else (1, 1)
        res = _spec_against_one_card("glm4-9b", shape, tmp)
        for r in res["ranks"]:
            add(r["launches"])
        _spec_line("glm4-9b", shape, res)
        if four:
            free_card()
            q = _spec_launcher(tmp)
            out = q["out"]
            s, m = out["summary"], out["mesh"]
            sp = s["speculative"]
            add(m["trace_kernel_launches"])
            states = set(out["request_states"].values())
            peak = max(m["init_peak_gb"])
            ref = MESH_PEAK_GB[-1] if MESH_PEAK_GB else None
            ref_note = (f"phase 15's {ref} GB" if ref is not None else
                        "phase 15 did not run here: not compared")
            print(f"speculative mesh serving: qwen3-32b full width and "
                  f"depth (64 layers, d_model 5120, 64/8 heads; float32 "
                  f"weights, bf16 compute) through the launcher on data 1 "
                  f"x model 4, phase 12's flags then {' '.join(SPEC_ARGV)} "
                  f"(the target drafts for itself): config.mesh "
                  f"{out['config']['mesh']!r}, states {sorted(states)}; "
                  f"wall {s['wall_s']:.3f} s, {s['generated_tokens']} "
                  f"tokens, {s['tok_per_s']:.2f} tok/s, TTFT p50 "
                  f"{s['ttft_s']['p50'] * 1e3:.1f} p90 "
                  f"{s['ttft_s']['p90'] * 1e3:.1f} ms, TPOT p50 "
                  f"{s['tpot_s']['p50'] * 1e3:.2f} p90 "
                  f"{s['tpot_s']['p90'] * 1e3:.2f} ms, "
                  f"{s['decode_steps']} decode ticks, accepted/drafted "
                  f"{sp['accepted_tokens']}/{sp['drafted_tokens']}, "
                  f"draft_overhead_s {sp['draft_overhead_s']:.3f} "
                  f"({sp['draft_overhead_s'] / s['wall_s']:.3f} of the "
                  f"wall); placement peak {m['init_peak_gb']} GB a card "
                  f"({ref_note}); "
                  f"captured verify's collectives {m['decode_collectives']}; "
                  f"the command {q['s']:.1f} s; on {CARD}", flush=True)
            if states != {"finished"} or out["config"]["mesh"] != "1x4":
                fail(f"speculative mesh serving qwen3-32b: states "
                     f"{states}, mesh {out['config']['mesh']!r}")
            if not sp["accepted_tokens"] > 0:
                fail("speculative mesh serving qwen3-32b: no draft "
                     "accepted")
            if ref is not None and peak > ref + SPEC_PEAK_SLACK_GB:
                fail(f"speculative mesh serving qwen3-32b: placement peak "
                     f"{peak:.2f} GB, over phase 15's {ref} GB by more "
                     f"than {SPEC_PEAK_SLACK_GB} GB")
        else:
            print(f"speculative mesh serving: this machine has "
                  f"{torch.cuda.device_count()} card(s): the four-card "
                  f"parts (glm4-9b on 2 x 2 against one card, qwen3-32b "
                  f"through the launcher on 1 x 4) were not run",
                  flush=True)
    secs = time.perf_counter() - t0
    print(f"speculative mesh serving: phase 16 took {secs:.1f} s; trace "
          f"kernel launches over the ranks {launches}; on {CARD}",
          flush=True)
    if any(launches.values()):
        fail(f"speculative mesh serving: a trace kernel launched: "
             f"{launches}")
    if four and secs > SPEC_BUDGET_S:
        fail(f"speculative mesh serving: phase 16 took {secs:.1f} s, over "
             f"{SPEC_BUDGET_S} s")
    return launches


# ----------------------------------------------------------------- phase 14
STATIC_TIMEOUT_S = 900          # the child of phase 14, every part included
KIMI_TIMEOUT_S = 600            # kimi-k2's 512-rank cell, a child of its own
PEAK_RATIO = (0.8, 1.2)         # static peak estimate / measured peak
#: a microbatched step's measured peak over the one-microbatch step's: a
#: step holding the last microbatch's gradients through the update reads
#: one float32 gradient tree (6.6 GB for stablelm-1.6b) above
PEAK_MICRO_MAX = 1.01
TWO_TIER_TOKENS = 16
#: dry-run cells on the fake 16 x 16 production mesh
DRYRUN_CELLS = (("qwen3-32b", "train_4k"), ("qwen3-32b", "prefill_32k"),
                ("qwen3-32b", "decode_32k"), ("mamba2-2.7b", "long_500k"))
#: the reference's figures per device of each dry-run cell (FLOPs, HBM
#: bytes, collective bytes): its own dry-run compiled with Auto mesh axes
#: for 512 host devices and read by its HLO walker on XLA:CPU (ROADMAP.md
#: section 3)
REFERENCE_CELLS = {
    "qwen3-32b train_4k": (1.36e15, 2.49e13, 6.10e11),
    "qwen3-32b prefill_32k": (6.23e14, 2.65e13, 1.75e11),
    "qwen3-32b decode_32k": (6.68e10, 1.43e11, 7.24e8),
    "mamba2-2.7b long_500k": (1.62e8, 4.12e8, 1.42e7),
    "kimi-k2-1t-a32b train_4k": (7.37e14, 9.00e13, 5.18e12),
}
#: qwen3-32b's query heads split over model: at most this many times the
#: reference's FLOPs per device (tests/test_torch_dryrun_parity.py)
FLOPS_RATIO_MAX = 1.25


def _static_lint() -> dict:
    """The lint smoke grid (three archs on a fake 2 x 2 x 2 mesh) with
    fake CUDA tensors: its exit code green and with each seeded defect."""
    from repro_torch.launch import lint
    out = {}
    for name, extra in (("green", []), ("reshard", ["--seed-defect",
                                                    "reshard"]),
                        ("blocking", ["--seed-defect", "blocking"])):
        t0 = time.perf_counter()
        rc = lint.main(["--device", "cuda", "--baseline", lint.BASELINE]
                       + extra)
        out[name] = {"rc": rc, "s": time.perf_counter() - t0}
    return out


def _static_cell(arch: str, shape: str, multi_pod: bool) -> dict:
    from repro_torch.launch import dryrun
    t0 = time.perf_counter()
    out, _lint = dryrun.run_cell(arch, shape, multi_pod=multi_pod,
                                 device="cuda")
    keep = ("mesh", "chips", "status", "trace_s", "lower_s", "layers_traced",
            "layers_total", "microbatches_traced", "microbatches",
            "state_bytes_per_device", "roofline", "memory_analysis")
    res = {k: out[k] for k in keep if k in out}
    res["hlo"] = {k: out["hlo"][k] for k in (
        "flops_per_device", "hbm_bytes_per_device", "collective_total_bytes",
        "exposed_collective_s", "n_collectives")}
    res["lint"] = out["lint"]["n_unsuppressed"]
    res["wall_s"] = time.perf_counter() - t0
    return res


def _static_peak(microbatches: int = 1) -> dict:
    """stablelm-1.6b at full width, one train step (world 1) of
    ``microbatches``: the static peak estimate of its trace (fake CUDA
    tensors) against ``torch.cuda.max_memory_allocated`` of the same
    step, run."""
    from repro_torch import analysis
    from repro_torch.core.trace import trace_step
    cfg = configs.get("stablelm-1.6b")
    free_card()
    params = init_params(cfg, SEED, "cuda")
    opt_cfg = OptConfig()
    state = init_opt_state(params, opt_cfg)
    batch = _card_batch(cfg, "cuda")
    step = make_train_step(cfg, opt_cfg, microbatches=microbatches)
    t0 = time.perf_counter()
    trace = trace_step(step, params, state, batch, device_type="cuda")
    trace_s = time.perf_counter() - t0
    est = analysis.estimate_peak_bytes(trace)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    out = step(params, state, batch)
    torch.cuda.synchronize()
    measured = torch.cuda.max_memory_allocated()
    loss = float(out[2]["loss"])
    del out, params, state
    free_card()
    return {"estimate": est["peak_bytes"], "measured": measured,
            "persistent": est["persistent_bytes"], "trace_s": trace_s,
            "fake_peak": trace.measured_peak_bytes,
            "records": len(trace.records), "loss": loss}


def _static_two_tier() -> dict:
    """glm4-9b at full width (float32 compute): a 16-token prompt
    prefilled, then 16 greedy decodes through the two-tier KV cache
    (frozen main cache, 16-slot recent buffer) and through the dense
    cache, each feeding its own argmax."""
    cfg = dataclasses.replace(configs.get("glm4-9b"), dtype="float32")
    cfg2 = dataclasses.replace(cfg, kv_two_tier=True,
                               kv_recent_len=TWO_TIER_TOKENS)
    free_card()
    params = init_params(cfg, SEED, "cuda")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 2)
    prompt = torch.randint(0, cfg.vocab_size, (2, 16), generator=gen,
                           dtype=torch.int32, device="cuda")
    with torch.no_grad():
        logits, cache = forward(params, prompt, cfg, return_cache=True,
                                logits_mode="last")
        kv = cache["kv"]
        recent = torch.zeros((*kv["k"].shape[:2], TWO_TIER_TOKENS,
                              *kv["k"].shape[3:]), dtype=kv["k"].dtype,
                             device="cuda")
        two = {"kv": {**kv, "main_len": kv["length"].clone(),
                      "rk": recent, "rv": recent.clone()}}
        pad = lambda a: torch.cat([a, torch.zeros_like(recent)],  # noqa
                                  dim=2)
        dense = {"kv": {"k": pad(kv["k"]), "v": pad(kv["v"]),
                        "length": kv["length"].clone()}}
        main_k = kv["k"].clone()
        tok_t = tok_d = logits.argmax(-1).to(torch.int32)
        worst, toks_t, toks_d = 0.0, [], []
        t0 = time.perf_counter()
        for _ in range(TWO_TIER_TOKENS):
            lt, two = forward(params, tok_t, cfg2, cache=two,
                              logits_mode="last")
            ld, dense = forward(params, tok_d, cfg, cache=dense,
                                logits_mode="last")
            worst = max(worst, _max_err(lt, ld))
            tok_t = lt.argmax(-1).to(torch.int32)
            tok_d = ld.argmax(-1).to(torch.int32)
            toks_t.append(tok_t.flatten().tolist())
            toks_d.append(tok_d.flatten().tolist())
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        frozen = torch.equal(two["kv"]["k"], main_k)
    del params, two, dense, cache
    free_card()
    return {"max_dlogit": worst, "tokens_two_tier": toks_t,
            "tokens_dense": toks_d, "main_frozen": frozen, "s": secs}


def _static_child(out_path: str, part: str) -> None:
    """Phase 14's parts, in a process with no default group (phase 13
    ran real ones; a trace makes its own fake one)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if part == "kimi":
        res = {"kimi": _static_cell("kimi-k2-1t-a32b", "train_4k", True)}
    else:
        res = {"lint": _static_lint(),
               "cells": {f"{a} {s}": _static_cell(a, s, False)
                         for a, s in DRYRUN_CELLS},
               "peak": _static_peak(), "peak_m2": _static_peak(2),
               "two_tier": _static_two_tier()}
    res["launches"] = dict(ops.launches)
    with open(out_path, "w") as f:
        json.dump(res, f)


def _run_static_child(part: str, tmp: str, timeout: float):
    """``(result or None, seconds)``: ``part`` in a child process; None
    when it ran past ``timeout`` (the child is killed)."""
    path = os.path.join(tmp, f"static_{part}.json")
    here = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    try:
        r = subprocess.run(
            [sys.executable, "-c", f"import chip_smoke as c; "
             f"c._static_child({path!r}, {part!r})"],
            cwd=here, capture_output=True, text=True, timeout=timeout)
    except subprocess.TimeoutExpired:
        return None, time.perf_counter() - t0
    secs = time.perf_counter() - t0
    if r.stdout.strip():
        print(r.stdout.rstrip(), flush=True)
    if r.returncode != 0:
        print(r.stderr[-4000:], flush=True)
        fail(f"static: the {part} child exited {r.returncode}")
    with open(path) as f:
        return json.load(f), secs


def phase_static() -> None:
    """Phase 14: the static half — lint and dry-run on fake process groups
    with fake CUDA tensors, the peak estimate against a real step, and the
    two-tier KV cache on the card."""
    import tempfile
    global CARD
    if not CARD:
        CARD = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True,
                              text=True, check=True,
                              timeout=60).stdout.strip().splitlines()[0]
    free_card()
    with tempfile.TemporaryDirectory() as tmp:
        res, secs = _run_static_child("main", tmp, STATIC_TIMEOUT_S)
        if res is None:
            fail(f"static: the child ran past {STATIC_TIMEOUT_S} s")
        kimi, kimi_s = _run_static_child("kimi", tmp, KIMI_TIMEOUT_S)
    print(f"static: the child took {secs:.1f} s; trace kernel launches "
          f"{res['launches']}, on {CARD}", flush=True)
    if any(res["launches"].values()):
        fail(f"static: a trace kernel launched: {res['launches']}")
    lint = res["lint"]
    print(f"static lint: smoke grid (qwen3-32b, mamba2-2.7b, dbrx-132b "
          f"reduced, fake 2 x 2 x 2 mesh, fake CUDA tensors, the shipped "
          f"baseline): exit green {lint['green']['rc']} "
          f"({lint['green']['s']:.1f} s), --seed-defect reshard "
          f"{lint['reshard']['rc']} ({lint['reshard']['s']:.1f} s), "
          f"--seed-defect blocking {lint['blocking']['rc']} "
          f"({lint['blocking']['s']:.1f} s); on {CARD}", flush=True)
    if [lint[k]["rc"] for k in ("green", "reshard", "blocking")] != [0, 1, 1]:
        fail("static: lint exit codes are not green 0, reshard 1, "
             "blocking 1")
    cells = dict(res["cells"])
    if kimi is not None:
        cells["kimi-k2-1t-a32b train_4k"] = kimi["kimi"]
    for name, c in cells.items():
        r = c["roofline"]
        print(f"static dryrun: {name} on {c['mesh']} ({c['chips']} fake "
              f"ranks): trace_s {c['trace_s']} (layers "
              f"{c['layers_traced']}/{c['layers_total']}, microbatches "
              f"{c['microbatches_traced']}/{c['microbatches']}), cell "
              f"{c['wall_s']:.1f} s; state_bytes_per_device "
              f"{c['state_bytes_per_device']}; roofline compute "
              f"{r['compute_s']:.6g} s, memory {r['memory_s']:.6g} s, "
              f"collective {r['collective_s']:.6g} s -> {r['bottleneck']}, "
              f"fraction {r['roofline_fraction']:.4f}; flops/device "
              f"{c['hlo']['flops_per_device']:.6g}, hbm bytes/device "
              f"{c['hlo']['hbm_bytes_per_device']:.6g}, collective bytes "
              f"{c['hlo']['collective_total_bytes']:.6g} "
              f"({c['hlo']['n_collectives']} collectives, exposed "
              f"{c['hlo']['exposed_collective_s']:.6g} s); peak estimate "
              f"{c['memory_analysis']['peak_bytes'] / 1e9:.3f} GB; "
              f"unsuppressed lint findings {c['lint']}; on {CARD}",
              flush=True)
        if c["status"] != "ok" or not c["hlo"]["flops_per_device"] > 0:
            fail(f"static: dry-run cell {name} gave no FLOPs")
        ref = REFERENCE_CELLS[name]
        got = (c["hlo"]["flops_per_device"],
               c["hlo"]["hbm_bytes_per_device"],
               c["hlo"]["collective_total_bytes"])
        ratios = [g / r for g, r in zip(got, ref)]
        print(f"static dryrun: {name} per device, port / reference "
              f"(reference, XLA:CPU, ROADMAP.md section 3): FLOPs "
              f"{got[0]:.4g} / {ref[0]:.3g} = {ratios[0]:.3f}, HBM bytes "
              f"{got[1]:.4g} / {ref[1]:.3g} = {ratios[1]:.3f}, collective "
              f"bytes {got[2]:.4g} / {ref[2]:.3g} = {ratios[2]:.3f}; on "
              f"{CARD}", flush=True)
        if name.startswith("qwen3-32b") and name.endswith(("train_4k",
                                                           "prefill_32k")) \
                and ratios[0] > FLOPS_RATIO_MAX:
            fail(f"static: {name} counts {ratios[0]:.3f} x the "
                 f"reference's FLOPs per device")
    if kimi is None:
        print(f"static dryrun: kimi-k2-1t-a32b train_4k on 2x16x16 did not "
              f"end within {KIMI_TIMEOUT_S} s ({kimi_s:.1f} s), left out; "
              f"on {CARD}", flush=True)
    else:
        print(f"static dryrun: kimi-k2-1t-a32b train_4k child {kimi_s:.1f} "
              f"s; on {CARD}", flush=True)
    p = res["peak"]
    ratio = p["estimate"] / p["measured"]
    print(f"static peak: stablelm-1.6b full width, one train step (world "
          f"1, float32 weights and moments, batch 2 x 64): estimate "
          f"{p['estimate'] / 1e9:.4f} GB (persistent "
          f"{p['persistent'] / 1e9:.4f} GB; the fake run's own high-water "
          f"mark {p['fake_peak'] / 1e9:.4f} GB; {p['records']} records, "
          f"traced in {p['trace_s']:.1f} s) against "
          f"torch.cuda.max_memory_allocated {p['measured'] / 1e9:.4f} GB "
          f"of the step run: ratio {ratio:.4f} (held to {PEAK_RATIO}); "
          f"loss {p['loss']!r}; on {CARD}", flush=True)
    if not PEAK_RATIO[0] <= ratio <= PEAK_RATIO[1]:
        fail(f"static: the peak estimate is {ratio:.4f} of the measured")
    p2 = res["peak_m2"]
    ratio2 = p2["estimate"] / p2["measured"]
    over = p2["measured"] / p["measured"]
    print(f"static peak: stablelm-1.6b full width, one train step of 2 "
          f"microbatches (world 1, batch 2 x 64, one row a microbatch): "
          f"estimate {p2['estimate'] / 1e9:.4f} GB (the fake run's own "
          f"high-water mark {p2['fake_peak'] / 1e9:.4f} GB; "
          f"{p2['records']} records, traced in {p2['trace_s']:.1f} s) "
          f"against torch.cuda.max_memory_allocated "
          f"{p2['measured'] / 1e9:.4f} GB of the step run: ratio "
          f"{ratio2:.4f} (held to {PEAK_RATIO}); peak over the one-"
          f"microbatch step's {over:.4f} (held to at most "
          f"{PEAK_MICRO_MAX}); loss {p2['loss']!r}; on {CARD}", flush=True)
    if not PEAK_RATIO[0] <= ratio2 <= PEAK_RATIO[1]:
        fail(f"static: the 2-microbatch peak estimate is {ratio2:.4f} of "
             f"the measured")
    if over > PEAK_MICRO_MAX:
        fail(f"static: the 2-microbatch step peaks at {over:.4f} x the "
             f"one-microbatch step's")
    t = res["two_tier"]
    same = t["tokens_two_tier"] == t["tokens_dense"]
    print(f"static two-tier: glm4-9b full width (float32 compute), 16-token "
          f"prompt, {TWO_TIER_TOKENS} greedy decodes two-tier (frozen main "
          f"cache, {TWO_TIER_TOKENS}-slot recent buffer) against dense: "
          f"largest |dlogit| {t['max_dlogit']:.3e}, greedy tokens equal "
          f"{same}, main cache frozen {t['main_frozen']}; both paths "
          f"{t['s']:.2f} s; on {CARD}", flush=True)
    if not same or not t["main_frozen"]:
        fail("static: two-tier decode differs from dense decode")


def profiler_probe(when: str) -> None:
    """Print how many of one fill's and one negation's two device records
    a profiler session keeps (a short session late in this process has
    been seen to keep fewer: PERF.md section 7), beside
    :func:`plain_profiler_probe`."""
    n = len(device_ops(lambda: torch.ones(1 << 20, device="cuda").neg_()))
    print(f"profiler {when}: one fill and one negation record {n} device "
          "operations (2 expected)", flush=True)
    plain_profiler_probe(when)


def plain_profiler_probe(when: str) -> None:
    """The same two operations under ``torch.profiler`` alone, with no
    code of the port or of this script between them: after a
    ``torch.cuda.synchronize()``, one session around a fill and a
    negation, as ``core/capture.py`` opens one around a step.  Prints the
    device records against the CUDA API launch calls (the same count
    ``capture`` calls lost), once as is and once with 50 ms of host time
    before the session stops."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    counts = []
    for wait in (0.0, 0.05):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            x = torch.ones(1 << 20, device="cuda")
            x.neg_()
            torch.cuda.synchronize()
            time.sleep(wait)
        ev = prof.events()
        launched = [e.id for e in ev if e.device_type == DeviceType.CPU
                    and e.name.startswith(("cudaLaunchKernel",
                                           "cuLaunchKernel",
                                           "cudaMemsetAsync",
                                           "cudaMemcpyAsync"))]
        recorded = {e.id for e in ev if e.device_type == DeviceType.CUDA}
        counts.append((len(recorded), len(launched),
                       sum(i not in recorded for i in launched)))
    print(f"profiler {when}, plain torch.profiler (no code of the port): "
          f"one fill and one negation record {counts[0][0]} device "
          f"operations of {counts[0][1]} launched ({counts[0][2]} lost); "
          f"with 50 ms before the session stops {counts[1][0]} of "
          f"{counts[1][1]} ({counts[1][2]} lost); torch "
          f"{torch.__version__}, CUDA {torch.version.cuda}", flush=True)


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
    phase_serving()
    dist_launches = phase_dist()
    phase_mesh_serving()
    phase_spec_mesh()
    phase_static()
    for row in kernels:
        row["launches_dist"] = dist_launches.get(row["name"], 0)
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
