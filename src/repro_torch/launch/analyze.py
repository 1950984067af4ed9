"""Workload characterization + offload planning — the paper's §V case
studies end-to-end on one model, on the GPU.

  1. instrumented inference → per-operator working sets (Table V),
  2. time-series hotness → pin/evict candidates (Fig. 13),
  3. host-offload planner → object vs tensor granularity under
     oversubscription (Figs. 11–12),
  4. cross-level locator → most memory-referenced kernel.

Every TRACE_BUFFER of access records is reduced on ``device`` by the
hand-written CUDA kernels (the fused counts+hotness kernel when it fits).

    PYTHONPATH=src python -m repro_torch.launch.analyze [--arch glm4-9b]
        [--steps 4] [--reduced] [--device cuda] [--spans]

``--arch`` is any of the twelve architectures of
:mod:`repro_torch.configs`.  Those with ``frontend="embed"`` (qwen2-vl-72b,
musicgen-large) take (2, 64, d_model) float32 embeddings in place of
tokens, as the example feeds them.  ``--spans`` turns the port's probe
(:mod:`repro_torch.probe`) on and prints, at the end, each span's
self time a step and the counters a step.
"""

from __future__ import annotations

import argparse

import torch

import repro_torch.configs as configs
import repro_torch.core as pasta
from repro_torch import probe
from repro_torch.core.pool import CHUNK_ALIGN
from repro_torch.core.tools import offload
from repro_torch.models import init_params, forward
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import torch_dtype

#: the reference example's hotness map: 256 blocks of 2**5 512-B units
#: (16 KiB), which covers 4 MiB — enough for a reduced model only
REF_BLOCKS, REF_SHIFT = 256, 5
MAX_BLOCKS = 4096


def hotness_config(cfg: ModelConfig, steps: int) -> dict:
    """The reference's constants when they cover the model's parameter
    bytes; otherwise the smallest ``block_shift`` for which at most 4096
    blocks cover them (at full width the reference's 4 MiB map would drop
    almost every record)."""
    footprint = cfg.n_params * torch_dtype(cfg.param_dtype).itemsize
    shift, n_blocks = REF_SHIFT, REF_BLOCKS
    if footprint > n_blocks * (512 << shift):
        while MAX_BLOCKS * (512 << shift) < footprint:
            shift += 1
        n_blocks = -(-footprint // (512 << shift))
    return {"base": CHUNK_ALIGN, "n_blocks": n_blocks, "n_tbins": steps,
            "t_max": float(steps), "block_shift": shift}


def make_inputs(cfg: ModelConfig, seed: int, device):
    """Random parameters (from ``seed``) and a (2, 64) int32 token batch
    (from ``seed + 1``), the example's shapes; (2, 64, d_model) float32
    standard-normal embeddings under the ``embed`` frontend."""
    params = init_params(cfg, seed, device)
    gen = torch.Generator(device=device).manual_seed(seed + 1)
    if cfg.frontend == "embed":
        return params, torch.randn((2, 64, cfg.d_model), generator=gen,
                                   dtype=torch.float32, device=device)
    tokens = torch.randint(0, max(cfg.vocab_size, 2), (2, 64), generator=gen,
                           dtype=torch.int32, device=device)
    return params, tokens


def offload_plans(schedule, pool, oversubscriptions=(1.0, 3.0)) -> dict:
    """Offload plans over the run's kernel schedule and pool objects."""
    objects = {o.oid: o.size for o in pool.objects.values()}
    return {ov: offload.plan(schedule, objects, pool.footprint, ov)
            for ov in oversubscriptions}


def run(cfg: ModelConfig, steps: int = 4, device="cuda",
        hotness: dict | None = None, seed: int = 0, observe=None):
    """Instrumented inference of ``cfg`` for ``steps`` steps on ``device``.

    ``hotness`` defaults to :func:`hotness_config`.  ``observe``, when
    given, is called with the session before the first step (to subscribe
    extra consumers to ``session.handler``).  Returns ``(reports, logits,
    schedule)``: the session's reports, the last step's logits and the
    per-operator :class:`~repro_torch.core.tools.offload.KernelAccess`
    schedule.
    """
    # float32 stays float32 on the card (cuDNN would default to TF32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    hot_cfg = hotness if hotness is not None else hotness_config(cfg, steps)
    session = pasta.Session(
        tools=["workingset",
               pasta.HotnessTool(n_tbins=hot_cfg["n_tbins"],
                                 n_blocks=hot_cfg["n_blocks"],
                                 hot_frac=0.75),
               "locator"],
        hotness=hot_cfg, instrument=True, fine=True,
        pool_chunk=128 << 10, pool_align=4 << 10,
        name=f"analyze/{cfg.name}", torch_device=device)
    handler = session.handler
    session.instrumenter.time_source = \
        lambda: float(max(handler._step, 0))

    params, x = make_inputs(cfg, seed, device)

    schedule = []
    addr2obj = {}
    handler.subscribe(
        lambda e: addr2obj.update({e.addr: (e.attrs["object_id"], e.size,
                                            e.attrs["tensor_id"])}),
        kinds=("tensor_alloc",))

    def grab(ev):
        tensors = [(addr2obj.get(a, (0, s, a))[2], s,
                    addr2obj.get(a, (0, s, a))[0])
                   for a, s in ev.attrs.get("tensors", ())]
        if tensors:
            schedule.append(offload.KernelAccess(
                ev.name, max(sum(s for _t, s, _o in tensors) / 20e9, 5e-5),
                tensors))
    handler.subscribe(grab, kinds=("operator_start",))
    if observe is not None:
        observe(session)

    logits = None
    with torch.inference_mode(), session:
        for s in range(steps):
            handler.step_start(s)
            # the clone outlives the step; the hooked logits die here, as
            # the reference example's discarded result does
            logits = torch.clone(forward(params, x, cfg)[0])
            handler.step_end(s)
    return session.reports(), logits, schedule


def span_lines(rows) -> list:
    """Lines for the probe's step rows (:func:`probe.snapshot`): each
    span's self time a step, largest first, then each counter a step."""
    steps = [r for r in rows if r["step"] is not None]
    if not steps:
        return ["spans: no step was run"]
    spans: dict = {}
    counts: dict = {}
    for r in steps:
        for name, s in r["spans"].items():
            acc = spans.setdefault(name, [0, 0, 0])
            acc[0] += s["self_ns"]
            acc[1] += s["total_ns"]
            acc[2] += s["calls"]
        for name, n in r["counts"].items():
            counts[name] = counts.get(name, 0) + n
    n = len(steps)
    out = [f"spans over {n} steps (ms a step: self, total; calls a step):"]
    for name, (self_ns, total_ns, calls) in sorted(
            spans.items(), key=lambda kv: -kv[1][0]):
        out.append(f"  {name}: {self_ns / n / 1e6:.3f} self, "
                   f"{total_ns / n / 1e6:.3f} total, {calls / n:g} calls")
    out.append("counters a step: " + ", ".join(
        f"{name} {v / n:g}" for name, v in sorted(counts.items())))
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="glm4-9b",
                    choices=configs.list_archs())
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--reduced", action="store_true",
                    help="the reference example's tiny variant")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--spans", action="store_true",
                    help="turn the probe's spans on and print them at the end")
    args = ap.parse_args(argv)
    if args.spans:
        probe.enable()

    cfg = configs.get(args.arch)
    if args.reduced:
        cfg = configs.reduced(cfg)
    hot_cfg = hotness_config(cfg, args.steps)
    print(f"hotness: {hot_cfg['n_blocks']} blocks of "
          f"{(512 << hot_cfg['block_shift']) >> 10} KiB x "
          f"{hot_cfg['n_tbins']} time bins")
    sessions = []
    reports, _logits, schedule = run(cfg, args.steps, args.device, hot_cfg,
                                     observe=sessions.append)
    print(f"== {args.arch} characterization ==")
    w = reports["workingset"]
    print(f"working set: max={w['working_set_mb']:.2f}MB "
          f"median={w['median_ws_mb']:.2f}MB "
          f"footprint={w['footprint_mb']:.1f}MB")
    h = reports["hotness"]
    print(f"hotness: persistent(pin)={len(h['persistent_blocks'])} "
          f"bursty(evict)={len(h['bursty_blocks'])} cold={h['cold_blocks']}")
    locr = reports["locator"]
    print(f"locator: hottest={locr.get('kernel')} "
          f"op={locr.get('hlo_op_name', '')[:60]}")
    for ov, plan in offload_plans(schedule, sessions[0].pool).items():
        print(f"offload @ oversubscription {ov}: "
              f"object={plan['object']['speedup_vs_none']:.2f}x "
              f"tensor={plan['tensor']['speedup_vs_none']:.2f}x vs on-demand")
    if args.spans:
        for line in span_lines(probe.snapshot()):
            print(line)


if __name__ == "__main__":
    main()
