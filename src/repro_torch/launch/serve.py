"""Serving launcher: ``python -m repro_torch.launch.serve --arch <id> [...]``.

Open-loop request-trace launcher over the request-lifecycle
``ServeEngine``, on the card unless ``--device cpu``: ``--num-requests``
ragged prompts (optionally sharing a ``--shared-prefix``) arrive as a
Poisson process at ``--rate`` req/s (0 = all at once) and are
``submit()``-ed into the continuous-batching scheduler; the loop ticks
``engine.step()`` until the trace drains.  PASTA instrumentation has two
levels: the fleet session carries the registered ``serving`` tool
(TTFT/TPOT percentiles, batch-occupancy timeline, prefix-cache hit rate)
plus whatever ``--pasta-tools`` names, and each request's child session
carries ``--request-tools``. The fleet's ``kernel_freq`` report comes from
one fused decode call captured with :func:`repro_torch.core.capture.
capture_step` (the device kernels on the card, aten operators on the CPU),
at parked rows so the pool is unchanged.

Multi-tenant traffic: ``--traffic <preset>`` swaps the uniform Poisson
trace for a ``repro_torch.serve.traffic`` preset, ``--policy`` picks the
scheduling policy (fcfs/priority/edf/fair), ``--save-trace out.jsonl``
writes the materialized trace and ``--trace-file in.jsonl`` replays one.
``--chaos <preset> --chaos-seed N`` arms a deterministic fault plan;
``--deadline-s`` stamps a hard per-request deadline onto every request.

``--json <path>`` writes the structured results in the reference launcher's
one-dict-per-run contract.  ``--compile-cache`` (XLA's persistent
compilation cache) has no PyTorch counterpart and raises if given.

On a mesh, ``--devices N --mesh DxM`` (data × model, D·M = N) spawns N
ranks, one per card (a ``FileStore`` in a temporary directory; NCCL on
``cuda``, gloo only with ``--device cpu``), the counterpart of the
reference's forced host devices.  Each rank places the weights leaf by
leaf (``init_params(shardings=)``), builds the mesh engine and serves the
same trace; the engine agrees its clock and plan over the ranks
(``serve.engine.MeshSync``), and the launcher's arrival check is one of
its sync points.  Rank 0 alone prints and writes ``--json``.  Every rank
captures the decode (the captured call holds collectives); rank 0's
reports are the run's.

    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \
        --devices 4 --mesh 2x2 --reduced
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import sys
import tempfile
import time

import numpy as np

from repro_torch.launch.train import _say, init_rank


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="paper-gpt2")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the weights, pools and model "
                         "calls (the card unless 'cpu')")
    ap.add_argument("--num-requests", type=int, default=8)
    ap.add_argument("--rate", type=float, default=0.0,
                    help="open-loop Poisson arrival rate in req/s "
                         "(0 = submit the whole trace up front)")
    ap.add_argument("--max-slots", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32,
                    help="max prompt length; ragged prompts draw uniformly "
                         "from [prompt-len-min, prompt-len]")
    ap.add_argument("--prompt-len-min", type=int, default=8)
    ap.add_argument("--shared-prefix", type=int, default=0,
                    help="tokens shared by every prompt (prefix-cache "
                         "reuse workload)")
    ap.add_argument("--max-new-tokens", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--no-prefix-cache", action="store_true")
    ap.add_argument("--prefix-block", type=int, default=16,
                    help="prefix-cache key granularity (tokens); in paged "
                         "mode this is also the KV block size")
    ap.add_argument("--no-paged", action="store_true",
                    help="use the legacy dense (slots, max_seq) KV pool "
                         "instead of the paged block pool")
    ap.add_argument("--block-size", type=int, default=None,
                    help="paged KV block width in tokens "
                         "(default: --prefix-block)")
    ap.add_argument("--n-blocks", type=int, default=None,
                    help="paged pool capacity in blocks (default: per-slot "
                         "parity + 2 sequences of prefix-store headroom)")
    ap.add_argument("--prefill-chunk", type=int, default=None,
                    help="per-tick prefill token budget shared across "
                         "mid-prefill requests (bounds decode stalls; "
                         "paged mode only)")
    ap.add_argument("--spec-decode", type=int, default=0, metavar="K",
                    help="speculative decode: draft K tokens per active "
                         "slot per tick, verify in one fused forward "
                         "(0 = off)")
    ap.add_argument("--draft", default="ngram",
                    choices=("ngram", "model"),
                    help="draft source: n-gram prompt-lookup self-draft, "
                         "or a draft model (--draft-arch)")
    ap.add_argument("--draft-arch", default=None,
                    help="arch id for --draft model (reduced to match; "
                         "default: the target model itself)")
    ap.add_argument("--policy", default="fcfs",
                    choices=("fcfs", "priority", "edf", "fair"),
                    help="scheduling policy: fcfs (default), priority / "
                         "edf (preemptive: evict-and-requeue via the "
                         "prefix store), fair (least-served tenant first)")
    ap.add_argument("--interleave", default="chunked",
                    choices=("chunked", "decode"),
                    help="prefill/decode arbitration per tick: spend the "
                         "chunk budget every tick, or defer prefill while "
                         "any slot can decode (needs --prefill-chunk)")
    ap.add_argument("--traffic", default=None,
                    choices=("two-tenant-bursty",),
                    help="multi-tenant traffic preset from "
                         "repro_torch.serve.traffic (overrides the uniform "
                         "Poisson trace flags)")
    ap.add_argument("--trace-file", default=None, metavar="PATH",
                    help="replay a JSONL trace (from --save-trace) "
                         "instead of generating one")
    ap.add_argument("--save-trace", default=None, metavar="PATH",
                    help="write the materialized trace as JSONL for "
                         "exact replay")
    ap.add_argument("--chaos", default=None,
                    choices=("one-poison", "transient", "storm", "pressure"),
                    help="arm a deterministic fault-injection preset "
                         "(repro_torch.serve.faults)")
    ap.add_argument("--chaos-seed", type=int, default=0,
                    help="seed for the chaos preset's fault schedule")
    ap.add_argument("--deadline-s", type=float, default=None,
                    help="hard per-request deadline stamped onto every "
                         "trace request's SLO (status 'timeout' on expiry)")
    ap.add_argument("--compile-cache", default=None, metavar="DIR",
                    help="not on PyTorch: XLA's persistent compilation "
                         "cache has no counterpart (raises if given)")
    ap.add_argument("--no-warmup", action="store_true",
                    help="skip the warm-up dispatches before the trace")
    ap.add_argument("--devices", type=int, default=0,
                    help="ranks to spawn, one per card (0: this process "
                         "alone, the plain engine)")
    ap.add_argument("--mesh", default="1x1",
                    help="DxM data×model mesh; D·M must equal --devices")
    ap.add_argument("--pasta-tools", default="serving,kernel_freq")
    ap.add_argument("--request-tools", default="serving")
    ap.add_argument("--json", default=None, metavar="PATH",
                    help="write structured per-request + fleet results")
    ap.add_argument("--seed", type=int, default=0)
    # deprecated generate()-era spelling, kept for muscle memory
    ap.add_argument("--batch", type=int, default=None,
                    help=argparse.SUPPRESS)
    return ap


def parse_args(argv=None) -> argparse.Namespace:
    """The reference launcher's flags plus ``--device``; refuses the one
    with no counterpart."""
    args = _parser().parse_args(argv)
    if args.compile_cache is not None:
        raise NotImplementedError(
            "--compile-cache: XLA's persistent compilation cache has no "
            "PyTorch counterpart (the port's model calls are eager)")
    if args.batch is not None:
        print("[serve] note: --batch is deprecated; the trace launcher uses "
              "--num-requests/--max-slots", file=sys.stderr)
        args.num_requests = args.batch
    return args


def mesh_dims(args) -> tuple:
    """``--mesh DxM`` as (D, M), checked against ``--devices``: D·M ranks,
    or one process alone without ``--devices``."""
    dims = tuple(int(x) for x in args.mesh.split("x"))
    if len(dims) != 2 or min(dims) < 1:
        raise ValueError(f"--mesh {args.mesh!r}: DxM (data x model)")
    if math.prod(dims) != max(args.devices, 1):
        raise ValueError(f"--mesh {args.mesh} has {math.prod(dims)} "
                         f"devices for --devices {args.devices}")
    return dims


def make_trace(args, vocab: int):
    """Ragged prompts (+ optional shared prefix) and Poisson arrival times."""
    rng = np.random.default_rng(args.seed)
    lo = min(args.prompt_len_min, args.prompt_len)
    lens = rng.integers(lo, args.prompt_len + 1, args.num_requests)
    prefix = rng.integers(0, vocab, (args.shared_prefix,), dtype=np.int32)
    prompts = [np.concatenate([prefix,
                               rng.integers(0, vocab, (int(n),),
                                            dtype=np.int32)])
               for n in lens]
    if args.rate > 0:
        arrivals = np.cumsum(rng.exponential(1.0 / args.rate,
                                             args.num_requests))
    else:
        arrivals = np.zeros(args.num_requests)
    return prompts, arrivals


def _short(data: dict) -> dict:
    return {k: v for k, v in data.items()
            if k not in ("series", "top", "by_label", "by_request")}


def capture_decode(engine, session):
    """Hand one fused decode (a verify when speculative) to the session's
    compiled-step capture, as the reference hands it the compiled
    dispatch.  Paged: every row parked at the span, so its writes drop and
    the pool is unchanged; slot pool: on a copy of the pool's cache."""
    import torch

    from repro_torch.core import capture
    from repro_torch.serve.cache import to_device

    slots = engine.pool.slots
    if engine.paged:
        span = engine.pool.blocks_per_seq * engine.pool.block_size
        cache = engine.pool.cache_view(np.full((slots,), span, np.int32))
    else:
        cache = _clone_tree(engine.pool.cache)
    if engine.spec_k:
        toks = to_device(np.zeros((slots, engine.spec_k + 1), np.int32),
                         engine.device)
        artifact = capture.capture_step(engine._verify, engine.params,
                                        cache, toks, engine._verify_idx_dev)
    else:
        toks = to_device(np.zeros((slots, 1), np.int32), engine.device)
        artifact = capture.capture_step(engine._decode, engine.params,
                                        cache, toks)
    del cache
    if engine.device.type == "cuda":
        torch.cuda.synchronize()
    return session.capture_compiled(artifact, label="serve.decode",
                                    steps=max(engine.decode_steps, 1))


def _clone_tree(tree):
    if isinstance(tree, dict):
        return {k: _clone_tree(v) for k, v in tree.items()}
    return tree.clone()


def run(args, params=None) -> dict:
    """Serve one trace as the reference launcher does and return its JSON
    result (the ``--json`` contract), plus ``engine``, ``reports`` and
    the captured decode's ``capture`` rollup.  ``params``: the model's
    weights, when the caller already holds them (else
    ``init_params(cfg, args.seed, args.device)``).

    With ``--devices N`` this is one rank of an initialized N-rank process
    group: it builds the data × model mesh, places the weights and serves
    on it (``params`` must then be None)."""
    import torch
    import torch.distributed as dist

    dims = mesh_dims(args)
    world = dist.get_world_size() if dist.is_initialized() else 0
    if args.devices and world != args.devices:
        raise ValueError(f"--devices {args.devices}: this is one rank of "
                         f"{world or 'no'} process group; run the launcher "
                         f"(main), which spawns the ranks")
    if args.devices and params is not None:
        raise ValueError("on a mesh every rank places its own weights")
    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: torch.cuda.is_available() is "
                           "false (pass --device cpu to serve on the CPU)")
    from repro_torch.dist.sharding import set_mesh
    mesh = None
    if args.devices:
        from torch.distributed.device_mesh import init_device_mesh
        mesh = init_device_mesh(args.device, dims,
                                mesh_dim_names=("data", "model"))
    set_mesh(mesh)
    try:
        return _serve(args, params, mesh)
    finally:
        set_mesh(None)


def _serve(args, params, mesh) -> dict:
    import torch
    import torch.distributed as dist

    import repro_torch.configs as configs
    import repro_torch.core as pasta
    from repro_torch.models import init_params
    from repro_torch.serve import (SamplingParams, ServeEngine, SLOSpec,
                                   traffic)

    device = args.device
    if mesh is not None and device == "cuda":
        device = f"cuda:{torch.cuda.current_device()}"
    cfg = configs.get(args.arch)
    if args.reduced:
        cfg = configs.reduced(cfg)
    vocab = max(cfg.vocab_size, 2)
    trace_meta = {"seed": args.seed}
    if args.trace_file:
        trace, trace_meta = traffic.load_trace(args.trace_file)
        _say(f"[serve] replaying {len(trace)} requests from "
             f"{args.trace_file} (meta={trace_meta})")
    elif args.traffic:
        trace = traffic.PRESETS[args.traffic](vocab, seed=args.seed)
    else:
        prompts, arrivals = make_trace(args, vocab)
        trace = [traffic.TraceRequest(arrival_s=float(a), prompt=p,
                                      max_new_tokens=args.max_new_tokens,
                                      slo=None)
                 for a, p in zip(arrivals, prompts)]
    if args.save_trace and (mesh is None or dist.get_rank() == 0):
        traffic.save_trace(args.save_trace, trace, seed=args.seed,
                           meta={"preset": args.traffic,
                                 "arch": args.arch})
        print(f"[serve] wrote trace {args.save_trace}")
    if args.deadline_s is not None:
        trace = [dataclasses.replace(
                     t, slo=(dataclasses.replace(t.slo,
                                                 deadline_s=args.deadline_s)
                             if t.slo is not None
                             else SLOSpec(deadline_s=args.deadline_s)))
                 for t in trace]
    if args.traffic or args.trace_file:
        max_seq = traffic.max_seq_for(trace)
    else:
        max_seq = args.shared_prefix + args.prompt_len + args.max_new_tokens

    with pasta.Session(tools=args.pasta_tools, name="serve",
                       torch_device=device) as session:
        init_peaks = None
        if mesh is not None:
            params, init_peaks = _placed_params(cfg, args, device, mesh,
                                                max_seq)
        elif params is None:
            params = init_params(cfg, args.seed, device)
        paged = False if args.no_paged else None   # None = family default
        draft_cfg = None
        if args.draft_arch is not None:
            draft_cfg = configs.get(args.draft_arch)
            if args.reduced:
                draft_cfg = configs.reduced(draft_cfg)
        engine = ServeEngine(cfg, params, max_seq=max_seq,
                             max_slots=args.max_slots, session=session,
                             request_tools=args.request_tools or None,
                             prefix_cache=not args.no_prefix_cache,
                             prefix_block=args.prefix_block,
                             paged=paged, block_size=args.block_size,
                             n_blocks=args.n_blocks,
                             prefill_chunk=args.prefill_chunk,
                             spec_decode=args.spec_decode, draft=args.draft,
                             draft_cfg=draft_cfg,
                             policy=args.policy,
                             interleave=args.interleave,
                             rng_seed=args.seed,
                             faults=args.chaos, fault_seed=args.chaos_seed)
        if args.chaos:
            _say(f"[serve] chaos armed: preset={args.chaos} "
                 f"seed={args.chaos_seed} "
                 f"({len(engine.faults.specs)} fault specs)")
        compile_s = 0.0
        if not args.no_warmup:
            # the steady-state dispatches run once BEFORE the trace clock
            # starts, so TTFT/TPOT percentiles measure serving latency
            wu = engine.warmup(prompt_lens=[len(t.prompt) for t in trace])
            compile_s = wu["compile_s"]
            _say(f"[serve] warmup: {len(wu['warmed'])} shapes run in "
                 f"{compile_s:.2f}s (excluded from the trace clock)")
        # the arrival check reads the engine's clock (rank 0's on a mesh,
        # where it is a sync point that also holds the loop's state equal)
        t_wall = time.perf_counter()
        t0 = engine.sync.clock()
        pending = [(t.arrival_s, t) for t in trace]
        rids = []
        outputs = {}            # collected at retirement (pruning-safe)
        while True:
            now = engine.sync.agree(
                engine.ticks, "arrival check",
                {"pending": len(pending), "working": engine.has_work},
                clock=True) - t0
            if not (pending or engine.has_work):
                break
            while pending and pending[0][0] <= now:
                t = pending.pop(0)[1]
                rids.append(engine.submit(
                    t.prompt,
                    SamplingParams(max_new_tokens=t.max_new_tokens,
                                   temperature=args.temperature),
                    slo=t.slo))
            if engine.has_work:
                for rid in engine.step()["finished"]:
                    outputs[rid] = list(engine.requests[rid].tokens)
            elif pending:
                time.sleep(min(pending[0][0] - now, 0.05))
        dt = time.perf_counter() - t_wall
        n_tok = sum(len(t) for t in outputs.values())
        _say(f"[serve] {len(rids)} requests, {n_tok} tokens in {dt:.2f}s "
             f"({n_tok / dt:.1f} tok/s), max_slots={args.max_slots}, "
             f"policy={args.policy}, rate={args.rate or 'inf'}")
        if engine.preemptions:
            _say(f"[serve] preemptions={engine.preemptions} "
                 f"parked_blocks={engine.parked_blocks} "
                 f"recovered_blocks={engine.recovered_blocks} "
                 f"(zero-recompute resume)")
        if engine.spec_k:
            acc = (engine.accepted_tokens / engine.drafted_tokens
                   if engine.drafted_tokens else 0.0)
            _say(f"[serve] speculative k={engine.spec_k} "
                 f"({args.draft}): {engine.accepted_tokens}/"
                 f"{engine.drafted_tokens} drafts accepted "
                 f"({acc:.2f}), {engine.decode_steps} verify ticks")
        health = engine.health()
        if args.chaos or args.deadline_s is not None:
            _say(f"[serve] health: faults={health['fault_ticks']} "
                 f"retries={health['request_retries']} "
                 f"failed={health['failed']} "
                 f"timeouts={health['timeouts']} "
                 f"isolated={health['isolated_innocents']} "
                 f"degraded_ticks={health['degraded_ticks']}")
        done_rids = [r for r in rids if r in outputs]
        if done_rids:
            _say(f"[serve] sample: {outputs[done_rids[0]][:12]}")
        else:
            _say("[serve] sample: <no finished requests>")
        # fleet kernel_freq sees the fused decode's device kernels; a
        # failure here propagates (the reference prints and carries on).
        # On a mesh every rank captures: the call holds collectives
        captured = capture_decode(engine, session)
        reports = session.reports()

    serving = reports["serving"].data if "serving" in reports else {}
    for name, rep in reports.items():
        _say(f"  {name}: {_short(rep.data)}")
    mesh_out = None
    if mesh is not None:
        from repro_torch.kernels import ops
        nccl = {}
        for inst in captured.collective_instances:
            nccl[inst["name"]] = nccl.get(inst["name"], 0) + 1
        launches = [None] * dist.get_world_size()
        dist.all_gather_object(launches, dict(ops.launches))
        mesh_out = {"shape": list(mesh.shape), "init_peak_gb": init_peaks,
                    "decode_collectives": nccl,
                    "trace_kernel_launches": {
                        k: sum(r.get(k, 0) for r in launches)
                        for k in launches[0]}}
        _say(f"[serve] captured decode on the mesh: collectives {nccl} "
             f"(COLLECTIVE events; kernel_freq counts the kernel "
             f"launches); trace-kernel launches over the ranks "
             f"{mesh_out['trace_kernel_launches']}")
    per_request = []
    for req_reports in engine.request_reports:
        for name, rep in req_reports.items():
            per_request.append({"session": rep.session, "tool": name,
                                "data": rep.data})
    occ = serving.get("occupancy", {})
    pc = serving.get("prefix_cache", {})
    out = {
        "driver": "serve",
        "arch": args.arch,
        "status": "ok",
        "config": {
            "reduced": args.reduced,
            "num_requests": args.num_requests,
            "rate": args.rate,
            "max_slots": args.max_slots,
            "prompt_len": [args.prompt_len_min, args.prompt_len],
            "shared_prefix": args.shared_prefix,
            "max_new_tokens": args.max_new_tokens,
            "temperature": args.temperature,
            "prefix_cache": not args.no_prefix_cache,
            "paged": engine.paged,
            "block_size": engine.block_size,
            "prefill_chunk": engine.prefill_chunk,
            "spec_decode": engine.spec_k,
            "draft": args.draft if engine.spec_k else None,
            "warmup": not args.no_warmup,
            "seed": args.seed,
            "mesh": args.mesh,
            "policy": args.policy,
            "interleave": args.interleave,
            "traffic": args.traffic,
            "trace_file": args.trace_file,
            "trace_seed": trace_meta.get("seed", args.seed),
            "chaos": args.chaos,
            "chaos_seed": args.chaos_seed,
            "deadline_s": args.deadline_s,
            "compile_cache": args.compile_cache,
            "device": str(engine.device),
        },
        "summary": {
            "wall_s": dt,
            "compile_s": compile_s,
            "generated_tokens": n_tok,
            "tok_per_s": n_tok / dt if dt > 0 else 0.0,
            "ttft_s": serving.get("ttft_s"),
            "tpot_s": serving.get("tpot_s"),
            "queue_s": serving.get("queue_s"),
            "occupancy_mean": occ.get("mean"),
            "occupancy_max": occ.get("max"),
            "decode_steps": serving.get("decode_steps"),
            "prefix_hit_rate": pc.get("hit_rate"),
            "prefix_reused_frac": pc.get("reused_frac"),
            "max_prefill_tokens_per_tick":
                serving.get("prefill", {}).get("max_tokens_per_tick"),
            "max_prefill_stall_s":
                serving.get("prefill", {}).get("max_stall_s"),
            "speculative": serving.get("speculative"),
            "bandwidth": serving.get("bandwidth"),
            "pool": engine.pool_stats(),
            "slo": serving.get("slo"),
            "preemption": serving.get("preemption"),
            "tenants": serving.get("tenants"),
            "health": serving.get("health"),
            "engine_health": health,
            "faults": (engine.faults.to_dict()
                       if engine.faults is not None else None),
        },
        "fleet": {name: rep.data for name, rep in reports.items()},
        "requests": per_request,
        "tokens": {int(rid): [int(t) for t in toks]
                   for rid, toks in outputs.items()},
        "request_states": {int(rid): engine.requests[rid].state.value
                           for rid in rids if rid in engine.requests},
    }
    if mesh_out is not None:
        out["mesh"] = mesh_out
    return {"result": out, "engine": engine, "reports": reports,
            "capture": captured}


def _placed_params(cfg, args, device, mesh, max_seq) -> tuple:
    """The weights placed leaf by leaf on every rank, and each card's
    peak device memory over the placement (GB; None on the CPU)."""
    import torch
    import torch.distributed as dist

    from repro_torch.models import init_params
    from repro_torch.train.trainer import serve_shardings

    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    p_sh = serve_shardings(mesh, cfg, args.max_slots, max_seq)[0]
    params = init_params(cfg, args.seed, device, shardings=p_sh)
    peak = torch.cuda.max_memory_allocated() / 1e9 if cuda else None
    peaks = [None] * dist.get_world_size()
    dist.all_gather_object(peaks, peak)
    _say(f"[serve] weights placed leaf by leaf on data {mesh.shape[0]} x "
         f"model {mesh.shape[1]} in {time.perf_counter() - t0:.2f}s; peak "
         f"device memory per card over the placement "
         f"{[None if p is None else round(p, 2) for p in peaks]} GB")
    return params, peaks


def _write_json(args, out: dict) -> None:
    with open(args.json, "w") as f:
        json.dump(out, f, indent=1, default=str)
    print(f"[serve] wrote {args.json}")


def _rank_main(rank: int, world: int, store_path: str, argv) -> None:
    import torch.distributed as dist

    args = parse_args(argv)
    init_rank(rank, world, store_path, args.device)
    try:
        out = run(args)["result"]
        if rank == 0 and args.json:
            _write_json(args, out)
    finally:
        dist.destroy_process_group()


def main(argv=None) -> int:
    args = parse_args(argv)
    mesh_dims(args)
    if args.devices:
        import torch
        import torch.multiprocessing as mp
        if args.device == "cuda" and torch.cuda.device_count() < \
                args.devices:
            raise RuntimeError(
                f"--devices {args.devices}: the machine has "
                f"{torch.cuda.device_count()} cards (one rank per card)")
        with tempfile.TemporaryDirectory() as tmp:
            mp.spawn(_rank_main, args=(args.devices,
                                       os.path.join(tmp, "store"),
                                       argv if argv is not None
                                       else sys.argv[1:]),
                     nprocs=args.devices, join=True)
        return 0
    out = run(args)["result"]
    if args.json:
        _write_json(args, out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
