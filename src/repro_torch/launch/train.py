"""Training driver: ``python -m repro_torch.launch.train --arch <id> [...]``.

Runs end-to-end training with the PASTA tool stack attached: the train
step (one profiled call of it feeds the kernel/collective event source,
:func:`repro_torch.core.capture.capture_step`), step-indexed data,
elastic checkpoint/restart, straggler watchdog — on the card unless
``--device cpu``.

``--devices N`` spawns N ranks (``torch.multiprocessing``, a ``FileStore``
in a temporary directory), the counterpart of the reference's forced host
devices; the process group is NCCL on ``cuda`` (one card per rank) and
gloo only on ``--device cpu``.  ``--mesh DxM`` (data × model) or ``PxDxM``
(pod × data × model) must cover the N ranks.  ``--compile-cache`` (XLA's
persistent compilation cache) has no PyTorch counterpart and raises.

    PYTHONPATH=src python -m repro_torch.launch.train --device cpu \\
        --devices 4 --mesh 2x2 --reduced
"""

from __future__ import annotations

import argparse
import math
import os
import sys
import tempfile
import time

import torch
import torch.distributed as dist


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="paper-gpt2")
    ap.add_argument("--reduced", action="store_true",
                    help="family-preserving tiny config (CPU demo)")
    ap.add_argument("--device", default="cuda",
                    help="torch device of every rank (the card unless "
                         "'cpu')")
    ap.add_argument("--seq-len", type=int, default=256)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--devices", type=int, default=0,
                    help="ranks to spawn (0 or 1: this process alone)")
    ap.add_argument("--mesh", default="1x1",
                    help="DxM data×model mesh (e.g. 2x4) or PxDxM "
                         "pod×data×model (e.g. 2x2x2)")
    ap.add_argument("--overlap-sync", default="auto",
                    choices=("auto", "blocking", "overlap"),
                    help="cross-pod gradient sync on a PxDxM mesh: "
                         "DTensor-implicit (auto), explicit blocking "
                         "all-reduce at step end, or the bucketed "
                         "psum_start/psum_wait overlap pipeline")
    ap.add_argument("--sync-compressed", action="store_true",
                    help="int8 quantized reduce-scatter + all-gather for "
                         "the explicit cross-pod sync")
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--pasta-tools", default="kernel_freq,timeline",
                    help="tool spec, e.g. 'kernel_freq,timeline'; knobs via "
                         "'name:knob=val'; '' disables")
    ap.add_argument("--inject-failure-at", type=int, default=None)
    ap.add_argument("--data", default="", help="token .bin file (synthetic "
                                               "if empty)")
    ap.add_argument("--compile-cache", default=None, metavar="DIR",
                    help="not supported: the port's train step is eager")
    ap.add_argument("--seed", type=int, default=0)
    return ap


def parse_args(argv=None) -> argparse.Namespace:
    """The reference driver's flags plus ``--device``; refuses the one
    with no counterpart."""
    args = _parser().parse_args(argv)
    if args.compile_cache is not None:
        raise NotImplementedError(
            "--compile-cache: XLA's persistent compilation cache has no "
            "PyTorch counterpart (the port's train step is eager)")
    return args


def _mesh_dims(spec: str) -> tuple:
    dims = tuple(int(x) for x in spec.split("x"))
    if not 1 <= len(dims) <= 3:
        raise ValueError(f"--mesh {spec!r}: DxM or PxDxM")
    return dims


def _say(*a) -> None:
    if not dist.is_initialized() or dist.get_rank() == 0:
        print(*a, flush=True)


def run(args: argparse.Namespace) -> dict:
    """One rank's whole run (this process alone, or one rank of an
    initialized process group whose size the mesh covers).  Returns the
    losses by step as the loop logged them (a replayed step twice), the
    loop's step durations, restarts and stragglers, the final step, the
    session's reports and the captured step's rollup."""
    import repro_torch.configs as configs
    import repro_torch.core as pasta
    from repro_torch.core import capture
    from repro_torch.dist.sharding import set_mesh
    from repro_torch.models import init_params
    from repro_torch.train import (DataConfig, LoopConfig, OptConfig,
                                   TrainLoop, checkpoint as ckpt,
                                   make_source, make_train_step)
    from repro_torch.train.optimizer import init_opt_state
    from repro_torch.train.trainer import (batch_shardings, place,
                                           train_shardings)

    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: torch.cuda.is_available() is "
                           "false (pass --device cpu to train on the CPU)")
    # float32 stays float32 on the card (cuDNN would default to TF32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = configs.get(args.arch)
    if args.reduced:
        cfg = configs.reduced(cfg)
    device = args.device
    if device == "cuda" and dist.is_initialized():
        device = f"cuda:{torch.cuda.current_device()}"

    dims = _mesh_dims(args.mesh)
    world = dist.get_world_size() if dist.is_initialized() else 1
    if math.prod(dims) > 1 or world > 1:
        if math.prod(dims) != world:
            raise ValueError(f"--mesh {args.mesh} has {math.prod(dims)} "
                             f"devices for {world} ranks")
    mesh = None
    if math.prod(dims) > 1:
        from torch.distributed.device_mesh import init_device_mesh
        mesh = init_device_mesh(args.device, dims, mesh_dim_names=(
            "pod", "data", "model")[-len(dims):])
    set_mesh(mesh)
    overlap_sync = {"auto": None, "blocking": False,
                    "overlap": True}[args.overlap_sync]

    seen: list = []
    with pasta.Session(tools=args.pasta_tools, name="train") as session:
        opt_cfg = OptConfig(lr=args.lr, total_steps=args.steps,
                            moment_dtype=cfg.opt_moment_dtype,
                            warmup_steps=max(2, args.steps // 20))
        step_fn = make_train_step(cfg, opt_cfg,
                                  microbatches=args.microbatches,
                                  overlap_sync=overlap_sync,
                                  sync_compressed=args.sync_compressed)
        with pasta.region("init"):
            params = init_params(cfg, args.seed, device)
            if mesh is not None:
                p_sh, _o_sh, _, _ = train_shardings(mesh, cfg, opt_cfg)
                params = place(params, p_sh, mesh)
            state = {"params": params,
                     "opt": init_opt_state(params, opt_cfg)}
            del params

        dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq_len,
                          global_batch=args.global_batch, seed=args.seed,
                          frontend=cfg.frontend, d_model=cfg.d_model)
        source = make_source(dcfg, args.data or None)
        b_sh = None
        if mesh is not None:
            b_sh = batch_shardings(mesh, source.batch_at(0),
                                   include_pod=overlap_sync is None)

        def place_batch(b):
            batch = {k: torch.from_numpy(v).to(device) for k, v in b.items()}
            return batch if b_sh is None else place(batch, b_sh, mesh)

        start = 0
        if args.resume and args.ckpt_dir:
            last = ckpt.latest_step(args.ckpt_dir)
            if last is not None:
                start, state = ckpt.restore(args.ckpt_dir, state, step=last)
                _say(f"[train] resumed from step {start}")

        loop = TrainLoop(LoopConfig(total_steps=args.steps,
                                    ckpt_every=args.ckpt_every,
                                    ckpt_dir=args.ckpt_dir,
                                    inject_failure_at=args.inject_failure_at),
                         step_fn, source, place_batch)

        def metrics_cb(step, mx):
            seen.append((step, mx["loss"]))
            _say(f"[train] step {step:5d} loss {mx['loss']:.4f} "
                 f"gnorm {mx['grad_norm']:.3f} lr {mx['lr']:.2e} "
                 f"({mx['tokens']:.0f} tok)")

        with pasta.region("train"):
            # the loop gets the only references: each step frees the state
            # it started from
            params, opt_state, step = loop.run(state.pop("params"),
                                               state.pop("opt"), start,
                                               metrics_cb)

        # post-run: one profiled call of the step into the event stream
        example = place_batch(source.batch_at(0))
        t_c = time.perf_counter()
        artifact = capture.capture_step(step_fn, params, opt_state, example)
        capture_s = time.perf_counter() - t_c
        stats = session.capture_compiled(artifact, label="train_step",
                                         default_trip=cfg.n_layers,
                                         steps=step - start)
        reports = session.reports()
    _say("[pasta] tool reports:")
    for name, rep in reports.items():
        short = {k: v for k, v in rep.data.items()
                 if k not in ("series", "top", "by_label")}
        _say(f"  {name}: {short}")
    if loop.stragglers:
        _say(f"[train] straggler steps detected: {loop.stragglers}")
    _say(f"[train] train_step capture_s={capture_s:.3f}")
    _say(f"[train] done at step {step}; restarts={loop.restarts}")
    set_mesh(None)
    return {"losses": seen, "durations": list(loop.durations),
            "restarts": loop.restarts, "stragglers": loop.stragglers,
            "step": step, "reports": reports, "stats": stats,
            "params": params, "opt": opt_state}


def init_rank(rank: int, world: int, store_path: str, device: str) -> None:
    """Join the ``world``-rank process group through the ``FileStore`` at
    ``store_path``: NCCL on ``cuda`` (card ``rank``), gloo on ``cpu``."""
    if device == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("an NCCL process group needs a CUDA card")
        torch.cuda.set_device(rank)
        backend = "nccl"
    elif device == "cpu":
        torch.set_num_threads(1)
        backend = "gloo"
    else:
        raise ValueError(f"device {device!r}: 'cuda' or 'cpu'")
    store = dist.FileStore(store_path, world)
    dist.init_process_group(backend, store=store, rank=rank,
                            world_size=world)


def _rank_main(rank: int, world: int, store_path: str, argv) -> None:
    args = parse_args(argv)
    init_rank(rank, world, store_path, args.device)
    try:
        run(args)
    finally:
        dist.destroy_process_group()


def main(argv=None) -> int:
    args = parse_args(argv)
    if args.devices > 1:
        import torch.multiprocessing as mp
        with tempfile.TemporaryDirectory() as tmp:
            mp.spawn(_rank_main, args=(args.devices,
                                       os.path.join(tmp, "store"),
                                       argv if argv is not None
                                       else sys.argv[1:]),
                     nprocs=args.devices, join=True)
        return 0
    run(args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
