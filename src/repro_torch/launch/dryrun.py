"""Multi-pod dry-run: trace every (arch × shape × mesh) cell on a fake
process group and extract the roofline terms from the step trace.

For each cell this:
  1. builds the production mesh (16×16 single-pod / 2×16×16 multi-pod) on
     a fake process group of its size (``launch.mesh.make_production_mesh``
     inside ``core.trace.trace_step``), as rank 0;
  2. places params / optimizer state / caches as fake DTensors (no
     allocation — the 1T-param config costs nothing);
  3. runs the step once under fake tensors of the card's type
     (``--device``), recording rank 0's aten calls and collectives — a
     placement that DTensor cannot run fails HERE, which is the point of
     the dry-run; the layer loop is cut to ``LAYERS_TRACED`` iterations
     and the microbatch loop to ``MICROBATCHES_TRACED``, and the records
     of the cut loops carry their trip counts;
  4. rolls the trace up (``core.trace.analyze_trace``; kernels through a
     ``Session``'s ``capture_compiled``), estimates the peak from the
     trace's liveness, lints it, and prices it on the H100 roofline;
  5. writes results/dryrun_torch/<arch>__<shape>__<mesh>.json.

Usage:
  python -m repro_torch.launch.dryrun --arch qwen3-32b --shape train_4k
  python -m repro_torch.launch.dryrun --all [--multi-pod] [--skip-existing]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time
import traceback

import torch
from torch.distributed.tensor import distribute_tensor

import repro_torch.configs as configs
import repro_torch.core as pasta
from repro_torch import analysis
from repro_torch.configs.shapes import get_shape
from repro_torch.core.tools import roofline as RL
from repro_torch.core.trace import trace_step
from repro_torch.dist.sharding import DEFAULT_RULES, ShardingRules
from repro_torch.launch.mesh import (make_production_mesh,
                                     production_mesh_shape)
from repro_torch.models.config import ModelConfig
from repro_torch.train import trainer
from repro_torch.train.optimizer import OptConfig, tree_map

ASSIGNED = configs.ASSIGNED
RESULTS_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                           "results", "dryrun_torch")

#: the traced cut: layer-loop iterations and microbatches (the records of
#: the cut loops carry their trip counts); two layers, so the gradient
#: sums a stacked weight receives are counted too
LAYERS_TRACED = 2
MICROBATCHES_TRACED = 1


# ---------------------------------------------------------------------------
# input specs
# ---------------------------------------------------------------------------

def input_specs(cfg: ModelConfig, shape, device: str) -> dict:
    """Tensors standing in for every model input of the cell (made under
    the trace's fake mode: shapes and dtypes only)."""
    b, s = shape.global_batch, shape.seq_len

    def mk(bb, ss):
        if cfg.frontend == "embed":
            return torch.zeros((bb, ss, cfg.d_model), dtype=torch.bfloat16,
                               device=device)
        return torch.zeros((bb, ss), dtype=torch.int32, device=device)

    if shape.kind == "train":
        return {"inputs": mk(b, s),
                "labels": torch.zeros((b, s), dtype=torch.int32,
                                      device=device)}
    if shape.kind == "prefill":
        return {"inputs": mk(b, s)}
    return {"tokens": mk(b, 1)}          # decode: one new token, cache of s


def _opt_cfg(cfg: ModelConfig) -> OptConfig:
    return OptConfig(moment_dtype=cfg.opt_moment_dtype)


def sharded_bytes(shapes_tree, shardings_tree, mesh_axes: dict) -> int:
    """Exact per-device bytes of a tree of tensors placed by
    ``shardings_tree`` (a dimension sharded over mesh dimensions holds
    1/their product of it)."""
    names = list(mesh_axes)
    total = 0
    for path, t in _leaves(shapes_tree):
        placements = _at(shardings_tree, path)
        denom = {}
        for name, p in zip(names, placements):
            if p.is_shard():
                denom[p.dim] = denom.get(p.dim, 1) * int(mesh_axes[name])
        n = 1
        for i, d in enumerate(t.shape):
            n *= d // denom.get(i, 1)
        total += n * t.element_size()
    return total


def _leaves(tree, prefix=()):
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from _leaves(tree[k], (*prefix, k))
        else:
            yield (*prefix, k), tree[k]


def _at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


# ---------------------------------------------------------------------------
# cell builders
# ---------------------------------------------------------------------------

def build_cell(cfg: ModelConfig, shape, mesh_axes: dict, overlap_sync=None,
               device: str = "cuda"):
    """Returns ``(step, setup, meta)``: ``setup(mesh)`` places the step's
    arguments as fake DTensors (called inside the trace).

    ``overlap_sync``: ``None`` keeps DTensor's implicit pod reduction;
    ``False``/``True`` trace the explicit blocking / bucketed-overlap
    cross-pod sync (batch replicated across pods — see
    :mod:`repro_torch.train.trainer`)."""
    meta = {"microbatches": 1}
    include_pod = overlap_sync is None

    def place(mesh, shapes, shardings):
        return tree_map(lambda t, sh: distribute_tensor(
            torch.empty(t.shape, dtype=t.dtype, device=device), mesh, sh),
            shapes, shardings)

    def place_batch(mesh, specs, pod=True):
        sh = trainer.batch_shardings(mesh, specs, include_pod=pod)
        return tree_map(lambda t, s: distribute_tensor(t, mesh, s), specs,
                        sh)

    if shape.kind == "train":
        opt_cfg = _opt_cfg(cfg)
        micro = shape.microbatches
        # keep per-microbatch batch divisible by the dp axes
        dp = mesh_axes.get("data", 1)
        if include_pod:
            dp *= mesh_axes.get("pod", 1)
        while micro > 1 and (shape.global_batch // micro) % dp:
            micro //= 2
        meta["microbatches"] = micro
        meta["overlap_sync"] = overlap_sync
        step = trainer.make_train_step(cfg, opt_cfg, microbatches=micro,
                                       overlap_sync=overlap_sync)

        def setup(mesh):
            p_sh, o_sh, p_shapes, o_shapes = trainer.train_shardings(
                mesh, cfg, opt_cfg)
            meta["state_bytes_per_device"] = (
                sharded_bytes(p_shapes, p_sh, mesh_axes)
                + sharded_bytes(o_shapes, o_sh, mesh_axes))
            return (place(mesh, p_shapes, p_sh), place(mesh, o_shapes, o_sh),
                    place_batch(mesh, input_specs(cfg, shape, device),
                                include_pod))
        return step, setup, meta
    if shape.kind == "prefill":
        step = trainer.make_prefill_step(cfg)

        def setup(mesh):
            p_sh, _c, p_shapes, _cs = trainer.serve_shardings(
                mesh, cfg, shape.global_batch, shape.seq_len)
            meta["state_bytes_per_device"] = sharded_bytes(p_shapes, p_sh,
                                                           mesh_axes)
            specs = place_batch(mesh, input_specs(cfg, shape, device))
            return place(mesh, p_shapes, p_sh), specs["inputs"]
        return step, setup, meta
    step = trainer.make_decode_step(cfg)

    def setup(mesh):
        p_sh, c_sh, p_shapes, c_shapes = trainer.serve_shardings(
            mesh, cfg, shape.global_batch, shape.seq_len)
        meta["state_bytes_per_device"] = (
            sharded_bytes(p_shapes, p_sh, mesh_axes)
            + sharded_bytes(c_shapes, c_sh, mesh_axes))
        specs = place_batch(mesh, input_specs(cfg, shape, device))
        return (place(mesh, p_shapes, p_sh), place(mesh, c_shapes, c_sh),
                specs["tokens"])
    return step, setup, meta


# ---------------------------------------------------------------------------
# run one cell
# ---------------------------------------------------------------------------

def run_cell(arch: str, shape_name: str, multi_pod: bool,
             rules_patch: dict | None = None, tag: str = "",
             cfg_overrides: dict | None = None,
             microbatches: int | None = None,
             overlap_sync: bool | None = None,
             lint_spec: str | None = None, lint_baseline=None,
             device: str = "cuda", reduced: bool = False,
             mesh_shape: tuple | None = None,
             shape_overrides: dict | None = None) -> tuple:
    """``(result dict, Findings or None)`` of one cell.  ``reduced``,
    ``mesh_shape`` (with the production dims' names from the right) and
    ``shape_overrides`` cut a cell to test size."""
    cfg = configs.get(arch)
    if reduced:
        cfg = configs.reduced(cfg)
    if cfg_overrides:
        cfg = dataclasses.replace(cfg, **cfg_overrides)
    shape = get_shape(shape_name)
    if microbatches is not None:
        shape = dataclasses.replace(shape, microbatches=microbatches)
    if shape_overrides:
        shape = dataclasses.replace(shape, **shape_overrides)
    if shape_name == "long_500k" and not cfg.supports_long_context:
        return ({"arch": arch, "shape": shape_name, "status": "skipped",
                 "reason": "pure full-attention arch; 0.5M-token quadratic "
                           "attention out of assigned scope (DESIGN.md §4)"},
                None)
    dims_shape, dims = production_mesh_shape(multi_pod)
    make_mesh = None
    if mesh_shape is not None:
        dims_shape, dims = tuple(mesh_shape), dims[-len(mesh_shape):]
    else:
        def make_mesh(device_type):
            return make_production_mesh(multi_pod=multi_pod,
                                        device_type=device_type)
    mesh_axes = dict(zip(dims, dims_shape))
    chips = 1
    for s in dims_shape:
        chips *= s
    rules = ShardingRules({**DEFAULT_RULES, **(rules_patch or {})})
    step, setup, meta = build_cell(cfg, shape, mesh_axes,
                                   overlap_sync=overlap_sync, device=device)
    placed = {}

    def timed_setup(mesh):
        t0 = time.perf_counter()
        args = setup(mesh)
        placed["s"] = time.perf_counter() - t0
        return args

    trace = trace_step(step, mesh_shape=dims_shape, mesh_dims=dims,
                       device_type=device, setup=timed_setup,
                       cuts={"layers": LAYERS_TRACED,
                             "microbatches": MICROBATCHES_TRACED},
                       params_at=0, rules=rules, make_mesh=make_mesh)
    with pasta.Session(tools="kernel_freq:top_k=5",
                       name=f"dryrun/{arch}/{shape_name}") as sess:
        stats = sess.capture_compiled(trace, label=f"{arch}.{shape_name}")
        lint = analysis.run_passes(
            trace, lint_spec, stats=stats, session=sess,
            baseline=lint_baseline, rules=rules, kind=shape.kind,
            label=f"{arch}.{shape_name}")
    kernel_freq = sess.reports()["kernel_freq"].data
    est = analysis.estimate_peak_bytes(trace)
    outs = {s for _d, _s, s in trace.out_leaves}
    mem_d = {"argument_size_in_bytes": int(est["persistent_bytes"]),
             "output_size_in_bytes": int(sum(
                 trace.storage_bytes.get(s, 0)
                 for s in outs - trace.persistent)),
             "temp_size_in_bytes": int(est["transient_peak_bytes"]),
             "alias_size_in_bytes": int(sum(
                 trace.storage_bytes.get(s, 0)
                 for s in outs & trace.persistent)),
             "peak_bytes": int(est["peak_bytes"])}
    cost_d = {"flops": stats.flops, "bytes accessed": stats.hbm_bytes}

    n_tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode"
                                     else 1)
    mf = RL.model_flops(cfg.n_params, n_tokens,
                        training=shape.kind == "train",
                        n_active_params=cfg.n_active_params
                        if cfg.family == "moe" else None)
    rl = RL.roofline(stats.flops, stats.hbm_bytes,
                     stats.total_collective_bytes,
                     model_flops_per_chip=mf / chips)
    out = {
        "arch": arch, "shape": shape_name,
        "mesh": "x".join(str(s) for s in dims_shape),
        "chips": chips, "status": "ok",
        # no lowering or compiling: placing the fake state on the mesh,
        # then one traced call of the step
        "lower_s": round(placed.get("s", 0.0), 1), "compile_s": None,
        "trace_s": round(trace.seconds, 1),
        "layers_traced": trace.layers_traced,
        "layers_total": trace.layers_total,
        "microbatches_traced": trace.microbatches_traced or 1,
        "microbatches": meta["microbatches"],
        "state_bytes_per_device": meta.get("state_bytes_per_device"),
        "memory_analysis": mem_d, "cost_analysis": cost_d,
        "hlo": {
            "flops_per_device": stats.flops,
            "hbm_bytes_per_device": stats.hbm_bytes,
            "collective_bytes_per_device": stats.collective_bytes,
            "collective_total_bytes": stats.total_collective_bytes,
            "collective_wire_bytes_per_device": stats.collective_wire_bytes,
            "collective_wire_total_bytes": stats.total_wire_bytes,
            "exposed_collective_bytes": stats.exposed_collective_bytes,
            "exposed_collective_s": stats.exposed_collective_s,
            "hidden_collective_s": stats.hidden_collective_s,
            "n_kernels": len(stats.kernel_counts),
            "n_collectives": len(stats.collective_instances),
            "top_kernels": kernel_freq["top"],
        },
        "overlap_sync": overlap_sync,
        "lint": lint.summary(),
        "model_flops_total": mf,
        "roofline": rl.as_dict(),
        "tag": tag,
    }
    return out, lint


def _print_lint(lint, min_severity: str = "info") -> None:
    for f in lint.unsuppressed(min_severity):
        print(f"  [{f.severity}] {f.pass_name}: {f.message}")
        if f.fix_hint:
            print(f"      fix: {f.fix_hint}")


def save_cell(out: dict) -> str:
    os.makedirs(RESULTS_DIR, exist_ok=True)
    tag = f"__{out['tag']}" if out.get("tag") else ""
    name = f"{out['arch']}__{out['shape']}__{out.get('mesh', 'skip')}{tag}.json"
    path = os.path.join(RESULTS_DIR, name)
    with open(path, "w") as f:
        json.dump(out, f, indent=1, default=str)
    return path


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.dryrun")
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--tag", default="")
    ap.add_argument("--device", default="cuda",
                    help="device type of the fake tensors (the card unless "
                         "'cpu'); nothing executes")
    ap.add_argument("--micro", type=int, default=None,
                    help="override train microbatch count")
    ap.add_argument("--overlap-sync", default="auto",
                    choices=("auto", "blocking", "overlap"),
                    help="cross-pod gradient sync: DTensor-implicit "
                         "(auto), explicit blocking all-reduce, or the "
                         "bucketed psum_start/psum_wait overlap pipeline")
    ap.add_argument("--set", action="append", default=[],
                    help="ModelConfig override key=value (perf knobs)")
    ap.add_argument("--lint", action="store_true",
                    help="print static-analysis findings per cell (the "
                         "lint section lands in the JSON either way)")
    ap.add_argument("--lint-spec", default=None,
                    help="pass spec, e.g. "
                         "'exposed-collectives:threshold_frac=0.3,"
                         "peak-memory'")
    ap.add_argument("--lint-baseline", default=None,
                    help="baseline JSON of accepted findings to suppress")
    return ap


def main(argv=None) -> int:
    """Exit status: 2 when any cell failed to trace (its error JSON is
    written all the same), else 0."""
    args = _parser().parse_args(argv)

    overrides = {}
    ftypes = {f.name: f.type for f in dataclasses.fields(ModelConfig)}
    for kv in args.set:
        k, v = kv.split("=", 1)
        t = ftypes.get(k, "str")
        if t in ("bool", bool):
            overrides[k] = v.lower() in ("1", "true", "yes")
        elif t in ("int", int):
            overrides[k] = int(v)
        elif t in ("float", float):
            overrides[k] = float(v)
        else:
            overrides[k] = v

    archs = ASSIGNED if args.arch is None else [args.arch]
    shapes = (["train_4k", "prefill_32k", "decode_32k", "long_500k"]
              if args.shape is None else [args.shape])
    mesh_tag = "2x16x16" if args.multi_pod else "16x16"
    n_errors = 0
    for arch in archs:
        for shape in shapes:
            tag = f"__{args.tag}" if args.tag else ""
            path = os.path.join(RESULTS_DIR,
                                f"{arch}__{shape}__{mesh_tag}{tag}.json")
            skip_path = os.path.join(RESULTS_DIR,
                                     f"{arch}__{shape}__skip{tag}.json")
            if args.skip_existing and (os.path.exists(path)
                                       or os.path.exists(skip_path)):
                print(f"[dryrun] {arch} {shape}: cached")
                continue
            lint = None
            try:
                out, lint = run_cell(
                    arch, shape, args.multi_pod, tag=args.tag,
                    cfg_overrides=overrides or None,
                    microbatches=args.micro,
                    overlap_sync={"auto": None, "blocking": False,
                                  "overlap": True}[args.overlap_sync],
                    lint_spec=args.lint_spec,
                    lint_baseline=args.lint_baseline, device=args.device)
            except Exception as e:                          # noqa: BLE001
                out = {"arch": arch, "shape": shape, "mesh": mesh_tag,
                       "status": "error", "error": str(e),
                       "traceback": traceback.format_exc()[-2000:],
                       "tag": args.tag}
            p = save_cell(out)
            if out["status"] == "ok":
                r = out["roofline"]
                lt = out.get("lint", {})
                print(f"[dryrun] {arch} {shape} {out['mesh']}: OK "
                      f"trace={out['trace_s']}s (layers "
                      f"{out['layers_traced']}/{out['layers_total']}, "
                      f"microbatches {out['microbatches_traced']}/"
                      f"{out['microbatches']}) "
                      f"state={out['state_bytes_per_device'] / 1e9:.2f}GB "
                      f"compute={r['compute_s']:.4f}s "
                      f"mem={r['memory_s']:.4f}s "
                      f"coll={r['collective_s']:.4f}s -> {r['bottleneck']} "
                      f"frac={r['roofline_fraction']:.3f} "
                      f"lint={lt.get('n_unsuppressed', 0)} ({p})")
                if args.lint and lint is not None:
                    _print_lint(lint)
            else:
                n_errors += out["status"] == "error"
                print(f"[dryrun] {arch} {shape}: {out['status']} "
                      f"{out.get('reason', out.get('error', ''))[:200]}")
    if n_errors:
        print(f"[dryrun] FAIL: {n_errors} cell(s) failed to trace")
        return 2
    return 0


if __name__ == "__main__":
    sys.exit(main())
