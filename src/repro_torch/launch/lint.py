"""Static-analysis lint over the configs grid:
``python -m repro_torch.launch.lint``.

Traces each cell of the grid (reduced smoke configs on a fake 8-rank
2x2x2 pod x data x model process group by default, the production
dry-run grid with ``--full``) and runs the :mod:`repro_torch.analysis`
pass suite over every step trace.  Nothing executes: the step runs once
under fake tensors of ``--device``'s type (the card unless
``--device cpu``).  Exit status is the CI gate: 1 when any unsuppressed
finding at or above ``--fail-on`` severity fires, 2 when a cell fails to
trace, so a green baseline stays at **zero unsuppressed findings** and a
sharding/overlap regression turns the job red before it burns hardware.

Seeded-defect self-check (the lint analogue of a mutation test)::

    python -m repro_torch.launch.lint --seed-defect reshard   # exits 1
    python -m repro_torch.launch.lint --seed-defect blocking  # exits 1

``reshard`` patches the rule table to shard between-layer activations over
the tensor axis (every layer boundary then all-gathers activations the
table never intended — implicit-reshard fires); ``blocking`` traces the
explicit blocking cross-pod gradient sync (exposed-collectives fires where
the bucketed overlap pipeline stays quiet).

Usage:
  python -m repro_torch.launch.lint [--archs qwen3-32b,mamba2-2.7b,dbrx-132b]
  python -m repro_torch.launch.lint --passes \
      'exposed-collectives:threshold_frac=0.5'
  python -m repro_torch.launch.lint --json out.json \
      --baseline src/repro_torch/launch/lint_baseline.json
  python -m repro_torch.launch.lint --write-baseline B.json
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import traceback

import torch
from torch.distributed.tensor import distribute_tensor

import repro_torch.configs as configs
from repro_torch import analysis
from repro_torch.core.trace import trace_step
from repro_torch.dist.sharding import DEFAULT_RULES, ShardingRules
from repro_torch.train import OptConfig, make_train_step, train_shardings
from repro_torch.train.optimizer import tree_map
from repro_torch.train.trainer import batch_shardings

#: one representative per assigned architecture family (dense / ssm / moe)
SMOKE_ARCHS = ("qwen3-32b", "mamba2-2.7b", "dbrx-132b")

#: the fake smoke mesh
MESH_SHAPE = (2, 2, 2)
MESH_DIMS = ("pod", "data", "model")

#: pass spec calibrated for the reduced smoke grid on the H100 table.  At
#: smoke scale there is almost no compute to hide a collective behind, so
#: exposed-collectives gates on the *aggregate* DCI exposure instead,
#: counting every pod-crossing collective however small (its latency is
#: the cost: ``min_bytes=0``).  Measured on the CPU (``--device cpu``):
#: the bucketed overlap pipeline exposes 41.19, 43.29 and 47.31 us
#: (qwen3-32b, mamba2-2.7b, dbrx-132b; 39-45 collectives) where the
#: blocking per-leaf sync exposes 81.89, 91.56 and 83.92 us (78-88) — the
#: 60 us budget sits between them.  dtype-promotion's implicit floor
#: stays above the ~32k-element dequantize upcasts the compressed sync
#: performs on purpose.
SMOKE_SPEC = ("exposed-collectives:link=dci,threshold_frac=1.1,"
              "min_bytes=0,total_budget_s=6e-05,"
              "implicit-reshard,"
              "dtype-promotion:min_numel_jaxpr=65536,"
              "peak-memory,host-sync")

#: the baseline of the smoke grid: exact finding keys, each with its
#: cause, checked on both torch releases (2.13 on a CPU mesh, 2.11 on the
#: card's): the loss's gathers of the vocab-sharded logits; the port
#: ships none at the repo root
BASELINE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "lint_baseline.json")

#: rule-table patch for ``--seed-defect reshard``: sharding the
#: between-layer activations over the tensor axis forces DTensor to
#: all-gather them at every layer boundary — traffic the default table
#: never intends, which implicit-reshard must flag
DEFECT_RULES = {"embed": "model"}


def smoke_cell(arch: str, *, overlap_sync=True, rules_patch=None,
               seq: int = 64, batch: int = 8, spec=None, baseline=None,
               label: str = "", device: str = "cuda") -> analysis.Findings:
    """Trace one reduced train cell on the fake mesh and lint it; the
    fake run's own live-storage high-water mark rides along as
    ``meta["measured_peak_bytes"]``."""
    cfg = configs.reduced(configs.get(arch))
    opt_cfg = OptConfig()
    rules = ShardingRules({**DEFAULT_RULES, **(rules_patch or {})})
    # compressed 4-bucket sync: the schedule where blocking and
    # overlapped cross-pod sync separate on aggregate DCI exposure
    step = make_train_step(cfg, opt_cfg, overlap_sync=overlap_sync,
                           sync_compressed=True, sync_buckets=4)

    def setup(mesh):
        p_sh, o_sh, p_shapes, o_shapes = train_shardings(mesh, cfg, opt_cfg)

        def make(t, sh):
            return distribute_tensor(torch.empty(t.shape, dtype=t.dtype,
                                                 device=device), mesh, sh)

        specs = {"inputs": torch.zeros((batch, seq), dtype=torch.int64,
                                       device=device),
                 "labels": torch.zeros((batch, seq), dtype=torch.int64,
                                       device=device)}
        b_sh = batch_shardings(mesh, specs,
                               include_pod=overlap_sync is None)
        return (tree_map(make, p_shapes, p_sh), tree_map(make, o_shapes, o_sh),
                tree_map(lambda t, sh: distribute_tensor(t, mesh, sh), specs,
                         b_sh))

    trace = trace_step(step, mesh_shape=MESH_SHAPE, mesh_dims=MESH_DIMS,
                       device_type=device, setup=setup, rules=rules)
    return analysis.run_passes(
        trace, spec, baseline=baseline, emit_events=False, rules=rules,
        kind="train",
        meta={"measured_peak_bytes": trace.measured_peak_bytes,
              "trace_s": trace.seconds},
        label=label or f"{arch}.train.smoke")


def run_grid(archs, *, overlap_sync=True, rules_patch=None, spec=None,
             baseline=None, device: str = "cuda") -> list:
    """[(label, Findings-or-None, error-or-None)] over the smoke grid."""
    out = []
    for arch in archs:
        label = f"{arch}.train.smoke"
        try:
            lint = smoke_cell(arch, overlap_sync=overlap_sync,
                              rules_patch=rules_patch, spec=spec,
                              baseline=baseline, label=label, device=device)
            out.append((label, lint, None))
        except Exception:                                   # noqa: BLE001
            out.append((label, None, traceback.format_exc()[-2000:]))
    return out


def run_full_grid(spec=None, baseline=None, device: str = "cuda") -> list:
    """Lint every (arch x shape) production cell through the dry-run's
    tracer.  Expensive — minutes per cell."""
    from repro_torch.launch import dryrun                  # noqa: PLC0415
    from repro_torch.configs.shapes import SHAPES          # noqa: PLC0415
    out = []
    for arch in dryrun.ASSIGNED:
        for shape in SHAPES:
            label = f"{arch}.{shape}"
            try:
                _, lint = dryrun.run_cell(arch, shape, multi_pod=True,
                                          lint_spec=spec,
                                          lint_baseline=baseline,
                                          device=device)
                if lint is not None:
                    out.append((label, lint, None))
            except Exception:                               # noqa: BLE001
                out.append((label, None, traceback.format_exc()[-2000:]))
    return out


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.launch.lint",
        description="static-analysis lint over the configs grid")
    ap.add_argument("--archs", default=",".join(SMOKE_ARCHS),
                    help="comma list of archs for the smoke grid")
    ap.add_argument("--device", default="cuda",
                    help="device type of the fake tensors (the card unless "
                         "'cpu'); nothing executes")
    ap.add_argument("--passes", default=None,
                    help="pass spec (default: the smoke spec) — e.g. "
                         "'exposed-collectives:threshold_frac=0.3,"
                         "peak-memory:budget_frac=0.8'")
    ap.add_argument("--baseline", default=None,
                    help="baseline JSON suppressing known-accepted findings")
    ap.add_argument("--write-baseline", default=None,
                    help="write a baseline accepting everything that fired, "
                         "then exit 0 (brownfield adoption)")
    ap.add_argument("--json", default=None,
                    help="write the full findings report to this path")
    ap.add_argument("--fail-on", default="warn",
                    choices=analysis.SEVERITIES,
                    help="exit non-zero on unsuppressed findings at or "
                         "above this severity")
    ap.add_argument("--overlap", default="overlap",
                    choices=("overlap", "blocking", "auto"),
                    help="cross-pod gradient sync variant to trace")
    ap.add_argument("--seed-defect", default=None,
                    choices=("reshard", "blocking"),
                    help="inject a known defect; the run MUST go red "
                         "(CI uses this to prove the lint can fail)")
    ap.add_argument("--full", action="store_true",
                    help="lint the production dry-run grid instead of the "
                         "reduced smoke grid")
    return ap


def main(argv=None) -> int:
    args = _parser().parse_args(argv)

    overlap = {"overlap": True, "blocking": False, "auto": None}[args.overlap]
    rules_patch = None
    if args.seed_defect == "reshard":
        rules_patch = dict(DEFECT_RULES)
    elif args.seed_defect == "blocking":
        overlap = False

    if args.full:
        results = run_full_grid(spec=args.passes, baseline=args.baseline,
                                device=args.device)
    else:
        results = run_grid([a.strip() for a in args.archs.split(",")
                            if a.strip()],
                           overlap_sync=overlap, rules_patch=rules_patch,
                           spec=args.passes or SMOKE_SPEC,
                           baseline=args.baseline, device=args.device)

    report = {"cells": [], "errors": {}}
    n_unsup = 0
    worst = None
    for label, lint, err in results:
        if lint is None:
            report["errors"][label] = err
            print(f"[lint] {label}: TRACE ERROR\n{err}")
            continue
        cell = lint.as_dict()
        report["cells"].append(cell)
        hits = lint.unsuppressed(args.fail_on)
        n_unsup += len(hits)
        sev = lint.max_severity()
        if sev and (worst is None
                    or analysis.severity_rank(sev)
                    > analysis.severity_rank(worst)):
            worst = sev
        print(f"[lint] {label}: {len(lint.findings)} finding(s), "
              f"{len(hits)} unsuppressed >= {args.fail_on} "
              f"(suppressed {cell['n_suppressed']}); traced in "
              f"{lint.meta.get('trace_s', 0.0):.1f} s")
        for f in hits:
            print(f"  [{f.severity}] {f.pass_name}: {f.message}")
            if f.fix_hint:
                print(f"      fix: {f.fix_hint}")
    report["n_unsuppressed"] = n_unsup
    report["max_severity"] = worst
    report["fail_on"] = args.fail_on

    if args.write_baseline:
        merged = analysis.Findings()
        for _, lint, _err in results:
            if lint is not None:
                merged.extend(lint.findings)
        merged.write_baseline(args.write_baseline,
                              reason="accepted by --write-baseline")
        print(f"[lint] baseline written: {args.write_baseline}")
        return 0

    if args.json:
        with open(args.json, "w") as f:
            json.dump(report, f, indent=1, default=str)
        print(f"[lint] report written: {args.json}")

    if report["errors"]:
        print(f"[lint] FAIL: {len(report['errors'])} cell(s) failed to "
              f"trace")
        return 2
    if n_unsup:
        print(f"[lint] FAIL: {n_unsup} unsuppressed finding(s) at or above "
              f"{args.fail_on!r}")
        return 1
    print("[lint] OK: zero unsuppressed findings")
    return 0


if __name__ == "__main__":
    sys.exit(main())
