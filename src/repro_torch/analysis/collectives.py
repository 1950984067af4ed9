"""Collective-traffic lint passes: exposed comm + unintended reshards.

Both passes consume the overlap-aware rollup ``core.trace.analyze_trace``
already computed (``stats.collective_instances`` carries per-instance wire
bytes, alpha-beta comm seconds, hidden/exposed splits, and the ICI/DCI
link classification), so they add no second walk over the trace.
"""

from __future__ import annotations

import bisect

from .base import AnalysisPass, register_pass

#: ops a value may pass through while still being "the same value" for
#: reshard-provenance purposes: layout/dtype-only ops (views among them)
#: plus the adds that accumulate gradient buckets — the reference's
#: ``_PROVENANCE_CHAIN`` in aten terms
_PROVENANCE_CHAIN = {"aten._to_copy", "aten.clone", "aten.copy_",
                     "aten.contiguous", "aten._unsafe_view", "aten.detach",
                     "aten.alias", "aten.add", "aten.add_", "aten.mul",
                     "aten.mul_", "aten.div", "aten.div_", "aten.cat",
                     "aten.split", "aten.split_with_sizes"}

#: scope names the port's explicit collectives run under
#: (``core.trace.scope``): the counterpart of the JAX primitive names the
#: reference reads from an instruction's ``op_name``
_EXPLICIT_COLLECTIVE_PRIMS = {"all_gather", "all_to_all", "ppermute",
                              "psum", "psum_scatter", "reduce_scatter",
                              "all_reduce", "pbroadcast", "psum_start",
                              "psum_wait"}


def _explicitly_requested(op_name: str) -> bool:
    return any(seg in _EXPLICIT_COLLECTIVE_PRIMS
               for seg in op_name.split("/"))


def _writers(trace) -> dict:
    """storage id -> sorted indices of the records that write it."""
    out: dict = {}
    for i, r in enumerate(trace.records):
        for s in r.out_ids:
            out.setdefault(s, []).append(i)
    return out


def _upstream_evidence(trace, idx: int, writers: dict,
                       limit: int = 256) -> tuple:
    """Bounded upstream def-use walk from collective ``idx``.

    Returns ``(reaches_param, reduce_scatters)``: whether the provenance
    chain reaches a parameter, and the reduce-scatter records on it.  The
    walk follows layout-only ops and accumulation adds (and waits, to the
    collective they retire); anything else is real compute, where
    provenance ends — a gather of *that* is an activation reshard."""
    r0 = trace.records[idx]
    queue = [(s, idx) for s in r0.in_ids]
    seen = set()
    reaches_param = any(r0.param_rooted)
    reduce_scatters = []
    while queue and len(seen) < limit:
        sid, before = queue.pop()
        if (sid, before) in seen:
            continue
        seen.add((sid, before))
        ws = writers.get(sid, [])
        k = bisect.bisect_left(ws, before) - 1
        if k < 0:
            continue                  # defined before the step: an input
        j = ws[k]
        r = trace.records[j]
        if r.opcode == "reduce-scatter":
            reduce_scatters.append(r)
        elif r.is_wait or r.is_view or r.base in _PROVENANCE_CHAIN:
            if any(r.param_rooted):
                reaches_param = True
            queue.extend((s, j) for s in r.in_ids)
    return reaches_param, reduce_scatters


@register_pass("exposed-collectives")
class ExposedCollectivesPass(AnalysisPass):
    """Flag collectives whose transfer the schedule does not hide.

    A collective is *exposed* when the overlap model (an async pair's
    window up to its wait, a synchronous collective's up to its first real
    consumer) finds too little concurrent compute to hide its alpha-beta
    transfer time.  A blocking gradient sync fires this pass; the bucketed
    ``psum_start``/``psum_wait`` overlap pipeline must make it go quiet.

    Per-instance knobs: ``threshold_frac`` — exposed fraction of wire
    bytes above which an instance is flagged; ``min_bytes`` — ignore
    instances with less wire traffic; ``min_comm_s`` — ignore instances
    cheaper than this even when fully exposed; ``severity``.

    Aggregate knobs: ``link`` — restrict the pass to one link class
    (``"ici"``/``"dci"``; empty = all); ``total_budget_s`` — when > 0,
    additionally emit one summary finding if the *total* exposed seconds
    over the considered instances exceed the budget.
    """

    KNOBS = {"threshold_frac": 0.2, "min_bytes": 1 << 14,
             "min_comm_s": 0.0, "link": "", "total_budget_s": 0.0,
             "severity": "warn"}

    def run(self, ctx):
        out = []
        if ctx.stats is None:
            return out
        thr = float(self.knobs["threshold_frac"])
        min_bytes = float(self.knobs["min_bytes"])
        min_comm = float(self.knobs["min_comm_s"])
        only_link = str(self.knobs["link"]).strip().lower()
        budget = float(self.knobs["total_budget_s"])
        total_exposed_s = 0.0
        total_wire = 0.0
        n_considered = 0
        for inst in ctx.stats.collective_instances:
            wire = float(inst.get("wire_bytes", 0.0))
            comm = float(inst.get("comm_s", 0.0))
            link = inst.get("link", "ici")
            if only_link and link != only_link:
                continue
            if wire < min_bytes or comm <= 0.0 or comm < min_comm:
                continue
            exposed_b = float(inst.get("exposed_bytes", wire))
            frac = exposed_b / wire if wire > 0 else 0.0
            hidden_s = float(inst.get("hidden_s", 0.0))
            exposed_s = max(comm - hidden_s, 0.0)
            mult = float(inst.get("mult", 1.0))
            total_exposed_s += exposed_s * mult
            total_wire += wire * mult
            n_considered += 1
            if frac <= thr:
                continue
            out.append(self.finding(
                str(self.knobs["severity"]),
                f"{inst['opcode']} {inst['name']!r} exposes "
                f"{frac:.0%} of its {wire / 1e6:.2f} MB wire traffic "
                f"({exposed_s * 1e6:.0f} us/instance x{mult:.0f} on "
                f"{link.upper()})",
                opcode=inst["opcode"], instruction=inst["name"],
                computation=inst.get("computation", ""),
                op_name=inst.get("op_name", ""),
                bytes_impact=exposed_b * mult,
                seconds_impact=exposed_s * mult,
                fix_hint="overlap it: issue the collective earlier "
                         "(psum_start/psum_wait bucketing, overlap_sync="
                         "True) or aggregate small messages so the "
                         "alpha cost amortizes",
                data={"exposed_frac": frac, "wire_bytes": wire,
                      "comm_s": comm, "hidden_s": hidden_s,
                      "link": link, "mult": mult}))
        link_tag = only_link.upper() if only_link else "all links"
        ctx.meta[f"exposed_s:{only_link or 'all'}"] = total_exposed_s
        if budget > 0.0 and total_exposed_s > budget:
            out.append(self.finding(
                str(self.knobs["severity"]),
                f"aggregate exposed collective time on {link_tag} is "
                f"{total_exposed_s * 1e6:.1f} us across {n_considered} "
                f"instance(s) — over the {budget * 1e6:.1f} us budget",
                opcode="", instruction=f"total[{only_link or 'all'}]",
                bytes_impact=total_wire,
                seconds_impact=total_exposed_s,
                fix_hint="the schedule is not hiding its gradient sync: "
                         "enable the bucketed overlap pipeline "
                         "(overlap_sync=True) or raise total_budget_s if "
                         "this config's exposure is accepted",
                data={"total_exposed_s": total_exposed_s,
                      "budget_s": budget, "link": only_link or "all",
                      "n_instances": n_considered}))
        ctx.meta["exposed_collective_s"] = ctx.stats.exposed_collective_s
        return out


@register_pass("implicit-reshard")
class ImplicitReshardPass(AnalysisPass):
    """Flag reshard traffic the sharding rule table never asked for.

    DTensor redistributes whenever an operand's placements do not match
    what an op or a ``shard`` annotation needs.  Most of that is
    *intended* (ZeRO parameter gathers, expert dispatch, pipeline shifts —
    see ``repro_torch.dist.sharding.intended_collectives``); one wrong
    annotation makes every layer bounce whole activations between layouts.
    This pass takes each reshard collective's mesh axes (from its group,
    through ``axes_of_replica_groups``) and reports any span the intent
    table does not cover.

    All-gathers get two provenance-based allowances (an upstream def-use
    walk over the trace):

    * a gather whose provenance roots at a parameter is a sharded weight
      being gathered — allowed over any axis some ``p_*`` rule shards over;
    * a gather whose provenance contains a ``reduce-scatter`` over the
      *same* axes is the tail of an all-reduce split in two — intended
      reduction traffic.

    The pod sync's own collectives (run under ``psum_start``/``psum_wait``
    scopes) are explicitly requested and never judged.

    Knobs: ``min_bytes`` — ignore tiny reshards; ``allow_axes`` — extra
    allowed axis sets, ``"+"``-separated (e.g. ``"model+data,model"``
    allows {model,data} and {model}); ``severity``.
    """

    KNOBS = {"min_bytes": 1 << 12, "allow_axes": "", "severity": "warn"}

    def run(self, ctx):
        out = []
        if ctx.stats is None or ctx.trace is None or not ctx.mesh_axes:
            return out          # no topology to judge against
        from ..dist.sharding import RESHARD_OPCODES, intended_collectives
        intended = intended_collectives(rules=ctx.rules or None,
                                        mesh_axes=ctx.mesh_axes,
                                        kind=ctx.kind)
        extra = set()
        for seg in str(self.knobs["allow_axes"]).split(","):
            seg = seg.strip()
            if seg:
                extra.add(frozenset(a.strip() for a in seg.split("+")))
        min_bytes = float(self.knobs["min_bytes"])
        present = {a for a, s in ctx.mesh_axes.items() if int(s) > 1}
        param_axes: set = set()
        for key, val in (ctx.rules or {}).items():
            if key.startswith("p_") and val is not None:
                cand = (val,) if isinstance(val, str) else tuple(val)
                param_axes |= {a for a in cand if a in present}
        writers = None
        for inst in ctx.stats.collective_instances:
            op = inst["opcode"]
            if op not in RESHARD_OPCODES:
                continue
            if float(inst.get("wire_bytes", 0.0)) < min_bytes:
                continue
            if _explicitly_requested(inst.get("op_name", "")):
                continue        # the code asked for this collective
            idx = inst.get("index")
            if idx is None or not 0 <= idx < len(ctx.trace.records):
                continue
            rec = ctx.trace.records[idx]
            if rec.axes is None:
                # a group that is no sub-grid of the mesh (a hand-written
                # topology): not an accident of the rule table
                ctx.meta["reshard_unclassified"] = \
                    ctx.meta.get("reshard_unclassified", 0) + 1
                continue
            axes = frozenset(rec.axes)
            allowed = set(intended.get(op, set())) | extra
            if any(axes <= a for a in allowed):
                continue
            if op == "all-gather":
                if writers is None:
                    writers = _writers(ctx.trace)
                reaches_param, rss = _upstream_evidence(ctx.trace, idx,
                                                        writers)
                if axes <= param_axes and reaches_param:
                    continue    # a sharded weight, gathered
                if any(rs.axes is not None and frozenset(rs.axes) == axes
                       for rs in rss):
                    continue    # the tail of a split all-reduce
            mult = float(inst.get("mult", 1.0))
            wire = float(inst.get("wire_bytes", 0.0))
            out.append(self.finding(
                str(self.knobs["severity"]),
                f"DTensor inserted {op} {inst['name']!r} over mesh "
                f"axes {{{', '.join(sorted(axes))}}} — "
                f"{wire / 1e6:.2f} MB x{mult:.0f} the rule table never "
                f"intended",
                opcode=op, instruction=inst["name"],
                computation=inst.get("computation", ""),
                op_name=inst.get("op_name", ""),
                bytes_impact=wire * mult,
                seconds_impact=float(inst.get("comm_s", 0.0)) * mult,
                fix_hint="a layer is mis-sharded: fix the logical-axis "
                         "annotation or extend the rule table in "
                         "repro_torch.dist.sharding (then accept via the "
                         "baseline file if the reshard is deliberate)",
                data={"axes": sorted(axes), "wire_bytes": wire,
                      "mult": mult,
                      "intended": [sorted(a) for a in sorted(
                          allowed, key=sorted)]}))
        return out
