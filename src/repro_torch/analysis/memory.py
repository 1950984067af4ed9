"""Buffer-level lint passes: static peak-memory estimate + host-sync audit.

``peak-memory`` runs a liveness analysis over the step trace — each
storage is live from the record that first defines it to the last record
that uses it, the step's arguments for the whole step, its results and
the gradients a train step holds to the end — and checks the resulting
peak against the per-device HBM budget the roofline model uses.  This is the static half of the OOM gate: it prices
a config *before* it burns hardware time.

``host-sync`` flags forced device↔host round trips inside the step
(``.item()`` / ``aten._local_scalar_dense``, data-dependent output
shapes, device→host copies) and missed donations: a large argument whose
dtype and shape reappear among the results in a new storage while the
argument stays live to the end — a state tensor the step double-buffers.
"""

from __future__ import annotations

from .base import AnalysisPass, register_pass

#: loops whose iterations' results coexist (a layer loop's saved
#: activations and cache slices); a microbatch loop's do not
STACKING_LOOPS = ("layers",)


def _held_grads(trace) -> set:
    """The gradient tree a train step holds until it returns: the step's
    local ``grads`` is the tree its update reads, and it stays bound while
    the update runs.  These are the storages that records of the step's
    ``"update"`` region (``core.trace.region``) read, that a record before
    the region defined in an argument's shape, and that are no argument:
    the backward's outputs at one microbatch, the summed tree divided by
    the microbatch count at more (each microbatch's own tree is dead once
    added).  A step that marks no update holds none."""
    spans = [(lo, hi) for name, lo, hi in trace.regions if name == "update"]
    if not spans:
        return set()
    lo, hi = spans[-1]
    shapes = {tuple(shape) for _dtype, shape, _s in trace.arg_leaves}
    before = {s for r in trace.records[:lo]
              for s, shape in zip(r.out_ids, r.out_shapes)
              if tuple(shape) in shapes}
    read = {s for r in trace.records[lo:hi] for s in r.in_ids}
    return (before & read) - trace.persistent


def _liveness(trace) -> dict:
    """storage id -> (first record, last record) of the transient
    storages, with the step's results and held gradients live to the
    end."""
    first: dict = {}
    last: dict = {}
    end = len(trace.records)
    for i, r in enumerate(trace.records):
        for s in (*r.in_ids, *r.out_ids):
            if s < 0 or s in trace.persistent:
                continue
            first.setdefault(s, i)
            last[s] = i
    for s in (*trace.outputs, *_held_grads(trace)):
        if s in first:
            last[s] = end
    return {s: (first[s], last[s]) for s in first}


def _weights(trace, spans: dict) -> dict:
    """storage id -> how many such storages a cut trace stands for: a
    storage made in an iteration of a cut layer loop that outlives the
    loop (a saved activation, a cache slice) stands for ``mult`` of them."""
    loops: dict = {}
    for name, lo, hi, m in trace.iterations:
        if name in STACKING_LOOPS and m > 1:
            b = loops.setdefault((name, m), [lo, hi])
            b[0], b[1] = min(b[0], lo), max(b[1], hi)
    out: dict = {}
    for s, (d, u) in spans.items():
        w = 1.0
        for (_name, m), (lo, hi) in loops.items():
            if lo <= d < hi and u >= hi:
                w *= m
        if w != 1.0:
            out[s] = w
    return out


def estimate_peak_bytes(trace) -> dict:
    """Static peak-memory estimate of one call of the traced step.

    Returns ``{"peak_bytes", "persistent_bytes", "transient_peak_bytes",
    "at_instruction"}``: ``persistent_bytes`` is the arguments' storages
    (live throughout); the transient peak tracks every other storage from
    its first definition to its last use (the results to the end), scaled
    for a cut trace as :func:`_weights` says."""
    nbytes = trace.storage_bytes
    persistent = float(sum(nbytes.get(s, 0) for s in trace.persistent))
    spans = _liveness(trace)
    weights = _weights(trace, spans)
    delta = [0.0] * (len(trace.records) + 2)
    for s, (d, u) in spans.items():
        b = nbytes.get(s, 0) * weights.get(s, 1.0)
        delta[d] += b
        delta[u + 1] -= b
    live = peak = 0.0
    at = -1
    for i in range(len(trace.records)):
        live += delta[i]
        if live > peak:
            peak, at = live, i
    name = f"{trace.records[at].name}.{at}" if at >= 0 else ""
    return {"peak_bytes": persistent + peak,
            "persistent_bytes": persistent,
            "transient_peak_bytes": peak,
            "at_instruction": name}


@register_pass("peak-memory")
class PeakMemoryPass(AnalysisPass):
    """Static peak-memory estimate vs. the device budget.

    Always publishes ``peak_bytes_est`` into the report meta (the lint
    grid compares it against the fake run's measured high-water mark);
    emits a finding only when the estimate exceeds ``budget_frac`` of the
    budget (``ctx.device_budget`` or ``hw["hbm_bytes"]``).
    """

    KNOBS = {"budget_frac": 0.92, "severity": "error"}

    def run(self, ctx):
        if ctx.trace is None or not ctx.trace.records:
            return []
        est = estimate_peak_bytes(ctx.trace)
        ctx.meta["peak_bytes_est"] = est["peak_bytes"]
        ctx.meta["peak_persistent_bytes"] = est["persistent_bytes"]
        ctx.meta["peak_at_instruction"] = est["at_instruction"]
        budget = ctx.budget_bytes
        if not budget:
            return []
        ctx.meta["peak_budget_bytes"] = budget
        frac = float(self.knobs["budget_frac"])
        if est["peak_bytes"] <= frac * budget:
            return []
        over = est["peak_bytes"] - frac * budget
        return [self.finding(
            str(self.knobs["severity"]),
            f"static peak memory estimate {est['peak_bytes'] / 2**30:.2f} "
            f"GiB exceeds {frac:.0%} of the {budget / 2**30:.1f} GiB device "
            f"budget (peak at {est['at_instruction']!r})",
            opcode="liveness", instruction=est["at_instruction"],
            computation="step",
            bytes_impact=over,
            fix_hint="shard the heaviest live buffers (FSDP the params, "
                     "microbatch the activations) or raise "
                     "remat/offload before this config OOMs on hardware",
            data=est)]


@register_pass("host-sync")
class HostSyncPass(AnalysisPass):
    KNOBS = {"min_donate_bytes": 1 << 20, "severity": "warn"}

    def run(self, ctx):
        out = []
        if ctx.trace is None or not ctx.trace.records:
            return out
        for i, r in enumerate(ctx.trace.records):
            if not r.host_sync:
                continue
            byts = float(max(r.in_bytes, r.out_bytes))
            comp = r.op_name or "step"
            out.append(self.finding(
                str(self.knobs["severity"]),
                f"{r.name} ({r.host_sync}) in {comp!r} forces a "
                f"device-host sync ({byts / 1e6:.2f} MB)",
                opcode=r.name, instruction=f"{r.name}.{i}",
                computation=comp, bytes_impact=byts,
                fix_hint="hot paths must stay on device: keep the value "
                         "a tensor (no .item()), give the op a static "
                         "shape, or batch the copy behind an async one",
                data={"target": r.host_sync}))
        out.extend(self._missed_donations(ctx))
        return out

    def _missed_donations(self, ctx) -> list:
        """Large state-shaped arguments updated out of place: every step
        pays a copy and double residency."""
        out = []
        trace = ctx.trace
        nbytes = trace.storage_bytes
        results = {}
        for dtype, shape, s in trace.out_leaves:
            results.setdefault((dtype, shape), set()).add(s)
        min_bytes = float(self.knobs["min_donate_bytes"])
        for pidx, (dtype, shape, s) in enumerate(trace.arg_leaves):
            byts = float(nbytes.get(s, 0))
            if byts < min_bytes or s in trace.outputs:
                continue
            if not results.get((dtype, shape), set()) - {s}:
                continue
            out.append(self.finding(
                str(self.knobs["severity"]),
                f"argument {pidx} ({byts / 2**20:.1f} MiB) has a result "
                f"of its dtype and shape in a new buffer — the step "
                f"double-buffers it and copies every step",
                opcode="parameter", instruction=f"arg{pidx}",
                computation="step", bytes_impact=byts,
                fix_hint="donate the state argument: update it in place "
                         "(torch.no_grad() param.copy_ / an optimizer's "
                         "foreach_ in-place update) so the new state "
                         "takes the old one's memory",
                data={"param_index": pidx}))
        return out
