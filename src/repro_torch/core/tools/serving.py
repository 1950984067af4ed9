"""Serving-lifecycle tool: TTFT/TPOT, batch occupancy, prefix-hit rate.

Consumes the operator events the request-lifecycle :class:`~repro_torch.serve.
engine.ServeEngine` emits — per-request lifecycle markers
(``serve.request.submit`` / ``.admit`` / ``.first_token`` / ``.finish``,
emitted through each request's child session and forwarded to the parent)
and fused phase spans (``serve.prefill`` / ``serve.decode`` on the engine
session) — and reduces them to the serving quantities a continuous-batching
deployment is judged on:

  * **TTFT** (time to first token: submit → first sampled token) and
    **TPOT** (time per output token over the decode tail), as mean/p50/p90,
  * the **batch-occupancy timeline** (active slots per fused decode tick)
    and its mean — decode goodput relative to the slot budget,
  * **prefix-cache reuse**: hit rate over admissions and the fraction of
    prompt tokens skipped at prefill (admissions and cache lookups are 1:1
    in the engine, so this hit rate and ``PrefixCache.stats()`` share the
    same denominator),
  * **prefill-stall accounting**: the prefill work inserted between
    consecutive fused decode ticks, as tokens and seconds — chunked prefill
    exists to bound exactly this quantity,
  * **paged-pool utilization**: block-pool occupancy sampled at every
    decode tick, plus the bytes duplicated for the prefix store (zero on
    the paged path, where the store aliases pool blocks),
  * **speculative-decode accounting**: draft acceptance rate, committed
    tokens per fused decode tick (the quantity speculation exists to raise
    above one-per-slot), and host-side draft overhead seconds,
  * an **analytic bandwidth estimate**: each decode dispatch streams the
    params once plus every active row's touched KV blocks, so
    ``(decode_steps * params_bytes + kv_read_bytes) / committed_tokens``
    is the modeled bytes per generated token — the decode-roofline
    denominator acceptance-rate gains are supposed to shrink,
  * **SLO / multi-tenant accounting**: per-request ``SLOSpec`` tags
    (tenant, priority, TTFT/TPOT targets) arrive on the submit event; the
    report adds per-tenant rollups (requests, tokens, TTFT percentiles,
    attainment), fleet **SLO attainment** (finished requests meeting
    every stated target), **goodput** (tokens from SLO-meeting requests
    per wall second — requests with no targets trivially meet), and the
    **Jain fairness index** over per-tenant generated tokens,
  * **preemption accounting**: ``serve.request.preempt`` events count
    evictions and blocks parked into the prefix store; resumed
    admissions report how many parked blocks aliased back with zero
    recompute (``recovered_blocks``),
  * **health / fault accounting**: every ``serve.fault`` (transient tick
    retries, blamed requests, bisection probes, isolated innocents),
    ``serve.degrade`` (shed/restore ladder moves, degraded ticks),
    ``serve.request.retry`` / ``.timeout`` / ``.failed`` / ``.reject``
    terminal outcome, and the recovered-vs-recomputed token split on
    resumed admissions — the report's ``health`` section accounts for
    every fault-tolerance event the engine emitted.

Attached to the engine's parent session it reports the fleet view; attached
to a request's child session (``request_tools="serving"``) it reports that
one request's lifecycle.
"""

from __future__ import annotations

import numpy as np

from ..events import EventKind
from .base import PastaTool, register


def _pctl(xs: list) -> dict | None:
    if not xs:
        return None
    a = np.asarray(xs, np.float64)
    return {"mean": float(a.mean()), "p50": float(np.percentile(a, 50)),
            "p90": float(np.percentile(a, 90)), "max": float(a.max())}


@register("serving")
class ServingTool(PastaTool):
    EVENTS = (EventKind.OPERATOR_START, EventKind.OPERATOR_END)

    def __init__(self, timeline_limit: int = 512, **knobs):
        super().__init__(**knobs)
        self.timeline_limit = timeline_limit
        self.req: dict = {}                # rid -> lifecycle dict
        self.decode_steps = 0
        self.occupancy_sum = 0
        self.occupancy_max = 0
        self.slots = 0
        self.prefill_events = 0
        self.prefill_tokens = 0
        self.chunked_events = 0
        self.cached_tokens = 0
        # admission-EVENT counters: 1:1 with prefix-cache lookups even when
        # preemption re-admits a request more than once
        self.admit_events = 0
        self.hit_events = 0
        self.admit_prompt_tokens = 0
        # preemption lifecycle: evictions, blocks parked into the prefix
        # store, resumed admissions and the blocks they aliased back
        self.preempt_events = 0
        self.parked_blocks = 0
        self.resumed_admits = 0
        self.recovered_blocks = 0
        # per-tick prefill stall: prefill work inside one scheduler tick
        # (the engine's serve.tick boundary event closes the window)
        self._tick_prefill_tokens = 0
        self._tick_prefill_s = 0.0
        self._prefill_start: float | None = None
        self.max_prefill_tokens_per_tick = 0
        self.max_prefill_stall_s = 0.0
        # paged-pool samples from decode-tick attrs
        self.pool_n_blocks = 0
        self.pool_util_max = 0.0
        self.pool_store_blocks_max = 0
        self.duplicate_copy_bytes = 0
        # speculative decode + analytic bandwidth (decode-end attrs)
        self.spec_k = 0
        self.drafted_tokens = 0
        self.accepted_tokens = 0
        self.committed_tokens = 0
        self.draft_s = 0.0
        self.params_bytes = 0
        self.kv_read_bytes = 0
        # fault-tolerance accounting (serve.fault / serve.degrade / the
        # terminal retry|timeout|failed|reject lifecycle events)
        self.fault_events = 0
        self.transient_faults = 0
        self.blamed_requests = 0
        self.isolated_innocents = 0
        self.probes = 0
        self.retry_events = 0
        self.timeout_events = 0
        self.failed_events = 0
        self.reject_events = 0
        self.degrade_shed = 0
        self.degrade_restore = 0
        self.degrade_level_max = 0
        self.degraded_ticks = 0
        self.recovered_tokens = 0
        self.recomputed_tokens = 0
        self.timeline: list = []           # (time, phase, active)
        self._t0: float | None = None

    # ------------------------------------------------------------- lifecycle
    def _entry(self, rid) -> dict:
        return self.req.setdefault(int(rid), {})

    def on_operator_start(self, ev):
        a = ev.attrs
        if self._t0 is None:
            self._t0 = ev.time
        name = ev.name
        if name == "serve.request.submit":
            e = self._entry(a["rid"])
            e["submit"] = ev.time
            e["prompt_len"] = int(a.get("prompt_len", 0))
            if "tenant" in a:
                e["tenant"] = a["tenant"]
                e["priority"] = int(a.get("priority", 0))
                e["ttft_target"] = a.get("ttft_target_s")
                e["tpot_target"] = a.get("tpot_target_s")
        elif name == "serve.request.admit":
            e = self._entry(a["rid"])
            # queue_s / TTFT anchor on the FIRST admission; later (resumed)
            # admissions only update the reuse/recovery counters
            e.setdefault("admit", ev.time)
            e["cached"] = int(a.get("cached_tokens", 0))
            e["slot"] = a.get("slot")
            self.admit_events += 1
            self.hit_events += int(a.get("cached_tokens", 0)) > 0
            self.admit_prompt_tokens += int(a.get("prompt_len", 0))
            if a.get("resumed"):
                self.resumed_admits += 1
                rec = int(a.get("recovered_blocks", 0))
                self.recovered_blocks += rec
                e["recovered_blocks"] = e.get("recovered_blocks", 0) + rec
                self.recovered_tokens += int(a.get("cached_tokens", 0))
                self.recomputed_tokens += int(a.get("recomputed_tokens", 0))
        elif name == "serve.request.retry":
            e = self._entry(a["rid"])
            e["retries"] = int(a.get("retries", 0))
            self.retry_events += 1
        elif name == "serve.request.timeout":
            self._entry(a["rid"])["status"] = "timeout"
            self.timeout_events += 1
        elif name == "serve.request.failed":
            self._entry(a["rid"])["status"] = "failed"
            self.failed_events += 1
        elif name == "serve.request.reject":
            self._entry(a["rid"])["status"] = "rejected"
            self.reject_events += 1
        elif name == "serve.fault":
            self.fault_events += 1
            self.transient_faults += bool(a.get("transient", False))
            self.blamed_requests += len(a.get("blamed", ()))
            self.isolated_innocents += len(a.get("isolated", ()))
            self.probes += int(a.get("probes", 0))
        elif name == "serve.degrade":
            if a.get("direction") == "shed":
                self.degrade_shed += 1
                self.degrade_level_max = max(self.degrade_level_max,
                                             int(a.get("level", 0)))
            else:
                self.degrade_restore += 1
        elif name == "serve.request.preempt":
            e = self._entry(a["rid"])
            e["preempts"] = e.get("preempts", 0) + 1
            self.preempt_events += 1
            self.parked_blocks += int(a.get("parked_blocks", 0))
        elif name == "serve.request.first_token":
            self._entry(a["rid"])["first"] = ev.time
        elif name == "serve.request.finish":
            e = self._entry(a["rid"])
            e["finish"] = ev.time
            e["n_tokens"] = int(a.get("n_tokens", 0))
            e["drafted"] = int(a.get("drafted", 0))
            e["accepted"] = int(a.get("accepted", 0))
        elif name == "serve.decode":
            active = int(a.get("active", 0))
            self.decode_steps += 1
            self.occupancy_sum += active
            self.occupancy_max = max(self.occupancy_max, active)
            self.slots = int(a.get("slots", self.slots))
            if "utilization" in a:
                self.pool_n_blocks = int(a.get("n_blocks", 0))
                self.pool_util_max = max(self.pool_util_max,
                                         float(a["utilization"]))
                self.pool_store_blocks_max = max(
                    self.pool_store_blocks_max, int(a.get("store_blocks", 0)))
            if len(self.timeline) < self.timeline_limit:
                self.timeline.append((ev.time - self._t0, "decode", active))
        elif name == "serve.prefill":
            self.prefill_events += 1
            n = int(a.get("n_tokens", 0))
            self.prefill_tokens += n
            self._tick_prefill_tokens += n
            self._prefill_start = ev.time
            self.chunked_events += bool(a.get("chunked", False))
            self.cached_tokens += int(a.get("cached", 0))
            if len(self.timeline) < self.timeline_limit:
                self.timeline.append((ev.time - self._t0, "prefill",
                                      int(a.get("group", 1))))
        elif name == "serve.tick":
            self.degraded_ticks += int(a.get("degrade_level", 0)) > 0
            self._close_tick()

    def on_operator_end(self, ev):
        if ev.name == "serve.prefill":
            if self._prefill_start is not None:
                self._tick_prefill_s += ev.time - self._prefill_start
                self._prefill_start = None
            self.duplicate_copy_bytes += int(
                ev.attrs.get("copied_bytes", 0))
        elif ev.name == "serve.decode":
            a = ev.attrs
            # non-speculative ticks commit one token per active slot
            self.committed_tokens += int(a.get("committed",
                                               a.get("active", 0)))
            self.spec_k = max(self.spec_k, int(a.get("spec_k", 0)))
            self.drafted_tokens += int(a.get("drafted", 0))
            self.accepted_tokens += int(a.get("accepted", 0))
            self.draft_s += float(a.get("draft_s", 0.0))
            self.params_bytes = int(a.get("params_bytes", self.params_bytes))
            self.kv_read_bytes += int(a.get("kv_read_bytes", 0))

    def _close_tick(self) -> None:
        """Fold the prefill work accumulated since the last decode dispatch
        into the per-tick stall maxima."""
        self.max_prefill_tokens_per_tick = max(
            self.max_prefill_tokens_per_tick, self._tick_prefill_tokens)
        self.max_prefill_stall_s = max(self.max_prefill_stall_s,
                                       self._tick_prefill_s)
        self._tick_prefill_tokens = 0
        self._tick_prefill_s = 0.0

    # -------------------------------------------------------------- finalize
    def finalize(self) -> dict:
        self._close_tick()       # a trailing prefill-only tick still counts
        ttft, tpot, queue, per_request = [], [], [], {}
        finished = 0
        generated = 0
        good_tokens = 0
        slo_met_n = 0
        tenants: dict = {}
        t_last = self._t0 or 0.0
        for rid, e in sorted(self.req.items()):
            tenant = e.get("tenant", "default")
            row = {"prompt_len": e.get("prompt_len", 0),
                   "cached_tokens": e.get("cached", 0),
                   "n_tokens": e.get("n_tokens", 0),
                   "drafted": e.get("drafted", 0),
                   "accepted": e.get("accepted", 0),
                   "tenant": tenant,
                   "preempts": e.get("preempts", 0),
                   "retries": e.get("retries", 0),
                   "status": e.get("status",
                                   "finished" if "finish" in e
                                   else "incomplete")}
            tn = tenants.setdefault(tenant, {
                "requests": 0, "finished": 0, "generated_tokens": 0,
                "good_tokens": 0, "slo_met": 0, "preempts": 0,
                "_ttft": [], "_queue": []})
            tn["requests"] += 1
            tn["preempts"] += row["preempts"]
            if "admit" in e and "submit" in e:
                row["queue_s"] = e["admit"] - e["submit"]
                queue.append(row["queue_s"])
                tn["_queue"].append(row["queue_s"])
            if "first" in e and "submit" in e:
                row["ttft_s"] = e["first"] - e["submit"]
                ttft.append(row["ttft_s"])
                tn["_ttft"].append(row["ttft_s"])
            if "finish" in e:
                finished += 1
                tn["finished"] += 1
                generated += e.get("n_tokens", 0)
                tn["generated_tokens"] += e.get("n_tokens", 0)
                t_last = max(t_last, e["finish"])
                if "first" in e and e.get("n_tokens", 0) > 1:
                    row["tpot_s"] = (e["finish"] - e["first"]) \
                        / (e["n_tokens"] - 1)
                    tpot.append(row["tpot_s"])
                # a finished request meets its SLO iff every STATED target
                # holds; untagged/targetless requests trivially meet, so
                # goodput degenerates to throughput without SLOs
                met = True
                tt = e.get("ttft_target")
                if tt is not None and row.get("ttft_s", 0.0) > tt:
                    met = False
                pt = e.get("tpot_target")
                if pt is not None and row.get("tpot_s", 0.0) > pt:
                    met = False
                row["slo_met"] = met
                if met:
                    slo_met_n += 1
                    tn["slo_met"] += 1
                    good_tokens += e.get("n_tokens", 0)
                    tn["good_tokens"] += e.get("n_tokens", 0)
            per_request[rid] = row
        span = max(t_last - (self._t0 or 0.0), 0.0)
        by_tenant = {}
        for name, tn in sorted(tenants.items()):
            by_tenant[name] = {
                "requests": tn["requests"],
                "finished": tn["finished"],
                "generated_tokens": tn["generated_tokens"],
                "ttft_s": _pctl(tn["_ttft"]),
                "queue_s": _pctl(tn["_queue"]),
                "slo_attainment": (tn["slo_met"] / tn["finished"]
                                   if tn["finished"] else None),
                "goodput_tok_per_s": (tn["good_tokens"] / span
                                      if span > 0 else 0.0),
                "preemptions": tn["preempts"],
            }
        # Jain's index over per-tenant generated tokens: 1.0 = perfectly
        # even service, 1/n = one tenant got everything
        shares = [tn["generated_tokens"] for tn in tenants.values()
                  if tn["finished"]]
        jain = ((sum(shares) ** 2 / (len(shares) * sum(x * x
                                                       for x in shares)))
                if shares and any(shares) else None)
        return {
            "requests": len(self.req),
            "finished": finished,
            "generated_tokens": generated,
            "tok_per_s": generated / span if span > 0 else 0.0,
            "ttft_s": _pctl(ttft),
            "tpot_s": _pctl(tpot),
            "queue_s": _pctl(queue),
            "decode_steps": self.decode_steps,
            "occupancy": {
                "mean": (self.occupancy_sum / self.decode_steps
                         if self.decode_steps else 0.0),
                "max": self.occupancy_max,
                "slots": self.slots,
            },
            "prefill": {"events": self.prefill_events,
                        "tokens": self.prefill_tokens,
                        "chunked_events": self.chunked_events,
                        "max_tokens_per_tick":
                            self.max_prefill_tokens_per_tick,
                        "max_stall_s": self.max_prefill_stall_s},
            "pool": {"n_blocks": self.pool_n_blocks,
                     "utilization_max": self.pool_util_max,
                     "store_blocks_max": self.pool_store_blocks_max,
                     "duplicate_copy_bytes": self.duplicate_copy_bytes},
            "speculative": {
                "spec_k": self.spec_k,
                "drafted_tokens": self.drafted_tokens,
                "accepted_tokens": self.accepted_tokens,
                "acceptance_rate": (self.accepted_tokens
                                    / self.drafted_tokens
                                    if self.drafted_tokens else 0.0),
                "committed_tokens": self.committed_tokens,
                "tokens_per_tick": (self.committed_tokens
                                    / self.decode_steps
                                    if self.decode_steps else 0.0),
                "draft_overhead_s": self.draft_s,
            },
            "bandwidth": {
                "params_bytes": self.params_bytes,
                "kv_read_bytes": self.kv_read_bytes,
                "analytic_bytes_per_token": (
                    (self.decode_steps * self.params_bytes
                     + self.kv_read_bytes) / self.committed_tokens
                    if self.committed_tokens else 0.0),
            },
            "prefix_cache": {
                "admits": self.admit_events,
                "hits": self.hit_events,
                "hit_rate": (self.hit_events / self.admit_events
                             if self.admit_events else 0.0),
                "reused_tokens": self.cached_tokens,
                "reused_frac": (self.cached_tokens
                                / self.admit_prompt_tokens
                                if self.admit_prompt_tokens else 0.0),
            },
            "slo": {
                "attainment": (slo_met_n / finished if finished else None),
                "good_tokens": good_tokens,
                "goodput_tok_per_s": (good_tokens / span
                                      if span > 0 else 0.0),
                "jain_fairness": jain,
            },
            "preemption": {
                "count": self.preempt_events,
                "parked_blocks": self.parked_blocks,
                "resumed": self.resumed_admits,
                "recovered_blocks": self.recovered_blocks,
            },
            "health": {
                "fault_events": self.fault_events,
                "transient_faults": self.transient_faults,
                "blamed_requests": self.blamed_requests,
                "isolated_innocents": self.isolated_innocents,
                "probes": self.probes,
                "retries": self.retry_events,
                "timeouts": self.timeout_events,
                "failed": self.failed_events,
                "rejections": self.reject_events,
                "degrade": {"shed_events": self.degrade_shed,
                            "restore_events": self.degrade_restore,
                            "level_max": self.degrade_level_max,
                            "degraded_ticks": self.degraded_ticks},
                "recovered_tokens": self.recovered_tokens,
                "recomputed_tokens": self.recomputed_tokens,
            },
            "tenants": by_tenant,
            "by_request": per_request,
            "series": self.timeline,
        }
