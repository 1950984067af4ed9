"""Heterogeneous multi-tenant trace generation for the serving engine.

A trace is a list of :class:`TraceRequest` — ``(arrival_s, prompt,
max_new_tokens, SLOSpec)`` — sorted by arrival time.  Each
:class:`TenantSpec` describes one tenant's traffic: how many requests,
when they arrive (Poisson / Gamma-renewal / bursty), how long their
prompts and generations are, how much prompt they share (a per-tenant
pool of common prefixes, the prefix-cache workload), and the SLO tags
every request carries.

Everything derives from one seed, so a trace is reproducible from
``(tenants, seed)`` alone — and :func:`save_trace` / :func:`load_trace`
round-trip the materialized trace through JSONL so a run can be replayed
exactly (``launch/serve.py --trace-file``) regardless of generator
changes.

Arrival processes (all with mean rate ``rate`` req/s from ``start_s``):

* ``poisson`` — i.i.d. exponential interarrivals; CV² = 1.
* ``gamma``  — Gamma-renewal interarrivals with squared coefficient of
  variation ``cv2`` (> 1 = burstier than Poisson, < 1 = smoother).
* ``burst``  — arrivals land in simultaneous clumps of ``burst_size``;
  clumps are spaced exponentially so the long-run rate still holds.
* ``rate == 0`` — the whole tenant arrives at once at ``start_s``.
"""

from __future__ import annotations

import dataclasses
import json

import numpy as np

from .slo import SLOSpec


@dataclasses.dataclass(frozen=True)
class TenantSpec:
    """One tenant's traffic model + SLO tags."""

    name: str = "default"
    n_requests: int = 8
    #: mean arrival rate in req/s (0 = everything at ``start_s``)
    rate: float = 0.0
    #: ``poisson`` | ``gamma`` | ``burst``
    arrival: str = "poisson"
    #: squared coefficient of variation of gamma interarrivals
    cv2: float = 4.0
    #: arrivals per clump for ``arrival="burst"``
    burst_size: int = 4
    #: offset added to every arrival time
    start_s: float = 0.0
    #: inclusive uniform range of fresh prompt tokens per request
    prompt_len: tuple = (8, 32)
    #: inclusive uniform range of generation lengths
    max_new_tokens: tuple = (8, 16)
    #: tokens of tenant-shared prefix prepended to every prompt
    shared_prefix: int = 0
    #: distinct shared prefixes the tenant draws from (1 = one system
    #: prompt for the whole tenant)
    prefix_pool: int = 1
    priority: int = 0
    ttft_target_s: float | None = None
    tpot_target_s: float | None = None

    @property
    def slo(self) -> SLOSpec:
        return SLOSpec(ttft_target_s=self.ttft_target_s,
                       tpot_target_s=self.tpot_target_s,
                       tenant=self.name, priority=self.priority)


@dataclasses.dataclass
class TraceRequest:
    """One materialized arrival: everything ``submit()`` needs."""

    arrival_s: float
    prompt: np.ndarray
    max_new_tokens: int
    #: None = untagged (no SLO, default tenant, priority 0)
    slo: SLOSpec | None = None

    @property
    def tenant(self) -> str:
        return self.slo.tenant if self.slo is not None else "default"


def _interarrivals(spec: TenantSpec, rng) -> np.ndarray:
    n = spec.n_requests
    if spec.rate <= 0:
        return np.zeros(n)
    if spec.arrival == "poisson":
        return np.cumsum(rng.exponential(1.0 / spec.rate, n))
    if spec.arrival == "gamma":
        # Gamma(shape k, scale θ): mean kθ, CV² = 1/k — pick k from the
        # requested burstiness, θ to keep the mean interarrival 1/rate
        k = 1.0 / max(spec.cv2, 1e-6)
        theta = 1.0 / (spec.rate * k)
        return np.cumsum(rng.gamma(k, theta, n))
    if spec.arrival == "burst":
        n_bursts = -(-n // spec.burst_size)
        # clump spacing keeps the long-run rate: burst_size arrivals per
        # exponential(burst_size/rate) gap
        gaps = np.cumsum(rng.exponential(spec.burst_size / spec.rate,
                                         n_bursts))
        return np.repeat(gaps, spec.burst_size)[:n]
    raise ValueError(f"unknown arrival process {spec.arrival!r} "
                     f"(poisson | gamma | burst)")


def make_trace(tenants, vocab: int, seed: int = 0) -> list:
    """Materialize every tenant's arrivals into one merged trace, sorted
    by arrival time (ties keep tenant listing order).  Deterministic in
    ``(tenants, vocab, seed)``; each tenant draws from its own
    seed-derived stream, so adding a tenant never perturbs another's
    trace."""
    out = []
    for ti, spec in enumerate(tenants):
        rng = np.random.default_rng([seed, ti])
        pool = [rng.integers(0, vocab, (spec.shared_prefix,), dtype=np.int32)
                for _ in range(max(spec.prefix_pool, 1))]
        arrivals = spec.start_s + _interarrivals(spec, rng)
        lens = rng.integers(spec.prompt_len[0], spec.prompt_len[1] + 1,
                            spec.n_requests)
        news = rng.integers(spec.max_new_tokens[0],
                            spec.max_new_tokens[1] + 1, spec.n_requests)
        picks = rng.integers(0, len(pool), spec.n_requests)
        slo = spec.slo
        for i in range(spec.n_requests):
            fresh = rng.integers(0, vocab, (int(lens[i]),), dtype=np.int32)
            prompt = np.concatenate([pool[int(picks[i])], fresh]) \
                if spec.shared_prefix else fresh
            out.append(TraceRequest(arrival_s=float(arrivals[i]),
                                    prompt=prompt,
                                    max_new_tokens=int(news[i]), slo=slo))
    out.sort(key=lambda t: t.arrival_s)
    return out


def max_seq_for(trace, pad: int = 0) -> int:
    """Tightest engine ``max_seq`` that fits every request in ``trace``."""
    return max(len(t.prompt) + t.max_new_tokens for t in trace) + pad


#: JSONL trace schema version written by :func:`save_trace`.  Bump on any
#: incompatible field change; :func:`load_trace` refuses unknown versions
#: instead of silently misreading a future trace.
TRACE_SCHEMA = 1


def save_trace(path: str, trace, seed: int | None = None,
               meta: dict | None = None) -> None:
    """Write a trace as JSONL: one ``_meta`` header line (schema version +
    seed + anything in ``meta``), then one request per line."""
    with open(path, "w") as f:
        f.write(json.dumps({"_meta": dict(meta or {}, schema=TRACE_SCHEMA,
                                          seed=seed,
                                          n_requests=len(trace))}) + "\n")
        for t in trace:
            f.write(json.dumps({
                "arrival_s": t.arrival_s,
                "prompt": [int(x) for x in t.prompt],
                "max_new_tokens": t.max_new_tokens,
                **(t.slo.to_dict() if t.slo is not None else {})}) + "\n")


def load_trace(path: str):
    """Replay a JSONL trace; returns ``(trace, meta)``.  Traces written by
    a newer schema are rejected with a readable error (a header with no
    ``schema`` field is the legacy v0 layout, which v1 reads fine)."""
    trace, meta = [], {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            d = json.loads(line)
            if "_meta" in d:
                meta = d["_meta"]
                schema = meta.get("schema", 0)
                if schema > TRACE_SCHEMA:
                    raise ValueError(
                        f"{path}: trace schema v{schema} is newer than "
                        f"this reader (v{TRACE_SCHEMA}) — regenerate the "
                        f"trace or upgrade repro_torch.serve.traffic")
                continue
            trace.append(TraceRequest(
                arrival_s=float(d.get("arrival_s", 0.0)),
                prompt=np.asarray(d["prompt"], np.int32),
                max_new_tokens=int(d.get("max_new_tokens", 16)),
                slo=SLOSpec.from_dict(d)))
    trace.sort(key=lambda t: t.arrival_s)
    return trace, meta


def two_tenant_bursty(vocab: int, seed: int = 0, n_lo: int = 4,
                      n_hi: int = 4, lo_new: int = 224, hi_new: int = 8,
                      hi_start_s: float = 0.15,
                      hi_ttft_s: float | None = 1.0) -> list:
    """The benchmark/CI scenario: a batch tenant floods the engine with
    long generations at t=0, then a latency-sensitive tenant bursts in
    shortly after.  Under FCFS the ``hi`` burst queues behind the ``lo``
    drain; under priority/EDF it preempts into service — high-priority
    TTFT should collapse while total goodput stays (token totals are
    policy-invariant and preempted work is parked, not lost)."""
    lo = TenantSpec(name="lo", n_requests=n_lo, rate=0.0, start_s=0.0,
                    prompt_len=(16, 24), max_new_tokens=(lo_new, lo_new),
                    shared_prefix=16, priority=0, ttft_target_s=60.0)
    hi = TenantSpec(name="hi", n_requests=n_hi, rate=0.0,
                    start_s=hi_start_s, prompt_len=(8, 16),
                    max_new_tokens=(hi_new, hi_new), shared_prefix=16,
                    priority=5, ttft_target_s=hi_ttft_s)
    return make_trace([lo, hi], vocab, seed=seed)


#: named presets for the launcher's ``--traffic`` flag
PRESETS = {"two-tenant-bursty": two_tenant_bursty}
