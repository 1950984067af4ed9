"""SLO specs and pluggable scheduling policies for the serving engine.

An :class:`SLOSpec` tags a request with its service-level objectives —
TTFT / TPOT targets in seconds — plus the tenant it belongs to and an
integer priority.  The engine threads the spec through the request
lifecycle events so the ``serving`` tool can report per-tenant SLO
attainment, goodput (tokens from SLO-meeting requests per wall second)
and Jain fairness, and the scheduler's :class:`SLOPolicy` uses it to
decide admission order and preemption victims.

Policies are deliberately tiny: a policy is an ordering ``key`` over the
waiting queue (stable-sorted, so equal keys keep arrival order) plus an
optional ``victims`` hook naming running requests to preempt when
higher-urgency work waits.  The engine owns the *mechanism* — parking a
victim's committed KV blocks in the prefix store and requeueing it so
re-admission aliases them back (see ``ServeEngine.preempt``) — the
policy only supplies the *decision*.

Built-ins:

=========== ======================================================
``fcfs``    arrival order, never preempts — byte-identical to the
            pre-policy scheduler (and the default)
``priority`` higher ``SLOSpec.priority`` first; preempts the
            youngest lowest-priority running request when a
            strictly higher-priority request waits with no free
            slot
``edf``     earliest TTFT deadline (``submit + ttft_target_s``)
            first; requests with no target sort last.  Preempts
            only victims that have not yet produced a first token
            (their TTFT is still at stake) for earlier deadlines
``fair``    tenants with the fewest served tokens first (the
            engine feeds committed-token counts back per tick);
            never preempts
=========== ======================================================
"""

from __future__ import annotations

import dataclasses
import math


@dataclasses.dataclass(frozen=True)
class SLOSpec:
    """Per-request service-level objectives + multi-tenant tags.

    Immutable — safe to share across every request of a tenant.  ``None``
    targets mean "no objective": the request trivially meets its SLO and
    sorts last under EDF.  ``deadline_s`` is HARD, not advisory: the
    engine cancels the request (status ``timeout``, resources released)
    once that many seconds elapse after submission."""

    ttft_target_s: float | None = None
    tpot_target_s: float | None = None
    tenant: str = "default"
    priority: int = 0
    deadline_s: float | None = None

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "SLOSpec":
        return cls(**{k: d[k] for k in
                      ("ttft_target_s", "tpot_target_s", "tenant",
                       "priority", "deadline_s")
                      if k in d})


def _slo(req) -> SLOSpec:
    return req.slo if getattr(req, "slo", None) is not None else _DEFAULT


_DEFAULT = SLOSpec()


class SLOPolicy:
    """Admission-order + preemption policy.  Subclass and override
    :meth:`key` (waiting-queue sort key; stable sort — ties keep arrival
    order) and, for preemptive policies, :meth:`victims`."""

    name = "base"
    #: False skips the (stable) waiting-queue sort entirely — FCFS stays
    #: byte-identical to the policy-free scheduler
    orders = True
    #: the engine only calls :meth:`victims` when this is True (and only
    #: in paged mode, where preempted KV can be parked in the prefix store)
    preemptive = False

    def key(self, req, now: float):
        """Sort key for the waiting queue; smaller admits first."""
        return req.rid

    def victims(self, waiting, running, n_free: int, now: float) -> list:
        """Running requests to preempt this tick, given the waiting list,
        the ``slot -> request`` running map and the free-slot count.
        Called before admission; each victim is parked and requeued."""
        return []

    def note_tokens(self, req, n: int = 1) -> None:
        """Feedback hook: ``n`` tokens just committed for ``req``."""

    def __repr__(self):
        return f"{type(self).__name__}()"


class FCFSPolicy(SLOPolicy):
    """Arrival order, no preemption — the default, byte-identical to the
    policy-free scheduler."""

    name = "fcfs"
    orders = False


class PriorityPolicy(SLOPolicy):
    """Strict priority admission; optionally preempts the youngest
    lowest-priority running request when a strictly higher-priority
    request waits and no slot is free."""

    name = "priority"

    def __init__(self, preempt: bool = True):
        self.preemptive = preempt

    def key(self, req, now):
        return (-_slo(req).priority, req.rid)

    def victims(self, waiting, running, n_free, now):
        # highest-priority waiting first; candidate victims sorted lowest
        # priority first, youngest (largest rid) breaking ties so the
        # request with the least sunk work is evicted
        wait = sorted(waiting, key=lambda r: (-_slo(r).priority, r.rid))
        run = sorted(running.values(),
                     key=lambda r: (_slo(r).priority, -r.rid))
        out = []
        free = n_free
        for w in wait:
            if free > 0:
                free -= 1
                continue
            if run and _slo(run[0]).priority < _slo(w).priority:
                out.append(run.pop(0))
            else:
                break
        return out

    def __repr__(self):
        return f"PriorityPolicy(preempt={self.preemptive})"


def _deadline(req) -> float:
    t = _slo(req).ttft_target_s
    return req.submit_time + t if t is not None else math.inf


class EDFPolicy(SLOPolicy):
    """Earliest TTFT deadline first.  Preemption (on by default) only
    targets running requests that have not yet produced a first token —
    once TTFT is met, evicting the victim could no longer help any
    deadline it still has."""

    name = "edf"

    def __init__(self, preempt: bool = True):
        self.preemptive = preempt

    def key(self, req, now):
        return (_deadline(req), req.rid)

    def victims(self, waiting, running, n_free, now):
        wait = sorted(waiting, key=lambda r: (_deadline(r), r.rid))
        run = sorted((r for r in running.values() if not r.tokens),
                     key=lambda r: (-_deadline(r), r.rid))
        out = []
        free = n_free
        for w in wait:
            if free > 0:
                free -= 1
                continue
            if run and _deadline(run[0]) > _deadline(w):
                out.append(run.pop(0))
            else:
                break
        return out

    def __repr__(self):
        return f"EDFPolicy(preempt={self.preemptive})"


class FairSharePolicy(SLOPolicy):
    """Least-served tenant first: the waiting queue sorts by each
    tenant's lifetime committed tokens (the engine calls
    :meth:`note_tokens` per committed token), so a chatty tenant cannot
    starve a quiet one.  Non-preemptive."""

    name = "fair"

    def __init__(self):
        self.served: dict = {}

    def key(self, req, now):
        return (self.served.get(_slo(req).tenant, 0), req.rid)

    def note_tokens(self, req, n: int = 1):
        t = _slo(req).tenant
        self.served[t] = self.served.get(t, 0) + n

    def __repr__(self):
        return f"FairSharePolicy(served={self.served})"


POLICIES = {
    "fcfs": FCFSPolicy,
    "priority": PriorityPolicy,
    "edf": EDFPolicy,
    "fair": FairSharePolicy,
}


def get_policy(spec) -> SLOPolicy | None:
    """Resolve ``None`` | policy name | :class:`SLOPolicy` instance.
    Fresh instance per call — policies may carry state (fair share)."""
    if spec is None or isinstance(spec, SLOPolicy):
        return spec
    try:
        return POLICIES[spec]()
    except KeyError:
        raise ValueError(
            f"unknown scheduling policy {spec!r}; "
            f"known: {sorted(POLICIES)}") from None
