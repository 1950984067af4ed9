"""Serving substrate: request-lifecycle engine over a paged KV block pool.

``ServeEngine.submit()/step()/run()/stream()`` is the continuous-batching
API; ``generate()`` survives as a deprecated one-shot shim.  See
``serve.scheduler`` (policy-ordered admission, preemption requeue, ragged
right-padding, chunked-prefill cursors), ``serve.slo`` (SLO specs +
FCFS/priority/EDF/fair-share scheduling policies), ``serve.traffic``
(seeded multi-tenant trace generation, JSONL replay), ``serve.faults``
(deterministic chaos plans driving the engine's blame-and-retry recovery)
and ``serve.cache`` (paged block pool + block tables, legacy KV slot
pool, hash-keyed zero-copy prefix reuse).  The engine runs on the device
of the parameters it is given.
"""

from .engine import ServeEngine
from .scheduler import Request, RequestState, SamplingParams, Scheduler
from .cache import KVSlotPool, PagedKVPool, PrefixCache
from .draft import DraftModelProposer, NgramProposer
from .faults import (FaultInjected, FaultPlan, FaultSpec, PRESETS,
                     get_plan)
from .slo import (EDFPolicy, FairSharePolicy, FCFSPolicy, POLICIES,
                  PriorityPolicy, SLOPolicy, SLOSpec, get_policy)
from .traffic import (TenantSpec, TraceRequest, load_trace, make_trace,
                      max_seq_for, save_trace, two_tenant_bursty)

__all__ = ["ServeEngine", "Request", "RequestState", "SamplingParams",
           "Scheduler", "KVSlotPool", "PagedKVPool", "PrefixCache",
           "NgramProposer", "DraftModelProposer",
           "FaultInjected", "FaultPlan", "FaultSpec", "PRESETS", "get_plan",
           "SLOSpec", "SLOPolicy", "FCFSPolicy", "PriorityPolicy",
           "EDFPolicy", "FairSharePolicy", "POLICIES", "get_policy",
           "TenantSpec", "TraceRequest", "make_trace", "max_seq_for",
           "save_trace", "load_trace", "two_tenant_bursty"]
