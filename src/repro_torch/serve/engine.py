"""Request-lifecycle serving engine: continuous batching over a paged KV pool.

The engine is a scheduler tick loop, not a one-shot call::

    engine = ServeEngine(cfg, params, max_seq=256, max_slots=4)
    rid = engine.submit(prompt, SamplingParams(max_new_tokens=32))
    while engine.step()["working"]:
        ...                                    # or: engine.run(requests)

One :meth:`step` is one scheduler tick: admit waiting requests FCFS into
free KV slots (gated on block availability in paged mode), prefill them,
then one fused decode step over *all* fully-prefilled slots, then retire
finished requests.  Heterogeneous traffic therefore shares every decode
dispatch, and batch occupancy/goodput become measurable quantities instead
of a fixed batch dimension.

KV memory for the ``dense`` family is **paged**
(:class:`~repro_torch.serve.cache.PagedKVPool`): one block pool plus
per-slot block tables, so a prefix-cache hit aliases the stored blocks into
the new request's table (refcount bump, zero bytes copied — no
``extract_kv`` copy on the prefill critical path) and publishing a
finished prefill retains the slot's own blocks under store keys.  Long cold
prefills optionally split into **chunks** across scheduler ticks
(``prefill_chunk=``), bounding how long prefill work can stall co-resident
decodes: ``prefill_chunk`` is a per-tick prefill token budget shared FCFS
across all mid-prefill requests, spent through the per-query-causal
multi-token append path before each fused decode — so the work between two
decode dispatches never exceeds one chunk.  SSM/hybrid (and MoE) families
keep the exact-length non-paged :class:`~repro_torch.serve.cache.KVSlotPool`
path — their recurrent state is not block-addressable.

**Scheduling is policy-pluggable** (``policy=``): an
:class:`~repro_torch.serve.slo.SLOPolicy` stable-sorts the waiting queue each
tick (FCFS default — byte-identical to the policy-free scheduler) and,
for preemptive policies (priority/EDF), names running victims when
higher-urgency work waits with no free slot.  Preemption is
**evict-and-requeue without losing work**: the victim's committed KV
blocks are parked in the :class:`~repro_torch.serve.cache.PrefixCache` through
the same ``insert_blocks``/refcount path a finished prefill uses (zero
bytes copied), the slot frees, and the request rejoins the queue front;
re-admission looks up its *context* (prompt + committed tokens), aliases
the parked blocks straight back, and the position-keyed sampler resumes
at exactly the next position — so a preempted request's output is
byte-identical to its unpreempted run, at any temperature.  The
``interleave=`` knob arbitrates prefill vs decode per tick:
``"chunked"`` spends the prefill budget every tick, ``"decode"`` defers
chunk work while any slot can decode.

**Speculative decoding** (``spec_decode=k``) reuses that same multi-token
append path for decode itself: a draft proposer (``draft=`` — n-gram
prompt-lookup self-draft, a small draft model, or any
``propose(contexts, k)`` object) guesses ``k`` tokens per active slot,
one fused verify forward scores all ``k+1`` positions, and the accept
loop commits the matching prefix (plus the bonus token on full
acceptance) while rejected suffixes roll back via
``PagedKVPool.truncate`` — block-table accounting only, the dead KV bytes
are overwritten before any mask exposes them.  Sampling keys derive from
``(seed-or-rid, position)`` so output is byte-identical to the
non-speculative path at ANY temperature; speculation changes speed,
never tokens.  Dense-attention families only: recurrent SSM/hybrid state
cannot roll back to an arbitrary position.

PASTA instrumentation is per request *across interleaved steps*: each
submitted request opens a child :class:`~repro_torch.core.Session` of the engine's
session at submit time and closes it at retirement, so its lifecycle events
(``serve.request.submit/admit/first_token/finish``) and any per-request tool
reports span queueing, prefill, and every fused decode tick it participated
in, while the parent session aggregates the fleet view (the registered
``serving`` tool turns those events into TTFT/TPOT, occupancy timeline,
prefix-hit-rate, block-pool-utilization and chunk-stall reports).

**Fault tolerance** is blame-and-retry, not abort-everything.  A seeded
:class:`~repro_torch.serve.faults.FaultPlan` (``faults=``) injects deterministic
chaos — tick exceptions, poisoned requests, NaN logits, stalls, pool
pressure, host-preemption signals — and the recovery layer turns a failed
tick into surgical cleanup: non-finite logits rows blame their request
directly, attributable tick exceptions are *bisected* over the live set
(``FaultPlan.probe``) to find the culprit(s), and every innocent runner is
losslessly re-queued by parking its committed KV blocks in the prefix
store exactly like a policy preemption (zero bytes copied, byte-identical
resumed output).  Blamed requests retry up to ``max_request_retries``
times behind a capped exponential backoff (their KV is recomputed, their
tokens are position-keyed so the output still cannot change) and then end
with status ``failed``.  ``SLOSpec.deadline_s`` is enforced every tick
(status ``timeout``, slot + blocks + owed reservation released, child
session closed).  Under sustained pool pressure or repeated slow ticks
the engine sheds load in declared order — speculative decode off, prefill
chunk budget halved, new admissions ``rejected`` — and restores each knob
as pressure clears.  ``health()`` accounts for every fault, retry,
timeout and degradation event; the session sees ``serve.fault`` /
``serve.degrade`` / ``serve.request.retry|timeout|failed|reject`` events.

**On PyTorch** the reference's ``jax.jit`` dispatches are plain calls of
:func:`~repro_torch.models.lm.forward` on the device of the parameters
the engine is given (the card, unless the caller built them on the CPU).
The pools are preallocated and written in place where the reference
donates them; block tables, lengths and tokens cross to the device once
per dispatch, and each dispatch waits on the card once, for its logits
(converted to float32 there: numpy has no bf16).  The model calls run with
the operator hooks silent, as the reference's jitted forwards are, so an
instrumented session sees the reference's event stream.  Sampling at
temperature > 0 draws from the port's own generator, keyed by the same
``(seed-or-(engine seed, rid), position)`` tuple: the reference's
invariants hold, its exact draws cannot.

**On a mesh** (a ``DeviceMesh`` registered with
:func:`repro_torch.dist.sharding.set_mesh`, one rank per card) every rank
runs this engine on its blocks: the weights are DTensors (placed by
``init_params(shardings=)``), the pools are placed
(:mod:`~repro_torch.serve.cache`), the dispatches run under DTensor's
implicit replication and the logits are gathered whole to every rank, so
every rank samples the same bits.  The host decisions are made once for
all ranks by :class:`MeshSync`, over a gloo group of the engine's own: one
clock, rank 0's, read at fixed points, and one plan, held equal on every
rank before a tick's first device call and after its commits; a rank that
would diverge makes every rank raise.

``generate(prompts)`` survives as a deprecated shim over ``submit``/``run``
with the legacy observability contract (one child session per *call*).
``abort(rid)`` cancels a request at any lifecycle stage, releasing its slot,
its pool blocks and its child session; ``run``/``stream``/``generate`` keep
abort-all as the backstop for *unattributable* exceptions (anything the
recovery layer does not own), so a mid-drain failure still cannot leak KV
slots or leave sessions open forever.
"""

from __future__ import annotations

import collections
import datetime
import hashlib
import itertools
import struct
import time
import warnings

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

import repro_torch.core as pasta
from repro_torch.core.instrument import capturing
from repro_torch.dist.sharding import get_mesh
from repro_torch.models import forward
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import torch_dtype
from repro_torch.train.trainer import _on_mesh
from .cache import (KVSlotPool, PagedKVPool, PrefixCache, bucket, to_device,
                    to_host)
from .draft import DraftModelProposer, NgramProposer
from .faults import FaultInjected, get_plan
from .scheduler import (Request, RequestState, SamplingParams, Scheduler,
                        pad_group)
from .slo import get_policy

#: families whose decode state is attention KV only — eligible for padded
#: group prefill, prefix-cache reuse, and the paged block pool.  SSM/hybrid
#: state summarizes the whole prefix nonlinearly (a pad token would mutate
#: it, unlike masked KV) and MoE routing couples tokens, so those prefill
#: alone at exact length.  vlm/audio would qualify if tokenized, but their
#: configs are embedding-frontend stubs with no autoregressive token loop.
_KV_ONLY = ("dense",)

#: lifecycle states no transition leaves — abort/cancel paths are
#: idempotent against all of them
_TERMINAL = frozenset((RequestState.FINISHED, RequestState.ABORTED,
                       RequestState.FAILED, RequestState.TIMEOUT,
                       RequestState.REJECTED))

#: degradation ladder: level -> the knob that level sheds
_DEGRADE_KNOBS = {1: "spec_decode_off", 2: "prefill_chunk_halved",
                  3: "reject_admissions"}

#: how long a host message of :class:`MeshSync` waits for every rank
SYNC_TIMEOUT_S = 600


class HostSync:
    """The engine's clock and plan agreement on one device: every clock
    read is ``time.perf_counter``, and there is no other rank to agree
    with."""

    def clock(self) -> float:
        """A reading every rank shares: a sync point."""
        return time.perf_counter()

    def now(self) -> float:
        """The time a host decision reads."""
        return time.perf_counter()

    def agree(self, tick: int, what: str, fields: dict,
              clock: bool = False):
        """Hold ``fields`` equal on every rank; with ``clock``, also a
        sync point, whose reading is returned."""
        del tick, what, fields
        return time.perf_counter() if clock else None


def _digest(value) -> int:
    """A 64-bit digest of a field's value, the same in every process."""
    return int.from_bytes(hashlib.blake2b(repr(value).encode(),
                                          digest_size=8).digest(),
                          "little", signed=True)


class MeshSync(HostSync):
    """One clock and one plan for every rank of the mesh, over a gloo
    group made once for the engine (a host message neither waits on the
    card nor enters the NCCL stream).

    The clock is rank 0's ``time.perf_counter``, sent at fixed points only
    (:meth:`clock`, and :meth:`agree` with ``clock=True``): the
    launcher's arrival check, a tick's start and a tick's end.  Between
    them every decision read (:meth:`now`) returns the last reading, so
    within a tick every rank decides on the tick-start time.
    :meth:`agree` gathers a 64-bit digest of each field from every rank
    and raises ``RuntimeError`` on every rank, naming the tick, the first
    rank that differs from rank 0 and the field, where any differs."""

    def __init__(self):
        self.group = dist.new_group(backend="gloo", timeout=datetime.timedelta(
            seconds=SYNC_TIMEOUT_S))
        self.world = dist.get_world_size(self.group)
        self.src = dist.get_global_rank(self.group, 0)
        self._now = self.clock()

    def clock(self) -> float:
        buf = torch.tensor([time.perf_counter()], dtype=torch.float64)
        dist.broadcast(buf, src=self.src, group=self.group)
        self._now = float(buf[0])
        return self._now

    def now(self) -> float:
        return self._now

    def agree(self, tick: int, what: str, fields: dict,
              clock: bool = False):
        names = list(fields)
        mine = [_digest(fields[n]) for n in names]
        if clock:
            mine.insert(0, struct.unpack("<q", struct.pack(
                "<d", time.perf_counter()))[0])
        buf = torch.tensor(mine, dtype=torch.int64)
        every = [torch.empty_like(buf) for _ in range(self.world)]
        dist.all_gather(every, buf, group=self.group)
        off = 1 if clock else 0
        for r in range(1, self.world):
            for i, name in enumerate(names):
                if int(every[r][off + i]) != int(every[0][off + i]):
                    raise RuntimeError(
                        f"serving on a mesh: tick {tick}: rank {r}'s {what} "
                        f"differs from rank 0's in {name!r}")
        if clock:
            self._now = struct.unpack("<d", struct.pack(
                "<q", int(every[0][0])))[0]
            return self._now
        return None


class ServeEngine:
    """Continuous-batching generation engine over the unified LM."""

    def __init__(self, cfg: ModelConfig, params, max_seq: int = 512,
                 max_slots: int = 8, handler=None,
                 session: "pasta.Session | None" = None,
                 rng_seed: int = 0, request_tools=None,
                 max_request_reports: int = 64, prefix_cache: bool = True,
                 prefix_block: int = 16, max_retained_requests: int = 4096,
                 paged: bool | None = None, block_size: int | None = None,
                 n_blocks: int | None = None,
                 prefill_chunk: int | None = None,
                 spec_decode: int = 0, draft="ngram",
                 draft_cfg: ModelConfig | None = None, draft_params=None,
                 policy=None, interleave: str = "chunked",
                 faults=None, fault_seed: int = 0,
                 max_request_retries: int = 2,
                 retry_backoff_s: float = 0.05,
                 retry_backoff_cap_s: float = 0.5,
                 degrade: bool | None = None,
                 slow_tick_s: float = 0.05):
        """``max_slots``: concurrent requests the KV pool holds; waiting
        requests queue FCFS.  ``session``: parent Session for per-request
        child sessions (innermost active session when omitted).
        ``request_tools``: tool spec instantiated fresh for every request's
        child session; reports land in ``request_reports`` at retirement.
        ``handler``: legacy pinned event sink — disables per-request
        sessions (compat path).  ``prefix_cache``: hash-keyed prompt-prefix
        reuse (KV-only families; block-aligned keys of ``prefix_block``).
        ``paged``: block-table KV layout (default: on for KV-only families,
        impossible for SSM/hybrid).  ``block_size``: pool block width in
        tokens (defaults to ``prefix_block`` so prefix hits alias whole
        blocks).  ``n_blocks``: pool capacity (default: per-slot parity plus
        two sequences of prefix-store headroom).  ``prefill_chunk``:
        per-tick prefill token budget, shared FCFS across mid-prefill
        requests (paged mode only; ``None`` = unbounded whole-prompt
        prefills).  ``spec_decode``: draft ``k`` tokens per active slot per
        tick and verify all ``k+1`` positions in ONE fused target forward
        (``0`` = the plain one-token-per-tick path, unchanged).  ``draft``:
        ``"ngram"`` (prompt-lookup self-draft, no second model),
        ``"model"`` (greedy rollout from ``draft_cfg``/``draft_params``;
        defaults to the target itself — every draft accepted), or any
        object with ``propose(contexts, k)``.  ``policy``: scheduling
        policy name (``fcfs``/``priority``/``edf``/``fair``) or
        :class:`~repro_torch.serve.slo.SLOPolicy` instance — orders the waiting
        queue and, preemptive policies, names running victims to
        evict-and-requeue (paged mode only; ``None``/``fcfs`` is
        byte-identical to the policy-free scheduler).  ``interleave``:
        prefill/decode arbitration per tick — ``"chunked"`` (default)
        spends the FCFS ``prefill_chunk`` budget every tick;
        ``"decode"`` defers ALL mid-prefill chunk work on ticks where any
        slot can decode (decode-priority; requires ``prefill_chunk``).
        ``faults``: a :class:`~repro_torch.serve.faults.FaultPlan`, a preset name,
        or ``None`` — deterministic chaos injected into the tick loop
        (paged mode only: recovery parks KV via the prefix store).
        ``max_request_retries``/``retry_backoff_s``/``retry_backoff_cap_s``:
        blamed requests are re-queued (full recompute, byte-identical
        output) up to this many times behind a capped exponential backoff,
        then end ``failed``.  ``degrade``: enable the load-shedding ladder
        (``None`` = auto: on only when a fault plan is present, so plain
        engines never shed on compile spikes); ``slow_tick_s``: absolute
        floor for slow-tick detection.

        On a registered mesh, ``params`` (and ``draft_params``) must be
        placed DTensors, a drawn draft model is placed leaf by leaf; the
        pools are placed and the host decisions, a speculative tick's
        drafts among them, agreed (:class:`MeshSync`), so every rank of
        the mesh builds its engine with the same arguments, at the same
        time."""
        if cfg.frontend != "none":
            raise NotImplementedError(
                "ServeEngine decodes token ids; embedding-frontend archs "
                "have no autoregressive token loop to serve")
        self.cfg = cfg
        self.params = params
        #: every dispatch runs where the parameters lie
        self.device = _params_device(params)
        self.mesh = get_mesh()
        self._check_placed(params)
        #: the engine's clock and plan agreement: on a mesh, rank 0's
        #: clock and one plan for every rank
        self.sync = MeshSync() if self.mesh is not None else HostSync()
        self.max_seq = max_seq
        self.session = session
        self._handler = handler
        self._route_handler = None        # legacy generate(): pin to the
        self._per_request_sessions = True  # per-call child session
        self.request_tools = request_tools
        self.request_reports: collections.deque = collections.deque(
            maxlen=max_request_reports)
        self._req_ids = itertools.count()
        self._call_ids = itertools.count()   # legacy generate() child names
        self._rng_seed = rng_seed
        self.requests: dict = {}             # rid -> Request
        # long-lived engines must not grow host memory with traffic served:
        # retired Requests (prompt + tokens) are pruned FIFO beyond this
        # bound (live requests are never pruned; the floor keeps one tick's
        # worth of retirements readable for run()/stream() collection)
        self.max_retained_requests = max(max_retained_requests, max_slots)
        self._retired: collections.deque = collections.deque()
        self.policy = get_policy(policy)
        self.sched = Scheduler(max_slots, policy=self.policy)

        # ---- fault tolerance: chaos plan, retry pen, degradation ladder
        self.faults = get_plan(faults, seed=fault_seed)
        self.max_request_retries = int(max_request_retries)
        self.retry_backoff_s = float(retry_backoff_s)
        self.retry_backoff_cap_s = float(retry_backoff_cap_s)
        self.degrade_enabled = ((self.faults is not None) if degrade is None
                                else bool(degrade))
        self.slow_tick_s = float(slow_tick_s)
        self.ticks = 0
        self.degrade_level = 0
        self.degraded_ticks = 0
        self.fault_ticks = 0
        self.tick_retries = 0
        self.request_retries = 0
        self.failed_requests = 0
        self.timeouts = 0
        self.rejections = 0
        self.isolated_innocents = 0
        self.fault_probes = 0
        self.host_preempt_signals = 0
        self.recomputed_tokens = 0
        #: blamed-but-retryable requests serving their backoff; NOT in the
        #: scheduler's waiting queue, so they cannot head-of-line block
        self._backoff: list = []
        self._tick_durs: collections.deque = collections.deque(maxlen=32)
        self._slow_streak = 0
        self._calm_streak = 0
        self._admission_blocked = False
        self._fault_streak = 0

        self.paged = (cfg.family in _KV_ONLY) if paged is None else paged
        if self.paged and cfg.family not in _KV_ONLY:
            raise ValueError(
                f"paged KV serving requires a KV-only family, not "
                f"{cfg.family!r} (SSM/hybrid state is not block-addressable)")
        if prefill_chunk is not None and not self.paged:
            raise ValueError("prefill_chunk requires the paged KV pool")
        if self.faults is not None and not self.paged:
            raise ValueError(
                "fault injection requires the paged KV pool: recovery "
                "parks innocent requests' KV in the prefix store, which "
                "non-paged recurrent state cannot re-alias")
        self.block_size = block_size if block_size is not None else \
            (prefix_block if self.paged else 16)
        if self.paged:
            # prefix keys must sit on block boundaries so a hit aliases
            # whole blocks and the suffix starts in a fresh one
            prefix_block = self.block_size
            self.pool = PagedKVPool(cfg, max_slots, max_seq,
                                    block_size=self.block_size,
                                    n_blocks=n_blocks, device=self.device,
                                    mesh=self.mesh)
        else:
            self.pool = KVSlotPool(cfg, max_slots, max_seq,
                                   device=self.device, mesh=self.mesh)
        self.prefill_chunk = None
        if prefill_chunk is not None:
            # round up to a block multiple: chunk boundaries then coincide
            # with block boundaries (tidy tables, O(log) tail shapes)
            self.prefill_chunk = -(-prefill_chunk // self.block_size) \
                * self.block_size
        if self.policy is not None and self.policy.preemptive \
                and not self.paged:
            raise ValueError(
                f"policy {self.policy!r} preempts via the prefix store, "
                f"which needs the paged KV pool; use a non-preemptive "
                f"policy (e.g. PriorityPolicy(preempt=False)) or paged "
                f"mode")
        if interleave not in ("chunked", "decode"):
            raise ValueError(
                f"interleave must be 'chunked' or 'decode', not "
                f"{interleave!r}")
        if interleave == "decode" and self.prefill_chunk is None:
            raise ValueError(
                "interleave='decode' arbitrates the chunked-prefill "
                "budget; set prefill_chunk=")
        self.interleave = interleave
        #: preemption lifetime counters: evictions, blocks parked into the
        #: prefix store at eviction, and tokens/blocks aliased back (zero
        #: recompute) at resumed admissions
        self.preemptions = 0
        self.parked_blocks = 0
        self.recovered_tokens = 0
        self.recovered_blocks = 0
        self.prefix_cache = None
        if prefix_cache and cfg.family in _KV_ONLY:
            on_evict = ((lambda ent: self.pool.release(ent, store=True))
                        if self.paged else None)
            self.prefix_cache = PrefixCache(block=prefix_block,
                                            on_evict=on_evict)
            if self.paged:
                self.pool.evict_cb = self.prefix_cache.evict_one
        #: host bytes copied to duplicate K/V for the prefix store — zero in
        #: paged mode (the store aliases pool blocks), nonzero only on the
        #: legacy extract_kv publish path
        self.duplicate_copy_bytes = 0
        self._prefilling: list = []          # paged requests mid-prefill
        #: rid -> blocks this live request may still draw from the pool
        #: (admission reserves the whole horizon incl. speculative spill;
        #: lazy binding/ensure() draws against it, truncate() pays back)
        self._owed: dict = {}
        self.last_tokens = np.zeros((max_slots,), np.int32)
        self.decode_steps = 0

        self.spec_k = int(spec_decode)
        if self.spec_k < 0:
            raise ValueError("spec_decode must be >= 0")
        self.proposer = None
        self.drafted_tokens = 0
        self.accepted_tokens = 0
        #: one full parameter read per decode dispatch — the model-bytes
        #: term of the analytic per-token bandwidth estimate
        self.params_bytes = int(sum(x.nbytes for x in _leaves(params)))
        if self.spec_k:
            if cfg.family not in _KV_ONLY:
                raise NotImplementedError(
                    f"speculative decoding is unsupported for the "
                    f"{cfg.family!r} family: verification rolls back by "
                    f"truncating KV lengths, but SSM/hybrid recurrent state "
                    f"cannot un-absorb a rejected suffix")
            if isinstance(draft, str):
                if draft == "ngram":
                    self.proposer = NgramProposer()
                elif draft == "model":
                    dcfg = draft_cfg if draft_cfg is not None else cfg
                    if dcfg.vocab_size != cfg.vocab_size:
                        raise ValueError(
                            f"draft vocab {dcfg.vocab_size} != target "
                            f"vocab {cfg.vocab_size}")
                    dparams = (draft_params if draft_params is not None
                               else (params if draft_cfg is None else None))
                    if dparams is not None:
                        self._check_placed(dparams)
                    self.proposer = DraftModelProposer(
                        dcfg, dparams, device=self.device)
                else:
                    raise ValueError(f"unknown draft source {draft!r}")
            else:
                self.proposer = draft
            self._verify_idx = np.broadcast_to(
                np.arange(self.spec_k + 1, dtype=np.int32),
                (max_slots, self.spec_k + 1)).copy()
            #: constant per engine; transferred once, not per tick
            self._verify_idx_dev = to_device(self._verify_idx, self.device)

    def _check_placed(self, params) -> None:
        if self.mesh is not None and not all(
                isinstance(x, DTensor) for x in _leaves(params)):
            raise ValueError(
                "serving on a mesh needs placed weights: "
                "init_params(cfg, seed, device, shardings=serve_shardings("
                "mesh, ...)[0])")

    # ------------------------------------------------------------ dispatches
    def _forward(self, params, tokens, **kw):
        """One model call, as the reference's jitted dispatches: no
        autograd, and the operator hooks silent (the reference's hooks
        are no-ops under ``jax.jit``); on a mesh, under DTensor's
        implicit replication, as ``make_decode_step``'s."""
        with torch.no_grad(), capturing(), _on_mesh():
            return forward(params, tokens, self.cfg, **kw)

    def _prefill_cold(self, params, tokens, last_idx):
        logits, cache = self._forward(params, tokens, return_cache=True,
                                      logits_mode="index",
                                      logits_index=last_idx)
        return logits[:, 0, :], cache

    def _prefill_suffix(self, params, cache, tokens, last_idx):
        logits, cache = self._forward(params, tokens, cache=cache,
                                      logits_mode="index",
                                      logits_index=last_idx)
        return logits[:, 0, :], cache

    def _decode(self, params, cache, tokens):
        logits, cache = self._forward(params, tokens, cache=cache,
                                      logits_mode="last")
        return logits[:, -1, :], cache

    def _verify(self, params, cache, tokens, idx):
        # speculative verify: ONE fused forward appends [last, d_1..d_k] per
        # row through the per-query-causal cache path and reads logits at
        # every position — logits[:, s] is the target's next-token
        # distribution given the committed prefix plus drafts d_1..d_s
        return self._forward(params, tokens, cache=cache,
                             logits_mode="index", logits_index=idx)

    def _dev(self, a) -> torch.Tensor:
        return to_device(a, self.device)

    # -------------------------------------------------------------- plumbing
    @property
    def handler(self):
        """The engine's fleet-level event sink: the legacy generate() route,
        the pinned legacy handler, the parent session's handler, or the
        innermost active session's."""
        if self._route_handler is not None:
            return self._route_handler
        if self._handler is not None:
            return self._handler
        if self.session is not None:
            return self.session.handler
        return pasta.current_handler()

    def _req_handler(self, req: Request):
        """Per-request events go through the request's child session (which
        forwards to the parent), or the engine sink when sessions are off."""
        if req.session is not None:
            return req.session.handler
        return self.handler

    def _sample_one(self, req: Request, logits_row: np.ndarray,
                    position: int | None = None) -> int:
        """Sample one token.  The temperature>0 key is derived purely from
        ``(seed-or-(engine seed, rid), position)`` — never from shared key
        state — so sampled streams are schedule-invariant: byte-identical
        whatever the admission interleaving, and identical between the
        speculative (sample-and-match) and sequential paths."""
        if req.params.temperature <= 0:
            return int(np.argmax(logits_row))
        position = len(req.tokens) if position is None else position
        seed = req.params.seed
        key = ((0, self._rng_seed, req.rid, position) if seed is None
               else (1, seed, position))
        # Gumbel-max: argmax(logits / T + G) is a categorical draw
        gumbel = np.random.default_rng(key).gumbel(size=logits_row.shape)
        return int(np.argmax(logits_row / req.params.temperature + gumbel))

    def pool_stats(self) -> dict:
        """Block-pool / slot-pool memory accounting, including the bytes
        duplicated for the prefix store (zero when paged: aliased blocks)."""
        if self.paged:
            st = self.pool.stats()
        else:
            st = {"paged": False, "slots": self.pool.slots,
                  "max_seq": self.pool.max_seq}
        st["duplicate_copy_bytes"] = self.duplicate_copy_bytes
        return st

    # --------------------------------------------------------------- warmup
    def warmup(self, prompt_lens=()) -> dict:
        """Run the steady-state dispatches once before traffic arrives, so
        TTFT/TPOT percentiles measure serving latency rather than set-up
        (the reference compiles them here; on PyTorch the first calls pay
        the device libraries' and the allocator's set-up instead).

        Warms the fused decode (and, speculative, the fused verify) at their
        one production shape, plus cold- and suffix-prefill per distinct
        pow2 bucket of ``prompt_lens``.  All warmup forwards run against
        fully *parked* rows (paged: every position resolves to the drop
        sentinel) or rows a later admission overwrites wholesale, so pool
        state stays exactly as if warmup never ran.  Call on an idle engine;
        returns ``{"compile_s", "warmed"}``."""
        assert not self.sched.has_work, "warmup() needs an idle engine"
        t0 = time.perf_counter()
        warmed = []
        slots = self.pool.slots
        zeros = self._dev(np.zeros((slots, 1), np.int32))
        if self.paged:
            span = self.pool.blocks_per_seq * self.pool.block_size
            parked = np.full((slots,), span, np.int32)
            _, cache = self._decode(self.params, self.pool.cache_view(parked),
                                    zeros)
            self.pool.adopt(cache)
            if self.spec_k:
                _, cache = self._verify(
                    self.params, self.pool.cache_view(parked),
                    self._dev(np.zeros((slots, self.spec_k + 1),
                                       np.int32)),
                    self._verify_idx_dev)
                self.pool.adopt(cache)
        else:
            # free-slot rows absorb one junk token at their current length;
            # harmless — admission's insert() rewrites the whole slot row
            # (KV, recurrent state, length) before the slot is ever read
            if self.spec_k:
                kv = self.pool.cache["kv"]
                parked = self._dev(np.full((slots,), self.pool.max_seq,
                                           np.int32))
                cache = dict(self.pool.cache, kv=dict(kv, length=parked))
                _, self.pool.cache = self._verify(
                    self.params, cache,
                    self._dev(np.zeros((slots, self.spec_k + 1),
                                       np.int32)),
                    self._verify_idx_dev)
            else:
                _, self.pool.cache = self._decode(self.params,
                                                  self.pool.cache, zeros)
        warmed.append(("decode", slots, self.spec_k + 1))
        buckets = sorted({min(bucket(int(n)), self.max_seq)
                          for n in prompt_lens})
        for length in buckets:
            one = self._dev(np.zeros((1, length), np.int32))
            idx = self._dev(np.zeros((1,), np.int32))
            self._prefill_cold(self.params, one, idx)
            warmed.append(("prefill_cold", 1, length))
            if self.paged:
                view = self.pool.cache_view(
                    np.asarray([span], np.int32), rows=[0])
                _, cache = self._prefill_suffix(self.params, view, one, idx)
                self.pool.adopt(cache)
                warmed.append(("prefill_suffix", 1, length))
            elif self.prefix_cache is not None:
                seeded = self.pool.seeded_prefill_cache(None)
                self._prefill_suffix(self.params, seeded, one, idx)
                warmed.append(("prefill_suffix", 1, length))
        return {"compile_s": time.perf_counter() - t0, "warmed": warmed}

    # ------------------------------------------------------------ submission
    def submit(self, prompt, params: SamplingParams | None = None,
               slo=None) -> int:
        """Enqueue one generation request; returns its request id.  The
        request's child Session opens here and spans queueing, prefill, and
        every fused decode step until retirement.  ``slo``: optional
        :class:`~repro_torch.serve.slo.SLOSpec` — tenant/priority tags feed the
        scheduling policy, TTFT/TPOT targets feed the serving tool's
        goodput/attainment accounting."""
        params = params or SamplingParams()
        prompt = np.asarray(prompt, dtype=np.int32)
        if prompt.ndim != 1 or prompt.shape[0] == 0:
            raise ValueError("submit() takes ONE 1-D token prompt; use "
                             "run()/generate() for batches")
        if params.max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        if prompt.shape[0] + params.max_new_tokens > self.max_seq:
            raise ValueError(
                f"prompt ({prompt.shape[0]}) + max_new_tokens "
                f"({params.max_new_tokens}) exceeds max_seq={self.max_seq}")
        rid = next(self._req_ids)
        req = Request(rid=rid, prompt=prompt, params=params, slo=slo,
                      submit_time=self.sync.now())
        attrs = {}
        if slo is not None:
            attrs = {"tenant": slo.tenant, "priority": slo.priority,
                     "ttft_target_s": slo.ttft_target_s,
                     "tpot_target_s": slo.tpot_target_s}
        if self.degrade_enabled and self.degrade_level >= 3:
            # shedding level 3: fail fast at the door — no child session,
            # no queue slot; callers see terminal status "rejected"
            req.state = RequestState.REJECTED
            self.requests[rid] = req
            self.rejections += 1
            self._req_handler(req).operator_start(
                "serve.request.submit", rid=rid, prompt_len=req.prompt_len,
                max_new_tokens=params.max_new_tokens, **attrs)
            self._req_handler(req).operator_start(
                "serve.request.reject", rid=rid,
                degrade_level=self.degrade_level)
            self._retired.append(rid)
            while len(self._retired) > self.max_retained_requests:
                self.requests.pop(self._retired.popleft(), None)
            return rid
        if self._per_request_sessions and self._handler is None:
            parent = self.session or pasta.current_session()
            req.session = parent.child(
                tools=self.request_tools or (),
                name=f"{parent.name}/request{rid}")
        self.requests[rid] = req
        self.sched.submit(req)
        self._req_handler(req).operator_start(
            "serve.request.submit", rid=rid, prompt_len=req.prompt_len,
            max_new_tokens=params.max_new_tokens, **attrs)
        return rid

    # ------------------------------------------------------------------ tick
    def _horizon_blocks(self, req: Request) -> int:
        """Blocks the request may ever hold at once.  Speculative verify
        writes can spill up to ``k-1`` positions past the final committed
        token before rolling back, so admission reserves that headroom too
        (capped at the table span — the attention scatter drops beyond it)."""
        horizon = req.prompt_len + req.params.max_new_tokens
        if self.spec_k:
            span = self.pool.blocks_per_seq * self.pool.block_size
            horizon = min(horizon - 1 + self.spec_k, span)
        return self.pool.blocks_for(horizon)

    def _fits(self, req: Request) -> bool:
        """Paged admission gate: enough blocks (free + store-evictable) for
        the request's whole horizon, on top of what already-admitted
        requests are still owed.  Conservative — a prefix hit will need
        fewer fresh blocks than this — and deadlock-free: aliasing a store
        entry removes at most as many evictable blocks as it saves, and
        every later draw (bind, lazy ensure) decrements the reservation by
        exactly the blocks taken, so ``available() >= sum(owed)`` is an
        invariant."""
        need = self._horizon_blocks(req)
        avail = self.pool.available() - sum(self._owed.values())
        if self.faults is not None:
            # injected pool pressure: blocks withheld from admission (never
            # from already-admitted draws, so the owed invariant holds)
            avail -= self.faults.held_blocks(self.ticks)
        if avail < need:
            self._admission_blocked = True
            return False
        self._owed[req.rid] = need
        return True

    def _bind_paged(self, req: Request, hit_len: int, entry) -> None:
        """Build the request's block table for the admission CONTEXT only
        (the prompt — plus the committed tokens, on a resumed admission):
        alias the prefix-store blocks (refcount bump, zero copies) and
        allocate fresh blocks for the rest.  Decode/speculative growth
        binds lazily (:meth:`PagedKVPool.ensure`) against the admission
        reservation."""
        need = self.pool.blocks_for(req.prefill_len)
        shared = list(entry) if hit_len else []
        if shared:
            self.pool.retain(shared)            # this request's live ref
        fresh = self.pool.alloc(need - len(shared))
        if fresh is None:                       # _fits() guarantees capacity
            raise RuntimeError(
                f"paged pool exhausted admitting rid={req.rid}: need "
                f"{need - len(shared)} fresh blocks, "
                f"{self.pool.available()} available")
        self.pool.bind_slot(req.slot, shared, fresh)
        self._owed[req.rid] = max(self._owed.get(req.rid, need) - need, 0)
        req.progress = hit_len

    def _grow_slot(self, req: Request, n_tokens: int) -> None:
        """Lazy block binding for decode/verify writes up to ``n_tokens``
        positions, drawing against the request's admission reservation."""
        grew = self.pool.ensure(req.slot, n_tokens)
        if grew:
            self._owed[req.rid] = max(self._owed.get(req.rid, 0) - grew, 0)

    @property
    def has_work(self) -> bool:
        """Live work anywhere: the scheduler's queue and slots, plus blamed
        requests serving their retry backoff in the engine's pen."""
        return self.sched.has_work or bool(self._backoff)

    def step(self) -> dict:
        """One scheduler tick: preempt victims the policy names, reorder +
        admit+prefill into free slots (at most one chunk's worth of prefill
        tokens across all mid-prefill requests), one fused decode over all
        fully-prefilled slots, retire finished requests.  Returns
        ``{"admitted","finished","new_tokens","active","queued","working"}``.

        The fault-tolerance envelope lives here: deadlines are enforced and
        expired retry backoffs re-admitted first; injected stalls /
        pool-pressure / host-preemption signals are applied; an injected
        tick exception is caught and recovered (blame bisection, retry or
        fail the culprits, park every innocent runner losslessly); and the
        degradation ladder updates from the tick's pressure signals.
        """
        self.ticks += 1
        t0 = self.sync.clock()
        self._admission_blocked = False
        self._enforce_deadlines(t0)
        self._readmit_backoff(t0)
        if self.faults is not None:
            stall = self.faults.tick_stall_s(self.ticks)
            if stall > 0:
                time.sleep(stall)
            for _ in range(self.faults.preempt_signals(self.ticks)):
                running = sorted(self.sched.running.values(),
                                 key=lambda r: r.rid)
                if not running:
                    break
                # the host wants a slot back — evict the newest runner
                # (least sunk work), parked losslessly like any victim
                self.host_preempt_signals += 1
                self._preempt(running[-1], reason="host")
        out: dict = {"admitted": [], "finished": [], "new_tokens": []}
        try:
            self._step_inner(out)
            self._fault_streak = 0
        except FaultInjected as exc:
            self._fault_streak += 1
            if self._fault_streak > 12:
                # unrecoverable storm: every recent tick died — fall back
                # to the callers' abort-all backstop instead of spinning
                raise
            self._recover(exc, out)
        t1 = self.sync.agree(self.ticks, "commits",
                             {"new_tokens": tuple(out["new_tokens"]),
                              "finished": tuple(out["finished"])},
                             clock=True)
        self._update_degradation(t1 - t0)
        # tick boundary marker: lets per-tick reductions (prefill-stall
        # accounting in the serving tool) close their window even on ticks
        # with no decodable slot — or on an abandoned faulty tick
        self.handler.operator_start("serve.tick", active=self.sched.n_active,
                                    queued=self.sched.n_queued,
                                    degrade_level=self.degrade_level)
        if not self.sched.has_work and self._backoff:
            # nothing runnable until a backoff expires: yield briefly so
            # run()/stream() drain loops don't spin the host CPU
            wake = min(r.retry_at for r in self._backoff)
            time.sleep(min(max(wake - self.sync.now(), 0.0), 0.02))
        out["active"] = self.sched.n_active
        out["queued"] = self.sched.n_queued
        out["working"] = self.has_work
        return out

    def _step_inner(self, out: dict) -> None:
        """The actual tick work; ``out`` accumulates what committed, so an
        abandoned tick still reports the tokens it landed before the
        fault."""
        new_tokens: list = out["new_tokens"]
        finished: list = out["finished"]
        if self.policy is not None:
            now = self.sync.now()
            if self.policy.preemptive and self.paged and self.sched.waiting:
                for victim in self.policy.victims(
                        list(self.sched.waiting), dict(self.sched.running),
                        self.sched.n_free, now):
                    self._preempt(victim)
            self.sched.reorder(now)
        admitted = self.sched.admit(fits=self._fits if self.paged else None)
        out["admitted"] = [r.rid for r in admitted]
        if self.mesh is not None:
            self._agree_plan(admitted)
        cold_group: list = []
        for req in admitted:
            # a resumed admission must re-materialize prompt + committed
            # tokens — lookups/prefill run over the CONTEXT, so the parked
            # blocks alias straight back (fresh request: context == prompt)
            ctx = req.context
            resumed = req.preemptions > 0 or req.retries > 0
            req.prefill_len = req.context_len
            hit_len, entry = 0, None
            if self.prefix_cache is not None:
                # every admission is one lookup — the cache's hit_rate and
                # the serving tool's per-admission hit_rate share the same
                # denominator by construction
                hit_len, entry = self.prefix_cache.lookup(ctx)
            req.cached_tokens = hit_len
            req.prefix_kv = entry
            recovered = hit_len // self.block_size \
                if resumed and self.paged else 0
            recomputed = (req.prefill_len - hit_len) if resumed else 0
            if resumed:
                self.recovered_tokens += hit_len
                self.recovered_blocks += recovered
                self.recomputed_tokens += recomputed
            self._req_handler(req).operator_start(
                "serve.request.admit", rid=req.rid, slot=req.slot,
                prompt_len=req.prefill_len, cached_tokens=hit_len,
                queue_s=req.admit_time - req.submit_time,
                resumed=resumed, recovered_blocks=recovered,
                recomputed_tokens=recomputed)
            if self.paged:
                self._bind_paged(req, hit_len, entry)
                req.prefix_kv = None
                if hit_len == 0 and self.prefill_chunk is None:
                    cold_group.append(req)      # grouped dense fast path
                else:
                    # hits append their suffix; with chunking on, EVERY
                    # prefill goes through the budgeted append path so the
                    # per-tick bound holds fleet-wide
                    self._prefilling.append(req)
            elif hit_len == 0 and self.cfg.family in _KV_ONLY:
                cold_group.append(req)
            else:
                self._prefill_unit([req], new_tokens, finished)
        if cold_group:
            self._prefill_unit(cold_group, new_tokens, finished)
        # chunked prefill: one shared FCFS token budget per tick — the total
        # prefill work between two fused decodes never exceeds one chunk.
        # interleave="decode" zeroes the budget whenever any slot can
        # decode: chunk work only runs on decode-idle ticks (max_new_tokens
        # bounds every decode tail, so deferral is starvation-free)
        budget = self.prefill_chunk
        if budget is not None and self.degrade_level >= 2:
            # shedding level 2: halve the per-tick prefill budget (floor
            # one block) — decode latency wins over admission ramp
            budget = max(self.block_size, budget // 2)
        if self.interleave == "decode" and self._prefilling \
                and self._decode_actives():
            budget = 0
        for req in list(self._prefilling):
            if budget is not None and budget <= 0:
                break
            budget_used = self._append_chunk(req, new_tokens, finished,
                                             budget)
            if budget is not None:
                budget -= budget_used
        if self.spec_k and self.degrade_level < 1:
            self._spec_decode_step(new_tokens, finished)
        else:
            # shedding level 1 parks speculation: plain one-token decode
            self._decode_step(new_tokens, finished)
        if self.policy is not None and new_tokens:
            # committed-token feedback (fair-share weights, etc.)
            for rid, _ in new_tokens:
                r = self.requests.get(rid)
                if r is not None:
                    self.policy.note_tokens(r)

    def _agree_plan(self, admitted: list) -> None:
        """The tick's plan, held equal on every rank before its first
        device call: the admitted requests and their slots, the queue,
        each running row's request and length, the degradation level and
        the pool's free blocks (free slots on the slot pool)."""
        self.sync.agree(self.ticks, "plan", {
            "admitted": tuple((r.rid, r.slot) for r in admitted),
            "queued": tuple(r.rid for r in self.sched.waiting),
            "rows": tuple((slot, r.rid, r.context_len)
                          for slot, r in sorted(self.sched.running.items())),
            "degrade_level": self.degrade_level,
            "free": self.pool.n_free if self.paged else self.sched.n_free})

    # -------------------------------------------------------------- prefill
    def _publish(self, req: Request) -> None:
        """Publish the finished prefill's K/V for reuse.  Paged: retain the
        slot's own blocks under block-aligned store keys of the admission
        context (zero bytes moved; the context is the prompt on a fresh
        admission, prompt + committed tokens on a resumed one).  Legacy:
        one blocking device->host extract per new prompt (counted in
        ``duplicate_copy_bytes``)."""
        if self.prefix_cache is None:
            return
        if self.paged:
            self.prefix_cache.insert_blocks(
                req.context, self.pool.tables[req.slot],
                on_retain=lambda ids: self.pool.retain(ids, store=True))
            return
        if self.prefix_cache.covers(req.prompt):
            return
        kv = self.pool.extract_kv(req.slot, req.prompt_len)
        self.duplicate_copy_bytes += kv["k"].nbytes + kv["v"].nbytes
        self.prefix_cache.insert(req.prompt, kv)

    def _first_token(self, req: Request, logits_row, new_tokens: list,
                     finished: list) -> None:
        """Sample the context's continuation once prefill completes.  On a
        resumed admission this is NOT the request's first token — the
        sampling position is ``len(req.tokens)``, exactly the position the
        unpreempted run would sample next, so preemption never changes a
        token — and the TTFT clock/event stays with the true first."""
        tok = self._sample_one(req, logits_row)
        req.tokens.append(tok)
        self.last_tokens[req.slot] = tok
        new_tokens.append((req.rid, tok))
        if not req.first_token_time:
            req.first_token_time = time.perf_counter()
            self._req_handler(req).operator_start(
                "serve.request.first_token", rid=req.rid,
                ttft_s=req.first_token_time - req.submit_time)
        if req.done:
            self._retire(req, finished)

    def _prefill_unit(self, reqs: list, new_tokens: list,
                      finished: list) -> None:
        """Prefill one admission unit: a right-padded cold group (KV-only
        families) or a single request (legacy prefix hit / SSM / hybrid /
        MoE)."""
        if self.faults is not None:
            # before the event span opens and before any device dispatch:
            # an abandoned tick leaves balanced events and untouched state
            self.faults.check_tick(self.ticks, [r.rid for r in reqs])
        hit = len(reqs) == 1 and reqs[0].cached_tokens > 0
        self.handler.operator_start(
            "serve.prefill",
            rids=tuple(r.rid for r in reqs),
            slots=tuple(r.slot for r in reqs),
            n_tokens=int(sum(r.prefill_len - r.cached_tokens
                             for r in reqs)),
            cached=int(sum(r.cached_tokens for r in reqs)),
            group=len(reqs), chunked=False)
        copied_before = self.duplicate_copy_bytes
        if hit:
            req = reqs[0]
            suffix = req.prompt[req.cached_tokens:]
            # right-pad the suffix to a pow2 bucket too (bounds the shapes;
            # causality keeps the pad exact) — capped so the append window
            # stays inside max_seq, as the reference's (whose
            # dynamic_update_slice would clamp the start)
            n = len(suffix)
            s_pad = min(bucket(n), self.max_seq - req.cached_tokens)
            toks = np.zeros((1, s_pad), np.int32)
            toks[0, :n] = suffix
            cache = self.pool.seeded_prefill_cache(req.prefix_kv)
            logits, cache = self._prefill_suffix(
                self.params, cache, self._dev(toks),
                self._dev(np.asarray([n - 1], np.int32)))
        else:
            # ragged group: right-pad to a power-of-two bucket CAPPED at the
            # pool bound (a non-pow2 max_seq must not compile positions the
            # pool can never hold); causality makes the pad exact for
            # attention (masked KV), so per-row results match solo prefill.
            # SSM/hybrid/MoE units are single requests prefilled at EXACT
            # length — a pad token would update the carried SSM state
            # (input-dependent dt) / MoE routing.
            pow2 = self.cfg.family in _KV_ONLY
            toks, lens = pad_group([r.context for r in reqs], pow2=pow2,
                                   max_len=self.max_seq if pow2 else None)
            logits, cache = self._prefill_cold(
                self.params, self._dev(toks), self._dev(lens - 1))
        logits = to_host(logits)
        if self.paged:
            cache = self.pool.local_rows(cache)
        for row, req in enumerate(reqs):
            if self.paged:
                self.pool.insert_prefill(cache, req.slot, row)
            else:
                self.pool.insert(cache, req.slot, row, req.prefill_len)
            req.progress = req.prefill_len
            self._publish(req)
            req.prefix_kv = None
        self.handler.operator_end(
            "serve.prefill", rids=tuple(r.rid for r in reqs),
            copied_bytes=self.duplicate_copy_bytes - copied_before)
        for row, req in enumerate(list(reqs)):
            self._first_token(req, logits[row], new_tokens, finished)

    def _append_chunk(self, req: Request, new_tokens: list, finished: list,
                      budget: int | None = None) -> int:
        """Advance one mid-prefill paged request by one chunk (at most
        ``budget`` tokens): scatter the chunk's K/V through the slot's block
        table (per-query causal masking keeps multi-token appends exact)
        and, on the final chunk, sample the first token and publish the
        prompt's blocks.  Returns the tokens prefilled."""
        if self.faults is not None:
            self.faults.check_tick(self.ticks, [req.rid])
        remaining = req.prefill_len - req.progress
        chunk = remaining if budget is None else min(budget, remaining)
        span = self.pool.blocks_per_seq * self.pool.block_size
        s_pad = min(bucket(chunk), span - req.progress)
        toks = np.zeros((1, s_pad), np.int32)
        ctx = req.context
        toks[0, :chunk] = ctx[req.progress:req.progress + chunk]
        first_chunk = req.progress == req.cached_tokens
        self.handler.operator_start(
            "serve.prefill", rids=(req.rid,), slots=(req.slot,),
            n_tokens=chunk, cached=req.cached_tokens if first_chunk else 0,
            group=1, chunked=self.prefill_chunk is not None,
            base=req.progress)
        cache = self.pool.cache_view(np.asarray([req.progress], np.int32),
                                     rows=[req.slot])
        logits, cache = self._prefill_suffix(
            self.params, cache, self._dev(toks),
            self._dev(np.asarray([chunk - 1], np.int32)))
        self.pool.adopt(cache)
        req.progress += chunk
        self.handler.operator_end("serve.prefill", rids=(req.rid,),
                                  copied_bytes=0)
        if req.prefilled:
            self._prefilling.remove(req)
            self._publish(req)
            self._first_token(req, to_host(logits)[0], new_tokens,
                              finished)
        return chunk

    # --------------------------------------------------------------- decode
    def _decode_actives(self) -> dict:
        """Slots eligible for the fused decode: fully prefilled, first token
        sampled (mid-prefill rows ride along masked)."""
        return {slot: req
                for slot, req in sorted(self.sched.running.items())
                if req.prefilled and req.tokens}

    def _kv_read_bytes(self, lens, s: int) -> int:
        """Analytic KV traffic of one fused decode/verify dispatch: every
        active row streams its whole live KV window (plus the ``s`` appended
        positions) once — block-granular in paged mode, since a partially
        filled block is still a whole block off the device memory bus."""
        cfg = self.cfg
        per_pos = 2 * cfg.n_layers * cfg.n_kv_heads * cfg.head_dim \
            * torch_dtype(cfg.dtype).itemsize
        total = 0
        for ln in lens:
            touched = ln + s
            if self.paged:
                touched = self.pool.blocks_for(touched) * self.pool.block_size
            total += touched * per_pos
        return total

    def _decode_pool_attrs(self) -> dict:
        if not self.paged:
            return {}
        st = self.pool.stats()
        return {"blocks_used": st["blocks_used"],
                "n_blocks": st["n_blocks"],
                "store_blocks": st["store_blocks"],
                "utilization": st["utilization"]}

    def _decode_step(self, new_tokens: list, finished: list) -> None:
        """One fused decode over every fully-prefilled slot (free and
        mid-prefill slots ride along as masked no-ops; their stale bytes
        never enter any softmax and their writes drop)."""
        active = self._decode_actives()
        if not active:
            return
        if self.faults is not None:
            self.faults.check_tick(self.ticks,
                                   [r.rid for r in active.values()])
        self.decode_steps += 1
        self.handler.operator_start(
            "serve.decode", step=self.decode_steps, active=len(active),
            slots=self.pool.slots, queued=self.sched.n_queued,
            rids=tuple(r.rid for r in active.values()),
            **self._decode_pool_attrs())
        base = {slot: req.prompt_len + len(req.tokens) - 1
                for slot, req in active.items()}
        if self.paged:
            span = self.pool.blocks_per_seq * self.pool.block_size
            # rows without a decodable request park at length == span: their
            # K/V writes resolve to the sentinel block and drop
            lengths = np.full((self.pool.slots,), span, np.int32)
            for slot, req in active.items():
                lengths[slot] = base[slot]
                self._grow_slot(req, base[slot] + 1)
            cache = self.pool.cache_view(lengths)
            logits, cache = self._decode(
                self.params, cache, self._dev(self.last_tokens[:, None]))
            self.pool.adopt(cache)
        else:
            logits, self.pool.cache = self._decode(
                self.params, self.pool.cache,
                self._dev(self.last_tokens[:, None]))
        logits = to_host(logits)
        logits, bad = self._blame_nonfinite(active, logits)
        for slot in bad:
            del active[slot]                    # blamed rows sample nothing
        for slot, req in active.items():
            tok = self._sample_one(req, logits[slot])
            req.tokens.append(tok)
            self.last_tokens[slot] = tok
            new_tokens.append((req.rid, tok))
        self.handler.operator_end(
            "serve.decode", step=self.decode_steps, active=len(active),
            committed=len(active), params_bytes=self.params_bytes,
            kv_read_bytes=self._kv_read_bytes(base.values(), 1))
        for req in list(active.values()):
            if req.done:
                self._retire(req, finished)

    def _spec_decode_step(self, new_tokens: list, finished: list) -> None:
        """Propose → fused verify → accept/rollback, one tick.

        Each active slot's verify row is ``[last_token, d_1..d_k]``
        (zero-padded past its draft).  The fused target forward appends all
        ``k+1`` positions through the per-query-causal cache path and
        returns logits at every one; per slot the accept loop then replays
        sequential decoding exactly: sample from position ``s`` (same
        argmax / same position-keyed PRNG draw the plain path would make),
        commit, and continue only while the sampled token matches draft
        ``d_{s+1}`` — so output is byte-identical to non-speculative decode
        and a fully-accepted draft commits ``k+1`` tokens (bonus token) in
        one dispatch.  Rejected suffix KV stays as dead bytes above the
        committed length (overwritten by the next append, never read);
        paged slots also roll their block tables back so draft-spill blocks
        return to the pool."""
        active = self._decode_actives()
        if not active:
            return
        if self.faults is not None:
            self.faults.check_tick(self.ticks,
                                   [r.rid for r in active.values()])
        k = self.spec_k
        t_draft = time.perf_counter()
        drafts = self.proposer.propose(
            [np.concatenate([req.prompt,
                             np.asarray(req.tokens, np.int32)])
             for req in active.values()], k)
        draft_s = time.perf_counter() - t_draft
        drafts = [np.asarray(d, np.int32)[:k] for d in drafts]
        # one batch of drafts for every rank before the verify: drafts
        # that differed by rank would mix inside its collectives unseen
        self.sync.agree(self.ticks, "drafts", {
            f"slot {slot}": tuple(int(t) for t in d)
            for slot, d in zip(active, drafts)})
        span = (self.pool.blocks_per_seq * self.pool.block_size
                if self.paged else self.pool.max_seq)
        toks = np.zeros((self.pool.slots, k + 1), np.int32)
        lengths = np.full((self.pool.slots,), span, np.int32)
        dlen = {}
        for (slot, req), d in zip(active.items(), drafts):
            dlen[slot] = len(d)
            toks[slot, 0] = self.last_tokens[slot]
            toks[slot, 1:1 + len(d)] = d
            lengths[slot] = req.prompt_len + len(req.tokens) - 1
            if self.paged:
                self._grow_slot(req, min(int(lengths[slot]) + k + 1, span))
        self.decode_steps += 1
        n_drafted = sum(dlen.values())
        self.handler.operator_start(
            "serve.decode", step=self.decode_steps, active=len(active),
            slots=self.pool.slots, queued=self.sched.n_queued,
            rids=tuple(r.rid for r in active.values()), spec_k=k,
            drafted=n_drafted, **self._decode_pool_attrs())
        if self.paged:
            cache = self.pool.cache_view(lengths)
            logits, cache = self._verify(self.params, cache,
                                         self._dev(toks),
                                         self._verify_idx_dev)
            self.pool.adopt(cache)
        else:
            # the device length leaf is not authoritative in spec mode (a
            # rollback never rewrites it); rebuild the mask lengths from
            # committed host state every tick, parking idle rows at max_seq
            kv = self.pool.cache["kv"]
            cache = dict(self.pool.cache,
                         kv=dict(kv, length=self._dev(lengths)))
            logits, self.pool.cache = self._verify(self.params, cache,
                                                   self._dev(toks),
                                                   self._verify_idx_dev)
        logits = to_host(logits)
        pairs = list(zip(list(active.items()), drafts))
        logits, bad = self._blame_nonfinite(active, logits)
        for slot in bad:
            del active[slot]                    # blamed rows commit nothing
        accepted = committed = 0
        for (slot, req), d in pairs:
            if slot not in active:
                continue
            len0 = len(req.tokens)
            s = 0
            while True:
                tok = self._sample_one(req, logits[slot, s],
                                       position=len0 + s)
                req.tokens.append(tok)
                new_tokens.append((req.rid, tok))
                committed += 1
                if req.done or s >= dlen[slot] or int(toks[slot, s + 1]) != tok:
                    break
                accepted += 1
                s += 1
            req.drafted += dlen[slot]
            req.accepted += s
            self.last_tokens[slot] = req.tokens[-1]
            if self.paged and not req.done:
                # rollback: keep blocks through the next write position
                # (committed prefix + the pending last token), release the
                # rejected draft spill back to the pool
                freed = self.pool.truncate(
                    req.slot, req.prompt_len + len(req.tokens))
                if freed:
                    self._owed[req.rid] = self._owed.get(req.rid, 0) + freed
        self.drafted_tokens += n_drafted
        self.accepted_tokens += accepted
        self.handler.operator_end(
            "serve.decode", step=self.decode_steps, active=len(active),
            spec_k=k, drafted=n_drafted, accepted=accepted,
            committed=committed, draft_s=draft_s,
            params_bytes=self.params_bytes,
            kv_read_bytes=self._kv_read_bytes(
                [int(lengths[s]) for s in active], k + 1))
        for req in list(active.values()):
            if req.done:
                self._retire(req, finished)

    # --------------------------------------------------------------- retire
    def _retire(self, req: Request, finished: list) -> None:
        n = len(req.tokens)
        if self.paged:
            self.pool.free_slot(req.slot)
        self._owed.pop(req.rid, None)
        self.sched.release(req)
        self._req_handler(req).operator_start(
            "serve.request.finish", rid=req.rid, n_tokens=n,
            ttft_s=req.first_token_time - req.submit_time,
            total_s=req.finish_time - req.submit_time,
            drafted=req.drafted, accepted=req.accepted,
            preemptions=req.preemptions)
        if req.session is not None:
            if self.request_tools:
                self.request_reports.append(req.session.reports())
            req.session.close()
            req.session = None
        finished.append(req.rid)
        self._retired.append(req.rid)
        while len(self._retired) > self.max_retained_requests:
            self.requests.pop(self._retired.popleft(), None)

    def preempt(self, rid: int) -> bool:
        """Evict-and-requeue a RUNNING request without losing its work:
        park its committed KV blocks in the prefix store (refcount holds,
        zero bytes copied), free the slot, and put it back at the front of
        the waiting queue.  Re-admission looks up the request's CONTEXT
        (prompt + committed tokens), aliases the parked blocks straight
        back, and resumes sampling at the exact position the unpreempted
        run would use — output is byte-identical, recompute is bounded to
        the sub-block tail.  Preemptive policies call this through
        :meth:`step`; it is also a public knob (e.g. manual load
        shedding).  Paged mode only.  Returns False for requests not
        currently RUNNING."""
        req = self.requests.get(rid)
        if req is None or req.state is not RequestState.RUNNING:
            return False
        if not self.paged:
            raise ValueError(
                "preemption parks KV in the prefix store, which needs the "
                "paged pool (non-paged recurrent state cannot re-alias)")
        self._preempt(req)
        return True

    def _preempt(self, req: Request, reason: str = "policy") -> None:
        # cached KV covers `progress` positions mid-prefill; once decoding,
        # it covers context_len - 1 (the newest sampled token is pending in
        # last_tokens — its KV is written by the NEXT decode dispatch)
        kv_len = req.progress if not req.prefilled else req.context_len - 1
        parked = 0
        if self.prefix_cache is not None and kv_len >= self.block_size:
            self.prefix_cache.insert_blocks(
                req.context[:kv_len], self.pool.tables[req.slot],
                on_retain=lambda ids: self.pool.retain(ids, store=True))
            parked = kv_len // self.block_size
        self.pool.free_slot(req.slot)           # store refs keep parked KV
        if req in self._prefilling:
            self._prefilling.remove(req)
        self._owed.pop(req.rid, None)
        self.preemptions += 1
        self.parked_blocks += parked
        self._req_handler(req).operator_start(
            "serve.request.preempt", rid=req.rid, slot=req.slot,
            n_tokens=len(req.tokens), kv_len=kv_len, parked_blocks=parked,
            reason=reason)
        req.progress = 0
        req.cached_tokens = 0
        req.prefill_len = None
        req.prefix_kv = None
        self.sched.preempt(req)

    def _cancel(self, req: Request, state: RequestState, event: str,
                **attrs) -> None:
        """Shared terminal-cancellation path (abort / timeout / fail):
        release queue position or slot (and, paged, pool blocks), clear the
        owed reservation, emit the terminal event, close the child session,
        enter retirement bookkeeping.  Callers guarantee the request is
        live (queued, running, or in the retry-backoff pen)."""
        if req in self._backoff:
            self._backoff.remove(req)
            req.state = state
        elif req.state is RequestState.QUEUED:
            self.sched.remove_waiting(req, state=state)
        else:                                   # RUNNING: holds a slot
            if self.paged:
                self.pool.free_slot(req.slot)
            if req in self._prefilling:
                self._prefilling.remove(req)
            self.sched.release(req, state=state)
        self._owed.pop(req.rid, None)
        self._req_handler(req).operator_start(
            event, rid=req.rid, n_tokens=len(req.tokens), **attrs)
        if req.session is not None:
            req.session.close()
            req.session = None
        req.prefix_kv = None
        self._retired.append(req.rid)
        while len(self._retired) > self.max_retained_requests:
            self.requests.pop(self._retired.popleft(), None)

    def abort(self, rid: int) -> bool:
        """Cancel a request at any lifecycle stage: drop it from the queue
        or release its slot (and, paged, its pool blocks), close its child
        session.  Idempotent; returns False for unknown/already-final
        requests.  This is the error-path cleanup ``run``/``stream``/
        ``generate`` invoke when a tick raises mid-drain."""
        req = self.requests.get(rid)
        if req is None or req.state in _TERMINAL:
            return False
        self._cancel(req, RequestState.ABORTED, "serve.request.abort")
        return True

    def abort_all(self) -> int:
        """Abort every queued, running, and backoff request; returns the
        count."""
        live = [r.rid for r in list(self.sched.waiting)
                + list(self.sched.running.values()) + list(self._backoff)]
        return sum(self.abort(rid) for rid in live)

    # ------------------------------------------------------ fault recovery
    def _enforce_deadlines(self, now: float) -> None:
        """Expire every live request whose ``SLOSpec.deadline_s`` has
        elapsed since submission: status ``timeout``, slot + blocks + owed
        reservation released, child session closed."""
        live = list(self.sched.waiting) + list(self.sched.running.values()) \
            + list(self._backoff)
        for req in live:
            deadline = getattr(req.slo, "deadline_s", None) \
                if req.slo is not None else None
            if deadline is None:
                continue
            elapsed = now - req.submit_time
            if elapsed > deadline:
                self.timeouts += 1
                self._cancel(req, RequestState.TIMEOUT,
                             "serve.request.timeout", deadline_s=deadline,
                             elapsed_s=elapsed)

    def _readmit_backoff(self, now: float) -> None:
        """Move blamed requests whose backoff expired back to the FRONT of
        the waiting queue (they already waited their turn once)."""
        for req in list(self._backoff):
            if req.retry_at <= now:
                self._backoff.remove(req)
                self.sched.waiting.appendleft(req)

    def _retry_requeue(self, req: Request, now: float) -> None:
        """Blamed but retryable: drop the slot and every cached byte of
        work (the fault makes its KV suspect — unlike preemption, nothing
        is parked) and hold the request in the backoff pen.  Committed
        tokens are kept: position-keyed sampling makes the recomputed
        continuation byte-identical, so a retry can change latency but
        never output."""
        self.request_retries += 1
        if req.state is RequestState.RUNNING:
            if self.paged:
                self.pool.free_slot(req.slot)
            if req in self._prefilling:
                self._prefilling.remove(req)
            self.sched.vacate(req)
        self._owed.pop(req.rid, None)
        req.progress = 0
        req.cached_tokens = 0
        req.prefill_len = None
        req.prefix_kv = None
        backoff = min(self.retry_backoff_s * (2 ** (req.retries - 1)),
                      self.retry_backoff_cap_s)
        req.retry_at = now + backoff
        self._backoff.append(req)
        self._req_handler(req).operator_start(
            "serve.request.retry", rid=req.rid, retries=req.retries,
            backoff_s=backoff, n_tokens=len(req.tokens))

    def _fail(self, req: Request, reason: str) -> None:
        """Retries exhausted (or unretryable): terminal ``failed``."""
        self.failed_requests += 1
        self._cancel(req, RequestState.FAILED, "serve.request.failed",
                     reason=reason, retries=req.retries)

    def _blame(self, blamed: list, kind: str, probes: int = 0,
               isolate: bool = False) -> None:
        """Fault attribution resolved: each blamed request retries (bounded,
        backed off) or fails; with ``isolate`` every innocent runner is
        parked losslessly first — exactly the preemption path, so resumed
        outputs stay byte-identical and zero bytes are copied."""
        self.fault_ticks += 1
        now = self.sync.now()
        blamed_rids = tuple(r.rid for r in blamed)
        retried, failed = [], []
        for req in blamed:
            req.retries += 1
            if req.retries > self.max_request_retries:
                self._fail(req, reason=kind)
                failed.append(req.rid)
            else:
                self._retry_requeue(req, now)
                retried.append(req.rid)
        isolated = []
        if isolate:
            for req in sorted(self.sched.running.values(),
                              key=lambda r: r.rid):
                isolated.append(req.rid)
                self._preempt(req, reason="fault")
            self.isolated_innocents += len(isolated)
        self.handler.operator_start(
            "serve.fault", tick=self.ticks, kind=kind, transient=False,
            blamed=blamed_rids, probes=probes, retried=tuple(retried),
            failed=tuple(failed), isolated=tuple(isolated))

    def _blame_nonfinite(self, active: dict, logits) -> list:
        """Row-attributable blame after a fused forward: inject armed NaN
        faults, then scan every active row for non-finite logits (injected
        or a genuine numeric blowup).  Blamed requests retry or fail on the
        spot; innocents keep the tick — no bisection, no tick abandonment.
        Returns ``(logits, blamed slots)`` — the caller drops blamed slots
        from the commit loop (logits may be a writable copy: np views of
        device arrays are read-only, and injection overwrites rows)."""
        if self.faults is not None:
            if not logits.flags.writeable:
                logits = logits.copy()
            self.faults.corrupt_logits(
                self.ticks,
                {req.rid: slot for slot, req in active.items()}, logits)
        bad = [slot for slot, req in active.items()
               if not np.isfinite(logits[slot]).all()]
        if bad:
            self._blame([active[s] for s in bad], kind="nan_logits",
                        isolate=False)
        return logits, bad

    def _bisect(self, cands: list) -> tuple:
        """Find the poisoned request(s) among ``cands`` by recursive
        halving against the plan's non-consuming :meth:`FaultPlan.probe`
        oracle — O(b log n) probes for b culprits instead of n replays."""
        bad: list = []
        probes = 0
        stack = [list(cands)]
        while stack:
            group = stack.pop()
            if not group:
                continue
            probes += 1
            if not self.faults.probe([r.rid for r in group]):
                continue
            if len(group) == 1:
                bad.append(group[0])
                continue
            mid = len(group) // 2
            stack.extend([group[mid:], group[:mid]])
        self.fault_probes += probes
        return sorted(bad, key=lambda r: r.rid), probes

    def _recover(self, exc: FaultInjected, out: dict) -> None:
        """An injected exception abandoned the tick.  Device state is safe
        to abandon: faults fire before the fused dispatch, and every KV
        write position derives from host-tracked lengths, so a resumed or
        retried dispatch overwrites the same positions identically.
        Attributable faults are blame-bisected (culprits retry or fail,
        innocents park losslessly); transient ones just retry the tick."""
        blamed: list = []
        probes = 0
        if exc.attributable:
            blamed, probes = self._bisect(
                sorted(self.sched.running.values(), key=lambda r: r.rid))
        if blamed:
            self._blame(blamed, exc.kind, probes=probes, isolate=True)
        else:
            self.fault_ticks += 1
            self.tick_retries += 1
            self.handler.operator_start(
                "serve.fault", tick=self.ticks, kind=exc.kind,
                transient=True, blamed=(), probes=probes, retried=(),
                failed=(), isolated=())

    def _update_degradation(self, tick_s: float) -> None:
        """Load-shedding ladder: on pool pressure (admission blocked with
        work queued) or a slow-tick streak (3x the rolling median, floored
        at ``slow_tick_s``), shed one level per pressured tick — spec
        decode off, prefill chunk halved, admissions rejected — and
        restore one level per 4 consecutive calm ticks."""
        self._tick_durs.append(tick_s)
        if not self.degrade_enabled:
            return
        slow = False
        if len(self._tick_durs) >= 5:
            med = float(np.median(self._tick_durs))
            slow = tick_s > max(self.slow_tick_s, 3.0 * med)
        self._slow_streak = self._slow_streak + 1 if slow else 0
        pooled = self._admission_blocked and bool(self.sched.waiting)
        pressure = pooled or self._slow_streak >= 2
        if pressure:
            self._calm_streak = 0
            if self.degrade_level < 3:
                self.degrade_level += 1
                self.handler.operator_start(
                    "serve.degrade", level=self.degrade_level,
                    direction="shed",
                    reason="pool_pressure" if pooled else "slow_ticks",
                    knob=_DEGRADE_KNOBS[self.degrade_level])
        else:
            self._calm_streak += 1
            if self.degrade_level > 0 and self._calm_streak >= 4:
                restored = self.degrade_level
                self.degrade_level -= 1
                self._calm_streak = 0
                self.handler.operator_start(
                    "serve.degrade", level=self.degrade_level,
                    direction="restore", reason="pressure_cleared",
                    knob=_DEGRADE_KNOBS[restored])
        if self.degrade_level:
            self.degraded_ticks += 1

    def health(self) -> dict:
        """Fault-tolerance counters for the engine's lifetime: every fault,
        retry, timeout, rejection, and degradation event is accounted for
        here (and mirrored in the ``serving`` tool's ``health`` section)."""
        return {
            "ticks": self.ticks,
            "fault_ticks": self.fault_ticks,
            "tick_retries": self.tick_retries,
            "request_retries": self.request_retries,
            "failed": self.failed_requests,
            "timeouts": self.timeouts,
            "rejections": self.rejections,
            "isolated_innocents": self.isolated_innocents,
            "probes": self.fault_probes,
            "host_preempt_signals": self.host_preempt_signals,
            "degrade_level": self.degrade_level,
            "degraded_ticks": self.degraded_ticks,
            "recovered_tokens": self.recovered_tokens,
            "recomputed_tokens": self.recomputed_tokens,
            "retry_backlog": len(self._backoff),
            "faults_fired": len(self.faults.fired) if self.faults else 0,
        }

    # ------------------------------------------------------------ high level
    def run(self, requests=()) -> dict:
        """Submit ``requests`` (prompts, or ``(prompt, SamplingParams)``
        pairs) and tick until all queued work drains.  Returns
        ``{rid: np.ndarray tokens}`` for the requests submitted here (or for
        everything drained, when called with no new requests).  Requests
        that end ``failed``/``timeout``/``rejected`` are simply absent from
        the result (their state lives in ``engine.requests[rid].state``).
        If a tick raises past the recovery layer, all live requests are
        aborted (slots, blocks and sessions released) before the error
        propagates."""
        rids = [self.submit(*self._split(r)) for r in requests]
        # tokens are snapshotted as requests retire — a drain larger than
        # max_retained_requests must not lose early results to pruning
        drained: dict = {}
        try:
            while self.has_work:
                for rid in self.step()["finished"]:
                    drained[rid] = np.asarray(self.requests[rid].tokens,
                                              np.int32)
        except Exception:
            self.abort_all()
            raise
        if rids:
            return {rid: drained[rid] for rid in rids if rid in drained}
        return drained

    def stream(self, requests=()):
        """Streaming iterator over ``(rid, token, done)`` triples, in the
        order tokens are produced across interleaved scheduler ticks."""
        for r in requests:
            self.submit(*self._split(r))
        try:
            while self.has_work:
                out = self.step()
                # a request can land 2 tokens in one tick (prefill + fused
                # decode); only its LAST token carries the done flag
                last = {rid: i
                        for i, (rid, _) in enumerate(out["new_tokens"])}
                done = set(out["finished"])
                for i, (rid, tok) in enumerate(out["new_tokens"]):
                    yield rid, tok, rid in done and last[rid] == i
        except Exception:
            self.abort_all()
            raise

    @staticmethod
    def _split(r):
        if isinstance(r, tuple) and len(r) == 2 \
                and isinstance(r[1], SamplingParams):
            return r
        return r, None

    # ------------------------------------------------------- deprecated shim
    def generate(self, prompts: np.ndarray, max_new_tokens: int = 16,
                 temperature: float = 0.0) -> np.ndarray:
        """Deprecated one-shot API: prompts (B, S) -> (B, max_new_tokens).

        Thin shim over ``submit``/``step`` keeping the legacy observability
        contract: the whole call runs inside ONE child session (per-call,
        not per-request), whose reports land in ``request_reports``."""
        warnings.warn(
            "ServeEngine.generate() is deprecated; use the request-"
            "lifecycle API — engine.submit(prompt, SamplingParams(...)) + "
            "engine.step()/run()/stream()",
            DeprecationWarning, stacklevel=2)
        prompts = np.asarray(prompts)
        if self._handler is not None:
            # legacy pinned-handler path: emit directly, no child session
            return self._generate_batch(prompts, max_new_tokens, temperature)
        parent = self.session or pasta.current_session()
        cid = next(self._call_ids)
        with parent.child(tools=self.request_tools or (),
                          name=f"{parent.name}/request{cid}") as call:
            prev = self._route_handler
            self._route_handler = call.handler
            try:
                out = self._generate_batch(prompts, max_new_tokens,
                                           temperature)
            finally:
                self._route_handler = prev
        if self.request_tools:
            self.request_reports.append(call.reports())
        call.close()       # drop the per-call pipeline (reports kept)
        return out

    def _generate_batch(self, prompts, max_new_tokens: int,
                        temperature: float) -> np.ndarray:
        prev = self._per_request_sessions
        self._per_request_sessions = False
        try:
            params = SamplingParams(max_new_tokens=max_new_tokens,
                                    temperature=temperature)
            rids = [self.submit(p, params) for p in prompts]
            done: dict = {}
            while self.has_work:
                for rid in self.step()["finished"]:
                    done[rid] = np.asarray(self.requests[rid].tokens,
                                           np.int32)
        except Exception:
            self.abort_all()
            raise
        finally:
            self._per_request_sessions = prev
        return np.stack([done[r] for r in rids])


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def _params_device(params) -> torch.device:
    return next(_leaves(params)).device
