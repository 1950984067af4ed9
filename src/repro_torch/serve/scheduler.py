"""Continuous-batching scheduler: policy-ordered admission over a fixed
slot set.

The scheduler owns request lifecycle bookkeeping and nothing device-side:
``waiting`` is an arrival-ordered queue, ``running`` maps KV-pool slot →
request, and admission (:meth:`Scheduler.admit`) moves requests into free
slots — the engine prefills them into those slots the same tick.  An
:class:`~repro_torch.serve.slo.SLOPolicy` may stable-sort the waiting queue
first (:meth:`Scheduler.reorder`); with no policy (or FCFS) admission is
pure arrival order, byte-identical to the policy-free scheduler.
Retirement (:meth:`Scheduler.release`) returns the slot to the allocator;
the pool bytes are reused in place by the next admission.  Preemption
(:meth:`Scheduler.preempt`) is the inverse of admission: the slot returns
to the allocator and the request rejoins the FRONT of the waiting queue
still carrying its generated tokens — the engine parks its KV blocks in
the prefix store so re-admission aliases them back.

Ragged prompt handling is right-padding: :func:`pad_group` pads a cold
admission group to a shared power-of-two bucket.  Causality makes the pad
exact — a right-pad token can only influence positions after it, all of
which are discarded — so a padded group prefill produces bit-identical
per-row K/V and logits to each request prefilling alone.
"""

from __future__ import annotations

import collections
import dataclasses
import enum
import time

import numpy as np

from .cache import bucket


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    """Per-request decode policy (immutable: safe to share across requests)."""

    max_new_tokens: int = 16
    temperature: float = 0.0
    stop_token: int | None = None
    #: per-request RNG seed for temperature>0 sampling; ``None`` derives a
    #: key from the engine seed and the request id, so sampled streams are
    #: independent of how requests happen to batch together
    seed: int | None = None


class RequestState(enum.Enum):
    QUEUED = "queued"
    RUNNING = "running"
    FINISHED = "finished"
    ABORTED = "aborted"
    #: terminal fault-tolerance outcomes: retries exhausted on a blamed
    #: request / SLO deadline elapsed / shed at admission (degrade level 3)
    FAILED = "failed"
    TIMEOUT = "timeout"
    REJECTED = "rejected"


@dataclasses.dataclass
class Request:
    """One served generation: prompt + params + lifecycle bookkeeping."""

    rid: int
    prompt: np.ndarray
    params: SamplingParams
    state: RequestState = RequestState.QUEUED
    slot: int | None = None
    tokens: list = dataclasses.field(default_factory=list)
    #: prompt tokens skipped at prefill via the prefix cache
    cached_tokens: int = 0
    #: prompt tokens already materialized in the KV cache (prefix aliases +
    #: chunks prefilled so far) — the chunked-prefill progress cursor
    progress: int = 0
    #: speculative-decode lifetime counters: draft tokens verified for this
    #: request / how many of them the target accepted
    drafted: int = 0
    accepted: int = 0
    submit_time: float = 0.0
    admit_time: float = 0.0
    first_token_time: float = 0.0
    finish_time: float = 0.0
    #: per-request child pasta.Session spanning the whole lifetime
    session: object = None
    #: transient: prefix-cache entry chosen at admission
    prefix_kv: dict | None = None
    #: service-level objectives + tenant/priority tags (None = untagged)
    slo: object = None
    #: times this request was preempted (evicted-and-requeued)
    preemptions: int = 0
    #: times this request was blamed for a fault and requeued for a full
    #: recompute; the engine fails it past ``max_request_retries``
    retries: int = 0
    #: earliest re-admission time while serving a retry backoff
    retry_at: float = 0.0
    #: context length the CURRENT admission must prefill to before the
    #: request can decode — ``prompt_len`` on a fresh admission, and
    #: ``prompt_len + len(tokens)`` when resuming after preemption (the
    #: generated prefix must be back in the cache first).  None = fresh.
    prefill_len: int | None = None

    @property
    def prompt_len(self) -> int:
        return int(self.prompt.shape[0])

    @property
    def context(self) -> np.ndarray:
        """Prompt plus every committed token — what a resumed prefill must
        (re)materialize in the KV cache.  Equals ``prompt`` before the
        first token."""
        if not self.tokens:
            return self.prompt
        return np.concatenate([self.prompt,
                               np.asarray(self.tokens, np.int32)])

    @property
    def context_len(self) -> int:
        return self.prompt_len + len(self.tokens)

    @property
    def tenant(self) -> str:
        return self.slo.tenant if self.slo is not None else "default"

    @property
    def prefilled(self) -> bool:
        """The admission's whole context is in the cache — the request
        decodes from here."""
        target = self.prompt_len if self.prefill_len is None \
            else self.prefill_len
        return self.progress >= target

    @property
    def done(self) -> bool:
        if len(self.tokens) >= self.params.max_new_tokens:
            return True
        stop = self.params.stop_token
        return stop is not None and len(self.tokens) > 0 \
            and self.tokens[-1] == stop


class Scheduler:
    """Continuous batching: admit into free slots (policy-ordered, FCFS by
    default), release on retire, preempt back to the queue head."""

    def __init__(self, max_slots: int, policy=None):
        self.max_slots = max_slots
        self.policy = policy                    # SLOPolicy | None
        self.waiting: collections.deque = collections.deque()
        self.running: dict = {}                 # slot -> Request
        self._free = list(range(max_slots - 1, -1, -1))   # pop() -> ascending

    # -------------------------------------------------------------- queries
    @property
    def n_free(self) -> int:
        return len(self._free)

    @property
    def n_active(self) -> int:
        return len(self.running)

    @property
    def n_queued(self) -> int:
        return len(self.waiting)

    @property
    def has_work(self) -> bool:
        return bool(self.waiting or self.running)

    # ------------------------------------------------------------ lifecycle
    def submit(self, req: Request) -> None:
        req.submit_time = req.submit_time or time.perf_counter()
        self.waiting.append(req)

    def reorder(self, now: float | None = None) -> None:
        """Stable-sort the waiting queue by the policy's key.  Ties keep
        arrival order; FCFS (``orders=False``) and no-policy skip the sort
        entirely, so the default path stays byte-identical."""
        if self.policy is None or not getattr(self.policy, "orders", False) \
                or len(self.waiting) < 2:
            return
        now = time.perf_counter() if now is None else now
        key = self.policy.key
        self.waiting = collections.deque(
            sorted(self.waiting, key=lambda r: key(r, now)))

    def admit(self, fits=None) -> list:
        """Move waiting requests into free slots in queue order (arrival
        order unless :meth:`reorder` ran first); returns the admitted
        requests with ``slot``/``state``/``admit_time`` assigned.  ``fits``
        (req -> bool) gates admission on resources beyond slots (the paged
        engine passes a block-availability check); queue order is
        preserved — a head-of-line request that does not fit blocks the
        queue rather than being overtaken."""
        out = []
        now = time.perf_counter()
        while self.waiting and self._free:
            if fits is not None and not fits(self.waiting[0]):
                break
            req = self.waiting.popleft()
            req.slot = self._free.pop()
            req.state = RequestState.RUNNING
            req.admit_time = now
            self.running[req.slot] = req
            out.append(req)
        return out

    def release(self, req: Request, state=RequestState.FINISHED) -> None:
        """Retire: free the request's slot (pool bytes reused in place)."""
        if req.slot is None or self.running.get(req.slot) is not req:
            raise ValueError(f"request {req.rid} does not hold a slot")
        del self.running[req.slot]
        self._free.append(req.slot)
        self._free.sort(reverse=True)           # deterministic ascending pops
        req.slot = None
        req.state = state
        req.finish_time = time.perf_counter()

    def vacate(self, req: Request) -> None:
        """Take the slot back WITHOUT enqueueing the request anywhere:
        state returns to QUEUED and the caller decides where it waits (the
        engine's retry-backoff pen uses this so a blamed request cannot
        head-of-line block the real queue while backing off)."""
        if req.slot is None or self.running.get(req.slot) is not req:
            raise ValueError(f"request {req.rid} does not hold a slot")
        del self.running[req.slot]
        self._free.append(req.slot)
        self._free.sort(reverse=True)           # deterministic ascending pops
        req.slot = None
        req.state = RequestState.QUEUED

    def preempt(self, req: Request) -> None:
        """Evict-and-requeue: return the slot to the allocator and put the
        request back at the FRONT of the waiting queue, still carrying its
        generated tokens (state QUEUED — it competes for re-admission like
        any arrival, but a policy reorder sees its original submit time /
        priority).  The engine parks its KV first; see
        ``ServeEngine.preempt``."""
        self.vacate(req)
        req.preemptions += 1
        self.waiting.appendleft(req)

    def remove_waiting(self, req: Request,
                       state=RequestState.ABORTED) -> bool:
        """Drop a still-queued request (abort/timeout path); False if not
        queued."""
        try:
            self.waiting.remove(req)
        except ValueError:
            return False
        req.state = state
        return True


def pad_group(prompts: list, pow2: bool = True, max_len: int | None = None):
    """Right-pad ragged prompts to a shared length.

    Returns ``(tokens (G, S) int32, lens (G,) int32)`` with ``S`` the
    power-of-two bucket of the longest prompt (``pow2=False``: exact max) —
    bucketing bounds distinct prefill compile shapes to O(log max_seq).
    ``max_len`` caps the bucket at the KV pool's sequence bound: a non-pow2
    ``max_seq`` must not compile a wider prefill than the pool can hold
    (positions past ``max_seq`` would be computed only to be cropped at the
    slot write) — the same cap the suffix-prefill path applies.
    """
    lens = np.asarray([len(p) for p in prompts], np.int32)
    s = int(lens.max())
    if pow2:
        s = bucket(s)
    if max_len is not None:
        if int(lens.max()) > max_len:
            raise ValueError(
                f"prompt of length {int(lens.max())} exceeds the pool bound "
                f"max_len={max_len}")
        s = min(s, max_len)
    toks = np.zeros((len(prompts), s), np.int32)
    for i, p in enumerate(prompts):
        toks[i, :len(p)] = p
    return toks, lens
