"""The port's serving engine at temperature > 0, held to the reference's
own invariants on its own side (the port's sampler cannot reproduce
``jax.random``'s draws; it is keyed by the same ``(seed-or-(engine seed,
rid), position)`` tuple): schedule invariance, lossless preemption,
fault recovery byte-identical to the undisturbed run, and speculative
decoding byte-identical to plain decode.  Also the recovery layer's
accounting (blame, retry, bisection, deadlines, the degradation ladder)
and the sampler itself.  One world-1 case against the reference's engine
itself: a draft model other than the target, at temperature 0.
"""

import dataclasses

import jax
import numpy as np
import pytest

import repro.configs as RC
from repro.models import init_params as jinit_params
from repro.serve import SamplingParams as JSamplingParams
from repro.serve import ServeEngine as JServeEngine
import repro_torch.configs as TC
import repro_torch.core as tpasta
from repro_torch.convert import params_from_numpy
from repro_torch.core import events as tevents
from repro_torch.core import session as tsession
from repro_torch.models import init_params
from repro_torch.serve import (FaultPlan, FaultSpec, RequestState,
                               SamplingParams, ServeEngine, SLOSpec)
from repro_torch.serve.scheduler import Request
from repro_torch.train.optimizer import tree_map

TEMP = 0.8


@pytest.fixture(autouse=True)
def _port_state():
    tevents.reset_seq()
    tsession.reset_state()
    yield
    tsession.reset_state()


@pytest.fixture(scope="module")
def gpt2():
    cfg = TC.reduced(TC.get("paper-gpt2"))
    return cfg, init_params(cfg, 0, "cpu")


def _prompts(vocab, lens, seed=0, shared=0):
    rng = np.random.default_rng(seed)
    pre = rng.integers(0, vocab, (shared,), dtype=np.int32)
    return [np.concatenate([pre, rng.integers(0, vocab, (n,),
                                              dtype=np.int32)])
            for n in lens]


def _run(cfg, params, prompts, max_new=8, temperature=TEMP, slos=None,
         **kw):
    """Half the trace, one tick, the rest; returns (engine, {rid: tokens})
    for the requests that finished."""
    sp = SamplingParams(max_new_tokens=max_new, temperature=temperature)
    eng = ServeEngine(cfg, params, **kw)
    slos = slos or [None] * len(prompts)
    half = len(prompts) // 2
    for p, slo in zip(prompts[:half], slos[:half]):
        eng.submit(p, sp, slo=slo)
    eng.step()
    for p, slo in zip(prompts[half:], slos[half:]):
        eng.submit(p, sp, slo=slo)
    out = {}
    while eng.has_work:
        for rid in eng.step()["finished"]:
            out[rid] = list(eng.requests[rid].tokens)
    return eng, out


def test_sampler_draws_from_the_softmax():
    """Gumbel-max over the keyed generator: empirical frequencies over
    4000 positions within 0.03 of softmax(logits / T)."""
    cfg = TC.reduced(TC.get("paper-gpt2"))
    eng = ServeEngine(cfg, init_params(cfg, 0, "cpu"), max_seq=16,
                      max_slots=1)
    logits = np.asarray([2.0, 1.0, 0.5, -1.0], np.float32)
    req = Request(rid=0, prompt=np.zeros(2, np.int32),
                  params=SamplingParams(temperature=TEMP))
    draws = [eng._sample_one(req, logits, position=i) for i in range(4000)]
    freq = np.bincount(draws, minlength=4) / len(draws)
    p = np.exp(logits / TEMP)
    np.testing.assert_allclose(freq, p / p.sum(), atol=0.03)
    # keyed, not stateful: the same position draws the same token
    assert [eng._sample_one(req, logits, position=i) for i in range(50)] \
        == draws[:50]


def test_request_seed_keys_the_stream_whatever_the_rid(gpt2):
    cfg, params = gpt2
    (p,) = _prompts(cfg.vocab_size, (9,), seed=1)
    eng = ServeEngine(cfg, params, max_seq=32, max_slots=2)
    sp = SamplingParams(max_new_tokens=10, temperature=TEMP, seed=7)
    a, b = eng.run([(p, sp), (p, sp)]).values()
    np.testing.assert_array_equal(a, b)
    c, d = eng.run([(p, SamplingParams(max_new_tokens=10,
                                       temperature=TEMP)),
                    (p, SamplingParams(max_new_tokens=10,
                                       temperature=TEMP))]).values()
    assert list(c) != list(d)          # keyed by rid when unseeded


@pytest.mark.parametrize("arch", ["paper-gpt2", "zamba2-7b"])
def test_schedule_invariance_at_temperature(arch):
    cfg = TC.reduced(TC.get(arch))
    params = init_params(cfg, 0, "cpu")
    prompts = _prompts(cfg.vocab_size, (9, 17, 5, 12, 23, 7),
                       shared=16 if arch == "paper-gpt2" else 0)
    _, narrow = _run(cfg, params, prompts, max_seq=96, max_slots=2)
    _, wide = _run(cfg, params, prompts, max_seq=96, max_slots=4)
    assert narrow == wide and len(wide) == len(prompts)
    if arch == "paper-gpt2":
        _, spec = _run(cfg, params, prompts, max_seq=96, max_slots=4,
                       spec_decode=3)
        assert spec == wide


def test_priority_preemption_is_byte_identical(gpt2):
    """Two low-priority requests fill both slots; a high-priority one
    arrives and preempts; every request's output equals the FCFS run's
    (parked KV aliased back, the keyed sampler resumes at the next
    position), with zero bytes copied."""
    cfg, params = gpt2
    prompts = _prompts(cfg.vocab_size, (19, 26, 9, 14), shared=16, seed=4)
    slos = [SLOSpec(priority=0), SLOSpec(priority=0), SLOSpec(priority=5),
            SLOSpec(priority=5)]
    _, base = _run(cfg, params, prompts, max_new=12, max_seq=64,
                   max_slots=2, prefix_block=8, slos=slos)
    with tpasta.Session(tools="serving", torch_device="cpu") as sess:
        eng, out = _run(cfg, params, prompts, max_new=12, max_seq=64,
                        max_slots=2, prefix_block=8, slos=slos,
                        policy="priority", session=sess)
        rep = sess.reports()["serving"].data
    assert eng.preemptions > 0 and eng.recovered_blocks > 0
    assert out == base
    assert rep["preemption"]["count"] == eng.preemptions
    assert eng.pool_stats()["duplicate_copy_bytes"] == 0


def _pool_whole(eng):
    eng.pool.scrub()
    st = eng.pool.stats()
    assert st["blocks_live"] + st["blocks_evictable"] + st["blocks_free"] \
        == st["n_blocks"]


def test_one_poison_preset_isolates_innocents_byte_identically(gpt2):
    cfg, params = gpt2
    prompts = _prompts(cfg.vocab_size, (19, 33, 25, 40, 22, 28),
                       shared=16, seed=5)
    _, base = _run(cfg, params, prompts, max_seq=96, max_slots=4)
    plan = FaultPlan.preset("one-poison", seed=0)
    poisoned = plan.specs[0].rid
    with tpasta.Session(tools="serving", torch_device="cpu") as sess:
        eng, out = _run(cfg, params, prompts, max_seq=96, max_slots=4,
                        faults=plan, retry_backoff_s=0.0, session=sess)
        rep = sess.reports()["serving"].data
    assert eng.requests[poisoned].state is RequestState.FAILED
    assert poisoned not in out
    assert out == {rid: t for rid, t in base.items() if rid != poisoned}
    h = eng.health()
    assert h["failed"] == 1 and h["request_retries"] == 2
    assert h["probes"] > 0 and h["isolated_innocents"] > 0
    assert rep["health"]["failed"] == 1
    assert rep["health"]["isolated_innocents"] == h["isolated_innocents"]
    assert rep["pool"]["duplicate_copy_bytes"] == 0
    _pool_whole(eng)


def test_nan_logits_blame_only_their_request(gpt2):
    cfg, params = gpt2
    prompts = _prompts(cfg.vocab_size, (9, 14, 11, 7), seed=6)
    _, base = _run(cfg, params, prompts, max_new=6, max_seq=64, max_slots=4)
    eng, out = _run(cfg, params, prompts, max_new=6, max_seq=64,
                    max_slots=4, retry_backoff_s=0.0,
                    faults=FaultPlan([FaultSpec(kind="nan_logits", rid=2,
                                                ttl=1)]))
    assert out == base
    h = eng.health()
    assert h["request_retries"] == 1 and h["failed"] == 0
    assert h["isolated_innocents"] == 0 and h["probes"] == 0
    _pool_whole(eng)


def test_transient_tick_error_and_host_preemption_lose_nothing(gpt2):
    cfg, params = gpt2
    prompts = _prompts(cfg.vocab_size, (9, 14, 11), seed=7, shared=16)
    _, base = _run(cfg, params, prompts, max_new=6, max_seq=64, max_slots=2,
                   prefix_block=8)
    eng, out = _run(cfg, params, prompts, max_new=6, max_seq=64,
                    max_slots=2, prefix_block=8,
                    faults=FaultPlan([FaultSpec(kind="tick_error", tick=3),
                                      FaultSpec(kind="preempt", tick=4)]))
    assert out == base
    h = eng.health()
    assert h["tick_retries"] == 1 and h["request_retries"] == 0
    assert h["host_preempt_signals"] == 1 and h["failed"] == 0
    _pool_whole(eng)


def test_deadline_is_a_hard_timeout(gpt2):
    cfg, params = gpt2
    prompts = _prompts(cfg.vocab_size, (9, 12), seed=8)
    eng = ServeEngine(cfg, params, max_seq=64, max_slots=1)
    sp = SamplingParams(max_new_tokens=40)
    fast = eng.submit(prompts[0], sp)
    slow = eng.submit(prompts[1], sp, slo=SLOSpec(deadline_s=0.0))
    while eng.has_work:
        eng.step()
    assert eng.requests[fast].state is RequestState.FINISHED
    assert eng.requests[slow].state is RequestState.TIMEOUT
    assert eng.health()["timeouts"] == 1
    assert eng.sched.n_free == 1


def test_degradation_ladder_sheds_and_restores(gpt2):
    """Sustained injected pool pressure sheds levels one per pressured
    tick up to rejecting admissions, then restores as it clears."""
    cfg, params = gpt2
    prompts = _prompts(cfg.vocab_size, (8,) * 6, seed=9)
    plan = FaultPlan([FaultSpec(kind="pressure", tick=1, duration=6,
                                blocks=10 ** 6)])
    with tpasta.Session(tools="serving", torch_device="cpu") as sess:
        eng = ServeEngine(cfg, params, max_seq=32, max_slots=2,
                          faults=plan, session=sess)
        rids = [eng.submit(p, SamplingParams(max_new_tokens=4))
                for p in prompts[:2]]
        for _ in range(4):
            eng.step()
        assert eng.degrade_level == 3
        late = eng.submit(prompts[2], SamplingParams(max_new_tokens=4))
        assert eng.requests[late].state is RequestState.REJECTED
        for _ in range(40):
            eng.step()
        rep = sess.reports()["serving"].data
    assert all(eng.requests[r].state is RequestState.FINISHED for r in rids)
    assert eng.degrade_level == 0
    d = rep["health"]["degrade"]
    assert d["shed_events"] == 3 and d["restore_events"] == 3
    assert rep["health"]["rejections"] == 1


@pytest.mark.parametrize("draft,paged", [("ngram", True), ("model", True),
                                         ("ngram", False)])
def test_spec_decode_byte_identical_to_plain_decode(gpt2, draft, paged):
    """``spec_decode=2`` (n-gram self-draft, or the target as its own draft
    model) commits exactly the plain decode's tokens at temperature."""
    cfg, params = gpt2
    prompts = _prompts(cfg.vocab_size, (9, 17, 5, 12, 23, 7), shared=24)
    kw = dict(max_seq=96, max_slots=4, paged=paged, prefix_block=8)
    _, base = _run(cfg, params, prompts, max_new=10, **kw)
    eng, spec = _run(cfg, params, prompts, max_new=10, spec_decode=2,
                     draft=draft, **kw)
    assert spec == base
    assert eng.drafted_tokens > 0
    if paged:
        _pool_whole(eng)
        assert eng.pool.n_used == eng.pool.stats()["store_blocks"]


def test_self_draft_accepts_nearly_all_at_temperature_zero(gpt2):
    """The target as its own draft model: greedy drafts match greedy
    decode, so (almost) every draft is accepted and decode dispatches
    fall by half or more."""
    cfg, params = gpt2
    prompts = _prompts(cfg.vocab_size, (9, 17, 5, 12), shared=16)
    kw = dict(max_seq=64, max_slots=4, temperature=0.0)
    base_eng, base = _run(cfg, params, prompts, max_new=16, **kw)
    eng, out = _run(cfg, params, prompts, max_new=16, spec_decode=4,
                    draft="model", **kw)
    assert out == base
    assert eng.accepted_tokens / eng.drafted_tokens > 0.8
    assert eng.decode_steps <= base_eng.decode_steps // 2


def test_one_layer_draft_counts_equal_the_reference_engine(monkeypatch):
    """The target's first layer as the draft model (reduced glm4-9b with
    2 KV heads, the reference's weights): on the staggered trace (one
    request every other tick, a 16-token shared prefix) the port drafts,
    accepts and ticks as the reference's engine does, with its greedy
    tokens."""
    monkeypatch.setenv("REPRO_PALLAS_INTERPRET", "0")   # reference: jnp path
    jcfg = dataclasses.replace(RC.reduced(RC.get("glm4-9b")), n_kv_heads=2)
    tcfg = dataclasses.replace(TC.reduced(TC.get("glm4-9b")), n_kv_heads=2)
    jparams = jinit_params(jax.random.PRNGKey(0), jcfg)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    prompts = _prompts(jcfg.vocab_size, (5, 17, 9, 30, 12, 3, 21),
                       shared=16)
    runs = []
    for engine, sp, cfg, params, cut in (
            (JServeEngine, JSamplingParams, jcfg, jparams, jax.tree.map),
            (ServeEngine, SamplingParams, tcfg, tparams, tree_map)):
        draft = dict(params, layers=cut(lambda x: x[:1], params["layers"]))
        eng = engine(cfg, params, max_seq=64, max_slots=4, prefix_block=8,
                     prefill_chunk=16, spec_decode=2, draft="model",
                     draft_cfg=dataclasses.replace(cfg, n_layers=1),
                     draft_params=draft)
        out, rids, pending, tick = {}, {}, list(enumerate(prompts)), 0
        while pending or eng.has_work:
            if pending and tick % 2 == 0:
                i, p = pending.pop(0)
                rids[eng.submit(p, sp(max_new_tokens=8))] = i
            if eng.has_work:
                for rid in eng.step()["finished"]:
                    out[rids[rid]] = [int(t) for t in eng.requests[rid].tokens]
            tick += 1
        runs.append((eng.drafted_tokens, eng.accepted_tokens, eng.ticks, out))
    assert runs[1] == runs[0]
    assert runs[1][:3] == (90, 4, 19)


def test_spec_decode_refuses_stateful_families_and_bad_drafts(gpt2):
    cfg, params = gpt2
    zcfg = TC.reduced(TC.get("zamba2-7b"))
    with pytest.raises(NotImplementedError, match="hybrid"):
        ServeEngine(zcfg, init_params(zcfg, 0, "cpu"), max_seq=32,
                    spec_decode=2)
    with pytest.raises(ValueError, match="draft source"):
        ServeEngine(cfg, params, max_seq=32, spec_decode=2,
                    draft="telepathy")
    with pytest.raises(ValueError, match="paged"):
        ServeEngine(zcfg, init_params(zcfg, 0, "cpu"), max_seq=32,
                    paged=True)
    with pytest.raises(ValueError, match="paged"):
        ServeEngine(cfg, params, max_seq=32, paged=False, faults="storm")
