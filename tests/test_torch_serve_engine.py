"""The port's ``ServeEngine`` against the JAX package's, on the CPU, at
temperature 0, and against its own guarantees.

Against the reference (same weights, moved through numpy): the same
staggered ragged trace gives the same tokens on paper-gpt2 (paged pool,
shared prefix, chunked prefill) and on mamba2-2.7b, zamba2-7b and
dbrx-132b (slot pool, exact-length prefills); the ``serving`` report's
counts are equal on a trace submitted at once; the stop token ends both
engines at its first occurrence.  The reference's runs are shared in
module-scoped fixtures (each JAX engine compiles per shape).

On the port itself, as the reference's tests hold its engine: batched
equals solo, a prefix hit equals a cold prefill, the legacy dense pool
matches the paged one (and only it copies bytes), abort releases the slot,
its blocks and its session, warm-up leaves the pool as it was, and the
model calls stay silent under an instrumented session.
"""

import warnings

import jax
import numpy as np
import pytest
import torch

import repro.configs as RC
import repro.core as jpasta
from repro.models import init_params as jinit_params
from repro.serve import SamplingParams as JSamplingParams
from repro.serve import ServeEngine as JServeEngine
import repro_torch.configs as TC
import repro_torch.core as tpasta
from repro_torch.convert import params_from_numpy
from repro_torch.core import events as tevents
from repro_torch.core import session as tsession
from repro_torch.serve import RequestState, SamplingParams, ServeEngine

#: family -> engine options of its trace (paper-gpt2: the paged pool with a
#: shared prefix and chunked prefill; the others: the slot pool)
TRACES = {"paper-gpt2": dict(prefix_block=8, prefill_chunk=16, shared=16),
          "mamba2-2.7b": dict(shared=0), "zamba2-7b": dict(shared=0),
          "dbrx-132b": dict(shared=0)}
LENS = (5, 17, 9, 30, 12, 3, 21)
MAX_NEW = 8


@pytest.fixture(autouse=True)
def _port_state(monkeypatch):
    monkeypatch.setenv("REPRO_PALLAS_INTERPRET", "0")   # reference: jnp path
    tevents.reset_seq()
    tsession.reset_state()
    yield
    tsession.reset_state()


def _prompts(vocab, lens, seed=0, shared=0):
    rng = np.random.default_rng(seed)
    pre = rng.integers(0, vocab, (shared,), dtype=np.int32)
    return [np.concatenate([pre, rng.integers(0, vocab, (n,),
                                              dtype=np.int32)])
            for n in lens]


def _staggered(engine_cls, sp_cls, cfg, params, prompts, max_new=MAX_NEW,
               temperature=0.0, **kw):
    """Submit one request every other tick; returns (engine, {i: tokens})
    keyed by the prompt's index."""
    eng = engine_cls(cfg, params, **{"max_seq": 64, "max_slots": 4, **kw})
    out, rids = {}, {}
    pending = list(enumerate(prompts))
    tick = 0
    while pending or eng.has_work:
        if pending and tick % 2 == 0:
            i, p = pending.pop(0)
            rids[eng.submit(p, sp_cls(max_new_tokens=max_new,
                                      temperature=temperature))] = i
        if eng.has_work:
            for rid in eng.step()["finished"]:
                out[rids[rid]] = list(eng.requests[rid].tokens)
        tick += 1
    return eng, out


def _models(arch):
    jcfg, tcfg = RC.reduced(RC.get(arch)), TC.reduced(TC.get(arch))
    jparams = jinit_params(jax.random.PRNGKey(0), jcfg)
    return jcfg, tcfg, jparams, params_from_numpy(
        jax.tree.map(np.asarray, jparams), "cpu")


@pytest.fixture(scope="module")
def reference_runs():
    """Each family's staggered trace through the reference engine."""
    out = {}
    for arch, opts in TRACES.items():
        opts = dict(opts)
        shared = opts.pop("shared")
        jcfg, tcfg, jparams, tparams = _models(arch)
        prompts = _prompts(jcfg.vocab_size, LENS, shared=shared)
        _, tokens = _staggered(JServeEngine, JSamplingParams, jcfg, jparams,
                               prompts, **opts)
        out[arch] = (tcfg, tparams, prompts, opts, tokens)
    return out


@pytest.mark.parametrize("arch", list(TRACES))
def test_greedy_tokens_match_reference(reference_runs, arch):
    tcfg, tparams, prompts, opts, want = reference_runs[arch]
    eng, got = _staggered(ServeEngine, SamplingParams, tcfg, tparams,
                          prompts, **opts)
    assert got == want
    assert len(got) == len(LENS)
    assert all(len(t) == MAX_NEW for t in got.values())
    assert eng.paged == (arch == "paper-gpt2")
    assert eng.device == torch.device("cpu")
    if eng.paged:
        assert eng.pool_stats()["duplicate_copy_bytes"] == 0
        assert eng.prefix_cache.stats()["hits"] > 0
        # after the drain only the prefix store holds blocks
        assert eng.pool.n_used == eng.pool.stats()["store_blocks"]


def _timeless(report: dict) -> dict:
    """The serving report without wall-clock values: counts, occupancy
    timeline phases and sizes, prefix hits, pool blocks."""
    drop = {"tok_per_s", "ttft_s", "tpot_s", "queue_s", "max_stall_s",
            "draft_overhead_s", "goodput_tok_per_s", "timeline",
            "by_request"}

    def clean(d):
        if isinstance(d, dict):
            return {k: ([tuple(e[1:]) for e in v] if k == "series"
                        else clean(v))
                    for k, v in d.items() if k not in drop}
        return d
    out = clean(report)
    out["timeline"] = [tuple(e[1:]) for e in report.get("timeline", [])]
    return out


@pytest.fixture(scope="module")
def rate0_reports():
    """paper-gpt2, 6 shared-prefix requests submitted at once on 3 slots,
    under a session with the serving tool: the reference's report."""
    jcfg, tcfg, jparams, tparams = _models("paper-gpt2")
    prompts = _prompts(jcfg.vocab_size, (3, 9, 5, 14, 7, 11), shared=16)
    with jpasta.Session(tools="serving", name="fleet") as sess:
        eng = JServeEngine(jcfg, jparams, max_seq=48, max_slots=3,
                           session=sess, prefix_block=8,
                           request_tools="serving")
        want = eng.run([(p, JSamplingParams(max_new_tokens=6))
                        for p in prompts])
        report = sess.reports()["serving"].data
    return tcfg, tparams, prompts, want, report


def test_serving_report_counts_match_reference(rate0_reports):
    tcfg, tparams, prompts, want, ref_report = rate0_reports
    with tpasta.Session(tools="serving", name="fleet",
                        torch_device="cpu") as sess:
        eng = ServeEngine(tcfg, tparams, max_seq=48, max_slots=3,
                          session=sess, prefix_block=8,
                          request_tools="serving")
        got = eng.run([(p, SamplingParams(max_new_tokens=6))
                       for p in prompts])
        report = sess.reports()["serving"].data
    assert {k: list(v) for k, v in got.items()} == \
        {k: list(v) for k, v in want.items()}
    assert _timeless(report) == _timeless(ref_report)
    assert report["occupancy"]["mean"] > 1
    assert report["prefix_cache"]["hit_rate"] > 0
    assert len(eng.request_reports) == len(prompts)


def test_stop_token_ends_both_engines_at_its_first_occurrence():
    """The stop token is picked from the solo run's tokens and ends a
    request at its FIRST occurrence, which may come before the index it
    was picked from (the reference's own test assumes it does not)."""
    jcfg, tcfg, jparams, tparams = _models("paper-gpt2")
    (prompt,) = _prompts(jcfg.vocab_size, (9,))
    solo = list(ServeEngine(tcfg, tparams, max_seq=32, max_slots=1).run(
        [(prompt, SamplingParams(max_new_tokens=8))]).values())[0]
    stop = int(solo[2])
    first = list(solo).index(stop)
    want = solo[:first + 1]
    got = list(ServeEngine(tcfg, tparams, max_seq=32, max_slots=1).run(
        [(prompt, SamplingParams(max_new_tokens=8, stop_token=stop))])
        .values())[0]
    ref = list(JServeEngine(jcfg, jparams, max_seq=32, max_slots=1).run(
        [(prompt, JSamplingParams(max_new_tokens=8, stop_token=stop))])
        .values())[0]
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(ref, want)


def _solo(cfg, params, prompt, max_new, **kw):
    eng = ServeEngine(cfg, params, **kw)
    return list(eng.run([(prompt, SamplingParams(max_new_tokens=max_new))])
                .values())[0]


@pytest.mark.parametrize("arch", ["paper-gpt2", "zamba2-7b"])
def test_batched_equals_solo(arch):
    _, tcfg, _, tparams = _models(arch)
    prompts = _prompts(tcfg.vocab_size, (6, 13, 4, 9, 11), seed=2)
    _, batched = _staggered(ServeEngine, SamplingParams, tcfg, tparams,
                            prompts, max_slots=3)
    for i, p in enumerate(prompts):
        np.testing.assert_array_equal(
            batched[i], _solo(tcfg, tparams, p, MAX_NEW, max_seq=64,
                              max_slots=3), err_msg=f"request {i}")


@pytest.mark.parametrize("paged", [True, False])
def test_prefix_hit_equals_cold_prefill(paged):
    _, tcfg, _, tparams = _models("paper-gpt2")
    a, b = _prompts(tcfg.vocab_size, (7, 12), seed=3, shared=24)
    eng = ServeEngine(tcfg, tparams, max_seq=64, max_slots=2,
                      prefix_block=8, paged=paged)
    eng.run([(a, SamplingParams(max_new_tokens=6))])
    hit = list(eng.run([(b, SamplingParams(max_new_tokens=6))])
               .values())[0]
    assert eng.prefix_cache.stats()["hits"] == 1
    assert eng.prefix_cache.stats()["reused_tokens"] == 24
    cold = _solo(tcfg, tparams, b, 6, max_seq=64, max_slots=2,
                 prefix_cache=False, paged=paged)
    np.testing.assert_array_equal(hit, cold)
    copied = eng.pool_stats()["duplicate_copy_bytes"]
    if paged:
        assert copied == 0
    else:
        # the legacy publish copies each new prompt's K/V, as tensors
        n_kv = 2 * tcfg.n_layers * tcfg.n_kv_heads * tcfg.head_dim * 4
        assert copied == n_kv * (len(a) + len(b))


def test_legacy_dense_pool_matches_paged(reference_runs):
    tcfg, tparams, prompts, opts, want = reference_runs["paper-gpt2"]
    opts = {k: v for k, v in opts.items() if k != "prefill_chunk"}
    _, dense = _staggered(ServeEngine, SamplingParams, tcfg, tparams,
                          prompts, paged=False, **opts)
    _, paged = _staggered(ServeEngine, SamplingParams, tcfg, tparams,
                          prompts, **opts)
    assert dense == paged == want


def test_abort_releases_slot_blocks_and_session():
    _, tcfg, _, tparams = _models("paper-gpt2")
    prompts = _prompts(tcfg.vocab_size, (8, 8, 8), seed=5)
    sp = SamplingParams(max_new_tokens=20)
    with tpasta.Session(name="fleet", torch_device="cpu") as sess:
        eng = ServeEngine(tcfg, tparams, max_seq=48, max_slots=2,
                          prefix_block=8, session=sess)
        rids = [eng.submit(p, sp) for p in prompts]
        eng.step()                               # 0, 1 running; 2 queued
        assert eng.abort(rids[2])
        assert eng.requests[rids[2]].state is RequestState.ABORTED
        victim = eng.requests[rids[1]]
        assert eng.abort(rids[1])
        assert victim.state is RequestState.ABORTED and victim.slot is None
        assert victim.session is None and eng.sched.n_free == 1
        assert not eng.abort(rids[1])            # idempotent
        while eng.has_work:
            eng.step()
    want = _solo(tcfg, tparams, prompts[0], 20, max_seq=48, max_slots=2)
    np.testing.assert_array_equal(eng.requests[rids[0]].tokens, want)
    assert eng.pool.n_used == eng.pool.stats()["store_blocks"]
    assert sess.children == []


def test_warmup_leaves_the_paged_pool_unchanged():
    _, tcfg, _, tparams = _models("paper-gpt2")
    eng = ServeEngine(tcfg, tparams, max_seq=40, max_slots=2,
                      prefix_block=8, spec_decode=2)
    eng.pool.pk.normal_()
    before = eng.pool.pk.clone(), eng.pool.pv.clone()
    wu = eng.warmup(prompt_lens=[5, 12, 30])
    assert [w[0] for w in wu["warmed"]] == \
        ["decode"] + ["prefill_cold", "prefill_suffix"] * 3
    assert torch.equal(eng.pool.pk, before[0])
    assert torch.equal(eng.pool.pv, before[1])


def test_model_calls_are_silent_under_an_instrumented_session():
    """Operator hooks stay silent inside the engine's model calls, as
    inside the reference's jitted dispatches: the only operator events
    are the engine's own ``serve.*`` markers."""
    _, tcfg, _, tparams = _models("paper-gpt2")
    names = []
    with torch.inference_mode(), tpasta.Session(
            tools="serving", instrument=True, torch_device="cpu") as sess:
        sess.handler.subscribe(lambda e: names.append(e.name),
                               kinds=("operator_start",))
        eng = ServeEngine(tcfg, tparams, max_seq=32, max_slots=2,
                          session=sess)
        eng.run([(p, SamplingParams(max_new_tokens=3)) for p in
                 _prompts(tcfg.vocab_size, (5, 9))])
    assert names and all(n.startswith("serve.") for n in names)


def test_generate_shim_deprecated_but_equivalent():
    _, tcfg, _, tparams = _models("paper-gpt2")
    prompts = np.stack(_prompts(tcfg.vocab_size, (6, 6, 6), seed=8))
    eng = ServeEngine(tcfg, tparams, max_seq=32, max_slots=2)
    with pytest.warns(DeprecationWarning, match="deprecated"):
        out = eng.generate(prompts, max_new_tokens=4)
    assert out.shape == (3, 4)
    for row, p in zip(out, prompts):
        np.testing.assert_array_equal(
            row, _solo(tcfg, tparams, p, 4, max_seq=32, max_slots=2))


def test_stream_yields_tokens_with_one_done_flag_each():
    _, tcfg, _, tparams = _models("paper-gpt2")
    prompts = _prompts(tcfg.vocab_size, (5, 9, 7), seed=9)
    eng = ServeEngine(tcfg, tparams, max_seq=32, max_slots=2)
    seen: dict = {}
    dones = []
    for rid, tok, done in eng.stream([(p, SamplingParams(max_new_tokens=4))
                                      for p in prompts]):
        seen.setdefault(rid, []).append(tok)
        if done:
            dones.append(rid)
    assert sorted(dones) == sorted(seen) and len(dones) == 3
    for rid, toks in seen.items():
        assert toks == list(eng.requests[rid].tokens)


def test_submit_validation_and_mid_drain_failure():
    _, tcfg, _, tparams = _models("paper-gpt2")
    eng = ServeEngine(tcfg, tparams, max_seq=16, max_slots=1)
    with pytest.raises(ValueError, match="1-D"):
        eng.submit(np.zeros((2, 4), np.int32))
    with pytest.raises(ValueError, match="max_seq"):
        eng.submit(np.zeros(12, np.int32), SamplingParams(max_new_tokens=8))
    real = eng._sample_one
    calls = {"n": 0}

    def flaky(req, row, position=None):
        calls["n"] += 1
        if calls["n"] == 2:
            raise RuntimeError("injected sampling failure")
        return real(req, row, position)
    eng._sample_one = flaky
    with warnings.catch_warnings():
        with pytest.raises(RuntimeError, match="injected"):
            eng.run([(p, SamplingParams(max_new_tokens=3)) for p in
                     _prompts(tcfg.vocab_size, (4, 6))])
    assert not eng.has_work and eng.sched.n_free == 1
    assert (eng.pool._refs == eng.pool._store_refs).all()
