"""The port's serving host modules against the JAX package's, on the CPU:
the same sequence of calls gives the same results in both.

Covered: ``bucket``/``pad_group``, the ``Scheduler``, the paged pool's
allocator (block ids, tables, ``stats()``) and its device copies, the
slot pool's insert, the ``PrefixCache`` (hits, LRU order, stats), the SLO
policies (orderings and victims), the traffic generator and its JSONL
round trip, the fault presets' schedules, and the ``serving`` tool's
report on one golden event stream recorded from the reference engine.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

import repro.configs as RC
import repro.core as jpasta
from repro.core.tools.serving import ServingTool as JServingTool
from repro.models import init_params as jinit_params
from repro.serve import ServeEngine as JServeEngine
from repro.serve import cache as jcache
from repro.serve import faults as jfaults
from repro.serve import scheduler as jsched
from repro.serve import slo as jslo
from repro.serve import traffic as jtraffic
import repro_torch.configs as TC
from repro_torch.core import events as tevents
from repro_torch.core import session as tsession
from repro_torch.core.tools import TOOL_REGISTRY
from repro_torch.core.tools.serving import ServingTool
from repro_torch.models import init_cache
from repro_torch.serve import cache as tcache
from repro_torch.serve import faults as tfaults
from repro_torch.serve import scheduler as tsched
from repro_torch.serve import slo as tslo
from repro_torch.serve import traffic as ttraffic


@pytest.fixture(autouse=True)
def _port_state(monkeypatch):
    monkeypatch.setenv("REPRO_PALLAS_INTERPRET", "0")   # reference: jnp path
    tevents.reset_seq()
    tsession.reset_state()
    yield
    tsession.reset_state()


@pytest.mark.parametrize("n,floor", [(1, 8), (8, 8), (9, 8), (33, 8),
                                     (12280, 8), (5, 2)])
def test_bucket_matches_reference(n, floor):
    assert tcache.bucket(n, floor) == jcache.bucket(n, floor)


@pytest.mark.parametrize("pow2,max_len", [(True, None), (False, None),
                                          (True, 20)])
def test_pad_group_matches_reference(pow2, max_len):
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, 50, n).astype(np.int32) for n in (3, 17, 9)]
    jt, jl = jsched.pad_group(prompts, pow2=pow2, max_len=max_len)
    tt, tl = tsched.pad_group(prompts, pow2=pow2, max_len=max_len)
    np.testing.assert_array_equal(tt, jt)
    np.testing.assert_array_equal(tl, jl)
    with pytest.raises(ValueError):
        tsched.pad_group(prompts, max_len=10)


def _requests(mod, n, slos=None):
    out = []
    for i in range(n):
        out.append(mod.Request(rid=i, prompt=np.arange(3 + i, dtype=np.int32),
                               params=mod.SamplingParams(),
                               slo=None if slos is None else slos[i],
                               submit_time=float(i)))
    return out


def _sched_trace(mod):
    """Admit/release/preempt/vacate with a ``fits`` gate; the log of slots
    and states the scheduler hands out."""
    s = mod.Scheduler(3)
    reqs = _requests(mod, 6)
    for r in reqs:
        s.submit(r)
    log = []
    admitted = s.admit(fits=lambda r: r.rid != 2)
    log.append([(r.rid, r.slot) for r in admitted])
    s.release(admitted[0])
    s.preempt(admitted[1])
    log.append([(r.rid, r.state.value) for r in s.waiting])
    admitted = s.admit()
    log.append([(r.rid, r.slot) for r in admitted])
    s.vacate(admitted[0])
    log.append((s.n_free, s.n_active, s.n_queued, s.has_work))
    log.append(s.remove_waiting(reqs[5]))
    log.append(sorted((slot, r.rid) for slot, r in s.running.items()))
    return log


def test_scheduler_matches_reference():
    assert _sched_trace(tsched) == _sched_trace(jsched)


def _pool_trace(mod, cfg):
    """One sequence of allocator calls: alloc, bind, retain/release with
    store references, evict under pressure, ensure, truncate, scrub."""
    pool = mod.PagedKVPool(cfg, 3, 24, block_size=4, n_blocks=14,
                           **({"device": "cpu"} if mod is tcache else {}))
    pc = mod.PrefixCache(block=4, capacity=4,
                         on_evict=lambda e: pool.release(e, store=True))
    pool.evict_cb = pc.evict_one
    log = []
    a = pool.alloc(3)
    pool.bind_slot(0, [], a)
    toks = np.arange(12, dtype=np.int32)
    pc.insert_blocks(toks, pool.tables[0],
                     on_retain=lambda ids: pool.retain(ids, store=True))
    log.append((a, pool.stats(), pc.stats()))
    pool.free_slot(0)
    log.append(pool.stats())
    hit, ent = pc.lookup(np.arange(14, dtype=np.int32))
    pool.retain(ent)
    b = pool.alloc(2)
    pool.bind_slot(1, ent, b)
    log.append((hit, ent, b, pool.tables.tolist(), pool.stats()))
    log.append(pool.ensure(1, 23))
    log.append(pool.ensure(1, 40))
    log.append(pool.truncate(1, 9))
    log.append((sorted(pool._dirty), pool.tables.tolist()))
    c = pool.alloc(9)                     # evicts the prefix store
    log.append((c, pool.alloc(20), pool.stats(), pc.stats(), len(pc)))
    pool.scrub()
    log.append((pool.available(), pool.n_evictable(), pool._free[:]))
    return log


def test_paged_pool_allocator_matches_reference():
    jcfg = RC.reduced(RC.get("paper-gpt2"))
    tcfg = TC.reduced(TC.get("paper-gpt2"))
    assert _pool_trace(tcache, tcfg) == _pool_trace(jcache, jcfg)


def test_paged_pool_exhaustion_raises_in_both():
    for mod, cfg, kw in ((jcache, RC.reduced(RC.get("paper-gpt2")), {}),
                         (tcache, TC.reduced(TC.get("paper-gpt2")),
                          {"device": "cpu"})):
        pool = mod.PagedKVPool(cfg, 1, 16, block_size=4, n_blocks=2, **kw)
        with pytest.raises(RuntimeError, match="exhausted"):
            pool.ensure(0, 16)
        with pytest.raises(NotImplementedError):
            mod.PagedKVPool(RC.reduced(RC.get("zamba2-7b"))
                            if mod is jcache
                            else TC.reduced(TC.get("zamba2-7b")), 1, 16,
                            **kw)


def test_paged_insert_prefill_and_scrub_match_reference():
    """A dense prefill row copied into scrambled, sentinel-padded blocks
    (cropped to the span), then two blocks scrubbed: the same pool bytes
    as the reference's scatter."""
    jcfg = RC.reduced(RC.get("paper-gpt2"))
    tcfg = TC.reduced(TC.get("paper-gpt2"))
    rng = np.random.default_rng(2)
    k = rng.standard_normal((jcfg.n_layers, 2, 16, jcfg.n_kv_heads,
                             jcfg.head_dim)).astype(np.float32)
    v = rng.standard_normal(k.shape).astype(np.float32)
    src = {"kv": {"k": k, "v": v, "length": np.full((2,), 16, np.int32)}}
    jpool = jcache.PagedKVPool(jcfg, 2, 12, block_size=4, n_blocks=7)
    tpool = tcache.PagedKVPool(tcfg, 2, 12, block_size=4, n_blocks=7,
                               device="cpu")
    for pool in (jpool, tpool):
        pool.bind_slot(1, [5], [2])       # third table entry: sentinel
    jpool.insert_prefill(jax.tree.map(jax.numpy.asarray, src), 1, 1)
    tpool.insert_prefill({"kv": {key: torch.from_numpy(a)
                                 for key, a in src["kv"].items()}}, 1, 1)
    np.testing.assert_array_equal(tpool.pk.numpy(), np.asarray(jpool.pk))
    np.testing.assert_array_equal(tpool.pv.numpy(), np.asarray(jpool.pv))
    for pool in (jpool, tpool):
        pool._dirty.update([2, 6])
        pool.scrub()
    np.testing.assert_array_equal(tpool.pk.numpy(), np.asarray(jpool.pk))


@pytest.mark.parametrize("arch", ["glm4-9b", "zamba2-7b", "mamba2-2.7b"])
def test_slot_pool_insert_matches_reference(arch):
    """A right-padded prefill row into one slot of the pool: cropped to
    max_seq, the rest of the row zeroed, the length overridden."""
    jcfg, tcfg = RC.reduced(RC.get(arch)), TC.reduced(TC.get(arch))
    jpool = jcache.KVSlotPool(jcfg, 3, 10)
    tpool = tcache.KVSlotPool(tcfg, 3, 10, device="cpu")
    rng = np.random.default_rng(3)
    src = jax.tree.map(
        lambda a: rng.standard_normal(a.shape).astype(a.dtype)
        if a.dtype.kind == "f" else np.full(a.shape, 12, a.dtype),
        jax.tree.map(np.asarray, jcache.pad_cache_to(
            jax.tree.map(lambda a: a[..., :12, :, :] if a.ndim == 5
                         else a, _batch2(jcfg)), jcfg, 12)))
    jpool.insert(jax.tree.map(jax.numpy.asarray, src), 2, 1, 7)
    tpool.insert(jax.tree.map(torch.from_numpy, src), 2, 1, 7)
    got = jax.tree.map(lambda t: t.numpy(), tpool.cache)
    want = jax.tree.map(np.asarray, jpool.cache)
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        np.testing.assert_array_equal(g, w)


def _batch2(jcfg):
    from repro.models import init_cache as jinit_cache
    return jinit_cache(jcfg, 2, 12)


def test_pad_cache_to_matches_reference():
    jcfg, tcfg = RC.reduced(RC.get("glm4-9b")), TC.reduced(TC.get("glm4-9b"))
    cache = init_cache(tcfg, 2, 5, "cpu")
    cache["kv"]["k"].normal_()
    got = tcache.pad_cache_to(cache, tcfg, 9)
    want = jcache.pad_cache_to(
        {"kv": {k: jax.numpy.asarray(t.numpy())
                for k, t in cache["kv"].items()}}, jcfg, 9)
    np.testing.assert_array_equal(got["kv"]["k"].numpy(),
                                  np.asarray(want["kv"]["k"]))
    assert tcache.pad_cache_to(got, tcfg, 4) is got


def _prefix_trace(mod):
    evicted = []
    pc = mod.PrefixCache(block=4, capacity=5, on_evict=evicted.append)
    a = np.arange(13, dtype=np.int32)
    b = np.concatenate([a[:8], np.full(6, 99, np.int32)])
    log = []
    pc.insert_blocks(a, list(range(10, 14)), on_retain=lambda e: None)
    log.append(pc.lookup(b))
    log.append(pc.covers(a, 8))
    log.append(pc.covers(b))
    pc.insert_blocks(b, [10, 11, 20, 21], on_retain=lambda e: None)
    log.append(pc.lookup(a))
    log.append(pc.lookup(a[:4]))
    log.append(pc.lookup(np.asarray([7, 7, 7, 7, 7], np.int32)))
    log.append([key[0] for key in pc._store])
    log.append(pc.evict_one())
    log.append((list(evicted), pc.stats(), len(pc)))
    return log


def test_prefix_cache_hits_and_lru_match_reference():
    assert _prefix_trace(tcache) == _prefix_trace(jcache)


def test_prefix_cache_legacy_insert_matches_reference():
    kv = np.random.default_rng(4).standard_normal((2, 10, 1, 4)) \
        .astype(np.float32)
    toks = np.arange(10, dtype=np.int32)
    jpc, tpc = jcache.PrefixCache(block=4), tcache.PrefixCache(block=4)
    jpc.insert(toks, {"k": kv, "v": kv})
    tpc.insert(toks, {"k": torch.from_numpy(kv), "v": torch.from_numpy(kv)})
    assert [k for k in tpc._store] == [k for k in jpc._store]
    jl, je = jpc.lookup(np.arange(12, dtype=np.int32))
    tl, te = tpc.lookup(np.arange(12, dtype=np.int32))
    assert tl == jl == 10
    np.testing.assert_array_equal(te["k"].numpy(), je["k"])


def _policy_trace(slo_mod, sched_mod, name):
    specs = [slo_mod.SLOSpec(tenant=t, priority=p, ttft_target_s=ttft)
             for t, p, ttft in (("a", 0, 2.0), ("b", 5, None), ("a", 1, 0.5),
                                ("c", 5, 1.0), ("b", 0, 3.0),
                                ("c", 2, 0.25))]
    reqs = _requests(sched_mod, 6, specs)
    reqs[1].tokens = [1]
    pol = slo_mod.get_policy(name)
    if pol is None:
        return None
    for r, n in zip(reqs, (5, 0, 2, 0, 7, 1)):
        pol.note_tokens(r, n)
    order = [r.rid for r in sorted(reqs[3:], key=lambda r: pol.key(r, 10.0))]
    running = {i: r for i, r in enumerate(reqs[:3])}
    victims = [r.rid for r in pol.victims(reqs[3:], running, 1, 10.0)]
    return (pol.name, pol.orders, pol.preemptive, order, victims, repr(pol))


@pytest.mark.parametrize("name", ["fcfs", "priority", "edf", "fair", None])
def test_slo_policies_match_reference(name):
    assert _policy_trace(tslo, tsched, name) == \
        _policy_trace(jslo, jsched, name)


@pytest.mark.parametrize("seed", [0, 3])
def test_traffic_traces_match_reference(seed):
    tenants = [ttraffic.TenantSpec(name="x", n_requests=5, rate=4.0,
                                   prompt_len=(4, 9),
                                   max_new_tokens=(2, 6), shared_prefix=3,
                                   prefix_pool=2),
               ttraffic.TenantSpec(name="y", n_requests=4, arrival="burst",
                                   rate=2.0, burst_size=2, priority=3,
                                   ttft_target_s=0.5)]
    jtenants = [jtraffic.TenantSpec(**dataclasses.asdict(t))
                for t in tenants]
    for got, want in ((ttraffic.make_trace(tenants, 97, seed=seed),
                       jtraffic.make_trace(jtenants, 97, seed=seed)),
                      (ttraffic.PRESETS["two-tenant-bursty"](97, seed=seed),
                       jtraffic.PRESETS["two-tenant-bursty"](97, seed=seed))):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert (g.arrival_s, g.max_new_tokens, g.tenant) == \
                (w.arrival_s, w.max_new_tokens, w.tenant)
            np.testing.assert_array_equal(g.prompt, w.prompt)
            assert (g.slo is None) == (w.slo is None)
            if g.slo is not None:
                assert g.slo.to_dict() == w.slo.to_dict()
        assert ttraffic.max_seq_for(got, 2) == jtraffic.max_seq_for(want, 2)


def test_trace_save_load_round_trip(tmp_path):
    trace = ttraffic.PRESETS["two-tenant-bursty"](50, seed=1)
    path = tmp_path / "trace.jsonl"
    ttraffic.save_trace(str(path), trace, seed=1, meta={"arch": "x"})
    back, meta = ttraffic.load_trace(str(path))
    jback, jmeta = jtraffic.load_trace(str(path))
    assert meta == jmeta and meta["seed"] == 1 and meta["arch"] == "x"
    for t, b, j in zip(trace, back, jback):
        np.testing.assert_array_equal(b.prompt, t.prompt)
        np.testing.assert_array_equal(b.prompt, j.prompt)
        assert b.slo.to_dict() == t.slo.to_dict() == j.slo.to_dict()


@pytest.mark.parametrize("preset", ["one-poison", "transient", "storm",
                                    "pressure"])
def test_fault_presets_match_reference(preset):
    """Same specs from the same seed, and the same firing schedule over a
    run of ticks (stalls, pressure, host preemptions, tick errors,
    poisons, NaN rows, probes)."""
    def trace(mod):
        plan = mod.get_plan(preset, seed=2)
        log = [plan.to_dict(), repr(plan)]
        for tick in range(1, 18):
            rids = [tick % 8, (tick + 3) % 8]
            row = [plan.tick_stall_s(tick), plan.held_blocks(tick),
                   plan.preempt_signals(tick), plan.probe(rids)]
            try:
                plan.check_tick(tick, rids)
                row.append(None)
            except mod.FaultInjected as e:
                row.append((e.kind, e.tick, e.attributable))
            logits = np.zeros((8, 3), np.float32)
            row.append(plan.corrupt_logits(tick, {r: r for r in rids},
                                           logits))
            row.append(np.isnan(logits).sum())
            log.append(row)
        log.append(plan.fired)
        return log
    assert trace(tfaults) == trace(jfaults)


def _engine_events():
    """The events a reference engine run emits (shared prefix, chunked
    prefill, a priority preemption), in order."""
    cfg = RC.reduced(RC.get("paper-gpt2"))
    params = jinit_params(jax.random.PRNGKey(0), cfg)
    events = []
    with jpasta.Session(tools="serving", name="fleet") as session:
        session.handler.subscribe(events.append)
        eng = JServeEngine(cfg, params, max_seq=64, max_slots=2,
                           session=session, prefix_block=8, prefill_chunk=16,
                           policy="priority")
        rng = np.random.default_rng(0)
        pre = rng.integers(0, cfg.vocab_size, 16).astype(np.int32)
        for i, (n, pri) in enumerate(((5, 0), (9, 0), (3, 5))):
            p = np.concatenate([pre, rng.integers(0, cfg.vocab_size, n)
                                .astype(np.int32)])
            eng.submit(p, jsched.SamplingParams(max_new_tokens=6),
                       slo=jslo.SLOSpec(priority=pri, tenant=f"t{i % 2}",
                                        ttft_target_s=5.0))
            eng.step()
        while eng.has_work:
            eng.step()
        want = session.reports()["serving"].data
    return events, want


def test_serving_tool_same_report_on_golden_stream():
    events, live = _engine_events()
    assert TOOL_REGISTRY["serving"] is ServingTool
    jtool, ttool = JServingTool(), ServingTool()
    for ev in events:
        jtool.on_event(ev)
        ttool.on_event(tevents.Event(
            kind=tevents.EventKind(ev.kind.value), name=ev.name,
            step=ev.step, time=ev.time, size=ev.size, attrs=dict(ev.attrs)))
    got, want = ttool.finalize(), jtool.finalize()
    assert got == want
    assert got["requests"] == 3 and got["preemption"]["count"] >= 1
    assert got["decode_steps"] == live["decode_steps"]
