"""The port's serve steps (``make_prefill_step``, ``make_decode_step``,
``serve_shardings``) and its two-tier KV cache against the JAX package's,
on the CPU.

Parameters come from the reference's ``init_params`` moved through numpy,
tokens from a seeded ``np.random.default_rng``; caches of both packages
start from the same zeros.  Float32 logits and caches agree within
rtol = atol = 1e-5 (sums run in another order in the two frameworks), and
greedy tokens are identical.  ``serve_shardings``' placements realise the
reference's ``PartitionSpec``s exactly (a fake 8-rank process group, as
tests/test_torch_sharding_rules.py).
"""

import dataclasses
import types

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.testing._internal.distributed.fake_pg import FakeStore

import repro.configs as RC
from repro.dist import sharding as jsh
from repro.models import forward as jforward
from repro.models import init_cache as jinit_cache
from repro.models import init_params as jinit_params
from repro.train import trainer as jtrainer
import repro_torch.configs as TC
from repro_torch.convert import params_from_numpy
from repro_torch.core import events as tevents
from repro_torch.core import session as tsession
from repro_torch.dist import sharding as tsh
from repro_torch.models import forward, init_cache
from repro_torch.train import trainer

RTOL = ATOL = 1e-5
ARCHS = ["glm4-9b", "zamba2-7b"]


@pytest.fixture(autouse=True)
def _port_state(monkeypatch):
    monkeypatch.setenv("REPRO_PALLAS_INTERPRET", "0")   # reference: jnp path
    tevents.reset_seq()
    tsession.reset_state()
    yield
    tsession.reset_state()
    tsh.set_mesh(None)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _torch(tree):
    if isinstance(tree, dict):
        return {k: _torch(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree, copy=True))


def _close(got, want, what):
    if isinstance(want, dict):
        assert set(got) == set(want), what
        for k in want:
            _close(got[k], want[k], f"{what}.{k}")
        return
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL, err_msg=what)


def _setup(arch, seed=0, batch=2, prompt=12):
    cfg = RC.reduced(RC.get(arch))
    tcfg = TC.reduced(TC.get(arch))
    jp = jinit_params(jax.random.PRNGKey(0), cfg)
    tp = params_from_numpy(_np(jp), device="cpu")
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (batch, prompt + 4),
                        dtype=np.int32)
    return cfg, tcfg, jp, tp, toks


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_steps_match_reference(arch):
    cfg, tcfg, jp, tp, toks = _setup(arch)
    prompt = toks.shape[1] - 4
    jl, jcache = jtrainer.make_prefill_step(cfg)(jp, toks[:, :prompt])
    tl, tcache = trainer.make_prefill_step(tcfg)(tp, torch.from_numpy(
        toks[:, :prompt]).long())
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=RTOL,
                               atol=ATOL)
    _close(tcache, _np(jcache), "prefill cache")
    # decode 4 tokens into a max_seq cache (zeros in both), greedy
    b, max_seq = toks.shape[0], toks.shape[1] + 4
    jc = jinit_cache(cfg, b, max_seq)
    tc = init_cache(tcfg, b, max_seq, device="cpu")
    jdec = jtrainer.make_decode_step(cfg)
    tdec = trainer.make_decode_step(tcfg)
    for t in range(toks.shape[1]):
        step_tok = toks[:, t:t + 1]
        jl, jc = jdec(jp, jc, step_tok)
        tl, tc = tdec(tp, tc, torch.from_numpy(step_tok).long())
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=RTOL,
                                   atol=ATOL, err_msg=f"token {t}")
        assert (tl.argmax(-1).numpy() == np.asarray(jl).argmax(-1)).all()
    _close(tc, _np(jc), "decode cache")


def _two_tier(cache: dict, n_kv: int, hd: int, recent: int) -> dict:
    kv = cache["kv"]
    n, b = kv["k"].shape[0], kv["k"].shape[1]
    return {"kv": {**kv, "main_len": kv["length"],
                   "rk": np.zeros((n, b, recent, n_kv, hd), np.float32),
                   "rv": np.zeros((n, b, recent, n_kv, hd), np.float32)}}


def test_two_tier_decode_matches_reference_and_dense():
    """Prefill 32 tokens, then 8 one-token decodes through the two-tier
    cache (frozen main cache, 8-slot recent buffer; tests/test_perf_knobs.py
    81's case): the port's logits equal the reference's two-tier decode and
    the port's own dense decode, greedy tokens are identical, and the main
    cache stays bit for bit what the prefill wrote."""
    cfg = RC.reduced(RC.get("glm4-9b"))
    tcfg = TC.reduced(TC.get("glm4-9b"))
    cfg2 = dataclasses.replace(cfg, kv_two_tier=True, kv_recent_len=8)
    tcfg2 = dataclasses.replace(tcfg, kv_two_tier=True, kv_recent_len=8)
    jp = jinit_params(jax.random.PRNGKey(0), cfg)
    tp = params_from_numpy(_np(jp), device="cpu")
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 40),
                                             dtype=np.int32)
    _, jc = jforward(jp, toks[:, :32], cfg, return_cache=True,
                     logits_mode="last")
    jc = _np(jc)
    jtwo = _two_tier(jc, cfg.n_kv_heads, cfg.head_dim, 8)
    ttwo = _torch(jtwo)
    main_k = ttwo["kv"]["k"].clone()
    # the port's dense decode over a cache padded to 40
    dense = _torch(jc)
    pad = lambda a: torch.cat([a, a.new_zeros(               # noqa: E731
        (*a.shape[:2], 8, *a.shape[3:]))], dim=2)
    dense["kv"]["k"], dense["kv"]["v"] = pad(dense["kv"]["k"]), \
        pad(dense["kv"]["v"])
    for t in range(32, 40):
        tok = toks[:, t:t + 1]
        jl, jtwo = jforward(jp, tok, cfg2, cache=jtwo, logits_mode="last")
        tl, ttwo = forward(tp, torch.from_numpy(tok).long(), tcfg2,
                           cache=ttwo, logits_mode="last")
        dl, dense = forward(tp, torch.from_numpy(tok).long(), tcfg,
                            cache=dense, logits_mode="last")
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=RTOL,
                                   atol=ATOL, err_msg=f"two-tier {t}")
        np.testing.assert_allclose(tl.numpy(), dl.numpy(), rtol=RTOL,
                                   atol=ATOL, err_msg=f"dense {t}")
        assert (tl.argmax(-1) == dl.argmax(-1)).all()
        assert (tl.argmax(-1).numpy() == np.asarray(jl).argmax(-1)).all()
    assert torch.equal(ttwo["kv"]["k"], main_k)
    _close(ttwo, _np(jtwo), "two-tier cache")


def test_two_tier_cache_layout_matches_reference():
    for arch in ("glm4-9b", "zamba2-7b"):
        cfg = dataclasses.replace(RC.reduced(RC.get(arch)), kv_two_tier=True,
                                  kv_recent_len=8)
        tcfg = dataclasses.replace(TC.reduced(TC.get(arch)),
                                   kv_two_tier=True, kv_recent_len=8)
        want = jax.tree.map(lambda a: (tuple(a.shape), str(a.dtype)),
                            jinit_cache(cfg, 2, 16))
        got = jax.tree.map(lambda t: (tuple(t.shape),
                                      str(t.dtype).replace("torch.", "")),
                           init_cache(tcfg, 2, 16, device="meta"))
        assert got == want, arch
    # the serving pools keep refusing the two-tier layout, as the
    # reference's do
    from repro_torch.serve.cache import KVSlotPool
    with pytest.raises(NotImplementedError):
        KVSlotPool(tcfg, 2, 16, device="cpu")


@pytest.fixture()
def pod_mesh():
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=8)
    try:
        from torch.distributed.device_mesh import init_device_mesh
        names = ("pod", "data", "model")
        yield (init_device_mesh("cpu", (2, 2, 2), mesh_dim_names=names),
               types.SimpleNamespace(shape=dict(zip(names, (2, 2, 2))),
                                     axis_names=names))
    finally:
        dist.destroy_process_group()


def _spec_of(placements, mesh, ndim: int) -> tuple:
    """The per-tensor-dimension spec that ``placements`` realise."""
    per_dim: list = [[] for _ in range(ndim)]
    for name, p in zip(mesh.mesh_dim_names, placements):
        if p.is_shard():
            per_dim[p.dim].append(name)
    return tuple(None if not a else a[0] if len(a) == 1 else tuple(a)
                 for a in per_dim)


def _leaves(tree, prefix=()):
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from _leaves(tree[k], (*prefix, k))
        else:
            yield (*prefix, k), tree[k]


@pytest.mark.parametrize("arch", ["glm4-9b", "zamba2-7b", "mamba2-2.7b"])
@pytest.mark.parametrize("two_tier", [False, True])
def test_serve_shardings_match_reference_specs(arch, two_tier, pod_mesh):
    """Every cache leaf's placements realise the reference's
    ``PartitionSpec`` (its ``tree_shardings`` over ``cache_axes``), and
    params and caches lie on the ``meta`` device."""
    from repro.models import cache_axes as jcache_axes
    tmesh, jmesh = pod_mesh
    cfg = dataclasses.replace(RC.get(arch), kv_two_tier=two_tier)
    tcfg = dataclasses.replace(TC.get(arch), kv_two_tier=two_tier)
    p_sh, c_sh, p_shapes, c_shapes = trainer.serve_shardings(
        tmesh, tcfg, 16, 4096)
    jshapes = jax.eval_shape(lambda: jinit_cache(cfg, 16, 4096))
    jaxes = dict(_leaves(jcache_axes(cfg)))
    got = dict(_leaves(c_sh))
    assert set(got) == set(jaxes)
    for path, pl in got.items():
        node = jshapes
        for k in path:
            node = node[k]
        want = tuple(jsh.logical(*jaxes[path], dims=node.shape,
                                 mesh=jmesh))
        assert _spec_of(pl, tmesh, len(node.shape)) == want, path
    assert all(t.device.type == "meta" for _p, t in
               [*_leaves(c_shapes), *_leaves(p_shapes)])
