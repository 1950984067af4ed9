"""The port's decode path against the JAX package's, on the CPU: KV and SSM
caches, the cached attention branches (dense slot and paged), the SSM
decode state, ``forward``'s serving arguments and blocked attention.

Parameters come from the reference's ``init_params`` moved through numpy;
caches are moved the same way, so both packages start every step from the
same state.  Float32 logits agree within rtol = atol = 1e-5 (sums run in
a different order in the two frameworks); the bf16 bound of blocked
against dense attention is stated where it is tested.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as RC
from repro.models import forward as jforward
from repro.models import init_cache as jinit_cache
from repro.models import init_params as jinit_params
from repro.models import layers as jlayers
from repro.models import mamba2 as jmamba2
from repro.serve.cache import pad_cache_to as jpad_cache_to
import repro_torch.configs as TC
from repro_torch.convert import params_from_numpy
from repro_torch.core import events as tevents
from repro_torch.core import session as tsession
from repro_torch.models import forward, init_cache
from repro_torch.models import layers as tlayers
from repro_torch.models import mamba2 as tmamba2
from repro_torch.serve.cache import pad_cache_to

ARCHS = ["paper-gpt2", "glm4-9b", "mamba2-2.7b", "zamba2-7b", "dbrx-132b"]
RTOL = ATOL = 1e-5
#: bf16 blocked against bf16 dense attention: both round their softmax
#: weights to bf16 before the PV product (blocked: unnormalized chunk
#: weights, dense: normalized ones) and their output once, so they differ
#: by a few bf16 ulps of the output scale — the worst measured at 256
#: and 1024 tokens, causal or not, was 3.6e-3 (about 2**-8) of max|v|;
#: the bound is four times that
BF16_BLOCKED_REL = 2 ** -6


@pytest.fixture(autouse=True)
def _port_state(monkeypatch):
    monkeypatch.setenv("REPRO_PALLAS_INTERPRET", "0")   # reference: jnp path
    tevents.reset_seq()
    tsession.reset_state()
    yield
    tsession.reset_state()


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _torch(tree):
    """Nested dict of numpy/JAX arrays → tensors on the CPU (any dtype)."""
    if isinstance(tree, dict):
        return {k: _torch(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree, copy=True))


def _models(arch, **replace):
    jcfg = dataclasses.replace(RC.reduced(RC.get(arch)), **replace)
    tcfg = dataclasses.replace(TC.reduced(TC.get(arch)), **replace)
    jparams = jinit_params(jax.random.PRNGKey(0), jcfg)
    tparams = params_from_numpy(_np(jparams), "cpu")
    return jcfg, tcfg, jparams, tparams


def _length(cache):
    return cache["kv"]["length"] if "kv" in cache else cache["length"]


def _tforward(*args, **kw):
    with torch.no_grad():
        return forward(*args, **kw)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_then_decode_matches_reference(arch):
    """A prefill with ``return_cache=True``, then three one-token decodes:
    logits within 1e-5 of the reference at every step, equal cache
    lengths, equal cache contents."""
    jcfg, tcfg, jparams, tparams = _models(arch)
    rng = np.random.default_rng(3)
    x = rng.integers(0, jcfg.vocab_size, (2, 12)).astype(np.int32)
    jl, jc = jforward(jparams, x, jcfg, return_cache=True)
    tl, tc = _tforward(tparams, torch.from_numpy(x), tcfg, return_cache=True)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=RTOL,
                               atol=ATOL)
    jc = jpad_cache_to(jc, jcfg, 16)
    tc = pad_cache_to(tc, tcfg, 16)
    tok = np.asarray(jl)[:, -1].argmax(-1).astype(np.int32)[:, None]
    for _ in range(3):
        jl, jc = jforward(jparams, tok, jcfg, cache=jc, logits_mode="last")
        tl, tc = _tforward(tparams, torch.from_numpy(tok), tcfg, cache=tc,
                           logits_mode="last")
        assert tl.shape == jl.shape == (2, 1, tcfg.vocab_size)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=RTOL,
                                   atol=ATOL)
        np.testing.assert_array_equal(_length(tc).numpy(),
                                      np.asarray(_length(jc)))
        tok = np.asarray(jl)[:, -1].argmax(-1).astype(np.int32)[:, None]
    for path, want in jax.tree_util.tree_leaves_with_path(_np(jc)):
        got = tc
        for key in path:
            got = got[key.key]
        np.testing.assert_allclose(np.asarray(got), want, rtol=RTOL,
                                   atol=ATOL, err_msg=str(path))


@pytest.mark.parametrize("arch", ARCHS)
def test_init_cache_layout_matches_reference(arch):
    jcfg, tcfg = RC.reduced(RC.get(arch)), TC.reduced(TC.get(arch))
    want = jax.tree_util.tree_leaves_with_path(jinit_cache(jcfg, 3, 20))
    got = init_cache(tcfg, 3, 20, "cpu")
    n = 0
    for path, leaf in want:
        t = got
        for key in path:
            t = t[key.key]
        assert tuple(t.shape) == leaf.shape, path
        assert str(t.dtype).removeprefix("torch.") == str(leaf.dtype)
        assert not t.any()
        n += 1
    assert n == _n_leaves(got)


def _n_leaves(tree):
    return sum(_n_leaves(v) if isinstance(v, dict) else 1
               for v in tree.values())


def _ragged_append_caches(jcfg, seed=5):
    """A dense slot cache and a paged pool holding the same state: two
    rows appended 8 tokens, then rolled back to lengths [3, 8] (row 0's
    positions 3..7 now stale), and the block tables scrambled."""
    jparams = jinit_params(jax.random.PRNGKey(0), jcfg)
    rng = np.random.default_rng(seed)
    first = rng.integers(0, jcfg.vocab_size, (2, 8)).astype(np.int32)
    dense = jinit_cache(jcfg, 2, 16)
    _, dense = jforward(jparams, first, jcfg, cache=dense)
    dense = {"kv": dict(dense["kv"], length=jnp.asarray([3, 8], jnp.int32))}
    bs = 4
    bt = np.asarray([[5, 2, 7, 0], [1, 3, 4, 6]], np.int32)
    k, v = np.asarray(dense["kv"]["k"]), np.asarray(dense["kv"]["v"])
    n_layers = k.shape[0]
    pk = rng.standard_normal((n_layers, 9, bs) + k.shape[3:]) \
        .astype(np.float32)               # garbage where nothing is bound
    pv = rng.standard_normal(pk.shape).astype(np.float32)
    for row in range(2):
        for col, blk in enumerate(bt[row]):
            pk[:, blk] = k[:, row, col * bs:(col + 1) * bs]
            pv[:, blk] = v[:, row, col * bs:(col + 1) * bs]
    paged = {"kv": {"pk": jnp.asarray(pk), "pv": jnp.asarray(pv),
                    "bt": jnp.asarray(bt),
                    "length": jnp.asarray([3, 8], jnp.int32)}}
    return jparams, dense, paged


def test_per_row_multi_token_append_dense_and_paged_agree():
    """A 4-token append at each row's own base (3 and 8): the dense slot
    layout, the paged layout and the reference give the same logits at
    every position, and both layouts hold the same K/V afterwards."""
    jcfg = RC.reduced(RC.get("glm4-9b"))
    tcfg = TC.reduced(TC.get("glm4-9b"))
    jparams, jdense, jpaged = _ragged_append_caches(jcfg)
    tparams = params_from_numpy(_np(jparams), "cpu")
    x = np.random.default_rng(6).integers(
        0, jcfg.vocab_size, (2, 4)).astype(np.int32)
    want, jdense2 = jforward(jparams, x, jcfg, cache=jdense)
    want_paged, _ = jforward(jparams, x, jcfg, cache=jpaged)
    tdense, tpaged = _torch(_np(jdense)), _torch(_np(jpaged))
    got, tdense2 = _tforward(tparams, torch.from_numpy(x), tcfg,
                             cache=tdense)
    got_paged, tpaged2 = _tforward(tparams, torch.from_numpy(x), tcfg,
                                   cache=tpaged)
    np.testing.assert_allclose(np.asarray(want_paged), np.asarray(want),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(got_paged.numpy(), got.numpy(), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_array_equal(tdense2["kv"]["length"].numpy(), [7, 12])
    np.testing.assert_array_equal(tpaged2["kv"]["length"].numpy(), [7, 12])
    # the in-place writes hold what the reference's functional ones return
    np.testing.assert_allclose(tdense2["kv"]["k"].numpy(),
                               np.asarray(jdense2["kv"]["k"]), rtol=RTOL,
                               atol=ATOL)
    bt = tpaged["kv"]["bt"].numpy()
    pk = tpaged2["kv"]["pk"].numpy()
    for row, upto in ((0, 7), (1, 12)):
        window = pk[:, bt[row]].reshape(pk.shape[0], -1, *pk.shape[3:])
        np.testing.assert_allclose(
            window[:, :upto], tdense2["kv"]["k"].numpy()[:, row, :upto],
            rtol=RTOL, atol=ATOL)


def test_paged_parked_rows_write_nothing_and_read_no_stale_bytes():
    """Row 1 parked at the span and row 0's right-pad in unbound
    (sentinel) blocks: those writes drop, so every pool byte outside row
    0's real positions is unchanged, and row 0's logits equal a clean
    solo run's (the pool's garbage and sentinel gathers are never read)."""
    jcfg = RC.reduced(RC.get("paper-gpt2"))
    tcfg = TC.reduced(TC.get("paper-gpt2"))
    jparams = jinit_params(jax.random.PRNGKey(0), jcfg)
    tparams = params_from_numpy(_np(jparams), "cpu")
    rng = np.random.default_rng(7)
    n_blocks, bs = 6, 4
    pk = rng.standard_normal((jcfg.n_layers, n_blocks, bs, jcfg.n_kv_heads,
                              jcfg.head_dim)).astype(np.float32)
    pv = rng.standard_normal(pk.shape).astype(np.float32)
    # row 0: two blocks bound for a 6-token prompt (8 positions); row 1
    # parked; both tables sentinel-padded
    bt = np.asarray([[4, 1, n_blocks, n_blocks],
                     [0, 2, 3, n_blocks]], np.int32)
    span = bt.shape[1] * bs
    x = np.zeros((2, 12), np.int32)
    x[0, :6] = rng.integers(0, jcfg.vocab_size, 6)
    x[1] = rng.integers(0, jcfg.vocab_size, 12)
    cache = {"kv": {"pk": torch.from_numpy(pk.copy()),
                    "pv": torch.from_numpy(pv.copy()),
                    "bt": torch.from_numpy(bt),
                    "length": torch.tensor([0, span], dtype=torch.int32)}}
    got, new = _tforward(tparams, torch.from_numpy(x), tcfg, cache=cache,
                         logits_mode="index",
                         logits_index=torch.tensor([5, 0]))
    solo = _tforward(tparams, torch.from_numpy(x[:1, :6]), tcfg)[0]
    np.testing.assert_allclose(got[0, 0].numpy(), solo[0, 5].numpy(),
                               rtol=RTOL, atol=ATOL)
    want, _ = jforward(jparams, x, jcfg, cache={"kv": {
        "pk": jnp.asarray(pk), "pv": jnp.asarray(pv), "bt": jnp.asarray(bt),
        "length": jnp.asarray([0, span], jnp.int32)}},
        logits_mode="index", logits_index=jnp.asarray([5, 0]))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)
    after = new["kv"]["pk"].numpy()
    assert new["kv"]["pk"] is cache["kv"]["pk"]           # in place
    written = np.zeros(pk.shape[1:3], bool)
    written[4, :] = written[1, :] = True                  # row 0, 0..7
    np.testing.assert_array_equal(after[:, ~written], pk[:, ~written])
    assert not np.array_equal(after[:, written], pk[:, written])


def test_dense_slot_writes_past_max_seq_drop():
    """A slot row parked at max_seq appends nothing; the other row's
    append lands at its own length."""
    jcfg, tcfg, jparams, tparams = _models("glm4-9b")
    cache = init_cache(tcfg, 2, 8, "cpu")
    cache["kv"]["length"] = torch.tensor([2, 8], dtype=torch.int32)
    before = {k: cache["kv"][k].clone() for k in ("k", "v")}
    x = np.asarray([[3, 4, 5], [6, 7, 8]], np.int32)
    _, new = _tforward(tparams, torch.from_numpy(x), tcfg, cache=cache)
    for k in ("k", "v"):
        np.testing.assert_array_equal(new["kv"][k][:, 1].numpy(),
                                      before[k][:, 1].numpy())
        assert new["kv"][k][:, 0, 2:5].abs().sum() > 0
        np.testing.assert_array_equal(new["kv"][k][:, 0, 5:].numpy(), 0)
    jc = {"kv": {k: jnp.asarray(before[k].numpy()) for k in ("k", "v")}}
    jc["kv"]["length"] = jnp.asarray([2, 8], jnp.int32)
    _, jnew = jforward(jparams, x, jcfg, cache=jc)
    np.testing.assert_allclose(new["kv"]["k"].numpy(),
                               np.asarray(jnew["kv"]["k"]), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("mode,index", [
    ("last", None), ("index", [3, 0]), ("index", [[0, 2, 3], [1, 1, 0]])])
def test_logits_modes_match_reference(mode, index):
    jcfg, tcfg, jparams, tparams = _models("paper-gpt2")
    x = np.random.default_rng(8).integers(
        0, jcfg.vocab_size, (2, 4)).astype(np.int32)
    jidx = None if index is None else jnp.asarray(index, jnp.int32)
    tidx = None if index is None else torch.tensor(index, dtype=torch.int32)
    want = np.asarray(jforward(jparams, x, jcfg, logits_mode=mode,
                               logits_index=jidx)[0])
    got = _tforward(tparams, torch.from_numpy(x), tcfg, logits_mode=mode,
                    logits_index=tidx)[0].numpy()
    full = _tforward(tparams, torch.from_numpy(x), tcfg)[0].numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    # the lm_head on the selected rows only: the same values as slicing
    # the full logits, up to the product's summation order
    if mode == "last":
        sliced = full[:, -1:]
    else:
        idx = np.asarray(index).reshape(2, -1)
        sliced = np.take_along_axis(full, idx[..., None], axis=1)
    np.testing.assert_allclose(got, sliced, rtol=RTOL, atol=ATOL)


def _qkv(rng, b, s, t, hkv, g, d):
    q = rng.standard_normal((b, s, hkv, g, d)).astype(np.float32)
    k = rng.standard_normal((b, t, hkv, d)).astype(np.float32)
    v = rng.standard_normal((b, t, hkv, d)).astype(np.float32)
    return q, k, v


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("t,chunk", [(64, 16), (24, 16), (40, 1024)])
def test_sdpa_blocked_matches_reference_and_dense(causal, t, chunk):
    """Float32: the port's blocked attention against the reference's
    (same chunk rule: 24 with a chunk of 16 halves to 8) and against the
    port's dense attention."""
    q, k, v = _qkv(np.random.default_rng(t), 2, t, t, 2, 3, 16)
    want = np.asarray(jlayers._sdpa_blocked(q, k, v, causal, chunk=chunk))
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    got = tlayers._sdpa_blocked(tq, tk, tv, causal, chunk=chunk).numpy()
    dense = tlayers._sdpa_dense(tq, tk, tv, causal).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got, dense, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("causal", [True, False])
def test_sdpa_blocked_bf16_within_stated_bound_of_dense(causal):
    """bf16, as on the card: blocked within BF16_BLOCKED_REL·max|v| of
    dense, and within the same bound of the reference's blocked."""
    q, k, v = _qkv(np.random.default_rng(11), 1, 256, 256, 2, 4, 64)
    tq, tk, tv = (torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v))
    got = tlayers._sdpa_blocked(tq, tk, tv, causal, chunk=64).float()
    dense = tlayers._sdpa_dense(tq, tk, tv, causal).float()
    bound = BF16_BLOCKED_REL * float(tv.float().abs().max())
    assert float((got - dense).abs().max()) <= bound
    jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))
    want = np.asarray(jlayers._sdpa_blocked(jq, jk, jv, causal, chunk=64)
                      .astype(jnp.float32))
    assert float(np.abs(got.numpy() - want).max()) <= bound


@pytest.mark.parametrize("arch", ["glm4-9b", "zamba2-7b"])
def test_blocked_threshold_routes_prefill_through_blocked(arch):
    """With the threshold lowered by ``dataclasses.replace`` a 64-token
    prefill takes the blocked path in both packages: equal logits, and
    equal to the dense path's."""
    jcfg, tcfg, jparams, tparams = _models(arch, attn_blocked_threshold=16)
    x = np.random.default_rng(9).integers(
        0, jcfg.vocab_size, (2, 64)).astype(np.int32)
    want = np.asarray(jforward(jparams, x, jcfg)[0])
    calls = []
    real = tlayers._sdpa_blocked

    def spy(*a, **kw):
        calls.append(a[0].shape)
        return real(*a, **kw)
    tlayers._sdpa_blocked = spy
    try:
        got = _tforward(tparams, torch.from_numpy(x), tcfg)[0].numpy()
    finally:
        tlayers._sdpa_blocked = real
    assert calls
    dense = _tforward(tparams, torch.from_numpy(x),
                      dataclasses.replace(tcfg,
                                          attn_blocked_threshold=8192))[0]
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got, dense.numpy(), rtol=RTOL, atol=ATOL)


def test_two_tier_cache_raises_naming_distribution():
    """The two-tier KV cache (``kv_two_tier``) came with distribution's
    serving half: ``init_cache`` builds it and ``forward`` decodes
    through it (held against the reference in
    tests/test_torch_serve_steps.py).  What still raises is the serving
    pools, which refuse the layout as the reference's do."""
    from repro_torch.serve.cache import KVSlotPool, PagedKVPool
    tcfg = dataclasses.replace(TC.reduced(TC.get("glm4-9b")),
                               kv_two_tier=True)
    cache = init_cache(tcfg, 1, 8, "cpu")
    assert {"rk", "rv", "main_len"} <= set(cache["kv"])
    params = params_from_numpy(_np(jinit_params(
        jax.random.PRNGKey(0), RC.reduced(RC.get("glm4-9b")))), "cpu")
    logits, new = _tforward(params, torch.zeros((1, 1), dtype=torch.int32),
                            tcfg, cache=cache)
    assert torch.isfinite(logits).all()
    assert int(new["kv"]["length"][0]) == 1
    assert int(new["kv"]["main_len"][0]) == 0
    for pool in (KVSlotPool, PagedKVPool):
        with pytest.raises(NotImplementedError, match="kv_two_tier"):
            pool(tcfg, 1, 8, device="cpu")


def test_ssm_state_pieces_match_reference():
    """The decode state's pieces: the causal conv from a carried tail,
    the chunked scan and the recurrence from a carried state."""
    rng = np.random.default_rng(12)
    b, s, h, p, n, c = 2, 32, 3, 4, 5, 6
    x = rng.standard_normal((b, s, h, p)).astype(np.float32)
    dt = np.abs(rng.standard_normal((b, s, h))).astype(np.float32) * 0.1
    A = -np.abs(rng.standard_normal(h)).astype(np.float32)
    B = rng.standard_normal((b, s, h, n)).astype(np.float32)
    C = rng.standard_normal((b, s, h, n)).astype(np.float32)
    init = rng.standard_normal((b, h, p, n)).astype(np.float32)
    t = [torch.from_numpy(a) for a in (x, dt, A, B, C)]
    for fn, jfn, kw in ((tmamba2.ssd_chunked, jmamba2.ssd_chunked,
                         {"chunk": 8}), (tmamba2.ssd_ref, jmamba2.ssd_ref,
                                         {})):
        y, st = fn(*t, init_state=torch.from_numpy(init), **kw)
        jy, jst = jfn(*map(jnp.asarray, (x, dt, A, B, C)),
                      init_state=jnp.asarray(init), **kw)
        np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=1e-4,
                                   atol=1e-4)
        np.testing.assert_allclose(st.numpy(), np.asarray(jst), rtol=1e-4,
                                   atol=1e-4)
    xc = rng.standard_normal((b, 3, c)).astype(np.float32)
    w = rng.standard_normal((4, c)).astype(np.float32)
    tail = rng.standard_normal((b, 3, c)).astype(np.float32)
    y, nt = tmamba2._causal_conv(*map(torch.from_numpy, (xc, w)),
                                 torch.from_numpy(tail))
    jy, jnt = jmamba2._causal_conv(*map(jnp.asarray, (xc, w, tail)))
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_array_equal(nt.numpy(), np.asarray(jnt))
