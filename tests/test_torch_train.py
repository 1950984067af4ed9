"""Single-device training on the port against the JAX package, on the CPU,
in float32.

* Every architecture at reduced size: three steps of ``make_train_step``
  with ``microbatches=2`` and ``OptConfig(lr=1e-3,
  moment_dtype=cfg.opt_moment_dtype)``, as tests/test_models.py takes
  them, from the same weights on the same batch.  The loss agrees within
  1e-5 relative, ``grad_norm`` within 1e-4 relative, and every parameter
  within 1e-5 after the three steps, except where ``PARAM_BOUNDS`` states
  another bound with its reason.  Both trace back to one effect: Adam
  divides each moment by the root of the second one, so an element whose
  gradient is tiny moves by about ``lr`` whatever the gradient's size, and
  float32 sums taken in another order (differences near 1e-6 of the
  largest gradient) can change its sign.  kimi-k2's int8 moments add to it:
  a moment at a rounding boundary lands on the neighbouring int8 step.
* The optimizer alone: the int8 ``_quant`` / ``_dequant`` are bit for bit
  (both libraries round half to even); ``lr_schedule`` is bit for bit
  through the warm-up.  On the cosine decay XLA's float32 ``cos`` and
  torch's differ in the last bit, and near the end of the decay ``1 +
  cos`` cancels, so there the two schedules are within 1e-7 of the peak
  rate (measured 9.7e-8; 2.9% of the steps differ at all).
* The data: ``batch_at(step)`` is numpy in both packages and equal bit for
  bit, for the token and the ``embed`` frontends and for token files.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as RC
from repro.models import cross_entropy as jcross_entropy
from repro.models import init_params as jinit_params
from repro.train import OptConfig as JOptConfig
from repro.train import make_train_step as jmake_train_step
from repro.train import data as jdata
from repro.train import optimizer as jopt
import repro_torch.configs as TC
from repro_torch.convert import params_from_numpy
from repro_torch.core import events as tevents
from repro_torch.core import session as tsession
from repro_torch.models import cross_entropy
from repro_torch.train import OptConfig, make_train_step
from repro_torch.train import data as tdata
from repro_torch.train import optimizer as topt

STEPS = 3
LOSS_RTOL = 1e-5
GNORM_RTOL = 1e-4
PARAM_ATOL = 1e-5
#: arch -> (max |Δparam|, share of elements beyond PARAM_ATOL), each twice
#: the measured value (see the module docstring for the cause):
#: dbrx-132b  measured 1.51e-5 on 1 of 16384 embedding elements;
#: kimi-k2    measured 3.73e-2, on at most 0.195% of a leaf's elements
PARAM_BOUNDS = {"dbrx-132b": (3.0e-5, 1.3e-4),
                "kimi-k2-1t-a32b": (7.5e-2, 3.9e-3)}


@pytest.fixture(autouse=True)
def _port_state():
    tevents.reset_seq()
    tsession.reset_state()
    yield
    tsession.reset_state()


def _batch(cfg, seed=1):
    rng = np.random.default_rng(seed)
    if cfg.frontend == "embed":
        x = rng.standard_normal((2, 64, cfg.d_model)).astype(np.float32)
    else:
        x = rng.integers(0, cfg.vocab_size, size=(2, 64)).astype(np.int32)
    labels = rng.integers(0, cfg.vocab_size, size=(2, 64)).astype(np.int32)
    return x, labels


@pytest.mark.parametrize("arch", RC.list_archs())
def test_train_steps_match_reference(arch):
    jcfg = RC.reduced(RC.get(arch))
    tcfg = TC.reduced(TC.get(arch))
    x, labels = _batch(jcfg)
    jparams = jinit_params(jax.random.PRNGKey(0), jcfg)
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")

    jo = JOptConfig(lr=1e-3, moment_dtype=jcfg.opt_moment_dtype)
    jstep = jax.jit(jmake_train_step(jcfg, jo, microbatches=2))
    jstate = jopt.init_opt_state(jparams, jo)
    to = OptConfig(lr=1e-3, moment_dtype=tcfg.opt_moment_dtype)
    step = make_train_step(tcfg, to, microbatches=2)
    state = topt.init_opt_state(params, to)
    jbatch = {"inputs": jnp.asarray(x), "labels": jnp.asarray(labels)}
    batch = {"inputs": torch.from_numpy(x), "labels": torch.from_numpy(labels)}
    for _ in range(STEPS):
        jparams, jstate, jm = jstep(jparams, jstate, jbatch)
        params, state, m = step(params, state, batch)
        assert set(m) == set(jm)
        assert float(m["loss"]) == pytest.approx(float(jm["loss"]),
                                                 rel=LOSS_RTOL)
        assert float(m["grad_norm"]) == pytest.approx(
            float(jm["grad_norm"]), rel=GNORM_RTOL)
        assert float(m["lr"]) == float(jm["lr"])
        assert float(m["tokens"]) == float(jm["tokens"])
    assert int(state["step"]) == int(jstate["step"]) == STEPS

    want = dict(topt.tree_paths(jax.tree.map(np.asarray, jparams)))
    got = topt.tree_paths(params)
    assert [p for p, _ in got] == sorted(want)
    max_err, share = PARAM_BOUNDS.get(arch, (PARAM_ATOL, 0.0))
    for path, leaf in got:
        assert str(leaf.dtype) == f"torch.{want[path].dtype}"
        d = np.abs(leaf.numpy() - want[path])
        assert d.max() <= max_err, (path, d.max())
        beyond = (d > PARAM_ATOL).mean()
        assert beyond <= share, (path, beyond)


def test_int8_moments_are_bit_for_bit():
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((6, 33)) * 10.0 ** rng.integers(
        -6, 3, size=(6, 1))).astype(np.float32)
    # exact halves of the scale: round half to even in both
    x[0, :6] = [127.0, 0.5, 1.5, 2.5, -0.5, -2.5]
    x[1] = 0.0
    jq, js = jopt._quant(jnp.asarray(x))
    q, s = topt._quant(torch.from_numpy(x))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    assert q[0, :6].tolist() == [127, 0, 2, 2, 0, -2]
    np.testing.assert_array_equal(
        topt._dequant(q, s).numpy(),
        np.asarray(jopt._dequant(jq, js)))


def test_lr_schedule_matches_reference():
    cfg, jcfg = OptConfig(), JOptConfig()
    steps = np.arange(0, cfg.total_steps + 2, dtype=np.int32)
    want = np.asarray(jopt.lr_schedule(jnp.asarray(steps), jcfg))
    got = topt.lr_schedule(torch.from_numpy(steps), cfg).numpy()
    assert got.dtype == want.dtype == np.float32
    warm = steps <= cfg.warmup_steps
    np.testing.assert_array_equal(got[warm], want[warm])
    assert np.abs(got - want).max() <= 1e-7 * cfg.lr


def test_global_norm_and_one_update_match_reference():
    rng = np.random.default_rng(2)
    tree = {"a": rng.standard_normal((4, 8)).astype(np.float32),
            "b": {"c": rng.standard_normal((8,)).astype(np.float32)}}
    grads = {"a": rng.standard_normal((4, 8)).astype(np.float32),
             "b": {"c": rng.standard_normal((8,)).astype(np.float32)}}
    jtree = jax.tree.map(jnp.asarray, tree)
    jgrads = jax.tree.map(jnp.asarray, grads)
    ttree = params_from_numpy(tree, "cpu")
    tgrads = params_from_numpy(grads, "cpu")
    assert float(topt.global_norm(tgrads)) == pytest.approx(
        float(jopt.global_norm(jgrads)), rel=1e-6)
    for moments in ("float32", "int8"):
        cfg = OptConfig(lr=1e-2, moment_dtype=moments)
        jcfg = JOptConfig(lr=1e-2, moment_dtype=moments)
        jp, js, jm = jopt.adamw_update(jtree, jgrads,
                                       jopt.init_opt_state(jtree, jcfg), jcfg)
        tp, ts, tm = topt.adamw_update(ttree, tgrads,
                                       topt.init_opt_state(ttree, cfg), cfg)
        assert set(tm) == set(jm)
        for path, leaf in topt.tree_paths(tp):
            want = dict(topt.tree_paths(jax.tree.map(np.asarray, jp)))[path]
            np.testing.assert_allclose(leaf.numpy(), want, rtol=1e-6,
                                       atol=1e-7)
        assert int(ts["step"]) == int(js["step"]) == 1


def test_sync_modes_are_not_ported():
    """Without a mesh the explicit pod sync is the identity (the
    reference's ``pod_sync`` returns the gradients unchanged when no mesh
    is set): each sync keyword gives the plain step's parameters and
    metrics bit for bit."""
    cfg = TC.reduced(TC.get("paper-gpt2"))
    x, labels = _batch(cfg)
    batch = {"inputs": torch.from_numpy(x), "labels": torch.from_numpy(labels)}
    opt_cfg = OptConfig(lr=1e-3)
    params = params_from_numpy(jax.tree.map(
        np.asarray, jinit_params(jax.random.PRNGKey(0), RC.reduced(
            RC.get("paper-gpt2")))), "cpu")
    want_p, want_s, want_m = make_train_step(cfg, opt_cfg)(
        params, topt.init_opt_state(params, opt_cfg), batch)
    for kw in ({"overlap_sync": True}, {"overlap_sync": False},
               {"sync_compressed": True}, {"sync_buckets": 2}):
        got_p, got_s, got_m = make_train_step(cfg, opt_cfg, **kw)(
            params, topt.init_opt_state(params, opt_cfg), batch)
        assert set(got_m) == set(want_m)
        for k in want_m:
            assert torch.equal(got_m[k], want_m[k]), (kw, k)
        for (path, a), (_q, b) in zip(topt.tree_paths(got_p),
                                      topt.tree_paths(want_p)):
            assert torch.equal(a, b), (kw, path)
        for (path, a), (_q, b) in zip(topt.tree_paths(got_s),
                                      topt.tree_paths(want_s)):
            assert torch.equal(a, b), (kw, path)


@pytest.mark.parametrize("frontend", ["none", "embed"])
def test_batch_at_is_bit_for_bit(frontend):
    kw = dict(vocab_size=1000, seq_len=32, global_batch=4, seed=3,
              frontend=frontend, d_model=16)
    for host in (0, 1):
        want = jdata.make_source(jdata.DataConfig(**kw), host_id=host,
                                 n_hosts=2)
        got = tdata.make_source(tdata.DataConfig(**kw), host_id=host,
                                n_hosts=2)
        for step in (0, 1, 7):
            w, g = want.batch_at(step), got.batch_at(step)
            assert set(w) == set(g) == {"inputs", "labels"}
            for k in w:
                assert g[k].dtype == w[k].dtype
                np.testing.assert_array_equal(g[k], w[k])


def test_file_tokens_are_bit_for_bit(tmp_path):
    path = tmp_path / "tokens.bin"
    np.random.default_rng(4).integers(0, 50000, size=4096).astype(
        np.uint16).tofile(path)
    cfg = dict(vocab_size=50000, seq_len=16, global_batch=2, seed=5)
    want = jdata.make_source(jdata.DataConfig(**cfg), str(path))
    got = tdata.make_source(tdata.DataConfig(**cfg), str(path))
    for step in (0, 3):
        for k, v in want.batch_at(step).items():
            np.testing.assert_array_equal(got.batch_at(step)[k], v)


def test_cross_entropy_matches_reference():
    """The f32 log-sum-exp, the NLL and the z-loss, from bf16 logits."""
    rng = np.random.default_rng(6)
    logits = (rng.standard_normal((2, 16, 300)) * 4).astype(np.float32)
    labels = rng.integers(0, 300, size=(2, 16)).astype(np.int32)
    jl = jnp.asarray(logits).astype(jnp.bfloat16)
    tl = torch.from_numpy(np.array(jl.astype(jnp.float32))).bfloat16()
    want, wparts = jcross_entropy(jl, jnp.asarray(labels))
    got, parts = cross_entropy(tl, torch.from_numpy(labels))
    assert float(got) == pytest.approx(float(want), rel=1e-6)
    assert set(parts) == set(wparts) == {"ce", "z"}
    for k in parts:
        assert float(parts[k]) == pytest.approx(float(wparts[k]), rel=1e-6)
