"""Port's models (dense, moe, ssm, hybrid) against the JAX package's, on
the CPU.

Parameters come from the reference's ``init_params``, moved through numpy
and ``convert.params_from_numpy``; the same int32 tokens go to both
forwards.  f32 logits must agree within rtol = atol = 1e-5: both compute in
float32, but einsum, softmax, cumsum and the SSD chunk sums run in a
different order in the two frameworks.  Greedy tokens must be identical.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as RC
from repro.models import forward as jforward
from repro.models import init_params as jinit_params
from repro.models import mamba2 as jmamba2
from repro.models import moe as jmoe
import repro_torch.configs as TC
import repro_torch.core as tpasta
from repro_torch.convert import params_from_numpy
from repro_torch.core import events as tevents
from repro_torch.core import session as tsession
from repro_torch.core.instrument import op_hook
from repro_torch.models import forward, init_params
from repro_torch.models import mamba2 as tmamba2
from repro_torch.models import moe as tmoe

ARCHS = ["glm4-9b", "paper-gpt2", "paper-bert", "mamba2-2.7b", "zamba2-7b",
         "dbrx-132b"]
RTOL = ATOL = 1e-5


@pytest.fixture(autouse=True)
def _port_state():
    tevents.reset_seq()
    tsession.reset_state()
    yield
    tsession.reset_state()


def _tokens(cfg, seed=1):
    rng = np.random.default_rng(seed)
    return rng.integers(0, cfg.vocab_size, size=(2, 64)).astype(np.int32)


@pytest.mark.parametrize("arch", ARCHS)
def test_logits_match_reference(arch):
    jcfg = RC.reduced(RC.get(arch))
    tcfg = TC.reduced(TC.get(arch))
    jparams = jinit_params(jax.random.PRNGKey(0), jcfg)
    x = _tokens(jcfg)
    want = np.asarray(jforward(jparams, x, jcfg)[0])
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    with torch.inference_mode():
        got = forward(params, torch.from_numpy(x), tcfg)[0].numpy()
    assert got.shape == want.shape == (2, 64, tcfg.vocab_size)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))


@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_layout_matches_reference(arch):
    """Same nested keys, stacked shapes and dtypes as the reference."""
    jcfg = RC.reduced(RC.get(arch))
    want = jax.eval_shape(lambda: jinit_params(jax.random.PRNGKey(0), jcfg))
    got = init_params(TC.reduced(TC.get(arch)), seed=0, device="cpu")

    def layout(tree):
        if isinstance(tree, dict):
            return {k: layout(v) for k, v in tree.items()}
        return (tuple(tree.shape), str(tree.dtype).replace("torch.", ""))
    assert layout(got) == layout(want)


def test_config_registry_matches_reference():
    for arch in ARCHS:
        assert TC.get(arch).__dict__ == RC.get(arch).__dict__
        assert TC.reduced(TC.get(arch)).__dict__ == \
            RC.reduced(RC.get(arch)).__dict__
        assert TC.get(arch).n_params == RC.get(arch).n_params


@pytest.mark.parametrize("change", [{"family": "encdec"},
                                    {"family": "retnet"},
                                    {"frontend": "conv"},
                                    {"frontend": "tokens"}])
def test_unported_families_raise(change):
    """A family or a frontend that the reference does not have is refused
    (the reference's are in repro.models.config.ModelConfig)."""
    cfg = dataclasses.replace(TC.reduced(TC.get("glm4-9b")), **change)
    with pytest.raises(NotImplementedError):
        init_params(cfg, device="cpu")
    with pytest.raises(NotImplementedError):
        forward({}, torch.zeros((1, 4), dtype=torch.int32), cfg)


def _ssd_inputs(seed, b=2, s=48, h=4, p=8, n=16):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, s, h)) - 1.0)) \
        .astype(np.float32)
    a = -np.exp(rng.standard_normal(h) * 0.5).astype(np.float32)
    bm = rng.standard_normal((b, s, h, n)).astype(np.float32)
    cm = rng.standard_normal((b, s, h, n)).astype(np.float32)
    return x, dt, a, bm, cm


@pytest.mark.parametrize("chunk", [8, 16, 48])
def test_ssd_chunked_matches_sequential(chunk):
    """The port's chunked SSD against its own sequential oracle, and both
    against the reference's; y and the final state within 1e-4 (float32
    sums over up to 48 steps in different orders)."""
    args = _ssd_inputs(chunk)
    t = [torch.from_numpy(a) for a in args]
    y_c, st_c = tmamba2.ssd_chunked(*t, chunk)
    y_r, st_r = tmamba2.ssd_ref(*t)
    jy, jst = jmamba2.ssd_chunked(*[jnp.asarray(a) for a in args], chunk)
    for got, want in ((y_c, y_r), (st_c, st_r), (y_c, np.asarray(jy)),
                      (st_c, np.asarray(jst))):
        np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                                   rtol=1e-4, atol=1e-4)


def test_segsum_is_finite_above_the_diagonal():
    """Steep decays make exp overflow above the diagonal; the port masks
    the exponent first, so L is exactly 0 there and finite below."""
    da = torch.full((2, 3, 16), -80.0)
    lmat = tmamba2._segsum(da)
    assert bool(torch.isfinite(lmat).all())
    assert bool((torch.triu(lmat, diagonal=1) == 0).all())
    assert float(lmat[0, 0, 5, 5]) == 1.0


def test_softplus_matches_jax_without_threshold():
    """``jax.nn.softplus`` (logaddexp) has no linear switch at 20, as
    ``torch.nn.functional.softplus`` does; the port follows the reference
    over the whole range."""
    v = np.linspace(-40, 60, 2001).astype(np.float32)
    got = tmamba2.softplus(torch.from_numpy(v)).numpy()
    want = np.asarray(jax.nn.softplus(jnp.asarray(v)))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


def test_mamba2_layer_pads_a_ragged_sequence():
    """s % chunk != 0 pads with dt = 0 steps: the output equals the
    reference's, and the final state equals the sequential oracle's."""
    jcfg = dataclasses.replace(RC.reduced(RC.get("mamba2-2.7b")),
                               ssm_chunk=8)
    tcfg = dataclasses.replace(TC.reduced(TC.get("mamba2-2.7b")),
                               ssm_chunk=8)
    jp = jax.tree.map(np.asarray, jinit_params(jax.random.PRNGKey(3),
                                               jcfg))["layers"]
    jblk = jax.tree.map(lambda a: a[0], jp)["mamba"]
    x = np.random.default_rng(4).standard_normal((2, 21, 64)) \
        .astype(np.float32)
    want, jst = jmamba2.mamba2_layer(jblk, jnp.asarray(x), jcfg)
    tblk = params_from_numpy(jblk, "cpu")
    got, st = tmamba2.mamba2_layer(tblk, torch.from_numpy(x), tcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(st["ssm"].numpy(), np.asarray(jst["ssm"]),
                               rtol=1e-4, atol=1e-4)


def test_top_k_breaks_ties_like_jax():
    """Equal router probabilities pick the lower expert index first, in
    ``jax.lax.top_k``'s order."""
    probs = np.array([[0.1, 0.3, 0.3, 0.3], [0.25, 0.25, 0.25, 0.25],
                      [0.4, 0.1, 0.4, 0.1]], dtype=np.float32)
    vals, idx = tmoe.top_k(torch.from_numpy(probs), 2)
    jv, ji = jax.lax.top_k(jnp.asarray(probs), 2)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(jv))


def test_moe_capacity_drops_like_the_reference():
    """Capacity below demand: the same tokens are dropped, so the layer's
    output and aux stats equal the reference's."""
    jcfg = dataclasses.replace(RC.reduced(RC.get("dbrx-132b")),
                               capacity_factor=0.5)
    tcfg = dataclasses.replace(TC.reduced(TC.get("dbrx-132b")),
                               capacity_factor=0.5)
    jp = jax.tree.map(np.asarray, jinit_params(jax.random.PRNGKey(5),
                                               jcfg))["layers"]
    jblk = jax.tree.map(lambda a: a[0], jp)["moe"]
    x = np.random.default_rng(6).standard_normal((2, 64, 64)) \
        .astype(np.float32)
    want, jaux = jmoe.moe_layer(jblk, jnp.asarray(x), jcfg)
    got, aux = tmoe.moe_layer(params_from_numpy(jblk, "cpu"),
                              torch.from_numpy(x), tcfg)
    assert float(jaux["dropped_frac"]) > 0
    assert float(aux["dropped_frac"]) == pytest.approx(
        float(jaux["dropped_frac"]))
    assert float(aux["lb_loss"]) == pytest.approx(float(jaux["lb_loss"]),
                                                  rel=1e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_op_hook_is_silent_under_fx_tracing():
    """FX proxies are not allocations: with an instrumenter active, a traced
    function emits no events (the counterpart of the reference's
    jax.core.Tracer guard)."""
    seen = []
    with tpasta.Session(tools=(), instrument=True, torch_device="cpu") as s:
        s.handler.subscribe(seen.append)

        def f(x):
            y = x * 2
            op_hook("traced", (x,), (y,))
            return y
        torch.fx.symbolic_trace(f)
        assert not seen
        op_hook("eager", (torch.ones(4),), ())
    ops = [e.name for e in seen if e.kind.value == "operator_start"]
    assert ops == ["eager"]
