"""Port's dense model against the JAX package's, on the CPU.

Parameters come from the reference's ``init_params``, moved through numpy
and ``convert.params_from_numpy``; the same int32 tokens go to both
forwards.  f32 logits must agree within rtol = atol = 1e-5: both compute in
float32, but einsum and softmax sum in a different order in the two
frameworks.  Greedy tokens must be identical.
"""

import jax
import numpy as np
import pytest
import torch

import repro.configs as RC
from repro.models import forward as jforward
from repro.models import init_params as jinit_params
import repro_torch.configs as TC
import repro_torch.core as tpasta
from repro_torch.convert import params_from_numpy
from repro_torch.core import events as tevents
from repro_torch.core import session as tsession
from repro_torch.core.instrument import op_hook
from repro_torch.models import forward, init_params

ARCHS = ["glm4-9b", "paper-gpt2", "paper-bert"]
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


def test_unported_families_raise():
    import dataclasses
    cfg = dataclasses.replace(TC.reduced(TC.get("glm4-9b")), family="moe")
    with pytest.raises(NotImplementedError):
        init_params(cfg, device="cpu")


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
