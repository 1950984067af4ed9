"""Six architectures against the JAX package, on the CPU, at reduced size
in float32: stablelm-1.6b, gemma-7b and kimi-k2 (features the other
tests cover), qwen3-32b (qk-norm), qwen2-vl-72b (M-RoPE and the ``embed``
frontend stub) and musicgen-large (the ``embed`` frontend).

Same weights (the reference's, or the port's, moved through numpy), same
inputs (numpy tokens, or numpy (B, S, d) embeddings for the ``embed``
frontend, since the reference draws its own with ``jax.random``).  The
analysis path's event stream and reports are identical, the logits within
rtol = atol = 1e-5 (float32 on both sides, sums in a different order) and
the greedy tokens identical.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as RC
from repro.core import events as jevents
from repro.models import forward as jforward
from repro.models import init_params as jinit_params
from repro.models import layers as jlayers
import repro_torch.configs as TC
from repro_torch.convert import params_from_numpy
from repro_torch.core import events as tevents
from repro_torch.core import session as tsession
from repro_torch.launch import analyze
from repro_torch.models import forward, init_params
from repro_torch.models import layers as tlayers
from test_torch_analyze import STEPS, _recorder, _reference_analyze

NEW_ARCHS = ["stablelm-1.6b", "gemma-7b", "qwen3-32b", "qwen2-vl-72b",
             "kimi-k2-1t-a32b", "musicgen-large"]
RTOL = ATOL = 1e-5


@pytest.fixture(autouse=True)
def _port_state(monkeypatch):
    monkeypatch.setenv("REPRO_PALLAS_INTERPRET", "0")   # reference: jnp path
    tevents.reset_seq()
    tsession.reset_state()
    yield
    tsession.reset_state()


def _inputs(cfg, seed=1):
    rng = np.random.default_rng(seed)
    if cfg.frontend == "embed":
        return rng.standard_normal((2, 64, cfg.d_model)).astype(np.float32)
    return rng.integers(0, cfg.vocab_size, size=(2, 64)).astype(np.int32)


def test_config_registry_has_every_reference_arch():
    assert TC.list_archs() == RC.list_archs()
    for arch in NEW_ARCHS:
        assert TC.get(arch).__dict__ == RC.get(arch).__dict__
        assert TC.reduced(TC.get(arch)).__dict__ == \
            RC.reduced(RC.get(arch)).__dict__
        assert TC.get(arch).n_params == RC.get(arch).n_params


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_logits_match_reference(arch):
    jcfg = RC.reduced(RC.get(arch))
    tcfg = TC.reduced(TC.get(arch))
    jparams = jinit_params(jax.random.PRNGKey(0), jcfg)
    x = _inputs(jcfg)
    want = np.asarray(jforward(jparams, x, jcfg)[0])
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    assert ("embed" in params) == (tcfg.frontend == "none")
    with torch.inference_mode():
        got = forward(params, torch.from_numpy(x), tcfg)[0].numpy()
    assert got.shape == want.shape == (2, 64, tcfg.vocab_size)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_init_params_layout_matches_reference(arch):
    """Same nested keys (q_norm / k_norm under qk-norm, no embed under the
    embed frontend), stacked shapes and dtypes as the reference."""
    jcfg = RC.reduced(RC.get(arch))
    want = jax.eval_shape(lambda: jinit_params(jax.random.PRNGKey(0), jcfg))
    got = init_params(TC.reduced(TC.get(arch)), seed=0, device="cpu")

    def layout(tree):
        if isinstance(tree, dict):
            return {k: layout(v) for k, v in tree.items()}
        return (tuple(tree.shape), str(tree.dtype).replace("torch.", ""))
    assert layout(got) == layout(want)


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_analyze_slice_matches_reference(arch):
    """examples/analyze_workload.py's sequence on both packages: identical
    event streams, reports and offload plans; logits within 1e-5."""
    tcfg = TC.reduced(TC.get(arch))
    port_stream, sessions = [], []

    def observe(session):
        sessions.append(session)
        session.handler.subscribe(_recorder(port_stream))
    reports, logits, schedule = analyze.run(tcfg, STEPS, "cpu",
                                            observe=observe)
    plans = analyze.offload_plans(schedule, sessions[0].pool)

    params_t, x_t = analyze.make_inputs(tcfg, 0, "cpu")
    if tcfg.frontend == "embed":
        assert x_t.shape == (2, 64, tcfg.d_model)
    jevents.reset_seq()
    ref_stream = []
    want_reports, want_logits, want_plans = _reference_analyze(
        RC.reduced(RC.get(arch)), params_t, x_t, ref_stream)

    assert len(port_stream) > 200
    assert port_stream == ref_stream
    for tool in ("workingset", "hotness", "locator"):
        assert reports[tool].data == want_reports[tool].data, tool
    assert reports["hotness"]["total_accesses"] > 0
    assert plans == want_plans
    np.testing.assert_allclose(logits.numpy(), want_logits, rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("head_dim", [16, 128])
def test_m_rope_sections_match_reference(head_dim):
    """Sectioned rotary with distinct temporal / height / width positions,
    and the text-only (B, S) stub, which equals plain RoPE."""
    rng = np.random.default_rng(head_dim)
    x = rng.standard_normal((2, 12, 3, head_dim)).astype(np.float32)
    pos3 = rng.integers(0, 50, size=(2, 12, 3)).astype(np.int32)
    pos2 = np.broadcast_to(np.arange(12, dtype=np.int32), (2, 12)).copy()
    for pos in (pos3, pos2):
        want = np.asarray(jlayers.apply_rope(jnp.asarray(x), jnp.asarray(pos),
                                             1e6, m_rope=True))
        got = tlayers.apply_rope(torch.from_numpy(x), torch.from_numpy(pos),
                                 1e6, m_rope=True).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    plain = tlayers.apply_rope(torch.from_numpy(x), torch.from_numpy(pos2),
                               1e6).numpy()
    np.testing.assert_array_equal(
        tlayers.apply_rope(torch.from_numpy(x), torch.from_numpy(pos2), 1e6,
                           m_rope=True).numpy(), plain)


def test_qk_norm_scales_match_reference():
    """qk-norm with non-zero q_norm / k_norm scales (init leaves them 0)."""
    jcfg = RC.reduced(RC.get("qwen3-32b"))
    tcfg = TC.reduced(TC.get("qwen3-32b"))
    rng = np.random.default_rng(3)
    jparams = jax.tree.map(np.asarray,
                           jinit_params(jax.random.PRNGKey(2), jcfg))
    attn = jparams["layers"]["attn"]
    for key in ("q_norm", "k_norm"):
        attn[key] = rng.standard_normal(attn[key].shape).astype(np.float32)
    x = _inputs(jcfg)
    want = np.asarray(jforward(jparams, x, jcfg)[0])
    params = params_from_numpy(jparams, "cpu")
    with torch.inference_mode():
        got = forward(params, torch.from_numpy(x), tcfg)[0].numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))
