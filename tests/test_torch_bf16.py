"""bf16 numerics of the port against the JAX package, on the CPU.

* The softmax scale: with ``attn_softmax_dtype="bfloat16"`` the reference
  multiplies the bf16 scores by 1/sqrt(D) rounded to bf16; a Python float
  would be applied in float32.  At head_dim 128 and 112 (whose 1/sqrt(D)
  is inexact in bf16) the port's ``_sdpa_dense`` equals the reference's
  bit for bit.
* The activations: ``layers._silu`` and ``layers._gelu`` take
  ``jax.nn.silu``'s and ``jax.nn.gelu``'s steps, each rounded to the
  input's dtype: bit for bit in bf16 on 10**5 values.  In float32 the two
  libraries' ``exp`` and ``tanh`` differ in the last bits (XLA's
  approximations against torch's; XLA's tanh saturates to -1 where
  torch's does not), so there the helpers agree within an absolute 1e-6
  (9.5e-7 measured on these values), not bit for bit.
* Whole models: every architecture at its reduced size with
  ``dtype="bfloat16"``.  The reference is run op by op (``jax.disable_jit``,
  which is how its instrumented analysis path runs) and compiled (its
  plain ``lax.scan`` forward, where XLA's fusion keeps float32 between
  fused elementwise operators instead of rounding each to bf16).  The mean
  and the max of |Δlogit| stay within the bounds below, each twice the
  gap measured with these weights and inputs.  The remaining gap comes
  from float32 functions whose last bits differ between the libraries
  (rmsnorm's rsqrt, RoPE's cos/sin, the SSD's exp), rounded to bf16, and
  from the order of float32 sums.  Identical greedy tokens is a float32
  guarantee only (tests/test_torch_models.py, tests/test_torch_archs.py).
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as RC
from repro.models import forward as jforward
from repro.models import init_params as jinit_params
from repro.models import layers as jlayers
import repro_torch.configs as TC
from repro_torch.convert import params_from_numpy
from repro_torch.core import events as tevents
from repro_torch.core import session as tsession
from repro_torch.models import forward
from repro_torch.models import layers as tlayers

#: float32 bound on |helper - jax.nn| over the 10**5 values of _values()
F32_ATOL = 1e-6

#: arch -> (op-by-op mean, op-by-op max, compiled mean, compiled max) of
#: |Δlogit| at bf16, each twice the gap measured after the bf16 fixes
BF16_BOUNDS = {
    "mamba2-2.7b": (0.0, 0.0, 1.8e-3, 1.3e-2),
    "stablelm-1.6b": (1.1e-3, 4.6e-2, 1.2e-2, 9.3e-2),
    "glm4-9b": (6.8e-6, 1.5e-2, 1.3e-2, 8.1e-2),
    "gemma-7b": (1.7e-4, 7.8e-3, 2.0e-3, 1.1e-2),
    "qwen3-32b": (1.6e-5, 1.5e-2, 1.3e-2, 1.3e-1),
    "zamba2-7b": (7.5e-3, 6.2e-2, 2.7e-2, 2.5e-1),
    "qwen2-vl-72b": (6.1e-10, 1.5e-5, 1.0e-2, 6.2e-2),
    "dbrx-132b": (2.0e-3, 5.4e-2, 1.4e-2, 1.0e-1),
    "kimi-k2-1t-a32b": (8.0e-6, 3.1e-2, 1.6e-2, 1.3e-1),
    "musicgen-large": (1.5e-3, 3.5e-2, 1.0e-2, 6.2e-2),
    "paper-gpt2": (1.7e-4, 7.8e-3, 1.9e-3, 1.5e-2),
    "paper-bert": (5.1e-3, 6.2e-2, 1.3e-2, 9.3e-2),
}


@pytest.fixture(autouse=True)
def _port_state():
    tevents.reset_seq()
    tsession.reset_state()
    yield
    tsession.reset_state()


def _bf16(a: np.ndarray):
    """The same bf16 values in both packages."""
    j = jnp.asarray(a).astype(jnp.bfloat16)
    t = torch.from_numpy(np.array(j.astype(jnp.float32))) \
        .to(torch.bfloat16)
    return j, t


def _values(dtype):
    v = np.random.default_rng(7).standard_normal(10 ** 5).astype(
        np.float32) * 4
    if dtype == "bfloat16":
        return _bf16(v)
    return jnp.asarray(v), torch.from_numpy(v)


@pytest.mark.parametrize("head_dim", [128, 112])
def test_bf16_softmax_scale_matches_reference(head_dim):
    assert float(torch.tensor(1 / math.sqrt(head_dim),
                              dtype=torch.bfloat16)) != 1 / math.sqrt(head_dim)
    rng = np.random.default_rng(head_dim)
    q = rng.standard_normal((2, 32, 2, 2, head_dim)).astype(np.float32)
    k = rng.standard_normal((2, 32, 2, head_dim)).astype(np.float32)
    v = rng.standard_normal((2, 32, 2, head_dim)).astype(np.float32)
    (jq, tq), (jk, tk), (jv, tv) = _bf16(q), _bf16(k), _bf16(v)
    want = jlayers._sdpa_dense(jq, jk, jv, True,
                               softmax_dtype=jnp.bfloat16)
    got = tlayers._sdpa_dense(tq, tk, tv, True,
                              softmax_dtype=torch.bfloat16)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want.astype(jnp.float32)))


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("name", ["silu", "gelu"])
def test_activation_helpers_match_jax(name, dtype):
    jx, tx = _values(dtype)
    want = np.asarray(getattr(jax.nn, name)(jx).astype(jnp.float32))
    got = getattr(tlayers, f"_{name}")(tx)
    assert got.dtype == tx.dtype
    got = got.float().numpy()
    if dtype == "bfloat16":
        np.testing.assert_array_equal(got, want)
    else:
        assert np.abs(got - want).max() <= F32_ATOL


def test_activation_helpers_fix_the_one_rounding():
    """``F.silu`` rounds once; in bf16 that differs from jax.nn.silu on a
    large share of values, which the helper does not."""
    jx, tx = _values("bfloat16")
    want = np.asarray(jax.nn.silu(jx).astype(jnp.float32))
    once = torch.nn.functional.silu(tx).float().numpy()
    assert (once != want).mean() > 0.1


def _bf16_case(arch):
    jcfg = dataclasses.replace(RC.reduced(RC.get(arch)), dtype="bfloat16")
    tcfg = dataclasses.replace(TC.reduced(TC.get(arch)), dtype="bfloat16")
    jparams = jinit_params(jax.random.PRNGKey(0), jcfg)
    rng = np.random.default_rng(1)
    if jcfg.frontend == "embed":
        x = rng.standard_normal((2, 64, jcfg.d_model)).astype(np.float32)
    else:
        x = rng.integers(0, jcfg.vocab_size, (2, 64)).astype(np.int32)
    return jcfg, tcfg, jparams, x


@pytest.mark.parametrize("arch", list(BF16_BOUNDS))
def test_bf16_logits_within_bound(arch):
    jcfg, tcfg, jparams, x = _bf16_case(arch)
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    with torch.inference_mode():
        got = forward(params, torch.from_numpy(x), tcfg)[0]
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    with jax.disable_jit():
        eager = np.asarray(jforward(jparams, jnp.asarray(x), jcfg)[0]
                           .astype(jnp.float32))
    compiled = np.asarray(jforward(jparams, jnp.asarray(x), jcfg)[0]
                          .astype(jnp.float32))
    mean_e, max_e, mean_c, max_c = BF16_BOUNDS[arch]
    d_e, d_c = np.abs(got - eager), np.abs(got - compiled)
    assert d_e.mean() <= mean_e and d_e.max() <= max_e, \
        (d_e.mean(), d_e.max())
    assert d_c.mean() <= mean_c and d_c.max() <= max_c, \
        (d_c.mean(), d_c.max())
