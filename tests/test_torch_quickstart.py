"""The eager half of examples/quickstart.py in both packages, at reduced
paper-gpt2: one ``Session(tools="kernel_freq,workingset,timeline",
instrument=True, fine=True, buffered=True)`` around a ``region("forward")``
forward pass.  Same weights (the reference's, moved through numpy), same
tokens; the three reports must be equal.  The example's compiled half
(capturing a compiled train step) waits for capture and training.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as RC
import repro.core as jpasta
from repro.core import events as jevents
from repro.models import forward as jforward
from repro.models import init_params as jinit_params
import repro_torch.configs as TC
import repro_torch.core as tpasta
from repro_torch.convert import params_from_numpy
from repro_torch.core import events as tevents
from repro_torch.core import session as tsession
from repro_torch.models import forward as tforward

TOOLS = "kernel_freq,workingset,timeline"


@pytest.fixture(autouse=True)
def _port_state():
    tevents.reset_seq()
    tsession.reset_state()
    yield
    tsession.reset_state()


def _eager_half(pasta, forward, params, x, cfg, **kw):
    with pasta.Session(tools=TOOLS, instrument=True, fine=True,
                       buffered=True, name="quickstart", **kw) as session:
        with pasta.region("forward"):
            logits, _ = forward(params, x, cfg)
    return session.reports(), np.asarray(logits)


def test_quickstart_eager_half_matches_reference():
    jcfg = RC.reduced(RC.get("paper-gpt2"))
    tcfg = TC.reduced(TC.get("paper-gpt2"))
    jparams = jinit_params(jax.random.PRNGKey(0), jcfg)
    x = np.random.default_rng(1).integers(0, jcfg.vocab_size, size=(2, 64)) \
        .astype(np.int32)
    jevents.reset_seq()
    want, want_logits = _eager_half(jpasta, jforward, jparams,
                                    jnp.asarray(x), jcfg)
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    with torch.inference_mode():
        got, logits = _eager_half(tpasta, tforward, params,
                                  torch.from_numpy(x), tcfg,
                                  torch_device="cpu")
    for tool in ("kernel_freq", "workingset", "timeline"):
        assert got[tool].data == want[tool].data, tool
    tl = got["timeline"]
    dev = tl["devices"][0]
    assert tl["peak_bytes"][dev] > 0
    assert tl["alloc_events"][dev] > tl["free_events"][dev] > 0
    assert {r for _s, _b, r in tl["series"][dev]} == {"forward"}
    assert got["workingset"]["working_set_mb"] > 0
    np.testing.assert_allclose(logits, want_logits, rtol=1e-5, atol=1e-5)
