"""examples/quickstart.py in both packages, at reduced paper-gpt2.

The eager half: one ``Session(tools="kernel_freq,workingset,timeline",
instrument=True, fine=True, buffered=True)`` around a ``region("forward")``
forward pass.  Same weights (the reference's, moved through numpy), same
tokens; the three reports must be equal.

The whole example: ``repro_torch.launch.quickstart`` adds the compiled
half, a profiled call of the train step handed to
``session.capture_compiled``.  Its kernel records are the port's own (aten
operators on the CPU, device kernels on the card), so its kernel_freq
report (and the workingset's kernel count) is held to the reference's keys
and invariants, while the rest of the workingset report and the timeline
stay equal to the reference example's.
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
from repro_torch.launch import quickstart as tquickstart
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


def _reference_example():
    """examples/quickstart.py's main() up to its reports."""
    from repro.train import OptConfig, make_train_step
    from repro.train.optimizer import init_opt_state
    cfg = RC.reduced(RC.get("paper-gpt2"))
    params = jinit_params(jax.random.PRNGKey(0), cfg)
    key = jax.random.PRNGKey(1)
    x = jax.random.randint(key, (2, 64), 0, cfg.vocab_size)
    labels = jax.random.randint(key, (2, 64), 0, cfg.vocab_size)
    with jpasta.Session(tools=TOOLS, instrument=True, fine=True,
                        buffered=True, name="quickstart") as session:
        with jpasta.region("forward"):
            logits, _ = jforward(params, x, cfg)
        opt_cfg = OptConfig()
        step = make_train_step(cfg, opt_cfg, microbatches=1)
        opt = init_opt_state(params, opt_cfg)
        compiled = jax.jit(step).lower(
            params, opt, {"inputs": x, "labels": labels}).compile()
        session.capture_compiled(compiled, label="train_step",
                                 default_trip=cfg.n_layers, steps=5)
    return session.reports()


def test_quickstart_compiled_half():
    tcfg = TC.reduced(TC.get("paper-gpt2"))
    got, artifact, stats = tquickstart.run(tcfg, "cpu")
    jevents.reset_seq()
    want = _reference_example()
    kf, wkf = got["kernel_freq"], want["kernel_freq"]
    assert got["timeline"].data == want["timeline"].data
    # the workingset tool also counts the captured kernels
    ws, wws = dict(got["workingset"].data), dict(want["workingset"].data)
    assert ws.pop("kernel_count") == kf["total_invocations"]
    assert wws.pop("kernel_count") == wkf["total_invocations"]
    assert ws == wws
    assert set(kf.data) == set(wkf.data)
    assert kf["total_invocations"] == sum(stats.kernel_counts.values()) * 5
    assert kf["total_invocations"] > 0 and kf["distinct_kernels"] > 0
    counts = [c for _n, c in kf["top"]]
    assert counts == sorted(counts, reverse=True)
    assert set(kf["by_label"]) == set(wkf["by_label"]) == {"train_step"}
    assert artifact.device == "cpu" and stats.flops > 0
    # the step ran for real: the loss of the profiled call is finite
    assert np.isfinite(float(artifact.result[2]["loss"]))


def test_quickstart_cli_prints_the_example_lines(capsys):
    tquickstart.main(["--device", "cpu"])
    out = capsys.readouterr().out
    for line in ("== PASTA tool reports ==", "kernel_freq: total=",
                 "workingset: footprint=", "timeline: peak=",
                 '{"tool": "kernel_freq"'):
        assert line in out
