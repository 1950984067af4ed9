"""Compiled-step capture and the roofline on the port, against the JAX
package's HLO walker (``repro/core/hlo.py``), on the CPU.

There is no torch artifact to match the reference's HLO text byte for
byte, so the port's capture is held to the reference's invariants: the
``GridIdFilter`` environment interface; FLOPs of a product (exact here:
the reference's scan test allows 20%, since its walker counts from the
HLO, while the port counts the products that ran); FLOPs of the same
forward; the events' order and attr keys; the kernel_freq and roofline
reports' sums; and the roofline arithmetic.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as RC
import repro.core as jpasta
from repro.core import hlo as jhlo
from repro.core.tools import roofline as jroofline
from repro.models import forward as jforward
from repro.models import init_params as jinit_params
from repro.train import OptConfig as JOptConfig
from repro.train import make_train_step as jmake_train_step
from repro.train.optimizer import init_opt_state as jinit_opt_state
import repro_torch.configs as TC
import repro_torch.core as tpasta
from repro_torch.convert import params_from_numpy
from repro_torch.core import capture
from repro_torch.core import events as tevents
from repro_torch.core import session as tsession
from repro_torch.core.tools import roofline as troofline
from repro_torch.models import forward
from repro_torch.train import OptConfig, make_train_step
from repro_torch.train.optimizer import init_opt_state

#: |port - reference| / reference FLOPs of the reduced paper-gpt2 forward,
#: measured 2.87e-3: the port counts one FLOP per output element of each
#: aten pointwise operator, the reference one per element of each XLA
#: elementwise opcode, and the two graphs split the same math into
#: slightly different elementwise steps (the products agree exactly)
FORWARD_FLOPS_RTOL = 3e-3
STEPS = 5


@pytest.fixture(autouse=True)
def _port_state():
    tevents.reset_seq()
    tsession.reset_state()
    yield
    tsession.reset_state()


def _record(handler):
    seen = []
    handler.subscribe(seen.append,
                      kinds=("compile", "kernel_launch", "collective"))
    return seen


def _gpt2_step():
    """The quickstart's train step on reduced paper-gpt2 in both packages:
    (reference compiled executable, port artifact, both configs, batch)."""
    jcfg = RC.reduced(RC.get("paper-gpt2"))
    tcfg = TC.reduced(TC.get("paper-gpt2"))
    jparams = jinit_params(jax.random.PRNGKey(0), jcfg)
    rng = np.random.default_rng(1)
    x = rng.integers(0, jcfg.vocab_size, size=(2, 64)).astype(np.int32)
    labels = rng.integers(0, jcfg.vocab_size, size=(2, 64)).astype(np.int32)
    jo = JOptConfig()
    compiled = jax.jit(jmake_train_step(jcfg, jo, microbatches=1)).lower(
        jparams, jinit_opt_state(jparams, jo),
        {"inputs": x, "labels": labels}).compile()
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    artifact = capture.capture_step(
        make_train_step(tcfg, OptConfig(), microbatches=1), params,
        init_opt_state(params, OptConfig()),
        {"inputs": torch.from_numpy(x), "labels": torch.from_numpy(labels)})
    return compiled, artifact, tcfg


def test_grid_filter_env(monkeypatch):
    monkeypatch.setenv("START_GRID_ID", "5")
    monkeypatch.setenv("END_GRID_ID", "7")
    f = tpasta.GridIdFilter()
    assert not f(4) and f(5) and f(7) and not f(8)
    assert tpasta.EventHandler().grid_filter.start_id == 5


def test_product_flops_are_exact():
    c = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (64, 64)).astype(np.float32))

    def chain(x):
        for _ in range(7):
            x = x @ x
        return x
    with tpasta.Session(tools=(), torch_device="cpu") as s:
        one = s.capture_compiled(
            capture.capture_step(lambda x: x @ x, c), label="mm")
        seven = s.capture_compiled(capture.capture_step(chain, c),
                                   label="chain7")
    assert one.flops == 2 * 64 ** 3
    assert seven.flops == 7 * 2 * 64 ** 3
    assert one.kernel_counts == {"aten::mm.0": 1}
    assert seven.kernel_counts == {"aten::mm.0": 7}
    # operand and result bytes of the product, per launch
    assert one.kernel_meta["aten::mm.0"]["bytes"] == 3 * 64 * 64 * 4
    assert seven.hbm_bytes == 7 * 3 * 64 * 64 * 4


def test_callable_is_captured_on_the_named_device():
    """A step is captured where its tensor arguments lie, and a closure
    (no tensor argument) on the card: without one, the handler's callable
    path raises instead of running on the CPU."""
    c = torch.ones((8, 8))
    art = capture.capture_step(lambda t: t @ t, c)
    assert art.device == "cpu" and art.matmul_flops == 2 * 8 ** 3
    assert torch.equal(art.result, c @ c)
    if torch.cuda.is_available():
        pytest.skip("a card is present; the capture would run on it")
    with tpasta.Session(tools=(), torch_device="cpu") as s:
        with pytest.raises((RuntimeError, AssertionError)):
            s.capture_compiled(lambda: c @ c)


def test_forward_flops_match_reference():
    jcfg = RC.reduced(RC.get("paper-gpt2"))
    tcfg = TC.reduced(TC.get("paper-gpt2"))
    jparams = jinit_params(jax.random.PRNGKey(0), jcfg)
    x = np.random.default_rng(1).integers(0, jcfg.vocab_size, size=(2, 64)) \
        .astype(np.int32)
    text = jax.jit(lambda p, t: jforward(p, t, jcfg)[0]).lower(
        jparams, x).compile().as_text()
    want = jhlo.analyze_text(text)
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    with torch.inference_mode():
        art = capture.capture_step(lambda p, t: forward(p, t, tcfg)[0],
                                   params, torch.from_numpy(x))
    got = capture.analyze(art)
    assert got.flops == pytest.approx(want.flops, rel=FORWARD_FLOPS_RTOL)
    # the products alone: 2·m·n·k per einsum, as the walker's dots count
    assert art.matmul_flops > 0.9 * want.flops
    assert set(vars(got)) == set(vars(want))
    assert got.collective_instances == [] == want.collective_instances


def test_quickstart_numbers():
    """kernel_freq's total is Σ count × steps; a narrower GridIdFilter
    drops exactly the rows outside it; the roofline's hbm_bytes is
    Σ bytes × count and its flops come from the COMPILE event."""
    _compiled, artifact, _cfg = _gpt2_step()
    stats = capture.analyze(artifact)
    assert stats.flops > 0 and stats.hbm_bytes > 0
    with tpasta.Session(tools="kernel_freq,roofline", torch_device="cpu",
                        name="capture") as s:
        seen = _record(s.handler)
        s.capture_compiled(artifact, label="train_step", steps=STEPS,
                           cost_analysis={"flops": stats.flops})
    rep = s.reports()
    launches = [e for e in seen if e.kind.value == "kernel_launch"]
    assert len(launches) == len(stats.kernel_counts)
    assert rep["kernel_freq"]["total_invocations"] == \
        sum(stats.kernel_counts.values()) * STEPS
    assert rep["kernel_freq"]["distinct_kernels"] > 10
    top = [c for _n, c in rep["kernel_freq"]["top"]]
    assert top == sorted(top, reverse=True)
    rl = rep["roofline"]
    assert rl["hbm_bytes"] == pytest.approx(stats.hbm_bytes * STEPS)
    assert rl["hbm_bytes"] == pytest.approx(sum(
        e.attrs["bytes"] * e.attrs["count"] for e in launches))
    assert rl["flops"] == stats.flops
    assert rl["kernel_invocations"] == rep["kernel_freq"]["total_invocations"]

    tsession.reset_state()
    with tpasta.Session(tools="kernel_freq", torch_device="cpu") as s2:
        s2.handler.grid_filter = tpasta.GridIdFilter(2, 5)
        seen2 = _record(s2.handler)
        s2.capture_compiled(artifact, label="train_step", steps=STEPS)
    kept = [e for e in seen2 if e.kind.value == "kernel_launch"]
    assert [e.attrs["grid_id"] for e in kept] == [2, 3, 4, 5]
    assert [e.name for e in kept] == [e.name for e in launches[2:6]]
    assert s2.reports()["kernel_freq"]["total_invocations"] == \
        sum(e.attrs["count"] for e in launches[2:6])


def test_events_have_the_reference_shape():
    """The same step captured by both packages: one COMPILE first, then one
    KERNEL_LAUNCH per kernel, then the COLLECTIVEs (none on one device),
    with the reference's attr keys."""
    compiled, artifact, _cfg = _gpt2_step()
    with jpasta.Session(tools=(), name="ref") as js:
        want = _record(js.handler)
        js.capture_compiled(compiled, label="train_step", default_trip=2,
                            steps=STEPS)
    with tpasta.Session(tools=(), torch_device="cpu", name="port") as ts:
        got = _record(ts.handler)
        ts.capture_compiled(artifact, label="train_step", default_trip=2,
                            steps=STEPS)

    def shape(events):
        kinds = [e.kind.value for e in events]
        keys = {(e.kind.value, tuple(sorted(e.attrs))) for e in events}
        return kinds[0], sorted(set(kinds)), keys
    assert shape(got) == shape(want)
    assert [e.kind.value for e in got][1:] == ["kernel_launch"] * \
        (len(got) - 1)
    assert [e.attrs["grid_id"] for e in got[1:]] == list(range(len(got) - 1))
    assert all(e.attrs["label"] == "train_step" for e in got[1:])


@pytest.mark.parametrize("which", ["reference", "port"])
def test_roofline_arithmetic_matches_reference(which):
    hw = dict(jroofline.V5E if which == "reference" else troofline.H100)
    args = (3.1e12, 4.5e9, 2.0e8)
    want = jroofline.roofline(*args, model_flops_per_chip=2.2e12, hw=hw)
    got = troofline.roofline(*args, model_flops_per_chip=2.2e12, hw=hw)
    w, g = want.as_dict(), got.as_dict()
    assert set(g) == set(w)
    for k in w:
        if k == "roofline_fraction":
            continue
        assert g[k] == w[k], k
    # the port divides by the peak of the hw it was given; the reference
    # by its built-in table's whatever hw it was given
    assert g["roofline_fraction"] == pytest.approx(
        w["roofline_fraction"] * jroofline.V5E["peak_flops"]
        / hw["peak_flops"], rel=1e-12)
    assert troofline.model_flops(1e9, 1e3) == jroofline.model_flops(1e9, 1e3)


def test_roofline_tool_matches_reference_on_one_stream():
    """Both RooflineTools (each on its own hw table) over the same events:
    the same sums and, scaled to one table, the same terms."""
    from repro.core.events import Event as JEvent, EventKind as JKind
    from repro_torch.core.events import Event as TEvent, EventKind as TKind
    rows = [("compile", "s", 0, {"cost_analysis": {"flops": 5e9}}),
            ("kernel_launch", "k.0", 0, {"count": 10, "bytes": 4096}),
            ("kernel_launch", "k.1", 0, {"count": 3, "bytes": 512}),
            ("collective", "ar", 1 << 20, {"mult": 2.0})]
    tools = (jroofline.RooflineTool(hw=troofline.H100),
             troofline.RooflineTool())
    for tool, (ev, kind) in zip(tools, ((JEvent, JKind), (TEvent, TKind))):
        for k, name, size, attrs in rows:
            getattr(tool, f"on_{k}")(ev(kind(k), name=name, size=size,
                                        attrs=attrs))
    w, g = tools[0].finalize(), tools[1].finalize()
    assert g == w
