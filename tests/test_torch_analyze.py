"""The whole slice: examples/analyze_workload.py on the JAX package against
``repro_torch.launch.analyze.run(device="cpu")``, at reduced glm4-9b
(dense), zamba2-7b (hybrid), mamba2-2.7b (ssm) and dbrx-132b (moe).

Both sides get the same weights and tokens (the port's, moved through
numpy).  Their event streams must be identical in kind, name, size and
address (the wall-clock ``time`` column aside), their workingset /
hotness / locator reports and offload plans equal, and their logits within
rtol = atol = 1e-5 (float32 on both sides, sums in a different order).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as RC
import repro.core as jpasta
from repro.core import events as jevents
from repro.core.pool import CHUNK_ALIGN
from repro.core.tools import offload as joffload
from repro.models import forward as jforward
import repro_torch.configs as TC
from repro_torch.core import events as tevents
from repro_torch.core import session as tsession
from repro_torch.launch import analyze

STEPS = 4
RTOL = ATOL = 1e-5


@pytest.fixture(autouse=True)
def _port_state(monkeypatch):
    monkeypatch.setenv("REPRO_PALLAS_INTERPRET", "0")   # reference: jnp path
    tevents.reset_seq()
    tsession.reset_state()
    yield
    tsession.reset_state()


def _recorder(store):
    return lambda e: store.append((e.kind.value, e.name, e.size, e.addr))


def _jax_tree(tree):
    if isinstance(tree, dict):
        return {k: _jax_tree(v) for k, v in tree.items()}
    return jnp.asarray(tree.numpy())


def _reference_analyze(cfg, params_t, x_t, stream):
    """examples/analyze_workload.py's sequence as a function, on the given
    weights and tokens; returns (reports, logits, plans)."""
    hot_cfg = {"base": CHUNK_ALIGN, "n_blocks": 256,
               "n_tbins": STEPS, "t_max": float(STEPS),
               "block_shift": 5}
    session = jpasta.Session(
        tools=["workingset",
               jpasta.HotnessTool(n_tbins=STEPS, n_blocks=256,
                                  hot_frac=0.75),
               "locator"],
        hotness=hot_cfg, instrument=True, fine=True,
        pool_chunk=128 << 10, pool_align=4 << 10,
        name=f"analyze/{cfg.name}")
    handler = session.handler
    session.instrumenter.time_source = \
        lambda: float(max(handler._step, 0))
    handler.subscribe(_recorder(stream))

    params = _jax_tree(params_t)
    x = jnp.asarray(x_t.numpy())

    schedule = []
    addr2obj = {}
    handler.subscribe(
        lambda e: addr2obj.update({e.addr: (e.attrs["object_id"], e.size,
                                            e.attrs["tensor_id"])}),
        kinds=("tensor_alloc",))

    def grab(ev):
        tensors = [(addr2obj.get(a, (0, s, a))[2], s,
                    addr2obj.get(a, (0, s, a))[0])
                   for a, s in ev.attrs.get("tensors", ())]
        if tensors:
            schedule.append(joffload.KernelAccess(
                ev.name, max(sum(s for _t, s, _o in tensors) / 20e9, 5e-5),
                tensors))
    handler.subscribe(grab, kinds=("operator_start",))

    with session:
        for s in range(STEPS):
            handler.step_start(s)
            logits = np.array(jforward(params, x, cfg)[0])
            handler.step_end(s)

    reports = session.reports()
    objects = {o.oid: o.size for o in session.pool.objects.values()}
    plans = {ov: joffload.plan(schedule, objects, session.pool.footprint, ov)
             for ov in (1.0, 3.0)}
    return reports, logits, plans


@pytest.mark.parametrize("arch", ["glm4-9b", "zamba2-7b", "mamba2-2.7b",
                                  "dbrx-132b"])
def test_analyze_slice_matches_reference(arch):
    tcfg = TC.reduced(TC.get(arch))
    port_stream, sessions = [], []

    def observe(session):
        sessions.append(session)
        session.handler.subscribe(_recorder(port_stream))
    reports, logits, schedule = analyze.run(tcfg, STEPS, "cpu",
                                            observe=observe)
    plans = analyze.offload_plans(schedule, sessions[0].pool)

    params_t, x_t = analyze.make_inputs(tcfg, 0, "cpu")
    assert x_t.dtype == torch.int32
    jevents.reset_seq()
    ref_stream = []
    want_reports, want_logits, want_plans = _reference_analyze(
        RC.reduced(RC.get(arch)), params_t, x_t, ref_stream)

    assert len(port_stream) > 200
    assert port_stream == ref_stream
    kinds = {k for k, *_ in port_stream}
    assert {"trace_buffer", "tensor_alloc", "tensor_free",
            "operator_start", "alloc"} <= kinds
    for tool in ("workingset", "hotness", "locator"):
        assert reports[tool].data == want_reports[tool].data, tool
    assert reports["hotness"]["total_accesses"] > 0
    assert plans == want_plans
    np.testing.assert_allclose(logits.numpy(), want_logits, rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("arch,n_layers", [("glm4-9b", None),
                                           ("zamba2-7b", None),
                                           ("mamba2-2.7b", None),
                                           ("dbrx-132b", 4)])
def test_hotness_config_sizes_the_map(arch, n_layers):
    """The map covers the (cut) model's parameter bytes with the fewest
    blocks of the smallest size that fits in 4096 blocks."""
    reduced = TC.reduced(TC.get(arch))
    assert analyze.hotness_config(reduced, 4) == {
        "base": CHUNK_ALIGN, "n_blocks": 256, "n_tbins": 4, "t_max": 4.0,
        "block_shift": 5}
    full = TC.get(arch)
    if n_layers is not None:
        full = dataclasses.replace(full, n_layers=n_layers)
    hot = analyze.hotness_config(full, 4)
    covered = hot["n_blocks"] * (512 << hot["block_shift"])
    assert hot["n_blocks"] <= analyze.MAX_BLOCKS
    assert covered >= full.n_params * 4 > covered - (512 << hot["block_shift"])
    assert analyze.MAX_BLOCKS * (512 << (hot["block_shift"] - 1)) \
        < full.n_params * 4


def test_cli_prints_the_example_summary(capsys):
    analyze.main(["--arch", "paper-gpt2", "--reduced", "--steps", "2",
                  "--device", "cpu"])
    out = capsys.readouterr().out
    for line in ("== paper-gpt2 characterization ==", "working set: max=",
                 "hotness: persistent(pin)=", "offload @ oversubscription"):
        assert line in out
