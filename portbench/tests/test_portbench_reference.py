"""The plain references against the port on tiny configurations on the
CPU: the weight tree's layout, the forward's logits, the operators a
forward reports, and whole runs of each cell."""

import pytest
import torch

import small
from portbench import check, reflib, weights


def _shapes(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _shapes(v, prefix + (k,))
        else:
            yield prefix + (k,), tuple(v.shape), v.dtype


@pytest.mark.parametrize("name", small.CELLS)
def test_weight_layout_is_the_ports(name):
    from repro_torch.models import init_params
    from repro_torch.models.config import ModelConfig
    cell = small.cell(name)
    ours = weights.draw(cell.reference.layout(cell.ref_cfg),
                        weights.generator(1, "cpu"), "cpu")
    port = init_params(ModelConfig(**cell.model), 0, "cpu")
    assert sorted(_shapes(ours)) == sorted(_shapes(port))


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5), ("bfloat16", 2e-2)])
@pytest.mark.parametrize("name", small.CELLS)
def test_reference_logits_match_the_ports_forward(name, dtype, tol):
    from repro_torch.models import forward
    from repro_torch.models.config import ModelConfig
    cell = small.cell(name, dtype=dtype)
    cfg = cell.ref_cfg
    gen = weights.generator(3, "cpu")
    params = weights.draw(cell.reference.layout(cfg), gen, "cpu")
    x = weights.tokens(cfg, gen, 2, 64, "cpu")
    rows = check.sample_rows(3, 2, 64)
    idx = tuple(torch.as_tensor(r) for r in rows)
    with torch.inference_mode():
        port = forward(params, x, ModelConfig(**cell.model))[0][idx]
        ref = reflib.head_rows(params, cell.reference.hidden(params, x, cfg),
                               idx, cfg, "bf16")
    assert check.logit_err(port, ref) <= tol


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("name", small.CELLS)
def test_a_whole_run_is_correct(name, trace):
    res = small.run(name, seconds=0.2, trace=trace)
    assert res["correct"], res["checks"]
    assert list(res)[-1] == "checks"
    assert res["checks"]["buffer_gap"]["value"] == 0
    assert res["checks"]["bad_operators"]["value"] == 0
    assert res["attempted"] >= 1 and res["failed"] == 0
    names = set(res["metrics"])
    if trace:
        assert {"plain_step_ms", "slowdown_x", "hook_ms_per_step",
                "emit_ms_per_step", "analysis_ms_per_buffer"} <= names
        assert ("locator_ms_per_step" in names) == name.endswith("hotness")
        assert "busy_s" in res["device"] and "breakdown" in res
    else:
        assert {"tokens_per_s", "setup_s"} <= names


@pytest.mark.parametrize("name", small.CELLS)
def test_the_operators_are_the_ports(name):
    """The reference's operators are those the port reports, step by step,
    with the bytes of each operand."""
    from repro_torch.core.events import EventKind, KIND_CODE
    from repro_torch.models import forward
    from repro_torch.models.config import ModelConfig
    import repro_torch.core as pasta
    cell = small.cell(name)
    cfg = cell.ref_cfg
    gen = weights.generator(5, "cpu")
    params = weights.draw(cell.reference.layout(cfg), gen, "cpu")
    clock = [0]
    log = check.Recorder(clock)
    session = pasta.Session(tools=[], instrument=True, fine=False,
                            torch_device="cpu")
    session.handler.subscribe_batch(log)
    with torch.inference_mode(), session:
        for step in range(2):
            clock[0] = step
            forward(params, weights.tokens(cfg, gen, 2, 64, "cpu"),
                    ModelConfig(**cell.model))
    session.close()
    op = int(KIND_CODE[EventKind.OPERATOR_START])
    codes = {"tensor_alloc": -1, "tensor_free": -2, "operator_start": op,
             "trace_buffer": -3}
    seen = check.replay(log.log, codes, None, 512, 64)["operators"]
    want = cell.reference.operators(cfg, 2, 64)
    assert seen[0] == want and seen[1] == want
    assert check.wrong_steps(seen, want, 2) == []
    assert check.wrong_steps(seen, want[:-1], 2)[0][:2] == (0, len(want) - 1)


def test_a_coarse_session_is_checked_without_new_code():
    """A session file with ``"fine": false`` (operator events, no trace
    buffer) runs and is checked by the same loop and replay."""
    import time
    from portbench import harness
    cell = small.cell("glm4-9b.fine-objects")
    cell.session = {**cell.session, "fine": False}
    res = harness.run_cell(cell, 7, 0.0, False, "cpu", time.perf_counter())
    assert res["correct"], res["checks"]
    assert res["checks"]["buffer_gap"]["value"] == 0
