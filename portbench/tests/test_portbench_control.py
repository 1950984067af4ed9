"""The comparison fails what it has to fail: the control (the reference
in float8 in the program's place) and faults planted under a whole run
of each cell, on the CPU at a tiny size; the control at the cells' own
size on the card."""

import importlib.util
import json

import pytest
import torch

import small
from conftest import ROOT
from portbench import harness

spec = importlib.util.spec_from_file_location(
    "portbench_calibrate", ROOT / "portbench" / "calibrate.py")
calibrate = importlib.util.module_from_spec(spec)
spec.loader.exec_module(calibrate)


def _limit(name):
    return json.loads((ROOT / "portbench" / "limits" / f"{name}.json")
                      .read_text())["logit_err"]


@pytest.mark.parametrize("seed", [1, 2, 3])
@pytest.mark.parametrize("name", small.CELLS)
def test_the_control_fails_the_limit(name, seed, monkeypatch):
    monkeypatch.setattr(torch.cuda, "empty_cache", lambda: None)
    assert calibrate.control_reading(small.cell(name), seed, "cpu") > _limit(name)


def _stale(real):
    """A step that returns the previous step's logits."""
    prev = []

    def forward(params, x, cfg, *a, **kw):
        out = real(params, x, cfg, *a, **kw)
        prev.append(out)
        return prev[-2] if len(prev) > 1 else out
    return forward


def _half(real):
    """Half of the batch left out; its rows take the mean of the rest."""
    def forward(params, x, cfg, *a, **kw):
        logits, cache = real(params, x[: x.shape[0] // 2], cfg, *a, **kw)
        rest = logits.float().mean(dim=0, keepdim=True).to(logits.dtype)
        return torch.cat([logits, rest.expand_as(logits)]), cache
    return forward


def _token(real):
    """One position's logits altered where they are produced."""
    def forward(params, x, cfg, *a, **kw):
        logits, cache = real(params, x, cfg, *a, **kw)
        logits[:, -1] = logits[:, -1].roll(1, dims=-1)
        return logits, cache
    return forward


@pytest.mark.parametrize("fault", [_stale, _half, _token])
@pytest.mark.parametrize("name", small.CELLS)
def test_a_broken_forward_is_not_correct(name, fault, monkeypatch):
    from repro_torch.models import lm
    monkeypatch.setattr(lm, "forward", fault(lm.forward))
    res = small.run(name, seconds=0.0)
    assert not res["correct"]
    assert res["checks"]["logit_err"]["value"] > _limit(name)


@pytest.mark.parametrize("name", small.CELLS)
def test_an_altered_count_is_not_correct(name, monkeypatch):
    from repro_torch.kernels import ops
    for fn in ("object_histogram_t", "trace_aggregate_t"):
        real = getattr(ops, fn)

        def altered(*a, _real=real, **kw):
            out = _real(*a, **kw)
            counts = out[0] if isinstance(out, tuple) else out
            counts[0] += 1
            return out
        monkeypatch.setattr(ops, fn, altered)
    res = small.run(name, seconds=0.0)
    assert not res["correct"] and res["checks"]["bad_buffers"]["value"] > 0


@pytest.mark.parametrize("name", small.CELLS)
def test_a_dropped_trace_buffer_is_not_correct(name, monkeypatch):
    from repro_torch.core.instrument import EagerInstrumenter
    real = EagerInstrumenter._emit_trace
    calls = []

    def sometimes(self, name_, handles):
        calls.append(name_)
        if len(calls) != 3:
            real(self, name_, handles)
    monkeypatch.setattr(EagerInstrumenter, "_emit_trace", sometimes)
    res = small.run(name, seconds=0.0)
    assert not res["correct"] and res["checks"]["buffer_gap"]["value"] == 1


@pytest.mark.parametrize("name", small.CELLS)
def test_a_lost_operand_is_not_correct(name, monkeypatch):
    """The instrumenter reports one operator without its last operand; the
    replay, which takes the operands it was given, agrees with the
    buffers, and the operand check against the shapes catches it."""
    from repro_torch.core.instrument import EagerInstrumenter
    real = EagerInstrumenter.op

    def short(self, name_, inputs, outputs):
        if name_ == "attn.out_proj":
            outputs = outputs[:-1]
        real(self, name_, inputs, outputs)
    monkeypatch.setattr(EagerInstrumenter, "op", short)
    res = small.run(name, seconds=0.0)
    assert not res["correct"] and res["checks"]["bad_operators"]["value"] > 0
    assert res["checks"]["bad_buffers"]["value"] == 0


@pytest.mark.cuda
@pytest.mark.parametrize("name", small.CELLS)
def test_the_control_fails_at_the_cells_size_on_the_card(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cell = harness.load_cell(ROOT, name)
    for seed in (11, 12, 13):
        assert calibrate.control_reading(cell, seed, "cuda") > _limit(name)
