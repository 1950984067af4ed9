"""A microbatched train step's memory, traced under fake tensors.

The reference accumulates its microbatches in a ``lax.scan`` body, where a
microbatch's gradient tree is dead once it has been added to the carry.
The port's loop must free it too: a step that kept the last microbatch's
tree alive through the update held one gradient tree more than the same
step at one microbatch.  And the static peak estimate
(``analysis.memory``) must hold the tree the update reads, which at more
than one microbatch is the summed tree divided by the count, not a
backward's output.

Setup: a 4-layer stablelm-1.6b variant (d_model 256, d_ff 1024, vocab
4096, float32), batch 4 x 64 on one device, and the dry-run's
``build_cell`` cut to seq 64, batch 8 on a fake data 2 x model 2 mesh.
Before the repair the one-device mark at m = 2 and m = 4 read 188,819,540
B against m = 1's 166,790,220 B (estimate / mark 0.8611), and on the mesh
m = 2 read estimate / mark 0.8062 (gather_params_once) and 0.8553 against
m = 1's 0.9128.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import pytest

from repro_torch.core import events as tevents
from repro_torch.core import session as tsession


@pytest.fixture(autouse=True)
def _port_state():
    tevents.reset_seq()
    tsession.reset_state()
    yield
    tsession.reset_state()


def _cfg(**kw):
    import repro_torch.configs as TC
    return dataclasses.replace(TC.reduced(TC.get("stablelm-1.6b")),
                               n_layers=4, d_model=256, d_ff=1024,
                               vocab_size=4096, **kw)


def _one_device(m: int):
    """(trace, params) of the one-device step at ``m`` microbatches."""
    import torch
    from repro_torch.core.trace import trace_step
    from repro_torch.models import init_params
    from repro_torch.train import OptConfig, init_opt_state, make_train_step
    cfg = _cfg()
    params = init_params(cfg, 0, "cpu")
    opt = OptConfig()
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (4, 65)))
    trace = trace_step(make_train_step(cfg, opt, microbatches=m), params,
                       init_opt_state(params, opt),
                       {"inputs": toks[:, :-1], "labels": toks[:, 1:]},
                       device_type="cpu")
    return trace, params


def _mesh(m: int, gather_params_once: bool):
    """The trace of ``build_cell``'s step on a fake data 2 x model 2 mesh
    (``gather_params_once`` acts only at more than one microbatch)."""
    from repro_torch.configs.shapes import Shape
    from repro_torch.core.trace import trace_step
    from repro_torch.launch.dryrun import build_cell
    cfg = _cfg(gather_params_once=gather_params_once)
    step, setup, meta = build_cell(cfg, Shape("train_cut", "train", 64, 8,
                                              microbatches=m),
                                   {"data": 2, "model": 2}, device="cpu")
    assert meta["microbatches"] == m
    return trace_step(step, mesh_shape=(2, 2), mesh_dims=("data", "model"),
                      device_type="cpu", setup=setup)


@pytest.fixture(scope="module")
def one_device():
    """``_one_device``, each ``m`` traced once for the module."""
    return functools.cache(_one_device)


@pytest.fixture(scope="module")
def mesh():
    """``_mesh``, each case traced once for the module."""
    return functools.cache(_mesh)


def _ratio(trace) -> float:
    from repro_torch.analysis import estimate_peak_bytes
    return estimate_peak_bytes(trace)["peak_bytes"] \
        / trace.measured_peak_bytes


@pytest.mark.parametrize("m", [2, 4])
def test_microbatched_step_holds_one_gradient_tree(one_device, m):
    """The fake run's mark is no higher than one microbatch's, and the
    estimate holds exactly the tree the update reads: one tree of bytes,
    none of it a backward's output."""
    from repro_torch.analysis.memory import _held_grads
    from repro_torch.train.optimizer import tree_paths
    one, params = one_device(1)
    trace, _ = one_device(m)
    assert trace.measured_peak_bytes <= one.measured_peak_bytes, \
        (trace.measured_peak_bytes, one.measured_peak_bytes)
    ratio = _ratio(trace)
    assert 0.95 <= ratio <= 1.0, ratio
    held = _held_grads(trace)
    assert sum(trace.storage_bytes[s] for s in held) == \
        sum(p.numel() * 4 for _path, p in tree_paths(params))
    bwd = {s for r in trace.records if r.backward for s in r.out_ids}
    assert not held & bwd


@pytest.mark.parametrize("gather_params_once", [True, False],
                         ids=["gather_params_once", "sharded_params"])
def test_microbatched_mesh_step_estimate_and_mark(mesh, gather_params_once):
    """On the mesh, m = 2's estimate / mark is at least m = 1's; with the
    params gathered once, m = 2 marks no more than m = 1 (the gathered
    copy is live there, as the reference's update reads it too)."""
    one = mesh(1, False)
    two = mesh(2, gather_params_once)
    assert _ratio(two) >= _ratio(one), (_ratio(two), _ratio(one))
    if gather_params_once:
        assert two.measured_peak_bytes <= one.measured_peak_bytes, \
            (two.measured_peak_bytes, one.measured_peak_bytes)
