"""Step traces (``repro_torch.core.trace``), on the CPU.

* A trace of a reduced train step rolls up to exactly what
  ``core.capture.analyze`` measures over a real CPU call of the same step
  on the same inputs: the same FLOPs and ``hbm_bytes`` (both count every
  non-view aten call's operand and result bytes, and the same FLOP rules),
  and the same kernel records.
* A scaled trace — two of four layers and one of two microbatches, each
  record scaled by its trip count — is within 1% of the full trace on
  FLOPs, bytes and collective bytes, on a fake 8-rank 2×2×2 mesh.
* An in-place cache write counts the rows it writes and the values and
  indices it reads, not the whole cache, as the reference's
  ``dynamic-update-slice``: the same bytes whatever ``max_seq``.
* Each collective's group maps to the mesh axes it spans on the 2×2×2
  mesh, the pod sync's collectives are paired with their marked waits,
  and the trace refuses to run inside an initialized process group.

Inputs are made from a seeded ``np.random.default_rng``.
"""

import dataclasses

import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.distributed.tensor import distribute_tensor

import repro_torch.configs as TC
from repro_torch.core import capture
from repro_torch.core import events as tevents
from repro_torch.core import session as tsession
from repro_torch.core.trace import analyze_trace, group_axes, trace_step
from repro_torch.dist import sharding as tsh
from repro_torch.models import init_cache, init_params
from repro_torch.train import (OptConfig, init_opt_state, make_decode_step,
                               make_train_step)
from repro_torch.train.optimizer import tree_map
from repro_torch.train.trainer import batch_shardings, train_shardings

MESH = ((2, 2, 2), ("pod", "data", "model"))


@pytest.fixture(autouse=True)
def _port_state():
    tevents.reset_seq()
    tsession.reset_state()
    yield
    tsession.reset_state()
    tsh.set_mesh(None)


def _batch(cfg, b=4, s=16, seed=0):
    rng = np.random.default_rng(seed)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (b, s + 1)))
    return {"inputs": toks[:, :-1].contiguous(),
            "labels": toks[:, 1:].contiguous()}


@pytest.mark.parametrize("arch", ["stablelm-1.6b", "mamba2-2.7b"])
def test_trace_equals_capture_of_a_real_call(arch):
    cfg = TC.reduced(TC.get(arch))
    opt = OptConfig()
    params = init_params(cfg, 0, "cpu")
    state = init_opt_state(params, opt)
    batch = _batch(cfg)
    step = make_train_step(cfg, opt)
    trace = trace_step(step, params, state, batch, device_type="cpu")
    got = analyze_trace(trace)
    want = capture.analyze(capture.capture_step(step, params, state, batch))
    assert got.flops == want.flops
    assert got.hbm_bytes == want.hbm_bytes
    assert sum(got.kernel_counts.values()) == \
        sum(want.kernel_counts.values())
    assert sorted(got.kernel_meta[k]["opcode"] for k in got.kernel_counts) \
        == sorted(want.kernel_meta[k]["opcode"] for k in want.kernel_counts)
    # the fake process group is gone with the trace
    assert not dist.is_initialized()


@pytest.mark.parametrize("kind", ["capture", "trace"])
def test_a_cache_write_counts_its_rows_not_the_cache(kind):
    """One decode step's in-place K/V writes (the ``put`` plan's
    ``index_put_``) on reduced glm4-9b: the bytes of each are its two new
    rows written and the values and indices read, at max_seq 64 and 4096
    alike."""
    cfg = TC.reduced(TC.get("glm4-9b"))
    params = init_params(cfg, 0, "cpu")
    step = make_decode_step(cfg)
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 1)))
    got = {}
    for max_seq in (64, 4096):
        cache = init_cache(cfg, 2, max_seq, "cpu")
        if kind == "capture":
            recs = capture.capture_step(step, params, cache, toks).ops
        else:
            recs = trace_step(step, params, cache, toks,
                              device_type="cpu").records
        got[max_seq] = [(r.in_bytes, r.out_bytes) for r in recs
                        if r.name == "aten::index_put_"]
    rows = 2 * cfg.n_kv_heads * cfg.head_dim * 4        # float32
    assert len(got[64]) == 2 * cfg.n_layers
    assert got[64] == got[4096]
    assert all(out == rows and in_b == rows + 2 * 8
               for in_b, out in got[64])


def _mesh_step(arch, layers, microbatches, overlap):
    cfg = dataclasses.replace(TC.reduced(TC.get(arch)), n_layers=layers)
    opt = OptConfig()
    batch = 16

    def setup(mesh):
        p_sh, o_sh, p_shapes, o_shapes = train_shardings(mesh, cfg, opt)

        def make(t, sh):
            return distribute_tensor(torch.empty(t.shape, dtype=t.dtype),
                                     mesh, sh)

        b = {"inputs": torch.zeros((batch, 32), dtype=torch.int64),
             "labels": torch.zeros((batch, 32), dtype=torch.int64)}
        b_sh = batch_shardings(mesh, b, include_pod=overlap is None)
        return (tree_map(make, p_shapes, p_sh), tree_map(make, o_shapes, o_sh),
                tree_map(lambda t, sh: distribute_tensor(t, mesh, sh), b,
                         b_sh))

    step = make_train_step(cfg, opt, microbatches=microbatches,
                           overlap_sync=overlap, sync_compressed=True,
                           sync_buckets=4)
    return step, setup


@pytest.fixture(scope="module")
def full_and_cut():
    """qwen3-32b reduced to 4 layers, 2 microbatches, the overlapped int8
    pod sync: its full trace and its trace cut to 2 layers and 1
    microbatch."""
    step, setup = _mesh_step("qwen3-32b", 4, 2, True)
    kw = dict(mesh_shape=MESH[0], mesh_dims=MESH[1], device_type="cpu",
              setup=setup)
    return (trace_step(step, **kw),
            trace_step(step, cuts={"layers": 2, "microbatches": 1}, **kw))


def test_scaled_trace_is_within_one_percent_of_the_full_trace(full_and_cut):
    full_trace, cut_trace = full_and_cut
    full, cut = analyze_trace(full_trace), analyze_trace(cut_trace)
    assert {r.mult for r in cut_trace.records} > {1.0}
    assert len(cut_trace.records) < len(full_trace.records)
    assert (cut_trace.layers_traced, cut_trace.layers_total,
            cut_trace.microbatches_traced, cut_trace.microbatches_total) \
        == (2, 4, 1, 2)
    assert (full_trace.layers_traced, full_trace.microbatches_traced) == \
        (4, 2)
    for what in ("flops", "hbm_bytes", "total_collective_bytes",
                 "total_wire_bytes"):
        a, b = getattr(full, what), getattr(cut, what)
        assert a > 0 and abs(b - a) <= 0.01 * a, (what, a, b)


def test_collective_groups_map_to_mesh_axes(full_and_cut):
    trace = full_and_cut[0]
    colls = [r for r in trace.records if r.opcode]
    by_axes = {}
    for r in colls:
        by_axes.setdefault(r.axes, set()).add(r.group)
    # rank 0's group along each axis of the row-major 2x2x2 mesh
    assert by_axes[("model",)] == {(0, 1)}
    assert by_axes[("data",)] == {(0, 2)}
    assert by_axes[("pod",)] == {(0, 4)}
    assert all(r.crosses_pods == (r.axes == ("pod",)) for r in colls
               if r.axes is not None and len(r.axes) == 1)
    # the pod sync's async calls are paired with their marked waits
    psum = [r for r in colls if "psum_start" in r.op_name]
    assert psum and all(r.wait is not None and trace.records[r.wait].is_wait
                        for r in psum)
    # the reference's golden groups, through the same mapping
    mesh = dict(zip(*reversed(MESH)))
    assert group_axes([[0, 1], [2, 3], [4, 5], [6, 7]], mesh) == \
        (("model",), False)
    assert group_axes([[0, 4], [1, 5], [2, 6], [3, 7]], mesh) == \
        (("pod",), True)
    assert group_axes([[0, 1, 2, 3], [4, 5, 6, 7]], mesh) == \
        (("data", "model"), False)
    assert group_axes([[0, 3], [1, 2], [4, 7], [5, 6]], mesh) == \
        (None, False)


def test_trace_refuses_an_initialized_group(tmp_path):
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=2)
    try:
        with pytest.raises(RuntimeError, match="initialized"):
            trace_step(lambda: None, device_type="cpu")
    finally:
        dist.destroy_process_group()
