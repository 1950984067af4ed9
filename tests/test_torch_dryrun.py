"""The port's dry-run (``repro_torch.launch.dryrun``) and its shapes
(``repro_torch.configs.shapes``) against the JAX package's, on the CPU.

* ``SHAPES``, ``get_shape`` and ``cells_for`` equal the reference's.
* A reduced cell of each kind (train, prefill, decode; long_500k skipped
  on a full-attention arch, run on an ssm arch) traced on a small fake
  data × model mesh returns the reference's result keys (read from the
  reference's source, which the test process cannot run: its dry-run
  forces 512 host devices), plus the port's trace fields.
* ``state_bytes_per_device`` equals the sum of the local shard bytes of
  the placed state (fake DTensors on the same mesh).
* ``main`` exits 2 when a cell fails to trace.
"""

import ast
import dataclasses
import os

import pytest
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import distribute_tensor
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.testing._internal.distributed.fake_pg import FakeStore

import repro.configs as RC
from repro.configs import shapes as jshapes
import repro_torch.configs as TC
from repro_torch.configs import shapes as tshapes
from repro_torch.core import events as tevents
from repro_torch.core import session as tsession
from repro_torch.dist import sharding as tsh
from repro_torch.launch import dryrun
from repro_torch.train import OptConfig
from repro_torch.train.optimizer import tree_map
from repro_torch.train.trainer import serve_shardings, train_shardings

SMALL = {"seq_len": 64, "global_batch": 8}
REFERENCE_DRYRUN = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src", "repro", "launch", "dryrun.py")
PORT_KEYS = {"trace_s", "layers_traced", "layers_total",
             "microbatches_traced"}


@pytest.fixture(autouse=True)
def _port_state():
    tevents.reset_seq()
    tsession.reset_state()
    yield
    tsession.reset_state()
    tsh.set_mesh(None)


def reference_keys() -> tuple:
    """``(top-level keys, "hlo" keys)`` of the reference's dry-run result
    (the dict literal its ``run_cell`` returns), read from its source."""
    with open(REFERENCE_DRYRUN) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict) \
                and any(getattr(t, "id", "") == "out" for t in node.targets):
            keys = [k.value for k in node.value.keys]
            if "hlo" in keys:
                hlo = node.value.values[keys.index("hlo")]
                return set(keys), {k.value for k in hlo.keys}
    raise ValueError(f"no result dict in {REFERENCE_DRYRUN}")


def test_shapes_equal_the_reference():
    assert {k: dataclasses.asdict(v) for k, v in tshapes.SHAPES.items()} \
        == {k: dataclasses.asdict(v) for k, v in jshapes.SHAPES.items()}
    for name in jshapes.SHAPES:
        assert dataclasses.asdict(tshapes.get_shape(name)) == \
            dataclasses.asdict(jshapes.get_shape(name))
    assert TC.ASSIGNED == RC.ASSIGNED
    for arch in RC.ASSIGNED:
        assert tshapes.cells_for(TC.get(arch)) == \
            jshapes.cells_for(RC.get(arch)), arch


@pytest.mark.parametrize("arch,shape", [
    ("qwen3-32b", "train_4k"), ("qwen3-32b", "prefill_32k"),
    ("qwen3-32b", "decode_32k"), ("mamba2-2.7b", "long_500k"),
    ("zamba2-7b", "decode_32k")])
def test_reduced_cell_returns_the_reference_keys(arch, shape):
    keys, hlo_keys = reference_keys()
    out, lint = dryrun.run_cell(arch, shape, multi_pod=False, device="cpu",
                                reduced=True, mesh_shape=(2, 2),
                                shape_overrides=SMALL)
    assert out["status"] == "ok"
    assert set(out) == keys | PORT_KEYS
    assert set(out["hlo"]) == hlo_keys
    assert out["mesh"] == "2x2" and out["chips"] == 4
    assert out["hlo"]["flops_per_device"] > 0
    assert out["hlo"]["hbm_bytes_per_device"] > 0
    assert out["memory_analysis"]["peak_bytes"] >= \
        out["state_bytes_per_device"]
    assert out["lint"]["spec"] and lint is not None
    assert out["roofline"]["bottleneck"] in ("compute", "memory",
                                             "collective")
    assert not dist.is_initialized()


@pytest.mark.parametrize("arch,rc", [("qwen3-32b", 0), ("no-such-arch", 2)])
def test_main_exits_2_when_a_cell_fails_to_trace(arch, rc, tmp_path,
                                                 monkeypatch):
    """A cell that fails still writes its error JSON, and the exit status
    says so (a skipped cell is no failure)."""
    monkeypatch.setattr(dryrun, "RESULTS_DIR", str(tmp_path))
    assert dryrun.main(["--arch", arch, "--shape", "long_500k",
                        "--device", "cpu"]) == rc
    (path,) = tmp_path.iterdir()
    status = "error" if rc else "skipped"
    assert f'"status": "{status}"' in path.read_text()


def test_full_attention_arch_skips_long_context():
    out, lint = dryrun.run_cell("qwen3-32b", "long_500k", multi_pod=False,
                                device="cpu", reduced=True)
    assert out["status"] == "skipped" and lint is None


def _local_bytes(shapes, shardings, mesh) -> int:
    with FakeTensorMode():
        placed = tree_map(lambda t, sh: distribute_tensor(
            torch.empty(t.shape, dtype=t.dtype), mesh, sh), shapes,
            shardings)
    total = 0
    for leaf in tree_map(lambda t: t._local_tensor, placed).values():
        stack = [leaf]
        while stack:
            x = stack.pop()
            if isinstance(x, dict):
                stack.extend(x.values())
            else:
                total += x.numel() * x.element_size()
    return total


@pytest.mark.parametrize("arch,shape", [("qwen3-32b", "train_4k"),
                                        ("zamba2-7b", "decode_32k")])
def test_state_bytes_per_device_is_the_local_shard_bytes(arch, shape):
    out, _lint = dryrun.run_cell(arch, shape, multi_pod=False, device="cpu",
                                 reduced=True, mesh_shape=(2, 2),
                                 shape_overrides=SMALL)
    cfg = TC.reduced(TC.get(arch))
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=4)
    try:
        mesh = init_device_mesh("cpu", (2, 2),
                                mesh_dim_names=("data", "model"))
        if shape == "train_4k":
            opt = OptConfig(moment_dtype=cfg.opt_moment_dtype)
            p_sh, o_sh, p_shapes, o_shapes = train_shardings(mesh, cfg, opt)
            want = _local_bytes(p_shapes, p_sh, mesh) + \
                _local_bytes(o_shapes, o_sh, mesh)
        else:
            p_sh, c_sh, p_shapes, c_shapes = serve_shardings(
                mesh, cfg, SMALL["global_batch"], SMALL["seq_len"])
            want = _local_bytes(p_shapes, p_sh, mesh) + \
                _local_bytes(c_shapes, c_sh, mesh)
    finally:
        dist.destroy_process_group()
    assert out["state_bytes_per_device"] == want > 0
