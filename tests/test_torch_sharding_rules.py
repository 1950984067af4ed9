"""The port's rule table (``repro_torch.dist.sharding``) against the JAX
package's, in one process.

The meshes are ``DeviceMesh``es on the CPU over a ``fake`` process group
of the mesh's size (no collective moves data; placements, groups and
coordinates are real), beside the reference's duck-typed meshes of the
same shape.  Every case of tests/test_sharding_rules.py has a counterpart
here, and every leaf of ``param_axes`` of the twelve architectures, at
full size (shapes from the ``meta`` device), resolves to the reference's
``PartitionSpec`` on a data × model and a pod × data × model mesh, with
placements that realise it.  Resolution is exact: no tolerance.
"""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import DTensor, Replicate, Shard, \
    distribute_tensor
from torch.testing._internal.distributed.fake_pg import FakeStore

import repro.configs as RC
from repro.dist import collectives as jcoll
from repro.dist import sharding as jsh
from repro.models import init_params as jinit_params
from repro.models import param_axes as jparam_axes
import repro_torch.configs as TC
from repro_torch.core import events as tevents
from repro_torch.core import session as tsession
from repro_torch.dist import collectives as tcoll
from repro_torch.dist import sharding as tsh
from repro_torch.dist.pipeline import make_pipelined_fn
from repro_torch.launch import mesh as tmesh
from repro_torch.models import param_axes
from repro_torch.train.trainer import abstract_state, batch_spec

#: the activation names models.{layers,lm,moe,mamba2} annotate
ACTIVATION_AXES = [
    "batch", "seq", "seq_sp", "heads", "kv_heads", "head_dim", "embed",
    "ff", "vocab", "experts", "experts_ep", "expert_ff", "p_ssm_inner",
    "ssm_heads",
]
SHAPES = {"dm": ((2, 4), ("data", "model")),
          "pod": ((2, 2, 2), ("pod", "data", "model"))}


@pytest.fixture(autouse=True)
def _port_state():
    tevents.reset_seq()
    tsession.reset_state()
    yield
    tsession.reset_state()
    tsh.set_mesh(None)


def _fake_world(n: int) -> None:
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)


@pytest.fixture()
def meshes():
    """{"dm": data 2 × model 4, "pod": pod 2 × data 2 × model 2} as
    (DeviceMesh, the reference's duck-typed mesh of the same shape)."""
    _fake_world(8)
    try:
        yield {k: (init_device_mesh("cpu", shape, mesh_dim_names=names),
                   types.SimpleNamespace(shape=dict(zip(names, shape)),
                                         axis_names=names))
               for k, (shape, names) in SHAPES.items()}
    finally:
        dist.destroy_process_group()


def _axes_leaves(tree, prefix=()):
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from _axes_leaves(v, (*prefix, k))
        else:
            yield (*prefix, k), v


def _at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _spec_of(placements, mesh, ndim: int) -> tuple:
    """The per-tensor-dimension spec that ``placements`` realise."""
    per_dim: list = [[] for _ in range(ndim)]
    for name, p in zip(mesh.mesh_dim_names, placements):
        if isinstance(p, Shard):
            per_dim[p.dim].append(name)
    return tuple(None if not a else a[0] if len(a) == 1 else tuple(a)
                 for a in per_dim)


def _check(axes, mesh, fake, dims=None):
    """resolve() equals the reference's logical(); logical()'s placements
    realise it."""
    want = tuple(jsh.logical(*axes, dims=dims, mesh=fake))
    got = tsh.resolve(*axes, dims=dims, mesh=mesh)
    assert got == want, (axes, dims, got, want)
    pl = tsh.logical(*axes, dims=dims, mesh=mesh)
    assert len(pl) == mesh.ndim
    assert all(isinstance(p, (Shard, Replicate)) for p in pl)
    assert _spec_of(pl, mesh, len(axes)) == want


def _cfgs(arch):
    jcfg, tcfg = RC.get(arch), TC.get(arch)
    out = [(jcfg, tcfg)]
    if jcfg.n_experts:                    # both MoE parallelism modes
        out.append((dataclasses.replace(jcfg, moe_parallelism="ep"),
                    dataclasses.replace(tcfg, moe_parallelism="ep")))
    return out


@pytest.mark.parametrize("arch", RC.list_archs())
def test_param_axes_resolve_as_the_reference(meshes, arch):
    for jcfg, tcfg in _cfgs(arch):
        jaxes, taxes = jparam_axes(jcfg), param_axes(tcfg)
        assert taxes == jax.tree.map(
            tuple, jaxes, is_leaf=lambda x: isinstance(x, tuple))
        shapes, _ = abstract_state(tcfg)
        jshapes = jax.eval_shape(
            lambda c=jcfg: jinit_params(jax.random.PRNGKey(0), c))
        for path, ax in _axes_leaves(taxes):
            dims = tuple(_at(shapes, path).shape)
            assert dims == tuple(_at(jshapes, path).shape), path
            for mesh, fake in meshes.values():
                _check(ax, mesh, fake, dims)
                _check(ax, mesh, fake)


def test_default_rules_cover_every_model_axis_name(meshes):
    assert tsh.DEFAULT_RULES == jsh.DEFAULT_RULES
    names = set(ACTIVATION_AXES)
    for arch in RC.list_archs():
        for _jcfg, tcfg in _cfgs(arch):
            for _path, ax in _axes_leaves(param_axes(tcfg)):
                names.update(a for a in ax if a is not None)
    assert names <= set(tsh.DEFAULT_RULES)
    mesh, fake = meshes["pod"]
    for n in sorted(names):
        _check((n,), mesh, fake)


def test_logical_resolves_named_axes(meshes):
    mesh, fake = meshes["dm"]
    for axes in [("p_vocab", "p_embed"), ("p_embed", "p_ff"), ("seq_sp",),
                 ("p_ssm_inner",), ("expert_ff",), (None, "seq", "embed")]:
        _check(axes, mesh, fake)
    assert tsh.logical("p_vocab", "p_embed", mesh=mesh) == (Shard(1),
                                                            Shard(0))


def test_logical_batch_composes_pod_and_data(meshes):
    mesh, fake = meshes["pod"]
    _check(("batch",), mesh, fake)
    assert tsh.resolve("batch", mesh=mesh) == (("pod", "data"),)
    # pod major, data minor: Shard(0) on both, in mesh order
    assert tsh.logical("batch", mesh=mesh) == (Shard(0), Shard(0),
                                               Replicate())
    mesh, fake = meshes["dm"]
    _check(("batch",), mesh, fake)
    assert tsh.resolve("batch", mesh=mesh) == ("data",)


def test_logical_drops_duplicate_physical_axes(meshes):
    mesh, fake = meshes["dm"]
    _check(("p_experts", "p_embed", "p_expert_ff"), mesh, fake)
    assert tsh.resolve("p_experts", "p_embed", "p_expert_ff",
                       mesh=mesh) == ("data", None, "model")


def test_logical_divisibility_filter(meshes):
    mesh, fake = meshes["dm"]
    _check(("p_embed", "p_kv_heads", None), mesh, fake, (64, 1, 16))
    _check(("p_embed", "p_heads", None), mesh, fake, (64, 4, 16))
    assert tsh.resolve("p_embed", "p_kv_heads", None, dims=(64, 1, 16),
                       mesh=mesh) == ("data", None, None)
    mesh, fake = meshes["pod"]
    for b in (1, 2, 4, 6, 8):              # (pod, data) keeps what divides
        _check(("batch", "embed"), mesh, fake, (b, 64))


def test_logical_rank_mismatch_raises_with_dims(meshes):
    mesh, _fake = meshes["dm"]
    with pytest.raises(ValueError):
        tsh.logical("p_embed", "p_ff", dims=(64,), mesh=mesh)


def test_logical_unknown_axis_raises(meshes):
    mesh, _fake = meshes["dm"]
    with pytest.raises(KeyError):
        tsh.logical("p_nonexistent", mesh=mesh)


def test_logical_needs_a_mesh():
    with pytest.raises(ValueError):
        tsh.logical("batch")


def test_shard_is_noop_without_mesh_or_on_a_plain_tensor(meshes):
    x = torch.ones((4, 8))
    assert tsh.shard(x, "batch", "embed") is x
    tsh.set_mesh(meshes["dm"][0])
    assert tsh.shard(x, "batch", "embed") is x


def test_shard_rank_mismatch_is_tolerated_hint(meshes):
    mesh = meshes["dm"][0]
    tsh.set_mesh(mesh)
    x = distribute_tensor(torch.ones((4, 8)), mesh,
                          (Replicate(), Replicate()))
    assert tsh.shard(x, "batch") is x          # rank-1 hint on rank 2
    y = tsh.shard(x, "batch", "embed")         # matching rank constrains
    assert isinstance(y, DTensor)
    assert tuple(y.placements) == (Shard(0), Replicate())
    assert tsh.shard(y, "batch", "embed") is y   # already laid out


def test_set_mesh_rules_override_and_reset(meshes):
    mesh, fake = meshes["dm"]
    tsh.set_mesh(mesh, tsh.ShardingRules({**tsh.DEFAULT_RULES,
                                          "p_embed": None}))
    assert tsh.get_mesh() is mesh
    assert tsh.get_rules()["p_embed"] is None
    assert tsh.resolve("p_embed") == (None,)
    tsh.set_mesh(mesh, tsh.get_rules())
    assert tsh.get_rules()["p_embed"] is None
    tsh.set_mesh(mesh)
    assert tsh.get_rules() == tsh.DEFAULT_RULES
    assert tsh.resolve("p_embed") == ("data",)


def test_mesh_axis_size_defaults_to_one(meshes):
    tsh.set_mesh(None)
    assert tsh.mesh_axis_size("data") == 1
    tsh.set_mesh(meshes["pod"][0])
    assert tsh.mesh_axis_size("data") == 2
    tsh.set_mesh(meshes["dm"][0])
    assert tsh.mesh_axis_size("model") == 4
    assert tsh.mesh_axis_size("pod") == 1     # absent axis


def test_batch_spec_drops_what_does_not_divide(meshes):
    mesh = meshes["pod"][0]
    assert batch_spec(mesh, 8) == (Shard(0), Shard(0), Replicate())
    assert batch_spec(mesh, 2) == (Shard(0), Replicate(), Replicate())
    assert batch_spec(mesh, 8, include_pod=False) == (
        Replicate(), Shard(0), Replicate())
    assert batch_spec(mesh, 3) == (Replicate(),) * 3


def test_intent_model_matches_reference(meshes):
    for key, (mesh, fake) in meshes.items():
        for kind in ("train", "serve"):
            assert tsh.intended_collectives(mesh=mesh, kind=kind) == \
                jsh.intended_collectives(mesh=fake, kind=kind), (key, kind)
    assert tsh.RESHARD_OPCODES == jsh.RESHARD_OPCODES
    axes = {"pod": 2, "data": 2, "model": 2}
    rng = np.random.default_rng(3)
    cases = [[[0, 1], [2, 3], [4, 5], [6, 7]], [[0, 4], [1, 5], [2, 6],
                                                  [3, 7]],
             [[0, 2, 4, 6], [1, 3, 5, 7]], [[0, 1, 2, 3, 4, 5, 6, 7]],
             [[0, 3], [1, 2]], [], [[0, 9]]]
    cases += [rng.permutation(8).reshape(-1, k).tolist() for k in (2, 4)]
    for groups in cases:
        assert tsh.axes_of_replica_groups(groups, axes) == \
            jsh.axes_of_replica_groups(groups, axes), groups


def test_quantize_int8_matches_reference(rng):
    x = (rng.standard_normal((16, 64)) * 3.0).astype(np.float32)
    x[0, :4] = [127.0, 0.5, 1.5, -2.5]       # exact halves of the scale
    x[1] = 0.0
    jq, js = jcoll.quantize_int8(jnp.asarray(x))
    q, s = tcoll.quantize_int8(torch.from_numpy(x))
    assert q.dtype == torch.int8 and tuple(s.shape) == (16, 1)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    np.testing.assert_array_equal(tcoll.dequantize_int8(q, s).numpy(),
                                  np.asarray(jcoll.dequantize_int8(jq, js)))
    x3 = rng.standard_normal((2, 3, 5)).astype(np.float32)
    q3, s3 = tcoll.quantize_int8(torch.from_numpy(x3))
    assert tuple(q3.shape) == x3.shape and tuple(s3.shape) == (2, 3, 1)


@pytest.mark.parametrize("n", [1, 2, 4, 8])
def test_simulated_compressed_psum_matches_reference(n):
    """The numpy mirror equals the reference's bit for bit, ragged
    payloads (padding) included."""
    rng = np.random.default_rng(n)
    for shape in ((16, 48), (5, 7), (13,)):
        stacked = rng.standard_normal((n, *shape)).astype(np.float32)
        np.testing.assert_array_equal(
            tcoll.simulate_compressed_psum(stacked),
            jcoll.simulate_compressed_psum(stacked))


def test_pipeline_rejects_bad_meshes(meshes):
    mesh = meshes["dm"][0]
    with pytest.raises(ValueError, match="pipe"):
        make_pipelined_fn(mesh, lambda w, x: x, 2, 1)


def test_pipeline_rejects_stage_and_layer_mismatch():
    _fake_world(8)
    try:
        mesh = init_device_mesh("cpu", (4, 2),
                                mesh_dim_names=("pipe", "data"))
        with pytest.raises(ValueError, match="n_stages"):
            make_pipelined_fn(mesh, lambda w, x: x, 2, 1)
        fn = make_pipelined_fn(mesh, lambda w, x: x, 4, 2)
        with pytest.raises(ValueError, match="layers"):
            fn(torch.zeros((6, 2, 2)), torch.zeros((3, 2, 2)))
    finally:
        dist.destroy_process_group()


def test_production_and_debug_mesh_shapes():
    _fake_world(512)
    try:
        m = tmesh.make_production_mesh(multi_pod=True, device_type="cpu")
        assert m.mesh_dim_names == ("pod", "data", "model")
        assert tmesh.mesh_name(m) == "2x16x16" and tmesh.n_chips(m) == 512
    finally:
        dist.destroy_process_group()
    _fake_world(256)
    try:
        m = tmesh.make_production_mesh(device_type="cpu")
        assert m.mesh_dim_names == ("data", "model")
        assert tmesh.mesh_name(m) == "16x16" and tmesh.n_chips(m) == 256
    finally:
        dist.destroy_process_group()
    _fake_world(8)
    try:
        m = tmesh.make_debug_mesh(2, 4, device_type="cpu")
        assert tmesh.mesh_name(m) == "2x4" and tmesh.n_chips(m) == 8
    finally:
        dist.destroy_process_group()
