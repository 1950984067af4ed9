"""Rank programs of tests/test_torch_dist.py: one spawn of WORLD gloo ranks
on the CPU that runs every case and writes each case's results as .npz
files.  It imports neither ``jax`` nor the JAX package: the test process
writes the inputs (the reference's weights, batches and payloads) and
holds the results against the reference.

    PYTHONPATH=src python tests/_torch_dist_ranks.py <dir> <world> <timeout>
        [case,...]

The optional last argument names the cases to run (default: ``CASES``).
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np
import torch
import torch.distributed as dist


def _tree(npz) -> dict:
    """{"a/b/c": array} → nested dict of CPU tensors."""
    out: dict = {}
    for key in npz.files:
        node = out
        *head, leaf = key.split("/")
        for k in head:
            node = node.setdefault(k, {})
        node[leaf] = torch.from_numpy(np.array(npz[key]))
    return out


def _flat(tree, prefix="") -> dict:
    from torch.distributed.tensor import DTensor
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            v = v.full_tensor() if isinstance(v, DTensor) else v
            out[f"{prefix}{k}"] = v.detach().numpy()
    return out


def _placements(x) -> np.ndarray:
    """A DTensor's placements as "S<dim>", "R" or "P", one per mesh
    dimension (``str`` of a placement differs between torch releases)."""
    return np.array([f"S{p.dim}" if p.is_shard() else
                     "P" if p.is_partial() else "R" for p in x.placements])


def _save(out_dir: str, name: str, **arrays) -> None:
    np.savez(os.path.join(out_dir, f"{name}.npz"), **arrays)


# ------------------------------------------------------------ collectives
def case_collectives(rank: int, d: str) -> None:
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from repro_torch.dist import collectives as C
    from repro_torch.dist.sharding import set_mesh

    inp = np.load(os.path.join(d, "in_collectives.npz"))
    mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("pod", "data"))
    set_mesh(mesh)
    out = {}
    for name in ("grad", "ragged"):
        x = torch.from_numpy(inp[name][rank])
        out[f"{name}_cp_pod"] = C.compressed_psum(x, "pod")
        out[f"{name}_pp_pod"] = C.plain_psum(x, "pod")
        out[f"{name}_cp_world"] = C.compressed_psum(x, None)
        out[f"{name}_pp_world"] = C.plain_psum(x, None)
    # pipelined start/wait over the world, payloads that need padding
    for comp in (False, True):
        xs = [torch.from_numpy(inp[f"sw{i}"][rank]) for i in range(3)]
        prev, outs = None, []
        for t in xs:
            h = C.psum_start(t, None, compressed=comp)
            if prev is not None:
                outs.append(C.psum_wait(prev, None))
            prev = h
        outs.append(C.psum_wait(prev, None))
        for i, o in enumerate(outs):
            out[f"sw{i}_{'c' if comp else 'p'}"] = o
    # blocking pod sync of a data-sharded, pod-replicated DTensor tree
    g = distribute_tensor(torch.from_numpy(inp["tree"]), mesh,
                          (Replicate(), Shard(0)))
    for key, kw in (("sync_p", {}), ("sync_c", {"compressed": True}),
                    ("sync_mean", {"mean": True})):
        synced = C.make_pod_sync(mesh, **kw)({"g": g, "n": torch.ones(
            (), dtype=torch.int32)})
        out[key] = synced["g"].full_tensor()
        assert synced["n"].dtype == torch.int32
    # a checkpoint of the DTensor (rank 0 writes the whole tensor),
    # restored with other placements on the registered mesh
    from repro_torch.train import checkpoint as ckpt
    path = os.path.join(d, "ckpt")
    ckpt.save(path, 1, {"w": g, "n": torch.tensor(3)})
    _step, back = ckpt.restore(path, {"w": g, "n": torch.tensor(3)},
                               shardings={"w": (Shard(0), Shard(1)),
                                          "n": (Replicate(), Replicate())})
    assert tuple(back["w"].placements) == (Shard(0), Shard(1))
    out["ckpt_w"] = back["w"].full_tensor()
    out["ckpt_n"] = back["n"].full_tensor()
    set_mesh(None)
    _save(d, f"collectives_r{rank}",
          **{k: v.numpy() for k, v in out.items()})


# --------------------------------------------------------- sharded steps
def _sharded_step(rank, d, case, arch, shape, names, microbatches,
                  gather_once=False, key=None):
    import dataclasses
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor.experimental import implicit_replication
    import repro_torch.configs as TC
    from repro_torch.dist.sharding import set_mesh
    from repro_torch.train import OptConfig, make_train_step
    from repro_torch.train.optimizer import init_opt_state
    from repro_torch.train.trainer import (_loss_and_grads, batch_shardings,
                                           place, train_shardings)

    key = key or arch
    with open(os.path.join(d, "overrides.json")) as f:
        cfg = dataclasses.replace(TC.reduced(TC.get(arch)),
                                  **json.load(f).get(key, {}))
    inp = np.load(os.path.join(d, f"in_{key}.npz"))
    params = _tree(np.load(os.path.join(d, f"w_{key}.npz")))
    batch = {"inputs": torch.from_numpy(inp["inputs"]),
             "labels": torch.from_numpy(inp["labels"])}
    mesh = init_device_mesh("cpu", shape, mesh_dim_names=names)
    set_mesh(mesh)
    opt_cfg = OptConfig(lr=1e-3)
    p_sh, _o_sh, _, _ = train_shardings(mesh, cfg, opt_cfg)
    dp = place(params, p_sh, mesh)
    db = place(batch, batch_shardings(mesh, batch), mesh)
    t0 = time.perf_counter()
    with implicit_replication():
        loss, _parts, grads = _loss_and_grads(dp, db["inputs"],
                                              db["labels"], cfg)
        loss = loss.full_tensor()
    out = {"loss_full": loss.numpy(),
           **{f"grad/{k}": v for k, v in _flat(grads).items()}}
    runs = [("", cfg)]
    if gather_once:
        runs.append(("once_", dataclasses.replace(cfg,
                                                  gather_params_once=True)))
    for tag, c in runs:
        step = make_train_step(c, opt_cfg, microbatches=microbatches)
        new_p, _new_o, m = step(dp, init_opt_state(dp, opt_cfg), db)
        out.update({f"{tag}m/{k}": v.numpy() for k, v in m.items()})
        out.update({f"{tag}param/{k}": v
                    for k, v in _flat(new_p).items()})
    out["seconds"] = np.float64(time.perf_counter() - t0)
    set_mesh(None)
    if rank == 0:
        _save(d, case, **out)


def case_step_qwen3(rank, d):
    _sharded_step(rank, d, "step_qwen3", "qwen3-32b", (2, 2),
                  ("data", "model"), 2, gather_once=True)


def case_step_dbrx(rank, d):
    _sharded_step(rank, d, "step_dbrx", "dbrx-132b", (2, 2),
                  ("data", "model"), 1)


def case_step_dbrx_model(rank, d):
    # "pipe" is in no rule: two replicas of a model-2 mesh without a data
    # dimension (data degree 1)
    _sharded_step(rank, d, "step_dbrx_model", "dbrx-132b", (2, 2),
                  ("pipe", "model"), 1)


def case_step_ssm(rank, d):
    _sharded_step(rank, d, "step_ssm", "mamba2-2.7b", (2, 2),
                  ("data", "model"), 1)


def case_step_hybrid(rank, d):
    _sharded_step(rank, d, "step_hybrid", "zamba2-7b", (2, 2),
                  ("data", "model"), 1)


# ------------------------------------------- query heads split on a mesh
def case_head_split(rank, d):
    """For each entry of ``head_split.json`` (key -> [arch, data, model],
    written by tests/test_torch_head_split.py): a sharded step, and where
    its attention output lies — this rank's block of the query heads."""
    import dataclasses
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import distribute_tensor
    from torch.distributed.tensor.experimental import implicit_replication
    import repro_torch.configs as TC
    from repro_torch.dist.sharding import logical, set_mesh
    from repro_torch.models import layers
    from repro_torch.train.trainer import place

    with open(os.path.join(d, "head_split.json")) as f:
        cases = json.load(f)
    for key, (arch, *shape) in cases.items():
        shape = tuple(shape)
        _sharded_step(rank, d, key, arch, shape, ("data", "model"), 1,
                      key=key)
        with open(os.path.join(d, "overrides.json")) as f:
            cfg = dataclasses.replace(TC.reduced(TC.get(arch)),
                                      **json.load(f)[key])
        params = _tree(np.load(os.path.join(d, f"w_{key}.npz")))
        inp = np.load(os.path.join(d, f"in_{key}.npz"))
        mesh = init_device_mesh("cpu", shape,
                                mesh_dim_names=("data", "model"))
        set_mesh(mesh)
        p_attn = {k: v[0] for k, v in params["layers"]["attn"].items()}
        axes = layers.attention_param_axes()
        sh = {k: logical(*axes[k], dims=v.shape) for k, v in p_attn.items()}
        dp = place(p_attn, sh, mesh)
        b, s = inp["inputs"].shape
        xs = np.random.default_rng(0).standard_normal(
            (b, s, cfg.d_model)).astype(np.float32)
        x = distribute_tensor(torch.from_numpy(xs), mesh, logical(
            "batch", "seq", "embed", dims=xs.shape))
        pos = torch.arange(s)[None].expand(b, s)
        with implicit_replication():
            q, k, v = layers._qkv(dp, x, cfg, pos)
            out = layers._per_shard(lambda q, k, v: q, q, k, v)
        _save(d, f"{key}_heads_r{rank}",
              q=_placements(q), out=_placements(out),
              local=np.array(out.to_local().shape))
        set_mesh(None)


def case_shard_grad(rank, d):
    """``shard``'s backward: the gradient leaving a site is in the
    annotated placement, whether or not the value needed a move."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import (Partial, Replicate, Shard,
                                          distribute_tensor)
    from repro_torch.dist.sharding import set_mesh, shard

    mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
    set_mesh(mesh)
    model = mesh.get_coordinate()[1]
    out = {}
    for name, start in (("placed", (Shard(0), Replicate())),
                        ("moved", (Replicate(), Replicate()))):
        x0 = distribute_tensor(torch.arange(32.0).reshape(4, 8), mesh,
                               start).requires_grad_(True)
        x = x0 * 1.0
        seen = []
        x.register_hook(lambda g: seen.append(g))
        y = shard(x, "batch", "embed")
        # each model rank holds its share of y's gradient: a partial sum
        local = y.to_local(grad_placements=(Shard(0), Partial()))
        (local * (model + 1.0)).sum().backward()
        (g,) = seen
        out[f"{name}/y"] = _placements(y)
        out[f"{name}/grad"] = _placements(g)
        out[f"{name}/value"] = g.full_tensor().numpy()
    set_mesh(None)
    _save(d, f"shard_grad_r{rank}", **out)


# ------------------------------------------------------------ sync modes
def case_sync(rank, d):
    from torch.distributed.device_mesh import init_device_mesh
    import repro_torch.configs as TC
    from repro_torch.dist.sharding import set_mesh
    from repro_torch.train import OptConfig, make_train_step
    from repro_torch.train.optimizer import init_opt_state
    from repro_torch.train.trainer import (batch_shardings, place,
                                           train_shardings)

    arch = "paper-gpt2"
    cfg = TC.reduced(TC.get(arch))
    inp = np.load(os.path.join(d, f"in_{arch}.npz"))
    params = _tree(np.load(os.path.join(d, f"w_{arch}.npz")))
    batch = {"inputs": torch.from_numpy(inp["inputs"]),
             "labels": torch.from_numpy(inp["labels"])}
    # model 1: the "model" dimension is left out (a size-1 dimension
    # resolves as an absent one, and DTensor's sharding propagation grows
    # with the mesh's rank)
    mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("pod", "data"))
    set_mesh(mesh)
    opt_cfg = OptConfig(lr=1e-3)
    p_sh, _o_sh, _, _ = train_shardings(mesh, cfg, opt_cfg)
    dp = place(params, p_sh, mesh)
    db = place(batch, batch_shardings(mesh, batch, include_pod=False), mesh)
    out = {}
    for name, ov, comp in (("blocking", False, False),
                           ("overlap", True, False),
                           ("overlap_c", True, True)):
        step = make_train_step(cfg, opt_cfg, overlap_sync=ov,
                               sync_compressed=comp, sync_buckets=2)
        new_p, _o, m = step(dp, init_opt_state(dp, opt_cfg), db)
        out.update({f"{name}/m/{k}": v.numpy() for k, v in m.items()})
        out.update({f"{name}/param/{k}": v
                    for k, v in _flat(new_p).items()})
    set_mesh(None)
    if rank == 0:
        _save(d, "sync", **out)


# -------------------------------------------------------------- pipeline
def case_pipeline(rank, d):
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.dist.pipeline import make_pipelined_fn

    inp = np.load(os.path.join(d, "in_pipeline.npz"))

    def block(w, x):
        return torch.tanh(x @ w)

    out = {}
    for name, shape, names, lps in (("pipe4", (4,), ("pipe",), 2),
                                    ("pipe2_data2", (2, 2),
                                     ("pipe", "data"), 4)):
        mesh = init_device_mesh("cpu", shape, mesh_dim_names=names)
        fn = make_pipelined_fn(mesh, block, shape[0], lps)
        ws = torch.from_numpy(inp["ws"]).requires_grad_(True)
        ys = fn(ws, torch.from_numpy(inp["xs"]))
        ys.sum().backward()
        g = ws.grad.clone()
        dist.all_reduce(g)               # each rank holds its share
        out[f"{name}/ys"] = ys.detach().numpy()
        out[f"{name}/grad"] = g.numpy()
    if rank == 0:
        _save(d, "pipeline", **out)


# ------------------------------------------------------- decode on a mesh
def case_decode(rank, d):
    """Decode steps on data 2 × model 2, for each (batch, max_seq) in the
    inputs: the logits of every step and the whole caches at the end.
    "even" places the cache by ``serve_shardings`` (batch over data,
    sequence over model); "uneven" places K/V so by hand, as the rule
    table does not (it shards only a dimension that divides), so that the
    last ranks hold shorter blocks."""
    import dataclasses
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Shard
    import repro_torch.configs as TC
    from repro_torch.dist.sharding import set_mesh
    from repro_torch.models import init_cache
    from repro_torch.train.trainer import (batch_shardings,
                                           make_decode_step, place,
                                           serve_shardings)

    arch = "glm4-9b"
    with open(os.path.join(d, "overrides.json")) as f:
        cfg = dataclasses.replace(TC.reduced(TC.get(arch)),
                                  **json.load(f).get(arch, {}))
    params = _tree(np.load(os.path.join(d, f"w_{arch}.npz")))
    inp = np.load(os.path.join(d, "in_decode.npz"))
    mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
    set_mesh(mesh)
    step = make_decode_step(cfg)
    out = {}
    for name in ("even", "uneven"):
        toks = torch.from_numpy(inp[f"{name}_tokens"]).long()
        lengths = torch.from_numpy(inp[f"{name}_lengths"])
        b, max_seq = toks.shape[0], int(inp[f"{name}_max_seq"])
        p_sh, c_sh, _ps, _cs = serve_shardings(mesh, cfg, b, max_seq)
        if name == "uneven":
            # (layers, batch, seq, kv heads, head dim)
            c_sh["kv"]["k"] = c_sh["kv"]["v"] = (Shard(1), Shard(2))
        cache = init_cache(cfg, b, max_seq, device="cpu")
        cache["kv"]["length"] = lengths.clone()
        dp, dc = place(params, p_sh, mesh), place(cache, c_sh, mesh)
        for t in range(toks.shape[1]):
            tok = {"tokens": toks[:, t:t + 1]}
            tok = place(tok, batch_shardings(mesh, tok), mesh)["tokens"]
            logits, dc = step(dp, dc, tok)
            out[f"{name}/logits{t}"] = logits.full_tensor().numpy()
        out.update({f"{name}/cache/{k}": v
                    for k, v in _flat(dc).items()})
    set_mesh(None)
    if rank == 0:
        _save(d, "decode", **out)


CASES = [case_collectives, case_pipeline, case_sync, case_step_qwen3,
         case_step_dbrx, case_step_dbrx_model, case_step_ssm,
         case_step_hybrid, case_decode]


def _rank(rank: int, world: int, d: str, cases: list) -> None:
    torch.set_num_threads(1)
    store = dist.FileStore(os.path.join(d, "store"), world)
    dist.init_process_group("gloo", store=store, rank=rank,
                            world_size=world)
    try:
        for case in cases:
            case(rank, d)
            dist.barrier()
    finally:
        dist.destroy_process_group()
    bad = sorted(m for m in sys.modules if m == "jax" or m.startswith(
        "jax.") or m == "repro" or m.startswith("repro."))
    with open(os.path.join(d, f"modules_r{rank}.json"), "w") as f:
        json.dump(bad, f)


def main() -> None:
    import torch.multiprocessing as mp
    d, world, timeout = sys.argv[1], int(sys.argv[2]), float(sys.argv[3])
    cases = CASES if len(sys.argv) < 5 else [
        globals()[f"case_{name}"] for name in sys.argv[4].split(",")]
    ctx = mp.start_processes(_rank, args=(world, d, cases), nprocs=world,
                             join=False, start_method="spawn")
    deadline = time.monotonic() + timeout
    try:
        while not ctx.join(timeout=max(1.0, deadline - time.monotonic())):
            if time.monotonic() > deadline:
                raise TimeoutError(f"ranks still running after {timeout} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()


if __name__ == "__main__":
    main()
