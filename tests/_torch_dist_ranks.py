"""Rank programs of tests/test_torch_dist.py: one spawn of WORLD gloo ranks
on the CPU that runs every case and writes each case's results as .npz
files.  It imports neither ``jax`` nor the JAX package: the test process
writes the inputs (the reference's weights, batches and payloads) and
holds the results against the reference.

    PYTHONPATH=src python tests/_torch_dist_ranks.py <dir> <world> <timeout>
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
                  gather_once=False):
    import dataclasses
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor.experimental import implicit_replication
    import repro_torch.configs as TC
    from repro_torch.dist.sharding import set_mesh
    from repro_torch.train import OptConfig, make_train_step
    from repro_torch.train.optimizer import init_opt_state
    from repro_torch.train.trainer import (_loss_and_grads, batch_shardings,
                                           place, train_shardings)

    with open(os.path.join(d, "overrides.json")) as f:
        cfg = dataclasses.replace(TC.reduced(TC.get(arch)),
                                  **json.load(f).get(arch, {}))
    inp = np.load(os.path.join(d, f"in_{arch}.npz"))
    params = _tree(np.load(os.path.join(d, f"w_{arch}.npz")))
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


CASES = [case_collectives, case_pipeline, case_sync, case_step_qwen3,
         case_step_dbrx, case_step_dbrx_model, case_step_ssm,
         case_step_hybrid]


def _rank(rank: int, world: int, d: str) -> None:
    torch.set_num_threads(1)
    store = dist.FileStore(os.path.join(d, "store"), world)
    dist.init_process_group("gloo", store=store, rank=rank,
                            world_size=world)
    try:
        for case in CASES:
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
    ctx = mp.start_processes(_rank, args=(world, d), nprocs=world,
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
