"""Time glm4-9b's train step at full width on data 2 x model 2, one NCCL
rank per card (four cards), for each source tree named on the command
line, in turn:

    python3 ab_mesh_step.py OLD_TREE NEW_TREE NEW_TREE OLD_TREE

Each tree is a checkout of this repository (its ``src`` holds the
``repro_torch`` that is timed); each run spawns four fresh ranks, takes
six steps of batch 2 x 64 from the same weights and batch, and prints one
line ``AB {"tree", "secs", "losses", "peak_gb"}`` from rank 0.  Compare
two trees only within one invocation, alternating their order: the step
is host-bound, and the host varies between machines and calls.
"""

import json
import os
import sys
import tempfile
import time

STEPS = 6


def _rank(rank: int, world: int, tmp: str, tree: str) -> None:
    sys.path.insert(0, os.path.join(tree, "src"))
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    import repro_torch.configs as configs
    from repro_torch.dist.sharding import set_mesh
    from repro_torch.launch import train as tl
    from repro_torch.models import init_params
    from repro_torch.train import OptConfig, make_train_step
    from repro_torch.train.optimizer import init_opt_state
    from repro_torch.train.trainer import (batch_shardings, place,
                                           train_shardings)
    tl.init_rank(rank, world, os.path.join(tmp, "store"), "cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        cfg = configs.get("glm4-9b")
        dev = f"cuda:{rank}"
        mesh = init_device_mesh("cuda", (2, 2),
                                mesh_dim_names=("data", "model"))
        set_mesh(mesh)
        opt_cfg = OptConfig()
        params = place(init_params(cfg, 0, dev),
                       train_shardings(mesh, cfg, opt_cfg)[0], mesh)
        torch.cuda.empty_cache()
        opt = init_opt_state(params, opt_cfg)
        gen = torch.Generator(device=dev).manual_seed(1)
        batch = {k: torch.randint(0, cfg.vocab_size, (2, 64), generator=gen,
                                  dtype=torch.int32, device=dev)
                 for k in ("inputs", "labels")}
        db = place(batch, batch_shardings(mesh, batch), mesh)
        step = make_train_step(cfg, opt_cfg)
        secs, losses = [], []
        for _ in range(STEPS):
            torch.cuda.synchronize()
            dist.barrier()
            t0 = time.perf_counter()
            params, opt, m = step(params, opt, db)
            losses.append(float(m["loss"]))
            torch.cuda.synchronize()
            dist.barrier()
            secs.append(time.perf_counter() - t0)
        if rank == 0:
            print("AB " + json.dumps({
                "tree": tree, "secs": secs, "losses": losses,
                "peak_gb": torch.cuda.max_memory_allocated() / 1e9}),
                flush=True)
    finally:
        dist.destroy_process_group()


def main() -> None:
    import torch.multiprocessing as mp
    for tree in sys.argv[1:]:
        with tempfile.TemporaryDirectory() as tmp:
            mp.start_processes(_rank, args=(4, tmp, os.path.abspath(tree)),
                               nprocs=4, join=True, start_method="spawn")


if __name__ == "__main__":
    main()
