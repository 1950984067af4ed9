"""Rank programs of tests/test_torch_serve_mesh.py: one spawn of gloo ranks
on the CPU, on a data × model mesh, that serves every case and writes what
each rank saw as JSON.  It imports neither ``jax`` nor the JAX package:
the test process writes the inputs (the reference's weights) and holds the
results against the reference's engine and the port's world-1 runs.

    PYTHONPATH=src python tests/_torch_serve_mesh_ranks.py <dir> <DxM>
        <timeout>

``<dir>/cases.json`` names the cases: ``engine`` cases serve a staggered
trace through ``ServeEngine`` on the reference's weights
(``<dir>/w_<name>.npz``; with ``draft_layers`` n among the options, a
draft model of the target's first n layers, placed); ``launcher`` cases
run ``repro_torch.launch.serve.run`` with their flags (``skew`` makes
rank 1's ``time.perf_counter`` run 3x fast, 1000 s ahead); the
``diverge`` case submits one request more on rank 1 than on the others,
the ``diverge_draft`` case drafts one token differently on rank 1; the
``draft_weights`` case builds draft-model engines and reports where
their weights lie.
"""

from __future__ import annotations

import dataclasses
import json
import os
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

#: the staggered trace of tests/test_torch_serve_engine.py
LENS = (5, 17, 9, 30, 12, 3, 21)
MAX_NEW = 8


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


def prompts(vocab: int, shared: int) -> list:
    rng = np.random.default_rng(0)
    pre = rng.integers(0, vocab, (shared,), dtype=np.int32)
    return [np.concatenate([pre, rng.integers(0, vocab, (n,),
                                              dtype=np.int32)])
            for n in LENS]


def staggered(engine, ps) -> dict:
    """Submit one request every other tick; {prompt index: tokens}."""
    from repro_torch.serve import SamplingParams
    out, rids, pending, tick = {}, {}, list(enumerate(ps)), 0
    while pending or engine.has_work:
        if pending and tick % 2 == 0:
            i, p = pending.pop(0)
            rids[engine.submit(p, SamplingParams(max_new_tokens=MAX_NEW))] = i
        if engine.has_work:
            for rid in engine.step()["finished"]:
                out[rids[rid]] = [int(t) for t in engine.requests[rid].tokens]
        tick += 1
    return out


def _config(case: dict):
    import repro_torch.configs as TC
    return dataclasses.replace(TC.reduced(TC.get(case["arch"])),
                               **case.get("over", {}))


def case_engine(d: str, name: str, case: dict, mesh) -> dict:
    from repro_torch.dist.sharding import placed
    from repro_torch.serve import ServeEngine
    from repro_torch.serve import draft as draft_mod
    from repro_torch.train.optimizer import tree_map
    from repro_torch.train.trainer import serve_shardings
    cfg = _config(case)
    full = _tree(np.load(os.path.join(d, f"w_{name}.npz")))
    p_sh = serve_shardings(mesh, cfg, 4, 64)[0]
    params = tree_map(lambda w, sh: placed(w, mesh, sh), full, p_sh)
    opts = dict(case.get("opts", {}))
    cut = opts.pop("draft_layers", None)
    if cut:
        # the target's first layers, carried across and placed
        dcfg = dataclasses.replace(cfg, n_layers=cut)
        d_full = dict(full, layers=tree_map(lambda x: x[:cut],
                                            full["layers"]))
        d_sh = serve_shardings(mesh, dcfg, 4, 64 + opts["spec_decode"])[0]
        opts.update(draft_cfg=dcfg, draft_params=tree_map(
            lambda w, sh: placed(w, mesh, sh), d_full, d_sh))
    eng = ServeEngine(cfg, params, max_seq=64, max_slots=4, **opts)
    # the rollout cache grows placed on a mesh, never through F.pad
    pads, pad = [], draft_mod.pad_cache_to
    draft_mod.pad_cache_to = lambda *a: pads.append(1) or pad(*a)
    try:
        tokens = staggered(eng, prompts(cfg.vocab_size, case["shared"]))
    finally:
        draft_mod.pad_cache_to = pad
    return {"tokens": tokens, "pool": eng.pool_stats(),
            "hits": (eng.prefix_cache.stats()["hits"]
                     if eng.prefix_cache is not None else 0),
            "ticks": eng.ticks, "drafted": eng.drafted_tokens,
            "accepted": eng.accepted_tokens, "pad_calls": len(pads)}


def case_launcher(d: str, name: str, case: dict, mesh) -> dict:
    from repro_torch.launch import serve
    data, model = mesh.shape
    argv = [*case["argv"], "--device", "cpu", "--devices",
            str(data * model), "--mesh", f"{data}x{model}"]
    real = time.perf_counter
    if case.get("skew") and dist.get_rank() == 1:
        time.perf_counter = lambda: 1000.0 + 3.0 * real()
    try:
        out = serve.run(serve.parse_args(argv))
    finally:
        time.perf_counter = real
    res = out["result"]
    return {"tokens": res["tokens"], "states": res["request_states"],
            "mesh": res["config"]["mesh"], "ticks": out["engine"].ticks,
            "speculative": {k: res["summary"]["speculative"][k] for k in
                            ("drafted_tokens", "accepted_tokens")}}


def case_diverge(d: str, name: str, case: dict, mesh) -> dict:
    """One request more on rank 1: every rank must raise at the tick's
    plan, never run a different batch."""
    from repro_torch.dist.sharding import placed
    from repro_torch.serve import SamplingParams, ServeEngine
    from repro_torch.train.optimizer import tree_map
    from repro_torch.train.trainer import serve_shardings
    import repro_torch.models as M
    cfg = _config(case)
    p_sh = serve_shardings(mesh, cfg, 4, 64)[0]
    params = tree_map(lambda w, sh: placed(w, mesh, sh),
                      M.init_params(cfg, 0, "cpu"), p_sh)
    eng = ServeEngine(cfg, params, max_seq=64, max_slots=4, prefix_block=8)
    ps = prompts(cfg.vocab_size, 16)[:2]
    if dist.get_rank() == 1:
        ps.append(ps[0])
    for p in ps:
        eng.submit(p, SamplingParams(max_new_tokens=4))
    try:
        while eng.has_work:
            eng.step()
    except RuntimeError as e:
        return {"error": str(e), "ticks": eng.ticks}
    return {"error": None, "ticks": eng.ticks}


class _RankDraft:
    """A caller's proposer: ``k`` tokens counted up from the context's
    length, one of them different on rank 1."""

    def propose(self, contexts, k: int) -> list:
        out = [np.arange(len(c), len(c) + k, dtype=np.int32) % 64
               for c in contexts]
        if dist.get_rank() == 1:
            out[0][0] += 1
        return out


def case_diverge_draft(d: str, name: str, case: dict, mesh) -> dict:
    """One draft token different on rank 1: every rank must raise at
    the tick's drafts, never verify a different batch."""
    from repro_torch.dist.sharding import placed
    from repro_torch.serve import SamplingParams, ServeEngine
    from repro_torch.train.optimizer import tree_map
    from repro_torch.train.trainer import serve_shardings
    import repro_torch.models as M
    cfg = _config(case)
    p_sh = serve_shardings(mesh, cfg, 4, 64)[0]
    params = tree_map(lambda w, sh: placed(w, mesh, sh),
                      M.init_params(cfg, 0, "cpu"), p_sh)
    eng = ServeEngine(cfg, params, max_seq=64, max_slots=4, prefix_block=8,
                      spec_decode=2, draft=_RankDraft())
    for p in prompts(cfg.vocab_size, 16)[:2]:
        eng.submit(p, SamplingParams(max_new_tokens=4))
    try:
        while eng.has_work:
            eng.step()
    except RuntimeError as e:
        return {"error": str(e), "ticks": eng.ticks}
    return {"error": None, "ticks": eng.ticks}


def case_draft_weights(d: str, name: str, case: dict, mesh) -> dict:
    """Without a draft config the draft is the target's own placed
    weights; with one, every rank draws them placed from seed 1; unplaced
    draft weights are refused."""
    from torch.distributed.tensor import DTensor
    from repro_torch.dist.sharding import placed
    from repro_torch.serve import ServeEngine
    from repro_torch.train.optimizer import tree_map, tree_paths
    from repro_torch.train.trainer import serve_shardings
    import repro_torch.models as M
    cfg = _config(case)
    params = tree_map(lambda w, sh: placed(w, mesh, sh),
                      M.init_params(cfg, 0, "cpu"),
                      serve_shardings(mesh, cfg, 4, 64)[0])
    kw = dict(max_seq=64, max_slots=4, spec_decode=2, draft="model")
    own = ServeEngine(cfg, params, **kw)
    dcfg = dataclasses.replace(cfg, n_layers=1)
    drawn = ServeEngine(cfg, params, draft_cfg=dcfg, **kw).proposer.params
    want = M.init_params(dcfg, 1, "cpu")
    sh = serve_shardings(mesh, dcfg, 4, 66)[0]
    ok = tree_map(lambda x, w, p: isinstance(x, DTensor)
                  and tuple(x.placements) == tuple(p)
                  and bool(torch.equal(x.full_tensor(), w)), drawn, want, sh)
    try:
        ServeEngine(cfg, params, draft_cfg=dcfg, draft_params=want, **kw)
        error = None
    except ValueError as e:
        error = str(e)
    return {"shares": own.proposer.params is params,
            "drawn_placed": {"/".join(p): bool(v)
                             for p, v in tree_paths(ok)},
            "unplaced_error": error}


def _rank(rank: int, world: int, d: str, shape: tuple) -> None:
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.dist.sharding import set_mesh
    torch.set_num_threads(1)
    store = dist.FileStore(os.path.join(d, "store"), world)
    dist.init_process_group("gloo", store=store, rank=rank,
                            world_size=world)
    with open(os.path.join(d, "cases.json")) as f:
        cases = json.load(f)
    out = {}
    try:
        mesh = init_device_mesh("cpu", shape,
                                mesh_dim_names=("data", "model"))
        for name, case in cases.items():
            run = {"engine": case_engine, "launcher": case_launcher,
                   "diverge": case_diverge,
                   "diverge_draft": case_diverge_draft,
                   "draft_weights": case_draft_weights}[case["kind"]]
            if case["kind"] != "launcher":
                set_mesh(mesh)
            t0 = time.perf_counter()
            try:
                out[name] = run(d, name, case, mesh)
            finally:
                set_mesh(None)
            out[name]["seconds"] = time.perf_counter() - t0
            dist.barrier()
    finally:
        dist.destroy_process_group()
    out["modules"] = sorted(m for m in sys.modules if m == "jax" or
                            m.startswith("jax.") or m == "repro" or
                            m.startswith("repro."))
    with open(os.path.join(d, f"out_r{rank}.json"), "w") as f:
        json.dump(out, f)


def main() -> None:
    import torch.multiprocessing as mp
    d, timeout = sys.argv[1], float(sys.argv[3])
    shape = tuple(int(x) for x in sys.argv[2].split("x"))
    world = shape[0] * shape[1]
    ctx = mp.start_processes(_rank, args=(world, d, shape), nprocs=world,
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
