"""Manifest-driven checkpointing with atomic publish, in the reference's
on-disk layout.

Layout:  <dir>/step_<N>/
           manifest.json        — keys, shapes, dtypes, step
           shard_p<proc>.npz    — the leaf arrays, ``leaf_<i>``
           COMMIT               — written last; a checkpoint without COMMIT
                                  is incomplete and ignored on restore

The keys are the reference's (``"params/layers/attn/wq"``: dict keys
joined by ``/``, leaves in sorted-key order, the order JAX flattens a dict
in), so ``leaf_<i>`` names the same leaf in both packages and either
package restores the other's checkpoints.  bfloat16 leaves are stored as
their uint16 bits under dtype ``"bfloat16"``.

Writes go to ``step_<N>.tmp`` and are renamed into place only after COMMIT —
a crash mid-save can never corrupt the latest restorable state.  An optional
async mode snapshots to host memory and writes on a background thread so the
train loop is blocked only for the device→host copy.

On a mesh a DTensor leaf is gathered whole (``full_tensor()``, a collective
every rank joins) and rank 0 writes; ``restore(..., shardings=)`` places
each leaf again with ``distribute_tensor`` on the registered mesh, whatever
its size — a checkpoint saved on N ranks restores on M.
"""

from __future__ import annotations

import json
import os
import shutil
import threading

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, distribute_tensor


def _paths(tree, prefix: tuple = (), seq: bool = True) -> list:
    """(path, leaf) pairs: dict keys in sorted order, lists and tuples by
    index (with ``seq=False`` a tuple is a leaf, as placements are)."""
    if isinstance(tree, dict):
        return [pair for k in sorted(tree)
                for pair in _paths(tree[k], (*prefix, k), seq)]
    if seq and isinstance(tree, (list, tuple)):
        return [pair for i, v in enumerate(tree)
                for pair in _paths(v, (*prefix, i), seq)]
    return [(prefix, tree)]


def _unflatten(like, leaves: list):
    """``like``'s structure with its leaves replaced, in ``_paths`` order."""
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            built = {k: build(t[k]) for k in sorted(t)}
            return {k: built[k] for k in t}
        if isinstance(t, (list, tuple)):
            return type(t)(build(v) for v in t)
        return next(it)
    return build(like)


def _keys(tree) -> list:
    return ["/".join(str(k) for k in path) for path, _leaf in _paths(tree)]


def _dtype_name(leaf) -> str:
    if isinstance(leaf, torch.Tensor):
        return str(leaf.dtype).removeprefix("torch.")
    return str(np.asarray(leaf).dtype)


def _to_host(leaf) -> np.ndarray:
    """A leaf as an owned numpy array (a DTensor gathered whole first;
    bfloat16 as its uint16 bits)."""
    if isinstance(leaf, DTensor):
        leaf = leaf.full_tensor()
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        if t.dtype == torch.bfloat16:
            t = t.view(torch.int16)
        a = t.cpu().numpy()             # a copy unless already on the host
        a = a.copy() if t.device.type == "cpu" else a
        return a.view(np.uint16) if leaf.dtype == torch.bfloat16 else a
    return np.array(leaf, copy=True)


def _writer() -> bool:
    return not dist.is_initialized() or dist.get_rank() == 0


def save(ckpt_dir: str, step: int, state: dict, process_index: int = 0,
         async_: bool = False) -> str:
    """state: tree of tensors, DTensors or numpy arrays (params/opt/...).
    On a process group every rank calls it; rank 0 writes."""
    paths = _paths(state)
    keys = _keys(state)
    dtypes = [_dtype_name(leaf) for _p, leaf in paths]
    host_leaves = [_to_host(leaf) for _p, leaf in paths]  # device→host
    final = os.path.join(ckpt_dir, f"step_{step:08d}")

    def _write():
        tmp = final + ".tmp"
        os.makedirs(tmp, exist_ok=True)
        np.savez(os.path.join(tmp, f"shard_p{process_index}.npz"),
                 **{f"leaf_{i}": a for i, a in enumerate(host_leaves)})
        manifest = {
            "step": step,
            "keys": keys,
            "shapes": [list(a.shape) for a in host_leaves],
            "dtypes": dtypes,
            "n_processes": 1,
        }
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        with open(os.path.join(tmp, "COMMIT"), "w") as f:
            f.write("ok")
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
        return final

    if not _writer():
        if not async_:
            dist.barrier()                  # rank 0 has published
        return final
    if async_:
        t = threading.Thread(target=_write, daemon=True)
        t.start()
        return final
    _write()
    if dist.is_initialized():
        dist.barrier()
    return final


def latest_step(ckpt_dir: str) -> int | None:
    """Newest *restorable* step: skips ``.tmp`` dirs (in-flight saves),
    dirs without COMMIT (crashed mid-save), and anything that merely looks
    like a checkpoint dir (``step_garbage``, stray files).  On a process
    group every rank calls it and gets rank 0's answer."""
    steps = []
    if os.path.isdir(ckpt_dir):
        for name in os.listdir(ckpt_dir):
            if not name.startswith("step_") or name.endswith(".tmp"):
                continue
            try:
                step = int(name.split("_", 1)[1])
            except ValueError:
                continue
            if os.path.exists(os.path.join(ckpt_dir, name, "COMMIT")):
                steps.append(step)
    found = [max(steps) if steps else None]
    if dist.is_initialized():
        dist.broadcast_object_list(found, src=0)
    return found[0]


def _validate(manifest: dict, like, path: str) -> None:
    """Refuse to restore a checkpoint whose tree disagrees with ``like``."""
    want_keys = _keys(like)
    got_keys = list(manifest.get("keys", []))
    if got_keys != want_keys:
        missing = [k for k in want_keys if k not in got_keys]
        extra = [k for k in got_keys if k not in want_keys]
        raise ValueError(
            f"{path}: checkpoint tree mismatch — "
            f"missing from checkpoint: {missing[:5]}, "
            f"unexpected in checkpoint: {extra[:5]}"
            + (" (keys agree but order differs)"
               if not missing and not extra else ""))
    bad = []
    for key, shape, dtype, (_p, leaf) in zip(
            want_keys, manifest.get("shapes", []),
            manifest.get("dtypes", []), _paths(like)):
        want_shape = list(leaf.shape) if isinstance(leaf, torch.Tensor) \
            else list(np.shape(leaf))
        want_dtype = _dtype_name(leaf)
        if list(shape) != want_shape or str(dtype) != want_dtype:
            bad.append(f"{key}: checkpoint {tuple(shape)}/{dtype} "
                       f"vs target {tuple(want_shape)}/{want_dtype}")
    if bad:
        raise ValueError(f"{path}: leaf mismatch — " + "; ".join(bad[:5])
                         + (f" (+{len(bad) - 5} more)" if len(bad) > 5
                            else ""))


def _from_host(a: np.ndarray, dtype: str, like, sharding):
    """A stored array as ``like``'s kind of leaf: placed per ``sharding``
    on the registered mesh, or with ``like``'s placements or device, or as
    numpy when ``like`` is not a tensor."""
    if not isinstance(like, torch.Tensor) and sharding is None:
        return a
    t = torch.from_numpy(a)
    if dtype == "bfloat16":
        t = t.view(torch.bfloat16)
    if sharding is not None:
        from repro_torch.dist.sharding import get_mesh
        return distribute_tensor(t, get_mesh(), sharding)
    if isinstance(like, DTensor):
        return distribute_tensor(t, like.device_mesh, like.placements)
    return t.to(like.device)


def restore(ckpt_dir: str, like: dict, step: int | None = None,
            shardings=None, process_index: int = 0) -> tuple:
    """Returns (step, state) with each leaf placed per ``shardings`` (a
    tree of placements) on the registered mesh, or like ``like``'s leaf.

    The manifest is validated against ``like`` before any array leaves the
    shard file: a checkpoint saved from a different model (missing/extra
    keys, mismatched shapes or dtypes) fails with an error naming the
    offending leaves instead of silently unflattening garbage.
    """
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no complete checkpoint in {ckpt_dir}")
    path = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    _validate(manifest, like, path)
    with np.load(os.path.join(path, f"shard_p{process_index}.npz")) as data:
        arrays = [data[f"leaf_{i}"] for i in range(len(manifest["keys"]))]
    like_leaves = [leaf for _p, leaf in _paths(like)]
    sh_leaves = ([leaf for _p, leaf in _paths(shardings, seq=False)]
                 if shardings is not None else [None] * len(arrays))
    if len(sh_leaves) != len(arrays):
        raise ValueError(f"{path}: {len(sh_leaves)} shardings for "
                         f"{len(arrays)} leaves")
    leaves = [_from_host(a, d, lk, sh) for a, d, lk, sh in
              zip(arrays, manifest["dtypes"], like_leaves, sh_leaves)]
    return step, _unflatten(like, leaves)
