"""Slot-indexed KV/SSM cache pool + hash-keyed prompt-prefix cache.

The serving cache is a fixed ``(slots, max_seq)`` pool: slot ``i`` of every
cache leaf (KV rows, SSM states, per-slot lengths) belongs to the request
currently occupying slot ``i``.  Requests of different lengths interleave
freely — decode writes land at each slot's own length (per-row scatter in
:func:`repro_torch.models.layers.attention`) and the per-row length masks
keep stale bytes from retired requests invisible.  Admitting a request
copies its prefill row into the slot's row of every leaf, in place
(:meth:`KVSlotPool.insert`); retiring is free (the slot index just returns
to the allocator).

:class:`PagedKVPool` replaces the dense rows for the KV-only (``dense``)
family: one ``(n_layers, n_blocks, block_size, heads, head_dim)`` K/V block
pool plus per-slot *block tables*, so live decode state and the prefix store
reference the **same** device blocks.  A prefix hit is block-table aliasing
plus a refcount bump — no device copy sits on the prefill critical path,
and publishing a finished prefill duplicates zero bytes.  Block sharing is
write-safe by construction: prefix keys exist only at block-aligned
lengths, so a hit's suffix (and all later decode appends) land in
freshly-allocated blocks, never in a shared one.

:class:`PrefixCache` is the cross-request reuse layer: completed prefills
publish their prompt K/V under hash keys at block-aligned prefix lengths,
and a new request whose prompt prefix matches a stored key skips
prefilling those tokens (RoPE keys are absolute-position, so a shared
prefix at positions ``0..L-1`` is bit-reusable).  Entries are opaque:
block-id tuples in paged mode (:meth:`PrefixCache.insert_blocks`,
zero-copy) or K/V tensor copies in the legacy dense-row mode
(:meth:`PrefixCache.insert`).  Prefix reuse is KV-only: SSM/hybrid states
summarize the whole prefix nonlinearly and are not block-addressable, so
those families always prefill cold (hit rate 0 by construction).

Device tensors are written in place where the reference donates them to
``jax.jit``; host-side tables and lengths reach the device through
:func:`to_device`, which does not wait for the card.

On a mesh (``mesh=``) the pools are DTensors and each rank allocates and
writes its block alone; the host state (allocator, block tables,
refcounts, the prefix store) is the same on every rank.  The slot pool
is placed by the rule table over ``cache_axes`` (rows over ``data``, the
KV sequence and the SSM heads over ``model``); the paged pool splits
only its KV heads over ``model``, where they divide it, and keeps every
block on every ``data`` rank, since one block can serve rows of both
halves through the prefix store.
"""

from __future__ import annotations

import collections

import numpy as np
import torch
from torch.distributed.tensor import DTensor, Partial

from repro_torch.dist.sharding import (block_range, logical, placed,
                                       placed_zeros)
from repro_torch.models import cache_axes, init_cache
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import torch_dtype
from repro_torch.train.optimizer import tree_map

#: marker in the slot-axis spec tree for per-slot int leaves ("length")
#: whose pool value is overridden with the request's true length (a
#: right-padded group prefill reports the padded length for every row)
LENGTH = "length"


def to_device(a, device) -> torch.Tensor:
    """A host array on ``device``.  To the card the copy goes from pinned
    memory without a wait (a pageable copy would wait for every queued
    kernel, where the reference's ``jnp.asarray`` does not)."""
    t = torch.from_numpy(np.array(a, copy=True))
    device = torch.device(device)
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t


def to_host(logits: torch.Tensor) -> np.ndarray:
    """Logits on the host for sampling: float32 on the device first (numpy
    has no bf16; argmax order and first-index ties are unchanged).  The
    dispatch's one wait on the card.  A DTensor's are gathered whole to
    every rank, so every rank samples the same bits."""
    if isinstance(logits, DTensor):
        logits = logits.full_tensor()
    return logits.float().cpu().numpy()


def slot_axes(cache: dict) -> dict:
    """Tree parallel to ``cache`` giving each leaf's slot (batch) axis.

    Mirrors the layout of :func:`repro_torch.models.lm.init_cache`: KV
    leaves carry batch at axis 1 under a leading layer axis, SSM leaves at
    axis 1 (axis 2 for the hybrid ``ssm_groups`` with its extra
    layer-in-group axis), and length vectors at axis 0 (marked
    :data:`LENGTH`).
    """
    spec: dict = {}
    for key, val in cache.items():
        if key == "kv":
            spec["kv"] = {k: (LENGTH if k in ("length", "main_len") else 1)
                          for k in val}
        elif key == "length":
            spec["length"] = LENGTH
        elif key in ("ssm", "ssm_tail"):
            spec[key] = {k: 1 for k in val}
        elif key == "ssm_groups":
            spec[key] = {k: 2 for k in val}
        else:
            raise ValueError(f"unknown cache entry {key!r}")
    return spec


def _slot_put(pool_leaf, src_leaf, ax, slot: int, row: int,
              length: int) -> None:
    if isinstance(src_leaf, DTensor):
        src_leaf = src_leaf.full_tensor()          # one request's cache
    if isinstance(pool_leaf, DTensor):
        # this rank's block: the slot's row where it holds it, and its
        # window of every other dimension
        blocks = [block_range(pool_leaf.shape, d, pool_leaf.device_mesh,
                              pool_leaf.placements)
                  for d in range(pool_leaf.dim())]
        r0, r1 = blocks[0 if ax == LENGTH else ax]
        pool_leaf = pool_leaf.to_local()
        if not r0 <= slot < r1:
            return
        slot -= r0
        if ax != LENGTH:
            src_leaf = src_leaf[tuple(slice(a, b) if d != ax else slice(None)
                                      for d, (a, b) in enumerate(blocks))]
    if ax == LENGTH:
        pool_leaf[slot] = length
        return
    # prefill caches may differ from the pool along non-slot dims (seq at
    # the prompt bucket vs max_seq): crop then zero-fill — submit() bounds
    # real content by max_seq, so cropping only drops right-pad junk, and
    # bytes beyond the slot's length are masked at decode anyway
    dst = pool_leaf.select(ax, slot)
    src = src_leaf.select(ax, row)
    crop = tuple(slice(0, min(a, b)) for a, b in zip(dst.shape, src.shape))
    dst.zero_()
    dst[crop] = src[crop]


def slot_insert(pool: dict, src: dict, slot: int, row: int,
                length: int) -> None:
    """Copy row ``row`` of prefill cache ``src`` into slot ``slot`` of the
    pool in place, overriding length leaves with the request's true
    ``length``."""
    spec = slot_axes(pool)

    def walk(p, s_, ax):
        if isinstance(p, dict):
            for k in p:
                walk(p[k], s_[k], ax[k])
        else:
            _slot_put(p, s_, ax, slot, row, length)
    walk(pool, src, spec)


def bucket(n: int, floor: int = 8) -> int:
    """Next power-of-two ≥ n (≥ floor) — the right-padding bucket for ragged
    prompts, bounding the distinct prefill shapes to O(log max_seq)."""
    b = floor
    while b < n:
        b *= 2
    return b


def pad_cache_to(cache: dict, cfg: ModelConfig, max_seq: int) -> dict:
    """Grow a prefill KV cache's sequence dim to ``max_seq`` slots."""
    del cfg
    if "kv" not in cache:
        return cache
    kv = cache["kv"]
    cur = kv["k"].shape[2]
    if cur >= max_seq:
        return cache

    def grow(x):
        return torch.nn.functional.pad(x, (0, 0, 0, 0, 0, max_seq - cur))

    cache = dict(cache)
    cache["kv"] = {"k": grow(kv["k"]), "v": grow(kv["v"]),
                   "length": kv["length"]}
    return cache


def grow_placed(cache: dict, max_seq: int, mesh, placements: dict) -> dict:
    """:func:`pad_cache_to` on a mesh: the K/V of a G-row prefill cache in
    the first positions of a ``(layers, G, max_seq, ...)`` cache placed by
    ``placements`` (``{"k", "v"}``), each rank allocating its block and
    writing its rows and positions through the slot write (one gather of
    each prefill leaf).  ``F.pad`` of a DTensor breaks on torch 2.11, and
    a pad of each rank's block would land inside a sequence sharded over
    ``model``, not at its global end.  The caller sets the lengths."""
    kv = cache["kv"]
    whole = {n: (kv[n].full_tensor() if isinstance(kv[n], DTensor)
                 else kv[n]) for n in ("k", "v")}
    grown = {"kv": {n: placed_zeros((*x.shape[:2], max_seq, *x.shape[3:]),
                                    mesh, placements[n], dtype=x.dtype,
                                    device=x.device)
                    for n, x in whole.items()}}
    for row in range(whole["k"].shape[1]):
        slot_insert(grown, {"kv": whole}, row, row, 0)
    return grown


def _conform(x, mesh, target):
    """``x`` in the ``target`` placements: a DTensor redistributed (a
    partial sum reduced), a plain tensor (every rank's same values) cut
    to this rank's block."""
    if not isinstance(x, DTensor):
        return placed(x, mesh, target)
    if tuple(x.placements) != tuple(target):
        return x.redistribute(mesh, target)
    return x


def _slot_window(leaf: DTensor, slot: int, upto: int) -> torch.Tensor:
    """``leaf[:, slot, :upto]`` of a placed (layers, slots, seq, ...) KV
    leaf, whole on every rank: the rank holding each block of it once
    (coordinate 0 where the leaf is replicated) contributes it, the others
    zeros, summed over the mesh.  One request's K/V, never the pool."""
    mesh, pl = leaf.device_mesh, leaf.placements
    (r0, r1), (t0, t1) = (block_range(leaf.shape, d, mesh, pl)
                          for d in (1, 2))
    local = leaf.to_local()
    out = local.new_zeros((leaf.shape[0], upto, *leaf.shape[3:]))
    coord = mesh.get_coordinate()
    owner = all(c == 0 for c, p in zip(coord, pl) if not p.is_shard())
    stop = min(t1, upto)
    if owner and r0 <= slot < r1 and t0 < stop:
        out[:, t0:stop] = local[:, slot - r0, :stop - t0]
    return DTensor.from_local(out, mesh, [Partial()] * mesh.ndim,
                              run_check=False).full_tensor()


class KVSlotPool:
    """Fixed ``(slots, max_seq)`` decode cache pool with per-slot lengths.

    ``cache`` is the live device tree (the tree the model's decode path
    consumes); callers reassign it after decode steps (the KV leaves are
    written in place, SSM states come back new).  ``insert`` copies an
    admitted request's prefill row into its slot in place.  On a mesh
    the leaves are DTensors placed by the rule table over ``cache_axes``,
    and a tree assigned to ``cache`` is put back in those placements.
    """

    def __init__(self, cfg: ModelConfig, slots: int, max_seq: int,
                 device="cuda", mesh=None):
        if cfg.kv_two_tier:
            raise NotImplementedError(
                "the slotted serving pool manages raggedness itself; "
                "kv_two_tier's frozen-main/recent-buffer split is a "
                "long-context decode layout, not a slot pool")
        self.cfg = cfg
        self.slots = slots
        self.max_seq = max_seq
        self.device = torch.device(device)
        self.mesh = mesh
        self.placements = None
        if mesh is None:
            self._cache = init_cache(cfg, slots, max_seq, self.device)
        else:
            shapes = init_cache(cfg, slots, max_seq, "meta")
            self.placements = tree_map(
                lambda ax, t: logical(*ax, dims=t.shape, mesh=mesh),
                cache_axes(cfg), shapes)
            self._cache = tree_map(
                lambda t, pl: placed_zeros(t.shape, mesh, pl, dtype=t.dtype,
                                           device=self.device),
                shapes, self.placements)

    @property
    def cache(self) -> dict:
        return self._cache

    @cache.setter
    def cache(self, tree: dict) -> None:
        if self.mesh is not None:
            tree = tree_map(lambda x, pl: _conform(x, self.mesh, pl), tree,
                             self.placements)
        self._cache = tree

    def insert(self, src_cache: dict, slot: int, row: int,
               length: int) -> None:
        slot_insert(self.cache, src_cache, slot, row, length)

    # ------------------------------------------------------- prefix plumbing
    def extract_kv(self, slot: int, upto: int) -> dict:
        """A copy of slot's K/V for the first ``upto`` positions —
        ``{"k","v"}: (n_layers, upto, n_kv_heads, head_dim)`` tensors on
        the pool's device (the reference copies to host numpy, which has
        no bf16); on a mesh, whole on every rank."""
        kv = self.cache["kv"]
        if self.mesh is not None:
            return {n: _slot_window(kv[n], slot, upto) for n in ("k", "v")}
        return {"k": kv["k"][:, slot, :upto].clone(),
                "v": kv["v"][:, slot, :upto].clone()}

    def seeded_prefill_cache(self, kv_prefix: dict | None,
                             batch: int = 1) -> dict:
        """A fresh single-request prefill cache (attention families only),
        optionally seeded with a stored prefix at positions ``0..L-1`` so
        only the prompt suffix needs prefilling; on a mesh, placed as the
        pool is."""
        dt = torch_dtype(self.cfg.dtype)
        n = self.cache["kv"]["k"].shape[0]
        hkv, hd = self.cfg.n_kv_heads, self.cfg.head_dim
        shape = (n, batch, self.max_seq, hkv, hd)
        k = torch.zeros(shape, dtype=dt, device=self.device)
        v = torch.zeros_like(k)
        length = np.zeros((batch,), np.int32)
        if kv_prefix is not None:
            pl = kv_prefix["k"].shape[1]
            k[:, 0, :pl] = kv_prefix["k"]
            v[:, 0, :pl] = kv_prefix["v"]
            length[0] = pl
        if self.mesh is not None:
            axes = cache_axes(self.cfg)["kv"]["k"]
            at = logical(*axes, dims=shape, mesh=self.mesh)
            k, v = placed(k, self.mesh, at), placed(v, self.mesh, at)
        return {"kv": {"k": k, "v": v,
                       "length": to_device(length, self.device)}}


class PagedKVPool:
    """Paged KV block pool: one device block array + per-slot block tables.

    Device state is a single ``(n_layers, n_blocks, block_size, heads,
    head_dim)`` pool for K and V.  Host state is the allocator: a free list,
    per-block refcounts (live request references + prefix-store references
    counted separately so evictability is exact), and a ``(slots,
    blocks_per_seq)`` block-table row per slot, sentinel-padded with
    ``n_blocks`` (the attention's writes there drop and its gathers clamp,
    as JAX's out-of-range scatter and gather do).

    Memory sharing is the point: a prefix hit binds the stored blocks into
    the new slot's table (refcount bump, zero bytes moved), and publishing a
    finished prefill retains the slot's own blocks under store keys —
    ``duplicate_copy_bytes`` is 0 by construction.  Under block pressure the
    allocator evicts LRU prefix-store entries via ``evict_cb``; blocks
    referenced by a live request are never reclaimed.
    """

    def __init__(self, cfg: ModelConfig, slots: int, max_seq: int,
                 block_size: int = 16, n_blocks: int | None = None,
                 device="cuda", mesh=None):
        if cfg.kv_two_tier:
            raise NotImplementedError(
                "the paged serving pool manages raggedness itself; "
                "kv_two_tier's frozen-main/recent-buffer split is a "
                "long-context decode layout, not a block pool")
        if cfg.family not in ("dense", "vlm", "audio", "moe"):
            raise NotImplementedError(
                "paged KV blocks are attention-only; SSM/hybrid state is "
                "not block-addressable (use KVSlotPool)")
        self.cfg = cfg
        self.slots = slots
        self.max_seq = max_seq
        self.block_size = block_size
        self.device = torch.device(device)
        self.blocks_per_seq = -(-max_seq // block_size)
        #: default sizing: dense-pool parity per slot plus two sequences'
        #: worth of headroom so the prefix store can retain blocks without
        #: starving admission
        self.n_blocks = (n_blocks if n_blocks is not None
                         else (slots + 2) * self.blocks_per_seq)
        shape = (cfg.n_layers, self.n_blocks, block_size,
                 cfg.n_kv_heads, cfg.head_dim)
        dt = torch_dtype(cfg.dtype)
        if mesh is None:
            self.pk = torch.zeros(shape, dtype=dt, device=self.device)
            self.pv = torch.zeros_like(self.pk)
        else:
            # KV heads over `model` where they divide it; every block on
            # every `data` rank
            at = logical(None, None, None, "kv_heads", None, dims=shape,
                         mesh=mesh)
            self.pk, self.pv = (placed_zeros(shape, mesh, at, dtype=dt,
                                             device=self.device)
                                for _ in range(2))
        self._free = list(range(self.n_blocks - 1, -1, -1))  # pop ascending
        self._refs = np.zeros((self.n_blocks,), np.int32)
        self._store_refs = np.zeros((self.n_blocks,), np.int32)
        #: sentinel-filled block tables; writes there drop, gathers clamp
        self.tables = np.full((slots, self.blocks_per_seq), self.n_blocks,
                              np.int32)
        self.evict_cb = None          # () -> bool, frees store blocks
        #: blocks freed by truncate() whose device bytes are still rejected
        #: draft KV — dead (every reader masks at its committed length), so
        #: scrubbing is deferred and batched instead of paid per tick
        self._dirty: set = set()

    # -------------------------------------------------------- allocator
    @property
    def n_free(self) -> int:
        return len(self._free)

    @property
    def n_used(self) -> int:
        return self.n_blocks - len(self._free)

    def n_evictable(self) -> int:
        """Blocks currently reclaimable by evicting prefix-store entries:
        every reference on them is a store reference (no live request)."""
        held = (self._refs > 0) & (self._refs == self._store_refs)
        return int(held.sum())

    def available(self) -> int:
        return self.n_free + self.n_evictable()

    def alloc(self, n: int) -> list | None:
        """Allocate ``n`` fresh blocks (refcount 1 each), evicting LRU
        prefix-store entries under pressure; ``None`` when the pool cannot
        satisfy the request even after evicting everything evictable."""
        while len(self._free) < n and self.evict_cb is not None \
                and self.evict_cb():
            pass
        if len(self._free) < n:
            return None
        ids = [self._free.pop() for _ in range(n)]
        self._refs[ids] += 1
        #: a re-allocated block must never be scrubbed later — its new owner
        #: overwrites it before reading, and a deferred zero would clobber
        #: live KV
        self._dirty.difference_update(ids)
        return ids

    def retain(self, ids, store: bool = False) -> None:
        ids = list(ids)
        self._refs[ids] += 1
        if store:
            self._store_refs[ids] += 1

    def release(self, ids, store: bool = False) -> list:
        """Drop one reference per block; returns the ids that became fully
        free (refcount hit zero) so callers can scrub them."""
        freed = []
        for b in ids:
            b = int(b)
            self._refs[b] -= 1
            if store:
                self._store_refs[b] -= 1
            if self._refs[b] == 0:
                self._free.append(b)
                freed.append(b)
        self._free.sort(reverse=True)          # deterministic ascending pops
        return freed

    # ------------------------------------------------------- slot tables
    def blocks_for(self, n_tokens: int) -> int:
        return -(-n_tokens // self.block_size)

    def bind_slot(self, slot: int, shared_ids, fresh_ids) -> None:
        """Install a slot's block table: ``shared_ids`` (prefix-store
        aliases, already retained by the caller) followed by ``fresh_ids``
        (owned by this request)."""
        row = list(shared_ids) + list(fresh_ids)
        assert len(row) <= self.blocks_per_seq
        self.tables[slot] = self.n_blocks
        self.tables[slot, :len(row)] = row

    def free_slot(self, slot: int) -> None:
        """Release every real block the slot references (shared blocks just
        drop this request's refcount; store references keep them alive)."""
        row = self.tables[slot]
        real = row[row < self.n_blocks]
        self.release([int(b) for b in real])
        self.tables[slot] = self.n_blocks

    def ensure(self, slot: int, n_tokens: int) -> int:
        """Grow the slot's table to cover ``n_tokens`` positions (lazy block
        binding: decode and speculative spill allocate just-in-time instead
        of reserving the whole horizon upfront).  Returns the number of
        blocks allocated; raises if the pool cannot satisfy it — admission's
        reservation accounting is supposed to make that impossible."""
        span = self.blocks_per_seq * self.block_size
        need = self.blocks_for(min(n_tokens, span))
        row = self.tables[slot]
        have = int((row < self.n_blocks).sum())
        if have >= need:
            return 0
        fresh = self.alloc(need - have)
        if fresh is None:
            raise RuntimeError(
                f"paged pool exhausted growing slot {slot} to {n_tokens} "
                f"tokens ({need - have} blocks short) — admission "
                f"reservation accounting is broken")
        self.tables[slot, have:have + len(fresh)] = fresh
        return len(fresh)

    def truncate(self, slot: int, n_tokens: int) -> int:
        """Roll the slot back to ``n_tokens`` valid positions: drop table
        blocks past ``blocks_for(n_tokens)`` and release them (store
        refcounts respected — a block the prefix store still holds is only
        deref'd, never scrubbed).  Blocks that became fully free still hold
        rejected-draft KV, but those bytes are dead — no table references
        them and any future owner overwrites before its mask exposes them —
        so scrubbing is deferred to :meth:`scrub` and batched.  Returns the
        number of blocks dropped from the table."""
        keep = self.blocks_for(n_tokens)
        row = self.tables[slot]
        real = row[row < self.n_blocks]
        if len(real) <= keep:
            return 0
        tail = [int(b) for b in real[keep:]]
        self.tables[slot, keep:] = self.n_blocks
        self._dirty.update(self.release(tail))
        if len(self._dirty) >= 32:
            self.scrub()
        return len(tail)

    def scrub(self) -> None:
        """Zero the device bytes of every truncate-freed block still
        pending (one batched write).  Called automatically once enough
        blocks accumulate; call explicitly for a deterministic pool image
        (tests, checkpointing an idle engine)."""
        self._zero_blocks(sorted(self._dirty))
        self._dirty.clear()

    def _zero_blocks(self, ids: list) -> None:
        """Scrub freed blocks' device bytes in one indexed write."""
        if not ids:
            return
        idx = to_device(np.asarray(ids, np.int64), self.device)
        for pool in (self.pk, self.pv):
            if isinstance(pool, DTensor):
                pool = pool.to_local()
            pool[:, idx] = 0

    # ------------------------------------------------------ device views
    def cache_view(self, lengths: np.ndarray, rows=None) -> dict:
        """The cache tree the model's paged attention consumes.  ``rows``
        selects a subset of slots (e.g. one prefilling request); default is
        the full slot set (the fused decode).  Tables and lengths cross to
        the device once here, for every layer of the forward."""
        bt = self.tables if rows is None else self.tables[rows]
        return {"kv": {"pk": self.pk, "pv": self.pv,
                       "bt": to_device(bt, self.device),
                       "length": to_device(np.asarray(lengths, np.int32),
                                           self.device)}}

    def adopt(self, cache: dict) -> None:
        """Re-own the pool tensors a step returns (the same tensors: the
        step wrote them in place)."""
        self.pk = cache["kv"]["pk"]
        self.pv = cache["kv"]["pv"]

    def local_rows(self, src_cache: dict) -> dict:
        """A dense prefill cache's K/V as :meth:`insert_prefill` takes
        them: on a mesh, every row (gathered over the dimensions that
        split the batch, where the pool keeps every block) on this rank's
        KV heads; off it, as they are."""
        kv = src_cache["kv"]
        if not isinstance(self.pk, DTensor):
            return src_cache
        return {"kv": {n: kv[n].redistribute(self.pk.device_mesh,
                                             self.pk.placements).to_local()
                       for n in ("k", "v")}}

    def insert_prefill(self, src_cache: dict, slot: int, row: int) -> None:
        """Copy one row of a dense grouped-prefill cache (on a mesh, as
        :meth:`local_rows` gives it) into the slot's blocks (cropped to
        the table span; positions past the prefill are zeroed, as the
        reference pads them)."""
        ids = self.tables[slot]
        cols = np.flatnonzero(ids < self.n_blocks)      # sentinels drop
        if not len(cols):
            return
        span = self.blocks_per_seq * self.block_size
        kv = src_cache["kv"]
        crop = min(span, kv["k"].shape[2])
        bs = self.block_size
        cols_dev = to_device(cols.astype(np.int64), self.device)
        ids_dev = to_device(ids[cols].astype(np.int64), self.device)
        for pool, src in ((self.pk, kv["k"]), (self.pv, kv["v"])):
            if isinstance(pool, DTensor):
                pool = pool.to_local()
            sl = src[:, row, :crop]
            if crop < span:
                sl = torch.nn.functional.pad(
                    sl, (0, 0, 0, 0, 0, span - crop))
            blocks = sl.reshape(sl.shape[0], -1, bs, *sl.shape[2:])
            pool[:, ids_dev] = blocks[:, cols_dev].to(pool.dtype)

    def stats(self) -> dict:
        evictable = self.n_evictable()
        return {
            "paged": True,
            "n_blocks": self.n_blocks,
            "block_size": self.block_size,
            "blocks_used": self.n_used,
            "blocks_free": self.n_free,
            # disjoint occupancy split: live (a request holds a non-store
            # reference) + evictable (store-only) + free == n_blocks
            "blocks_live": self.n_used - evictable,
            "blocks_evictable": evictable,
            "store_blocks": int((self._store_refs > 0).sum()),
            "utilization": self.n_used / self.n_blocks,
        }


class PrefixCache:
    """Hash-keyed prompt-prefix store (block-aligned keys, LRU-bounded).

    Entries are opaque values under ``(length, prefix_bytes)`` keys:

    * :meth:`insert_blocks` (paged mode) publishes block-id tuples for every
      ``block``-multiple prefix length — zero-copy aliases into the
      :class:`PagedKVPool`, retained/evicted through the ``on_retain`` /
      ``on_evict`` hooks so refcounts stay exact;
    * :meth:`insert` (legacy dense-row mode) publishes K/V tensor views for
      every block-multiple length plus the full prompt.

    ``lookup(tokens)`` returns the longest stored prefix strictly shorter
    than the prompt (at least one real token must run through the model to
    produce logits).  LRU order is an ``OrderedDict`` (``move_to_end`` on
    touch).  Stats discipline: **only ``lookup()`` counts traffic**;
    ``covers()`` is a pure query (no counter, no LRU touch), so ``stats()``
    reflects exactly the admission lookups the engine performed.
    """

    def __init__(self, block: int = 16, capacity: int = 64, on_evict=None):
        self.block = block
        self.capacity = capacity
        self.on_evict = on_evict        # entry -> None (paged: release ids)
        self._store: collections.OrderedDict = collections.OrderedDict()
        self.lookups = 0
        self.hits = 0
        self.reused_tokens = 0
        self.prompt_tokens = 0

    def __len__(self) -> int:
        return len(self._store)

    def _touch(self, key) -> None:
        self._store.move_to_end(key)

    def covers(self, tokens: np.ndarray, length: int | None = None) -> bool:
        """Pure query: is the length-``length`` prefix (default: the full
        prompt) already published?  Does NOT count as a lookup and does not
        touch LRU recency — stats track admission traffic only."""
        n = len(tokens) if length is None else length
        if n <= 0:
            return True                  # nothing to publish
        return (n, tokens[:n].tobytes()) in self._store

    def lookup(self, tokens: np.ndarray):
        """Longest-match lookup: ``(hit_len, entry) | (0, None)``."""
        self.lookups += 1
        n = len(tokens)
        self.prompt_tokens += n
        lens = sorted({L for (L, _) in self._store if L < n}, reverse=True)
        for L in lens:
            key = (L, tokens[:L].tobytes())
            ent = self._store.get(key)
            if ent is not None:
                self.hits += 1
                self.reused_tokens += L
                self._touch(key)
                return L, ent
        return 0, None

    def _put(self, key, entry) -> None:
        self._store[key] = entry
        self._store.move_to_end(key)
        while len(self._store) > self.capacity:
            self.evict_one()

    def evict_one(self) -> bool:
        """Drop the LRU entry (``on_evict`` releases its blocks in paged
        mode).  Returns False when the store is empty."""
        if not self._store:
            return False
        _key, entry = self._store.popitem(last=False)
        if self.on_evict is not None:
            self.on_evict(entry)
        return True

    def insert(self, tokens: np.ndarray, kv: dict) -> None:
        """Legacy dense-row publish: ``kv`` {"k","v"} tensors of shape
        (n_layers, len(tokens), heads, head_dim); entries are views."""
        n = len(tokens)
        lens = {L for L in range(self.block, n, self.block)} | {n}
        for L in sorted(lens):
            key = (L, tokens[:L].tobytes())
            if key in self._store:
                self._touch(key)
                continue
            self._put(key, {"k": kv["k"][:, :L], "v": kv["v"][:, :L]})

    def insert_blocks(self, tokens: np.ndarray, ids, on_retain) -> None:
        """Paged publish: for every block-multiple prefix length, store the
        covering block-id tuple (``ids`` is the slot's table row).  New
        entries call ``on_retain(entry)`` so the pool's store refcounts
        stay exact; already-present keys are just touched."""
        aligned = (len(tokens) // self.block) * self.block
        for L in range(self.block, aligned + 1, self.block):
            key = (L, tokens[:L].tobytes())
            if key in self._store:
                self._touch(key)
                continue
            entry = tuple(int(b) for b in ids[:L // self.block])
            on_retain(entry)
            self._put(key, entry)

    def stats(self) -> dict:
        return {
            "entries": len(self._store),
            "lookups": self.lookups,
            "hits": self.hits,
            "hit_rate": self.hits / self.lookups if self.lookups else 0.0,
            "reused_tokens": self.reused_tokens,
            "prompt_tokens": self.prompt_tokens,
            "reused_frac": (self.reused_tokens / self.prompt_tokens
                            if self.prompt_tokens else 0.0),
        }
