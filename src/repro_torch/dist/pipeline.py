"""Microbatch pipeline parallelism over a ``"pipe"`` mesh dimension.

A GPipe schedule run by every rank of the mesh: stage ``s`` (the rank's
coordinate on ``pipe``) owns layers ``[s·L/S, (s+1)·L/S)``, microbatches
stream through the stages, and activations move stage→stage on a ring
with ``batch_isend_irecv``.  The schedule runs ``M + S - 1`` ticks; at
tick ``t`` stage ``s`` processes microbatch ``t - s`` (bubble ticks
compute on zeros and are discarded).  Outputs are collected on the last
stage and all-reduced over ``pipe`` so every rank returns the full result;
with a ``"data"`` dimension the microbatch's batch dimension is split over
it and gathered back.

The ring shift is a ``torch.autograd.Function`` whose backward is the
reverse permutation, so gradients flow back along the same ring (the
transpose of the reference's ``ppermute``).  The gradient a rank gets for
``ws`` is its share: its stage's layers, from its data block — summed over
the mesh it is the gradient of the sequential layers.

Numerics match sequential layer-by-layer execution exactly (no
rematerialization or dtype tricks).
"""

from __future__ import annotations

import torch
import torch.distributed as dist


class _Shift(torch.autograd.Function):
    """Send ``y`` to the next stage and receive the previous stage's; the
    backward sends the gradient to the previous stage and receives the
    next stage's."""

    @staticmethod
    def forward(ctx, y, pg, nxt: int, prv: int):
        ctx.pg, ctx.nxt, ctx.prv = pg, nxt, prv
        return _exchange(y, pg, to=nxt, frm=prv)

    @staticmethod
    def backward(ctx, grad):
        return _exchange(grad.contiguous(), ctx.pg, to=ctx.prv,
                         frm=ctx.nxt), None, None, None


def _exchange(t: torch.Tensor, pg, to: int, frm: int) -> torch.Tensor:
    out = torch.empty_like(t)
    ops = [dist.P2POp(dist.isend, t.contiguous(), to, pg),
           dist.P2POp(dist.irecv, out, frm, pg)]
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    return out


class _Collect(torch.autograd.Function):
    """Sum over ``pipe`` (only the last stage holds non-zero outputs), then
    gather the batch blocks over ``data`` along dimension 1.  The result is
    replicated, so the backward passes each rank its own block of the
    gradient (the identity over ``pipe``)."""

    @staticmethod
    def forward(ctx, outputs, pipe_pg, data_pg, n_data: int, data_idx: int):
        ctx.n_data, ctx.data_idx = n_data, data_idx
        out = outputs.contiguous().clone()
        dist.all_reduce(out, group=pipe_pg)
        if n_data == 1:
            return out
        parts = [torch.empty_like(out) for _ in range(n_data)]
        dist.all_gather(parts, out, group=data_pg)
        return torch.cat(parts, dim=1)

    @staticmethod
    def backward(ctx, grad):
        if ctx.n_data > 1:
            grad = grad.chunk(ctx.n_data, dim=1)[ctx.data_idx]
        return grad.contiguous(), None, None, None, None


def make_pipelined_fn(mesh, block, n_stages: int, layers_per_stage: int):
    """Build ``fn(ws, xs) -> ys`` running ``block`` as a pipeline.

    ``block(w, x) -> x`` is one layer; ``ws`` stacks the per-layer weights
    on the leading dim (``n_stages * layers_per_stage`` layers; every rank
    passes the full stack and runs its stage's slice); ``xs`` stacks
    microbatches on the leading dim.  The per-microbatch batch dim
    (``xs.shape[1]``) additionally splits over the mesh's ``"data"``
    dimension when divisible.  Every rank gets the full ``ys``.
    """
    names = tuple(mesh.mesh_dim_names or ())
    if "pipe" not in names:
        raise ValueError(f"mesh {names} has no 'pipe' axis")
    sizes = dict(zip(names, mesh.shape))
    if sizes["pipe"] != n_stages:
        raise ValueError(f"n_stages={n_stages} != pipe axis size "
                         f"{sizes['pipe']}")
    pipe_pg = mesh.get_group("pipe")
    stage = mesh.get_local_rank("pipe")
    nxt = dist.get_global_rank(pipe_pg, (stage + 1) % n_stages)
    prv = dist.get_global_rank(pipe_pg, (stage - 1) % n_stages)
    n_data = sizes.get("data", 1)

    def pipelined(ws, xs):
        if ws.shape[0] != n_stages * layers_per_stage:
            raise ValueError(f"expected {n_stages * layers_per_stage} "
                             f"layers, got {ws.shape[0]}")
        n_micro = xs.shape[0]
        split = n_data > 1 and xs.dim() >= 2 and xs.shape[1] % n_data == 0
        data_idx = mesh.get_local_rank("data") if split else 0
        if split:
            xs = xs.chunk(n_data, dim=1)[data_idx]
        ws_local = ws[stage * layers_per_stage:
                      (stage + 1) * layers_per_stage]
        first = torch.tensor(stage == 0, device=xs.device)
        last = torch.tensor(stage == n_stages - 1, device=xs.device)
        state = torch.zeros_like(xs[0])
        outputs = [None] * n_micro
        ticks = n_micro + n_stages - 1
        for t in range(ticks):
            # stage 0 ingests microbatch t; later stages consume the
            # activation shifted to them at the end of tick t-1 (every
            # rank uses the shifted tensor, so every rank runs the
            # shift's backward, in the same order)
            mb = xs[t] if t < n_micro else torch.zeros_like(state)
            y = torch.where(first, mb, state)
            for i in range(layers_per_stage):
                y = block(ws_local[i], y)
            out_idx = t - (n_stages - 1)
            if out_idx >= 0:          # the last stage emits mb ``out_idx``
                outputs[out_idx] = torch.where(last, y,
                                               torch.zeros_like(y))
            if t < ticks - 1 and n_stages > 1:
                state = _Shift.apply(y, pipe_pg, nxt, prv)
        return _Collect.apply(torch.stack(outputs), pipe_pg,
                              mesh.get_group("data") if split else None,
                              n_data if split else 1, data_idx)

    return pipelined
