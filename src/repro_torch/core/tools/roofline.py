"""Roofline tool — the three roofline terms of a captured step, plus a
batch-consuming :class:`RooflineTool` that accumulates the same terms live
from the columnar event stream.

Terms (per device):

    compute    = FLOPs      / peak_FLOP/s
    memory     = HBM bytes  / HBM_bw
    collective = wire bytes / link_bw

Hardware constants: one NVIDIA H100 SXM5 80 GB, from NVIDIA's H100 data
sheet (https://www.nvidia.com/en-us/data-center/h100/), dense rates
without sparsity, at the card's full power limit of 700 W.  The ``hw``
dict keeps the reference's keys (``ici_bw`` is the card-to-card link,
NVLink on this card).  Unlike the reference, whose ``roofline_fraction``
divides by its one built-in table, :class:`Roofline` divides by the peak
of the ``hw`` it was built with.
"""

from __future__ import annotations

import dataclasses

H100 = {
    "peak_flops": 989e12,      # bf16 dense tensor-core FLOP/s
    "hbm_bw": 3.35e12,         # HBM3 bytes/s
    "ici_bw": 900e9,           # NVLink bytes/s per card (4th generation)
    # the link between hosts (the reference's inter-pod DCI): one
    # ConnectX-7 port of 400 Gb/s per card, from NVIDIA's DGX H100 data
    # sheet (https://www.nvidia.com/en-us/data-center/dgx-h100/) — a
    # data-sheet rate, not a measurement
    "dci_bw": 50e9,
    # per-collective latency (alpha): no data sheet gives one; the
    # reference's 1 us, kept as an assumption, not a measurement
    "ici_latency": 1e-6,
    "hbm_bytes": 80e9,         # HBM3 capacity, "80 GB"
}


@dataclasses.dataclass
class Roofline:
    compute_s: float
    memory_s: float
    collective_s: float
    model_flops_per_chip: float = 0.0
    hlo_flops_per_chip: float = 0.0
    peak_flops: float = H100["peak_flops"]

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def step_time_s(self) -> float:
        """Lower-bound step time = max of the three terms (perfect overlap)."""
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def roofline_fraction(self) -> float:
        """Fraction of the compute roofline achieved at the bound step time:
        useful-FLOPs/chip / peak / step_time."""
        if self.step_time_s <= 0:
            return 0.0
        return (self.model_flops_per_chip / self.peak_flops) \
            / self.step_time_s

    @property
    def useful_flops_ratio(self) -> float:
        if self.hlo_flops_per_chip <= 0:
            return 0.0
        return self.model_flops_per_chip / self.hlo_flops_per_chip

    def as_dict(self) -> dict:
        return {
            "compute_s": self.compute_s,
            "memory_s": self.memory_s,
            "collective_s": self.collective_s,
            "bottleneck": self.bottleneck,
            "step_time_lb_s": self.step_time_s,
            "roofline_fraction": self.roofline_fraction,
            "useful_flops_ratio": self.useful_flops_ratio,
        }


def roofline(flops_per_chip: float, hbm_bytes_per_chip: float,
             coll_bytes_per_chip: float, model_flops_per_chip: float = 0.0,
             hw: dict = H100) -> Roofline:
    return Roofline(
        compute_s=flops_per_chip / hw["peak_flops"],
        memory_s=hbm_bytes_per_chip / hw["hbm_bw"],
        collective_s=coll_bytes_per_chip / hw["ici_bw"],
        model_flops_per_chip=model_flops_per_chip,
        hlo_flops_per_chip=flops_per_chip,
        peak_flops=hw["peak_flops"],
    )


def model_flops(n_params: float, n_tokens: float, training: bool = True,
                n_active_params: float | None = None) -> float:
    """MODEL_FLOPS = 6·N·D (train) or 2·N·D (inference fwd); MoE uses
    N_active."""
    n = n_active_params if n_active_params is not None else n_params
    return (6.0 if training else 2.0) * n * n_tokens


# ---------------------------------------------------------------------------
# Event-stream roofline accumulator (columnar tool)
# ---------------------------------------------------------------------------

import numpy as np                                        # noqa: E402

from ..events import EventKind                            # noqa: E402
from .base import PastaTool, register                     # noqa: E402


@register("roofline")
class RooflineTool(PastaTool):
    """Accumulates the three roofline terms from the event stream itself:
    per-device HBM traffic from KERNEL_LAUNCH batches (``bytes × count``),
    wire bytes from COLLECTIVE batches (``size × mult``), and FLOPs from the
    COMPILE event's cost analysis.  Batch consumption is vectorized over the
    size/count columns; attrs are only touched on the (few) rows that carry
    them."""

    EVENTS = (EventKind.KERNEL_LAUNCH, EventKind.COLLECTIVE,
              EventKind.COMPILE)

    def __init__(self, hw: dict = H100, model_flops_per_chip: float = 0.0,
                 **knobs):
        super().__init__(**knobs)
        self.hw = dict(hw)
        self.model_flops_per_chip = model_flops_per_chip
        self.flops = 0.0
        self.hbm_bytes = 0.0
        self.coll_bytes = 0.0
        self.kernel_invocations = 0

    # scalar hooks — kept equivalent to on_batch (single-row fast path)
    def on_kernel_launch(self, ev):
        n = int(ev.attrs.get("count", 1))
        self.kernel_invocations += n
        self.hbm_bytes += float(ev.attrs.get("bytes", 0)) * n

    def on_collective(self, ev):
        self.coll_bytes += float(ev.size) * float(ev.attrs.get("mult", 1))

    def on_compile(self, ev):
        ca = ev.attrs.get("cost_analysis") or {}
        self.flops += float(ca.get("flops", 0.0))

    def on_batch(self, batch):
        kidx = batch.rows(EventKind.KERNEL_LAUNCH)
        if kidx.size:
            counts = (batch.counts[kidx] if batch.counts is not None
                      else np.ones(kidx.size, dtype=np.int64))
            self.kernel_invocations += int(counts.sum())
            byts = batch.attr_column("bytes", 0, rows=kidx, dtype=np.float64)
            self.hbm_bytes += float((byts * counts).sum())
        cidx = batch.rows(EventKind.COLLECTIVE)
        if cidx.size:
            mult = batch.attr_column("mult", 1, rows=cidx, dtype=np.float64)
            self.coll_bytes += float((batch.sizes[cidx] * mult).sum())
        for i in batch.rows(EventKind.COMPILE):
            a = batch.attrs_at(int(i))
            if a:
                ca = a.get("cost_analysis") or {}
                self.flops += float(ca.get("flops", 0.0))

    def finalize(self) -> dict:
        rl = roofline(self.flops, self.hbm_bytes, self.coll_bytes,
                      model_flops_per_chip=self.model_flops_per_chip,
                      hw=self.hw)
        out = rl.as_dict()
        out.update(kernel_invocations=self.kernel_invocations,
                   hbm_bytes=self.hbm_bytes, coll_bytes=self.coll_bytes,
                   flops=self.flops)
        return out
