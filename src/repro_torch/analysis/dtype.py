"""dtype-promotion lint: f32 leaks inside bf16 / int8-quantized paths.

Two views of one step trace, the counterparts of the reference's HLO and
jaxpr views:

  * **explicit upcasts** — narrow→f32 ``_to_copy`` calls (``x.to(float32)``)
    materializing at least ``min_numel`` elements (the reference's HLO
    ``convert`` floor);
  * **implicit promotions** — a pointwise op mixing a narrow tensor with an
    f32 one whose f32 result has at least ``min_numel_jaxpr`` elements
    (the reference's jaxpr view: a strong f32 operand dragging a narrow
    path wide).

Reduction accumulators are *supposed* to be f32; an upcast whose every
consumer is a reduction is exempt via ``allow_reduce``.
"""

from __future__ import annotations

from .base import AnalysisPass, register_pass

#: dtypes a quantized/mixed-precision path is allowed to stay in
NARROW = {"bf16", "f16", "s8", "u8", "s4", "u4", "s2", "u2",
          "f8e4m3fn", "f8e5m2", "f8e4m3b11fnuz", "f8e4m3fnuz",
          "f8e5m2fnuz", "f8e3m4", "f8e4m3", "f8e8m0fnu"}
WIDE = {"f32", "f64"}

#: the explicit casts
_CASTS = {"aten._to_copy", "aten.to"}

#: consumers that accumulate: an upcast feeding only these is exempt
_REDUCTIONS = {"aten.sum", "aten.mean", "aten.amax", "aten.amin",
               "aten.logsumexp", "aten.var", "aten.var_mean", "aten.std",
               "aten.linalg_vector_norm", "aten.norm", "aten.prod",
               "aten.cumsum"}
_REDUCE_OPCODES = {"all-reduce", "reduce-scatter"}


def _consumers(trace, idx: int) -> list:
    """The non-view records that read record ``idx``'s result, through
    views of it."""
    ids = set(trace.records[idx].out_ids)
    users = []
    for r in trace.records[idx + 1:]:
        if not ids.intersection(r.in_ids):
            continue
        if r.is_view:
            ids.update(r.out_ids)
        else:
            users.append(r)
    return users


@register_pass("dtype-promotion")
class DtypePromotionPass(AnalysisPass):
    KNOBS = {"min_numel": 1 << 20, "min_numel_jaxpr": 1 << 10,
             "allow_reduce": True, "severity": "warn"}

    def run(self, ctx):
        out = []
        if ctx.trace is None:
            return out
        min_numel = int(self.knobs["min_numel"])
        min_implicit = int(self.knobs["min_numel_jaxpr"])
        for i, r in enumerate(ctx.trace.records):
            if not r.out_dtypes or r.out_dtypes[0] not in WIDE:
                continue
            narrow = [d for d in r.in_dtypes if d in NARROW]
            if not narrow:
                continue
            numel = r.out_numel
            dst = r.out_dtypes[0]
            comp = r.op_name or ("backward" if r.backward else "step")
            if r.base in _CASTS:
                if numel < min_numel:
                    continue
                if self.knobs["allow_reduce"]:
                    users = _consumers(ctx.trace, i)
                    if users and all(u.base in _REDUCTIONS
                                     or u.opcode in _REDUCE_OPCODES
                                     for u in users):
                        continue
                byts = numel * (4 if dst == "f32" else 8)
                out.append(self.finding(
                    str(self.knobs["severity"]),
                    f"{narrow[0]}→{dst} promotion of {numel:,} elements "
                    f"({byts / 1e6:.2f} MB materialized) in {comp!r}",
                    opcode="convert", instruction=f"{r.name}.{i}",
                    computation=comp, op_name=r.op_name,
                    bytes_impact=float(byts),
                    fix_hint="keep the quantized path narrow: compute in "
                             f"{narrow[0]} (or fuse the upcast into the "
                             "consuming reduction) instead of "
                             "materializing a wide copy",
                    data={"src": narrow[0], "dst": dst, "numel": numel}))
            elif r.pointwise and any(d in WIDE for d in r.in_dtypes) \
                    and any(len(s) for s, d in zip(r.in_shapes, r.in_dtypes)
                            if d in WIDE):
                if numel < min_implicit:
                    continue
                out.append(self.finding(
                    str(self.knobs["severity"]),
                    f"implicit promotion: {r.name} mixes {narrow[0]} with "
                    f"an f32 tensor → {dst} ({numel:,} elements) in "
                    f"{comp!r}",
                    opcode=r.name, instruction=f"{r.name}.{i}",
                    computation=comp, bytes_impact=float(numel * 4),
                    fix_hint="cast the f32 operand down (or make it a "
                             "python scalar); the whole downstream path "
                             "now runs wide",
                    data={"numel": numel, "dtype": dst}))
        return out
