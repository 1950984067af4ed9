"""The port's static analysis (``repro_torch.analysis``) against the JAX
package's (``repro.analysis``), on the CPU: the counterpart of each unit
test of tests/test_analysis.py.

* Registry, spec grammar, knobs, ``spec_of``, finding keys, baselines and
  severity filters: the same inputs through both packages, equal results.
* The collective wire-bytes golden table and the ICI/DCI link
  classification: equal.
* Each pass on hand-built golden step traces that mirror the reference's
  golden HLO cases: it fires, or stays quiet, in the same cases, with the
  same ``pass_name``, severity and ``data`` keys (and the same values
  where both compute them exactly: axes, dtypes, element counts, the
  peak estimate, the argument index).
* The pass-error backstop, an unparseable artifact and ``FINDING`` events.

Random draws (spec round trips, trace mutations) come from a seeded
``np.random.default_rng``.  No tolerance is needed: every compared value
is exact.
"""

import json

import numpy as np
import pytest

from repro import analysis as janalysis
from repro.core.hlo import collective_wire_bytes as jwire
from test_analysis import (BLOCKING_HLO, DTYPE_HLO, HOST_HLO, HW, LINK_TABLE,
                           MESH, MODEL_GROUPS, OVERLAPPED_HLO, PEAK_HLO,
                           POD_GROUPS, RESHARD_ACT_HLO, RESHARD_RSAG_HLO,
                           RESHARD_WEIGHT_HLO, RULES, WIRE_TABLE)
from repro_torch import analysis
from repro_torch.analysis import (Baseline, Finding, Findings, PASS_REGISTRY,
                                  estimate_peak_bytes, format_pass_spec,
                                  parse_pass_spec, resolve_passes,
                                  run_passes, spec_of)
from repro_torch.core import events as tevents
from repro_torch.core import session as tsession
from repro_torch.core.capture import collective_wire_bytes
from repro_torch.core.trace import (StepTrace, TraceRecord, analyze_trace,
                                    group_axes)

RUN_KW = dict(rules=RULES, kind="train", hw=HW, emit_events=False)
JRUN_KW = dict(mesh_axes=MESH, rules=RULES, kind="train", hw=HW, pods=2,
               n_devices=8, emit_events=False)
MIB = 2 ** 20


@pytest.fixture(autouse=True)
def _port_state():
    tevents.reset_seq()
    tsession.reset_state()
    yield
    tsession.reset_state()


def _groups(text: str) -> list:
    return [[int(x) for x in g.split(",")]
            for g in text.strip("{}").split("},{")]


# ---------------------------------------------------------------------------
# golden step traces (the reference's golden HLO cases, as records)
# ---------------------------------------------------------------------------

def _nbytes(shape, itemsize=4):
    n = itemsize
    for d in shape:
        n *= d
    return n


def _op(op, ins, outs, in_shapes, out_shapes, dtype="f32", in_dtypes=None,
        **kw):
    """A compute record: storage ids, shapes and (HLO-named) dtypes."""
    size = {"f32": 4, "bf16": 2, "f64": 8}
    in_dtypes = in_dtypes or (dtype,) * len(ins)
    return TraceRecord(
        op=op, name=op.replace(".", "::", 1).rsplit(".", 1)[0],
        in_ids=tuple(ins), out_ids=tuple(outs),
        in_shapes=tuple(in_shapes), out_shapes=tuple(out_shapes),
        in_dtypes=tuple(in_dtypes), out_dtypes=(dtype,) * len(outs),
        in_bytes=sum(_nbytes(s, size[d]) for s, d in zip(in_shapes,
                                                          in_dtypes)),
        out_bytes=sum(_nbytes(s, size[dtype]) for s in out_shapes),
        out_numel=sum(_nbytes(s, 1) for s in out_shapes), **kw)


def _coll(opcode, ins, outs, in_shape, out_shape, groups, **kw):
    axes, crosses = group_axes(_groups(groups), MESH)
    rec = _op({"all-reduce": "_c10d_functional.all_reduce.default",
               "all-gather": "_c10d_functional.all_gather_into_tensor"
                             ".default",
               "reduce-scatter": "_c10d_functional.reduce_scatter_tensor"
                                 ".default",
               "all-to-all": "_c10d_functional.all_to_all_single.default"}
              [opcode], ins, outs, [in_shape], [out_shape], **kw)
    rec.opcode = opcode
    rec.group = tuple(_groups(groups)[0])
    rec.axes, rec.crosses_pods = axes, crosses
    return rec


def _wait(i_start, ids):
    return TraceRecord(op="_c10d_functional.wait_tensor.default",
                       name="_c10d_functional::wait_tensor",
                       in_ids=tuple(ids), out_ids=tuple(ids), is_wait=True)


def _trace(records, nbytes, persistent=(), outputs=(), arg_leaves=(),
           out_leaves=()):
    for i, r in enumerate(records):
        if r.opcode and r.wait is None:
            j = next((k for k in range(i + 1, len(records))
                      if records[k].is_wait
                      and set(records[k].in_ids) & set(r.out_ids)), None)
            r.wait = j
    return StepTrace(records=records, mesh_axes=dict(MESH), n_devices=8,
                     device_type="cpu", storage_bytes=dict(nbytes),
                     persistent=set(persistent), outputs=set(outputs),
                     arg_leaves=list(arg_leaves),
                     out_leaves=list(out_leaves))


N1 = 1048576


def blocking_trace():
    """all-reduce over the pod groups, consumed at once (sync)."""
    return _trace([
        _coll("all-reduce", [0], [1], (N1,), (N1,), POD_GROUPS),
        _op("aten.add.Tensor", [1, 1], [2], [(N1,), (N1,)], [(N1,)]),
    ], {0: 4 * N1, 1: 4 * N1, 2: 4 * N1}, persistent={0}, outputs={2})


def overlapped_trace():
    """an async all-reduce of p1 with a 1024^3 matmul before its wait."""
    mm = _op("aten.mm.default", [0, 0], [3], [(1024, 1024)] * 2,
             [(1024, 1024)])
    mm.flops = 2.0 * 1024 ** 3
    return _trace([
        _coll("all-reduce", [1], [2], (4096,), (4096,), POD_GROUPS),
        mm,
        _wait(0, [2]),
    ], {0: 4 * MIB, 1: 16384, 2: 16384, 3: 4 * MIB}, persistent={0, 1},
        outputs={2, 3})


def reshard_act_trace(groups=MODEL_GROUPS, op_name=""):
    mm = _op("aten.mm.default", [0, 0], [1], [(512, 512)] * 2, [(512, 512)],
             param_rooted=(True, True))
    mm.flops = 2.0 * 512 ** 3
    ag = _coll("all-gather", [1], [2], (512, 512), (1024, 512), groups,
               op_name=op_name)
    return _trace([mm, ag], {0: MIB, 1: MIB, 2: 2 * MIB}, persistent={0},
                  outputs={2})


def reshard_weight_trace():
    cast = _op("aten._to_copy.default", [0], [1], [(512, 512)], [(512, 512)],
               in_dtypes=("bf16",), param_rooted=(True,))
    ag = _coll("all-gather", [1], [2], (512, 512), (1024, 512), MODEL_GROUPS,
               param_rooted=(True,))
    return _trace([cast, ag], {0: MIB // 2, 1: MIB, 2: 2 * MIB},
                  persistent={0}, outputs={2})


def reshard_rsag_trace(rs_groups=MODEL_GROUPS):
    """reduce-scatter of a gradient, accumulated, then all-gathered: the
    two halves of one all-reduce."""
    return _trace([
        _op("aten.arange.start", [], [1], [], [(1024, 512)]),
        _coll("reduce-scatter", [1], [2], (1024, 512), (512, 512),
              rs_groups),
        _wait(1, [2]),
        _op("aten.add.Tensor", [3, 2], [4], [(512, 512)] * 2, [(512, 512)]),
        _coll("all-gather", [4], [5], (512, 512), (1024, 512),
              MODEL_GROUPS),
    ], {1: 2 * MIB, 2: MIB, 3: MIB, 4: MIB, 5: 2 * MIB}, persistent={0, 3},
        outputs={5})


def dtype_trace(consumer="aten.mul.Tensor"):
    cast = _op("aten._to_copy.default", [0], [1], [(1024, 1024)],
               [(1024, 1024)], in_dtypes=("bf16",))
    if consumer == "aten.sum.dim_IntList":
        use = _op(consumer, [1], [2], [(1024, 1024)], [(1024,)])
    else:
        use = _op(consumer, [1, 1], [2], [(1024, 1024)] * 2,
                  [(1024, 1024)], pointwise=True)
    return _trace([cast, use], {0: 2 * MIB, 1: 4 * MIB, 2: 4 * MIB},
                  persistent={0}, outputs={2})


def peak_trace():
    e = _op("aten.exp.default", [0], [1], [(512, 512)], [(512, 512)],
            pointwise=True)
    d = _op("aten.mm.default", [1, 1], [2], [(512, 512)] * 2, [(512, 512)])
    return _trace([e, d], {0: MIB, 1: MIB, 2: MIB}, persistent={0},
                  outputs={2})


def host_trace():
    """p0 updated in place (donated), p1's result in a new buffer, and a
    scalar read in between."""
    item = _op("aten._local_scalar_dense.default", [0], [], [(512, 512)], [],
               host_sync="item")
    upd = _op("aten.add_.Tensor", [0, 0], [0], [(512, 512)] * 2,
              [(512, 512)])
    new = _op("aten.mul.Tensor", [1, 1], [2], [(512, 512)] * 2,
              [(512, 512)], pointwise=True)
    leaf = ("f32", (512, 512))
    return _trace([item, upd, new], {0: MIB, 1: MIB, 2: MIB},
                  persistent={0, 1}, outputs={0, 2},
                  arg_leaves=[(*leaf, 0), (*leaf, 1)],
                  out_leaves=[(*leaf, 0), (*leaf, 2)])


def _shape(findings, name):
    return [(f.pass_name, f.severity, sorted(f.data))
            for f in findings.by_pass(name)]


def _both(text, trace, spec, **kw):
    """(port findings, reference findings) of one golden case."""
    want = janalysis.run_passes(text, spec, **{**JRUN_KW, **kw})
    got = run_passes(trace, spec, **{**RUN_KW, **kw})
    name = spec.split(":")[0]
    assert _shape(got, name) == _shape(want, name)
    return got, want


# ---------------------------------------------------------------------------
# registry + spec grammar
# ---------------------------------------------------------------------------

def test_registry_has_the_five_builtin_passes():
    assert sorted(PASS_REGISTRY) == sorted(janalysis.PASS_REGISTRY)
    for name in PASS_REGISTRY:
        assert PASS_REGISTRY[name].KNOBS == \
            janalysis.PASS_REGISTRY[name].KNOBS, name
    assert analysis.DEFAULT_SPEC == janalysis.DEFAULT_SPEC


def test_spec_parse_and_knob_override():
    spec = "exposed-collectives:threshold_frac=0.5,min_bytes=1024,peak-memory"
    got, want = resolve_passes(spec), janalysis.resolve_passes(spec)
    assert [(p.REGISTRY_NAME, p.knobs) for p in got] == \
        [(p.REGISTRY_NAME, p.knobs) for p in want]
    assert got[0].knobs["threshold_frac"] == 0.5
    assert got[0].knobs["min_bytes"] == 1024


def test_unknown_pass_and_unknown_knob_raise():
    for resolve in (resolve_passes, janalysis.resolve_passes):
        with pytest.raises(KeyError):
            resolve("no-such-pass")
        with pytest.raises(TypeError):
            resolve("peak-memory:bogus_knob=1")


def test_spec_of_records_only_non_default_knobs():
    spec = "exposed-collectives:threshold_frac=0.5,host-sync"
    assert spec_of(resolve_passes(spec)) == \
        janalysis.spec_of(janalysis.resolve_passes(spec)) == spec


# ---------------------------------------------------------------------------
# Finding / Baseline plumbing: the same calls on both packages
# ---------------------------------------------------------------------------

def _mk(mod, pass_name="p", sev="warn", opcode="all-gather", comp="main",
        ins="ag.1"):
    return mod.Finding(pass_name=pass_name, severity=sev, message="m",
                       opcode=opcode, computation=comp, instruction=ins)


@pytest.mark.parametrize("mod", [analysis, janalysis],
                         ids=["port", "reference"])
def test_finding_key_shape(mod):
    assert _mk(mod).key == "p:all-gather:main/ag.1"
    assert _mk(mod, ins="").key == "p:all-gather:main"
    assert mod.Finding(pass_name="p", severity="warn",
                       message="m").key == "p:-:-"
    assert _mk(mod).as_dict() == _mk(janalysis).as_dict()


def _baseline_run(mod, path):
    f = mod.Findings()
    f.extend([_mk(mod, ins="ag.1"), _mk(mod, ins="ag.2"),
              _mk(mod, pass_name="q")])
    base = {"version": 1, "suppress": [
        {"key": "p:all-gather:main/ag.1", "reason": "known"},
        {"key": "q:*"},
    ]}
    n = f.apply_baseline(base)
    live = [x.instruction for x in f.unsuppressed("warn")]
    reason = f.findings[0].suppressed_reason
    f.write_baseline(str(path), reason="adopt")
    doc = json.loads(path.read_text())
    f2 = mod.Findings()
    f2.extend([_mk(mod, ins="ag.2")])
    return n, live, reason, doc, f2.apply_baseline(str(path)), \
        f2.unsuppressed()


def test_baseline_exact_then_glob(tmp_path):
    got = _baseline_run(analysis, tmp_path / "port.json")
    want = _baseline_run(janalysis, tmp_path / "ref.json")
    assert got == want
    assert got[:4] == (2, ["ag.2"], "known", {
        "version": 1, "suppress": [{"key": "p:all-gather:main/ag.2",
                                    "reason": "adopt"}]})
    assert Baseline.load(str(tmp_path / "port.json")).entries == \
        janalysis.Baseline.load(str(tmp_path / "ref.json")).entries


def test_findings_severity_filter_and_counts():
    out = []
    for mod in (analysis, janalysis):
        f = mod.Findings(label="cell")
        f.extend([_mk(mod, sev="info"), _mk(mod, sev="warn"),
                  _mk(mod, sev="error")])
        out.append((len(f.unsuppressed("warn")), f.max_severity(),
                    f.counts(), json.loads(f.to_json()), f.summary()))
    assert out[0] == out[1]
    assert out[0][0] == 2 and out[0][1] == "error"
    assert out[0][2] == {"p": {"info": 1, "warn": 1, "error": 1}}


# ---------------------------------------------------------------------------
# exposed-collectives
# ---------------------------------------------------------------------------

def test_exposed_fires_on_blocking_sync():
    got, _want = _both(BLOCKING_HLO, blocking_trace(), "exposed-collectives")
    (h,) = got.by_pass("exposed-collectives")
    assert h.opcode == "all-reduce" and h.severity == "warn"
    assert h.data["link"] == "dci" and h.data["exposed_frac"] > 0.9
    assert h.seconds_impact > 0 and h.bytes_impact > 0
    assert "overlap" in h.fix_hint


def test_exposed_quiet_when_async_pair_hides_the_transfer():
    got, _want = _both(OVERLAPPED_HLO, overlapped_trace(),
                       "exposed-collectives")
    assert not got.by_pass("exposed-collectives")


def test_exposed_link_filter_and_aggregate_budget():
    spec = ("exposed-collectives:link=dci,threshold_frac=1.1,"
            "total_budget_s=1e-07")
    got, _want = _both(BLOCKING_HLO, blocking_trace(), spec)
    (h,) = got.by_pass("exposed-collectives")
    assert h.instruction == "total[dci]"
    assert h.data["total_exposed_s"] > 1e-07
    assert got.meta["exposed_s:dci"] == pytest.approx(
        h.data["total_exposed_s"])
    spec = ("exposed-collectives:link=ici,threshold_frac=1.1,"
            "total_budget_s=1e-07")
    got, _want = _both(BLOCKING_HLO, blocking_trace(), spec)
    assert not got.by_pass("exposed-collectives")
    assert got.meta["exposed_s:ici"] == 0.0


# ---------------------------------------------------------------------------
# implicit-reshard
# ---------------------------------------------------------------------------

def test_reshard_fires_on_activation_gather_over_tensor_axis():
    got, want = _both(RESHARD_ACT_HLO, reshard_act_trace(),
                      "implicit-reshard")
    (h,) = got.by_pass("implicit-reshard")
    assert h.opcode == "all-gather"
    assert h.data["axes"] == ["model"] == \
        want.by_pass("implicit-reshard")[0].data["axes"]
    assert "mis-sharded" in h.fix_hint


def test_reshard_quiet_on_intended_batch_axis_gather():
    got, _want = _both(RESHARD_ACT_HLO.replace(MODEL_GROUPS, POD_GROUPS),
                       reshard_act_trace(POD_GROUPS), "implicit-reshard")
    assert not got.by_pass("implicit-reshard")


def test_reshard_quiet_on_param_rooted_weight_gather():
    got, _want = _both(RESHARD_WEIGHT_HLO, reshard_weight_trace(),
                       "implicit-reshard")
    assert not got.by_pass("implicit-reshard")


def test_reshard_quiet_on_rs_ag_decomposition():
    """The all-gather tail of an all-reduce split in two (reduce-scatter,
    accumulated, gathered) is intended reduction traffic; a
    reduce-scatter over DIFFERENT axes is not its partner."""
    got, _want = _both(RESHARD_RSAG_HLO, reshard_rsag_trace(),
                       "implicit-reshard")
    assert not got.by_pass("implicit-reshard")
    text = RESHARD_RSAG_HLO.replace(
        "reduce-scatter(f32[1024,512]{1,0} %grad), replica_groups="
        + MODEL_GROUPS,
        "reduce-scatter(f32[1024,512]{1,0} %grad), replica_groups="
        + POD_GROUPS)
    got, _want = _both(text, reshard_rsag_trace(POD_GROUPS),
                       "implicit-reshard")
    assert len(got.by_pass("implicit-reshard")) == 1


def test_reshard_skips_explicitly_requested_collectives():
    text = RESHARD_ACT_HLO.replace(
        'op_name="jit(step)/jit(main)/dot_general"',
        'op_name="jit(step)/jit(main)/jit(shmap_body)/all_gather"')
    got, _want = _both(text, reshard_act_trace(
        op_name="psum_wait/trainer.retire"), "implicit-reshard")
    assert not got.by_pass("implicit-reshard")


def test_reshard_allow_axes_knob():
    got, _want = _both(RESHARD_ACT_HLO, reshard_act_trace(),
                       "implicit-reshard:allow_axes=model")
    assert not got.by_pass("implicit-reshard")


# ---------------------------------------------------------------------------
# dtype-promotion
# ---------------------------------------------------------------------------

def test_dtype_fires_on_large_upcast():
    got, want = _both(DTYPE_HLO, dtype_trace(), "dtype-promotion")
    (h,) = got.by_pass("dtype-promotion")
    (w,) = want.by_pass("dtype-promotion")
    assert h.opcode == w.opcode == "convert"
    assert h.data == w.data == {"src": "bf16", "dst": "f32",
                                "numel": 1024 * 1024}


def test_dtype_exempts_reduction_accumulator():
    text = DTYPE_HLO.replace(
        "ROOT %mul = f32[1024,1024]{1,0} multiply(f32[1024,1024]{1,0} %cv, "
        "f32[1024,1024]{1,0} %cv)",
        "ROOT %r = f32[1024]{0} reduce(f32[1024,1024]{1,0} %cv, f32[] %zero)"
        ", dimensions={1}, to_apply=%add")
    trace = dtype_trace("aten.sum.dim_IntList")
    got, _want = _both(text, trace, "dtype-promotion")
    assert not got.by_pass("dtype-promotion")
    got, _want = _both(text, trace, "dtype-promotion:allow_reduce=false")
    assert len(got.by_pass("dtype-promotion")) == 1


def test_dtype_min_numel_floor():
    got, _want = _both(DTYPE_HLO, dtype_trace(),
                       "dtype-promotion:min_numel=2097152")
    assert not got.by_pass("dtype-promotion")


def test_dtype_implicit_promotion_floor():
    """A pointwise op mixing bf16 with an f32 tensor promotes implicitly
    (the reference's jaxpr view): flagged above ``min_numel_jaxpr``."""
    mix = _op("aten.mul.Tensor", [0, 1], [2], [(64, 64)] * 2, [(64, 64)],
              in_dtypes=("bf16", "f32"), pointwise=True)
    trace = _trace([mix], {0: 8192, 1: 16384, 2: 16384},
                   persistent={0, 1}, outputs={2})
    (h,) = run_passes(trace, "dtype-promotion", **RUN_KW).findings
    assert sorted(h.data) == ["dtype", "numel"] and h.data["numel"] == 4096
    assert not run_passes(trace, "dtype-promotion:min_numel_jaxpr=8192",
                          **RUN_KW).findings


# ---------------------------------------------------------------------------
# peak-memory
# ---------------------------------------------------------------------------

def test_estimate_peak_bytes_liveness():
    from repro.core.hlo import parse_hlo
    want = janalysis.estimate_peak_bytes(parse_hlo(PEAK_HLO))
    got = estimate_peak_bytes(peak_trace())
    for k in ("persistent_bytes", "transient_peak_bytes", "peak_bytes"):
        assert got[k] == want[k], k
    assert got["peak_bytes"] == 3 * MIB
    assert got["at_instruction"] == "aten::mm.1"


def test_peak_memory_budget_gate():
    got, _want = _both(PEAK_HLO, peak_trace(), "peak-memory",
                       device_budget=2 * MIB)
    (h,) = got.by_pass("peak-memory")
    assert h.severity == "error" and h.opcode == "liveness"
    assert got.meta["peak_bytes_est"] == 3 * MIB
    got, _want = _both(PEAK_HLO, peak_trace(), "peak-memory")
    assert not got.by_pass("peak-memory")
    assert got.meta["peak_bytes_est"] == 3 * MIB


def test_peak_estimate_holds_a_train_steps_gradients():
    """A train step keeps its gradient tree until its update returns, so
    the estimate holds the gradients to the step's end.  On a 4-layer
    stablelm-1.6b variant (d_model 256, float32, batch 2 x 64) the
    estimate reads 0.975 of the fake run's own high-water mark; freeing
    each gradient at its last use read 0.843 (the 0.8432 the card's
    full-size step gave, ROADMAP section 3)."""
    import dataclasses
    import torch
    import repro_torch.configs as TC
    from repro_torch.analysis.memory import _held_grads
    from repro_torch.core.trace import trace_step
    from repro_torch.models import init_params
    from repro_torch.train import OptConfig, init_opt_state, make_train_step
    from repro_torch.train.optimizer import tree_paths
    cfg = dataclasses.replace(TC.reduced(TC.get("stablelm-1.6b")),
                              n_layers=4, d_model=256, d_ff=1024,
                              vocab_size=4096)
    params = init_params(cfg, 0, "cpu")
    opt = OptConfig()
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 65)))
    trace = trace_step(make_train_step(cfg, opt), params,
                       init_opt_state(params, opt),
                       {"inputs": toks[:, :-1], "labels": toks[:, 1:]},
                       device_type="cpu")
    held = sum(trace.storage_bytes[s] for s in _held_grads(trace))
    assert held == sum(p.numel() * 4 for _path, p in tree_paths(params))
    ratio = estimate_peak_bytes(trace)["peak_bytes"] \
        / trace.measured_peak_bytes
    assert 0.95 <= ratio <= 1.0, ratio


# ---------------------------------------------------------------------------
# host-sync
# ---------------------------------------------------------------------------

def test_host_sync_flags_scalar_read_and_missed_donation():
    got, want = _both(HOST_HLO, host_trace(), "host-sync")
    by_op = {h.opcode: h for h in got.by_pass("host-sync")}
    wby_op = {h.opcode: h for h in want.by_pass("host-sync")}
    assert "aten::_local_scalar_dense" in by_op       # the host round trip
    assert by_op["parameter"].instruction == "arg1"
    assert by_op["parameter"].data == wby_op["parameter"].data == \
        {"param_index": 1}
    assert "donate" in by_op["parameter"].fix_hint


def test_host_sync_min_donate_bytes_floor():
    got, _want = _both(HOST_HLO, host_trace(),
                       "host-sync:min_donate_bytes=2097152")
    assert [h.opcode for h in got.by_pass("host-sync")] == \
        ["aten::_local_scalar_dense"]


# ---------------------------------------------------------------------------
# collective wire-bytes golden table and link classification
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("opcode,op_b,out_b,n,expected", WIRE_TABLE)
def test_collective_wire_bytes_golden(opcode, op_b, out_b, n, expected):
    assert collective_wire_bytes(opcode, op_b, out_b, n) == expected == \
        jwire(opcode, op_b, out_b, n)


@pytest.mark.parametrize("groups,n,link", LINK_TABLE)
@pytest.mark.parametrize("opcode", ["all-reduce", "all-gather",
                                    "reduce-scatter", "all-to-all"])
def test_collective_link_classification(opcode, groups, n, link):
    numel = 65536
    in_shape = (numel // n,) if opcode == "all-gather" else (numel,)
    out_shape = (numel // n,) if opcode == "reduce-scatter" else (numel,)
    rec = _coll(opcode, [0], [1], in_shape, out_shape, groups)
    assert len(rec.group) == n
    stats = analyze_trace(_trace([rec], {0: 4 * numel, 1: 4 * numel},
                                 persistent={0}, outputs={1}), hw=HW)
    (inst,) = stats.collective_instances
    assert inst["link"] == link, (opcode, groups)


# ---------------------------------------------------------------------------
# event emission + robustness plumbing
# ---------------------------------------------------------------------------

class _Handler:
    def __init__(self):
        self.emitted = []

    def emit(self, ev):
        self.emitted.append(ev)


class _Session:
    def __init__(self):
        self.handler = _Handler()


def test_findings_emitted_as_session_events():
    sess, jsess = _Session(), _Session()
    kw = {k: v for k, v in RUN_KW.items() if k != "emit_events"}
    f = run_passes(blocking_trace(), "exposed-collectives", session=sess,
                   **kw)
    janalysis.run_passes(BLOCKING_HLO, "exposed-collectives", session=jsess,
                         **{k: v for k, v in JRUN_KW.items()
                            if k != "emit_events"})
    assert len(sess.handler.emitted) == len(f.findings) == 1 == \
        len(jsess.handler.emitted)
    ev, jev = sess.handler.emitted[0], jsess.handler.emitted[0]
    assert ev.kind.name == jev.kind.name == "FINDING"
    assert ev.attrs["severity"] == "warn" and \
        ev.attrs["key"] == f.findings[0].key
    assert sorted(ev.attrs) == sorted(jev.attrs)


def test_unparseable_artifact_warns_never_raises():
    for run, kw in ((run_passes, RUN_KW), (janalysis.run_passes, JRUN_KW)):
        f = run("this is not HLO at all {{{", None, **kw)
        assert f.warnings, "garbage input must surface a counted warning"
        assert not any(k.startswith("pass-error") for k in f.warnings)
    assert isinstance(run_passes(object(), None, **RUN_KW), Findings)


def test_pass_error_backstop():
    class Exploding(analysis.AnalysisPass):
        REGISTRY_NAME = "exploding"

        def run(self, ctx):
            raise RuntimeError("boom")

    f = run_passes(blocking_trace(), [Exploding()], **RUN_KW)
    assert f.warnings.get("pass-error:exploding") == 1
    (h,) = f.findings
    assert h.severity == "error" and "boom" in h.message
    assert isinstance(h, Finding)


# ---------------------------------------------------------------------------
# seeded random draws
# ---------------------------------------------------------------------------

_NAMES = sorted(PASS_REGISTRY)
_STR_CHOICES = ["warn", "error", "info", "dci", "ici", "model+data"]


def test_pass_spec_round_trips_through_registry_parser():
    """format_pass_spec(parse_pass_spec(s)) is the identity on canonical
    specs built from real registry passes with type-correct knob values,
    and both packages parse and format them alike (60 seeded draws)."""
    rng = np.random.default_rng(0)
    for _ in range(60):
        entries = []
        for _e in range(int(rng.integers(1, 7))):
            name = _NAMES[int(rng.integers(len(_NAMES)))]
            knobs = {}
            for k, default in sorted(PASS_REGISTRY[name].KNOBS.items())[
                    :int(rng.integers(0, 4))]:
                if isinstance(default, bool):
                    knobs[k] = bool(rng.integers(2))
                elif isinstance(default, int):
                    knobs[k] = int(rng.integers(0, 10 ** 6))
                elif isinstance(default, float):
                    knobs[k] = float(rng.uniform(0.0, 100.0))
                else:
                    knobs[k] = _STR_CHOICES[int(rng.integers(
                        len(_STR_CHOICES)))]
            entries.append((name, knobs))
        spec = format_pass_spec(entries)
        assert spec == janalysis.format_pass_spec(entries)
        assert parse_pass_spec(spec) == entries == \
            janalysis.parse_pass_spec(spec)
        assert format_pass_spec(parse_pass_spec(spec)) == spec
        assert [p.REGISTRY_NAME for p in resolve_passes(spec)] == \
            [n for n, _ in entries]


def _mutate(trace, rng):
    recs = list(trace.records)
    for _ in range(int(rng.integers(1, 9))):
        if not recs:
            break
        i = int(rng.integers(len(recs)))
        j = int(rng.integers(len(recs)))
        kind = int(rng.integers(6))
        if kind == 0:
            del recs[i]
        elif kind == 1:
            recs.insert(j, recs[i])
        elif kind == 2:
            recs[i], recs[j] = recs[j], recs[i]
        elif kind == 3:
            r = recs[i]
            recs[i] = TraceRecord(**{**r.__dict__,
                                     "in_ids": (int(rng.integers(-3, 50)),),
                                     "wait": int(rng.integers(-5, 50))})
        elif kind == 4:
            r = recs[i]
            recs[i] = TraceRecord(**{**r.__dict__, "axes": None,
                                     "group": (), "in_shapes": ()})
        else:
            recs.insert(i, TraceRecord(op="garbage", opcode="all-gather",
                                       wait=10 ** 6))
    trace.records = recs
    return trace


def test_random_trace_mutations_never_make_passes_raise():
    """Dropped, duplicated, reordered and corrupted records must degrade
    quietly — run_passes never raises AND no pass crashes internally (40
    seeded draws over the golden traces)."""
    rng = np.random.default_rng(1)
    makers = [blocking_trace, overlapped_trace, reshard_rsag_trace,
              dtype_trace, host_trace, peak_trace]
    for _ in range(40):
        trace = _mutate(makers[int(rng.integers(len(makers)))](), rng)
        f = run_passes(trace, None, **RUN_KW)
        assert isinstance(f, Findings)
        assert not any(k.startswith("pass-error") for k in f.warnings), \
            f.warnings
