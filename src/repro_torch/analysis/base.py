"""Pass framework for the ahead-of-time static analyzer.

Mirrors the PASTA *tool* registry (``repro_torch.core.tools.base``) one
level earlier in the lifecycle: where tools consume events from a run, an
:class:`AnalysisPass` consumes the *step trace itself* — the records of
one fake-tensor call of the step (``core.trace.trace_step``) plus the
overlap-aware rollup ``core.trace.analyze_trace`` derives from it — and
returns typed :class:`~repro_torch.analysis.findings.Finding` records
without executing anything.  The reference's artifact is compiled HLO
text; a torch step has none, and the trace takes its place.

Passes register under a string key::

    @register_pass("exposed-collectives")
    class ExposedCollectivesPass(AnalysisPass): ...

and are selectable by the same spec-string grammar as tools
(``"exposed-collectives:threshold_frac=0.2,peak-memory"``), so the launch
drivers accept ``--lint-passes`` exactly like ``--pasta-tools``.

:func:`run_passes` is the one-call entry point: parse + roll up once,
hand every pass the shared :class:`AnalysisContext`, collect findings,
apply the baseline, and (when a session is active) emit each finding as a
``FINDING`` event so dynamic tools can correlate static predictions with
measured behaviour.
"""

from __future__ import annotations

import dataclasses

from ..core import trace as trace_mod
from ..core.capture import CaptureStats
from ..core.events import Event, EventKind
from ..core.tools.base import parse_tool_spec
from .findings import Finding, Findings

#: the standard pass suite, in execution order
DEFAULT_SPEC = ("exposed-collectives,implicit-reshard,dtype-promotion,"
                "peak-memory,host-sync")


@dataclasses.dataclass
class AnalysisContext:
    """Everything a pass may consult — shared across the suite so the
    artifact is parsed and rolled up exactly once."""

    trace: trace_mod.StepTrace | None = None
    stats: CaptureStats | None = None
    hw: dict = dataclasses.field(default_factory=dict)
    #: ordered mesh axis sizes, e.g. {"pod": 2, "data": 2, "model": 2}
    mesh_axes: dict = dataclasses.field(default_factory=dict)
    #: logical->physical sharding rule table in force for the trace
    rules: dict = dataclasses.field(default_factory=dict)
    #: cell kind: "train" | "prefill" | "decode" | "" (unknown)
    kind: str = ""
    #: pod topology forwarded to the overlap model
    pods: int | None = None
    n_devices: int | None = None
    #: per-device HBM budget in bytes (defaults to hw["hbm_bytes"])
    device_budget: float | None = None
    label: str = ""
    meta: dict = dataclasses.field(default_factory=dict)

    @property
    def budget_bytes(self) -> float:
        if self.device_budget:
            return float(self.device_budget)
        return float(self.hw.get("hbm_bytes", 0.0))


class AnalysisPass:
    """One static lint pass.  Subclass and override :meth:`run`; declare
    tunables in ``KNOBS`` so spec strings can override them."""

    KNOBS: dict = {}

    def __init__(self, **knobs):
        self.knobs = dict(self.KNOBS)
        unknown = set(knobs) - set(self.KNOBS)
        if unknown:
            raise TypeError(
                f"unknown knob(s) {sorted(unknown)} for pass "
                f"{getattr(self, 'REGISTRY_NAME', type(self).__name__)!r}; "
                f"known: {sorted(self.KNOBS)}")
        self.knobs.update(knobs)

    def run(self, ctx: AnalysisContext) -> list:
        """Return a list of Findings.  Must never raise on malformed input:
        skip what cannot be analyzed (``run_passes`` converts an escape into
        a ``pass-error`` finding as a backstop)."""
        raise NotImplementedError

    def finding(self, severity: str, message: str, **kw) -> Finding:
        return Finding(pass_name=getattr(self, "REGISTRY_NAME",
                                         type(self).__name__),
                       severity=severity, message=message, **kw)


# ---------------------------------------------------------------------------
# registry + spec strings (same grammar as the tool registry)
# ---------------------------------------------------------------------------

#: registry name -> AnalysisPass subclass (populated by @register_pass)
PASS_REGISTRY: dict = {}


def register_pass(name: str):
    """Class decorator mirroring ``core.tools.base.register``."""
    def deco(cls):
        prev = PASS_REGISTRY.get(name)
        if prev is not None and prev is not cls:
            raise ValueError(f"pass name {name!r} is already registered to "
                             f"{prev.__name__}")
        PASS_REGISTRY[name] = cls
        cls.REGISTRY_NAME = name
        return cls
    return deco


def parse_pass_spec(spec: str) -> list:
    """``"name[:knob=val[,knob=val...]][,name...]"`` →
    ``[(name, {knob: value}), ...]`` — the tool-spec grammar verbatim."""
    return parse_tool_spec(spec)


def format_pass_spec(entries) -> str:
    """Canonical spec string for ``[(name, knobs)]`` — the round-trip
    inverse of :func:`parse_pass_spec` (knob order is sorted)."""
    segs = []
    for name, knobs in entries:
        if knobs:
            kv = ",".join(f"{k}={_fmt_knob(v)}"
                          for k, v in sorted(knobs.items()))
            segs.append(f"{name}:{kv}")
        else:
            segs.append(name)
    return ",".join(segs)


def _fmt_knob(v) -> str:
    if isinstance(v, bool):
        return "true" if v else "false"
    return str(v)


def resolve_passes(spec=None) -> list:
    """Instantiate passes from a spec string / list (``None`` → the default
    suite).  Accepts instances, classes, names, specs, and (name, kwargs)
    pairs — mirrors ``resolve_tools``."""
    if spec is None:
        spec = DEFAULT_SPEC

    def build(name: str, knobs: dict):
        if name not in PASS_REGISTRY:
            raise KeyError(f"unknown analysis pass {name!r}; "
                           f"known: {sorted(PASS_REGISTRY)}")
        return PASS_REGISTRY[name](**knobs)

    if isinstance(spec, AnalysisPass):
        return [spec]
    if isinstance(spec, str):
        return [build(n, k) for n, k in parse_pass_spec(spec)]
    out = []
    for item in spec:
        if isinstance(item, AnalysisPass):
            out.append(item)
        elif isinstance(item, type) and issubclass(item, AnalysisPass):
            out.append(item())
        elif isinstance(item, str):
            out.extend(build(n, k) for n, k in parse_pass_spec(item))
        elif isinstance(item, tuple) and len(item) == 2:
            out.append(build(item[0], dict(item[1])))
        else:
            raise TypeError(f"cannot resolve pass spec item {item!r}")
    return out


def spec_of(passes) -> str:
    """Canonical spec string of instantiated passes (records what ran)."""
    return format_pass_spec(
        [(getattr(p, "REGISTRY_NAME", type(p).__name__),
          {k: v for k, v in p.knobs.items() if v != p.KNOBS.get(k)})
         for p in passes])


# ---------------------------------------------------------------------------
# the driver
# ---------------------------------------------------------------------------

def build_context(target, *, stats=None, hw=None, pods=None, n_devices=None,
                  mesh_axes=None, rules=None, kind: str = "",
                  device_budget=None, label: str = "",
                  meta=None) -> AnalysisContext:
    """Roll up ``target`` (a :class:`~repro_torch.core.trace.StepTrace`)
    into a shared pass context.  Anything else is an unparseable artifact:
    empty stats with a counted ``parse-error`` warning, never an
    exception.  The mesh (``mesh_axes``: a dict or a ``DeviceMesh``),
    ``pods`` and ``n_devices`` default to the trace's own."""
    if hw is None:
        hw = trace_mod._default_hw()
    trace = target if isinstance(target, trace_mod.StepTrace) else None
    if trace is not None:
        if mesh_axes is None:
            mesh_axes = trace.mesh_axes
        pods = pods if pods is not None else trace.pods
        n_devices = n_devices if n_devices is not None else trace.n_devices
    if stats is None:
        if trace is None:
            stats = CaptureStats(hw=dict(hw), warnings={"parse-error": 1})
        else:
            stats = trace_mod.analyze_trace(trace, hw=hw)
    if mesh_axes is not None and not isinstance(mesh_axes, dict):
        from ..dist.sharding import axis_sizes
        mesh_axes = axis_sizes(mesh_axes)       # a DeviceMesh
    return AnalysisContext(
        trace=trace, stats=stats, hw=dict(hw),
        mesh_axes=dict(mesh_axes or {}), rules=dict(rules or {}),
        kind=kind, pods=pods, n_devices=n_devices,
        device_budget=device_budget, label=label, meta=dict(meta or {}))


def run_passes(target, passes=None, *, baseline=None, session=None,
               emit_events: bool = True, **ctx_kw) -> Findings:
    """Run a pass suite over one step trace and return the findings.

    ``target``/``ctx_kw`` feed :func:`build_context` (pass a precomputed
    ``stats=`` to skip the re-rollup when the trace was already rolled up,
    e.g. by ``Session.capture_compiled``).  ``baseline`` suppresses
    known-accepted findings.  Findings are additionally emitted as
    ``FINDING`` events into ``session`` (default: the active session) so
    dynamic tools can correlate them; pass ``emit_events=False`` to skip.

    Never raises on malformed artifacts: a pass that escapes is recorded
    as a single ``pass-error`` finding and the suite continues.
    """
    suite = resolve_passes(passes)
    ctx = build_context(target, **ctx_kw)
    out = Findings(label=ctx.label, spec=spec_of(suite),
                   meta=dict(ctx.meta))
    for key, n in getattr(ctx.stats, "warnings", {}).items():
        out.warn(key, n)
    for p in suite:
        name = getattr(p, "REGISTRY_NAME", type(p).__name__)
        try:
            found = p.run(ctx) or []
        except Exception as e:                              # noqa: BLE001
            out.warn(f"pass-error:{name}")
            found = [Finding(pass_name=name, severity="error",
                             opcode="pass-error",
                             message=f"pass crashed: {type(e).__name__}: {e}",
                             fix_hint="file a bug against "
                                      "repro_torch.analysis; the trace "
                                      "confused the pass")]
        out.extend(found)
    out.meta.update(ctx.meta)       # passes may publish estimates via ctx
    out.apply_baseline(baseline)
    if emit_events:
        _emit_findings(out, session)
    return out


def _emit_findings(findings: Findings, session=None) -> None:
    if session is None:
        from ..core.session import active_session
        session = active_session()
    if session is None:
        return
    for f in findings:
        session.handler.emit(Event(
            EventKind.FINDING, name=f.pass_name,
            size=int(f.bytes_impact),
            attrs={"severity": f.severity, "key": f.key,
                   "opcode": f.opcode, "instruction": f.instruction,
                   "message": f.message, "suppressed": f.suppressed,
                   "seconds_impact": f.seconds_impact,
                   "label": findings.label}))
