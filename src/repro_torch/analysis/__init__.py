"""repro_torch.analysis — ahead-of-time static lint over step traces.

The static half of the PASTA framework: where ``repro_torch.core`` tools
observe a *run*, these passes judge the *step itself* — exposed
collectives, unintended reshards, dtype leaks, static peak memory, host
syncs — from one fake-tensor call of it on a fake process group
(``repro_torch.core.trace.trace_step``), so a sharding or overlap
regression is caught in CI before it burns hardware.

Quick start::

    from repro_torch import analysis
    from repro_torch.core.trace import trace_step
    trace = trace_step(step, mesh_shape=(4, 2),
                       mesh_dims=("data", "model"), setup=make_args)
    findings = analysis.run_passes(trace,
                                   "exposed-collectives:threshold_frac=0.3")
    for f in findings.unsuppressed("warn"):
        print(f.severity, f.message)

See ``python -m repro_torch.launch.lint --help`` for the config-grid
driver and the README "Static analysis" section for the
baseline-suppression workflow.
"""

from .base import (AnalysisContext, AnalysisPass, DEFAULT_SPEC,
                   PASS_REGISTRY, build_context, format_pass_spec,
                   parse_pass_spec, register_pass, resolve_passes,
                   run_passes, spec_of)
from .findings import (Baseline, Finding, Findings, SEVERITIES,
                       severity_rank)

# importing the builtin pass modules populates PASS_REGISTRY
from . import collectives as _collectives           # noqa: F401
from . import dtype as _dtype                       # noqa: F401
from . import memory as _memory                     # noqa: F401

from .memory import estimate_peak_bytes

__all__ = [
    "AnalysisContext", "AnalysisPass", "Baseline", "DEFAULT_SPEC",
    "Finding", "Findings", "PASS_REGISTRY", "SEVERITIES", "build_context",
    "estimate_peak_bytes", "format_pass_spec", "parse_pass_spec",
    "register_pass", "resolve_passes", "run_passes", "severity_rank",
    "spec_of",
]
