"""Typed findings for the ahead-of-time lint passes (the port's own copy of
the reference's ``analysis/findings.py``).

A :class:`Finding` is one defect (or observation) a static pass extracted
from a step trace: severity, the instruction/opcode it anchors to,
the bytes/seconds it costs, and a fix hint.  :class:`Findings` is the
per-artifact report — JSON-exportable, CI-gateable, and suppressible
against a *baseline file* of known-accepted findings so a green grid can
be enforced at "zero unsuppressed findings" without hiding real history.

Baseline file format (JSON)::

    {"version": 1,
     "suppress": [
        {"key": "exposed-collectives:all-reduce:main/ar.1",
         "reason": "pod sync is blocking on purpose in this config"},
        {"key": "implicit-reshard:*", "reason": "glob ok too"}
     ]}

Keys are matched exactly first, then as ``fnmatch`` globs, so one entry
can accept a family of findings (e.g. every instance inside an unrolled
loop).  ``Findings.write_baseline`` emits a file accepting everything
currently firing — the workflow for adopting lint on a brownfield config.
"""

from __future__ import annotations

import dataclasses
import fnmatch
import json

#: severity ladder, least to most severe
SEVERITIES = ("info", "warn", "error")


def severity_rank(severity: str) -> int:
    try:
        return SEVERITIES.index(severity)
    except ValueError:
        return len(SEVERITIES)          # unknown sorts as most severe


@dataclasses.dataclass
class Finding:
    """One static-analysis finding, anchored to a traced call."""

    pass_name: str                      # registry name of the emitting pass
    severity: str                       # "info" | "warn" | "error"
    message: str
    opcode: str = ""                    # the reference's opcode class
    instruction: str = ""               # the call's name in the trace
    computation: str = ""               # the code that issued it
    op_name: str = ""                   # its scope path, if any
    bytes_impact: float = 0.0           # bytes moved/wasted per execution
    seconds_impact: float = 0.0         # modelled seconds of impact
    fix_hint: str = ""
    data: dict = dataclasses.field(default_factory=dict)
    suppressed: bool = False
    suppressed_reason: str = ""

    @property
    def key(self) -> str:
        """Stable identity used by baseline suppression: the pass, the
        opcode class, and where in the module it anchors."""
        loc = f"{self.computation}/{self.instruction}" if self.instruction \
            else self.computation or "-"
        return f"{self.pass_name}:{self.opcode or '-'}:{loc}"

    def as_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["key"] = self.key
        return d


@dataclasses.dataclass
class Baseline:
    """Known-accepted findings: exact keys and fnmatch patterns."""

    entries: list = dataclasses.field(default_factory=list)

    @classmethod
    def load(cls, path_or_dict) -> "Baseline":
        if isinstance(path_or_dict, Baseline):
            return path_or_dict
        if isinstance(path_or_dict, dict):
            doc = path_or_dict
        else:
            with open(path_or_dict) as f:
                doc = json.load(f)
        entries = []
        for e in doc.get("suppress", []):
            if isinstance(e, str):
                e = {"key": e}
            if e.get("key"):
                entries.append({"key": e["key"],
                                "reason": e.get("reason", "")})
        return cls(entries)

    def match(self, key: str) -> dict | None:
        for e in self.entries:
            if e["key"] == key:
                return e
        for e in self.entries:
            if fnmatch.fnmatchcase(key, e["key"]):
                return e
        return None

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump({"version": 1, "suppress": self.entries}, f, indent=1)
            f.write("\n")


class Findings:
    """Ordered collection of findings for one analyzed artifact."""

    def __init__(self, label: str = "", spec: str = "",
                 meta: dict | None = None):
        self.label = label
        self.spec = spec                # canonical pass-spec string used
        self.meta = dict(meta or {})    # estimates etc. passes want to expose
        self.findings: list = []
        self.warnings: dict = {}        # parser/pass warnings (counted)

    # ------------------------------------------------------------ building
    def add(self, finding: Finding) -> None:
        self.findings.append(finding)

    def extend(self, findings) -> None:
        self.findings.extend(findings)

    def warn(self, key: str, n: int = 1) -> None:
        self.warnings[key] = self.warnings.get(key, 0) + n

    # ----------------------------------------------------------- filtering
    def __iter__(self):
        return iter(self.findings)

    def __len__(self) -> int:
        return len(self.findings)

    def unsuppressed(self, min_severity: str = "info") -> list:
        rank = severity_rank(min_severity)
        return [f for f in self.findings
                if not f.suppressed and severity_rank(f.severity) >= rank]

    def by_pass(self, name: str) -> list:
        return [f for f in self.findings if f.pass_name == name]

    def max_severity(self) -> str | None:
        live = self.unsuppressed()
        if not live:
            return None
        return max(live, key=lambda f: severity_rank(f.severity)).severity

    # ------------------------------------------------------------ baseline
    def apply_baseline(self, baseline) -> int:
        """Mark findings matching the baseline as suppressed; returns the
        number suppressed.  ``baseline`` is a :class:`Baseline`, a path, a
        dict, or ``None`` (no-op)."""
        if baseline is None:
            return 0
        bl = Baseline.load(baseline)
        n = 0
        for f in self.findings:
            hit = bl.match(f.key)
            if hit is not None:
                f.suppressed = True
                f.suppressed_reason = hit.get("reason", "")
                n += 1
        return n

    def write_baseline(self, path: str, reason: str = "accepted") -> None:
        """Emit a baseline accepting every currently-unsuppressed finding."""
        seen: dict = {}
        for f in self.unsuppressed():
            seen.setdefault(f.key, {"key": f.key, "reason": reason})
        Baseline(list(seen.values())).save(path)

    # ------------------------------------------------------------- reports
    def counts(self) -> dict:
        """``{pass_name: {severity: n}}`` over unsuppressed findings (the
        dryrun JSON ``lint`` section shape)."""
        out: dict = {}
        for f in self.findings:
            if f.suppressed:
                continue
            out.setdefault(f.pass_name, {})
            out[f.pass_name][f.severity] = \
                out[f.pass_name].get(f.severity, 0) + 1
        return out

    def summary(self) -> dict:
        return {
            "spec": self.spec,
            "passes": self.counts(),
            "n_findings": len(self.findings),
            "n_unsuppressed": len(self.unsuppressed()),
            "n_suppressed": sum(1 for f in self.findings if f.suppressed),
            "max_severity": self.max_severity(),
            "warnings": dict(self.warnings),
            "meta": dict(self.meta),
        }

    def as_dict(self) -> dict:
        return {"label": self.label, **self.summary(),
                "findings": [f.as_dict() for f in self.findings]}

    def to_json(self, indent: int | None = 1) -> str:
        return json.dumps(self.as_dict(), indent=indent, default=str)

    def __repr__(self) -> str:
        c = self.counts()
        return f"Findings({self.label!r}, {len(self.findings)} findings, " \
               f"passes={sorted(c)})"
