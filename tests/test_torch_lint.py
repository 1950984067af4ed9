"""The port's lint driver end to end (``repro_torch.launch.lint``), on a
fake 8-rank 2×2×2 pod × data × model process group with ``--device cpu``:
the reference's three end-to-end invariants (tests/test_analysis.py
616-676) and its exit codes.

The reference's own end-to-end tests compile real steps on 8 virtual XLA
devices; the port traces its sharded train step once under fake tensors
instead, so it is held to the invariants, not to the reference's numbers:

* the green grid is quiet after its baseline, and ``--seed-defect
  reshard`` fires implicit-reshard, every new finding over ``["model"]``;
* the blocking pod sync trips the aggregate DCI budget of the smoke spec
  where the bucketed overlap pipeline does not;
* the static peak estimate is within 0.8–1.2 of the fake run's own
  live-storage high-water mark (tracked apart from the estimator);
* the driver exits 0 on the green grid (with the shipped baseline), 1 on
  each seeded defect.

Every trace runs in one child process (the fake group is process-global),
on qwen3-32b reduced; its results come back as one JSON line.
"""

import json
import os
import subprocess
import sys
import textwrap

import pytest

from repro_torch.core import events as tevents
from repro_torch.core import session as tsession

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_CHILD = """
import json, sys, warnings
warnings.filterwarnings("ignore")
from repro_torch.launch import lint

out = {}
spec = ("implicit-reshard,exposed-collectives:link=dci,threshold_frac=1.1,"
        "min_bytes=0,total_budget_s=6e-05,peak-memory")
green = lint.smoke_cell("qwen3-32b", spec=spec, device="cpu")
base = {"version": 1, "suppress": [{"key": f.key} for f in green.findings
                                   if f.pass_name == "implicit-reshard"]}
green.apply_baseline(base)
out["green_live"] = [f.key for f in green.unsuppressed("warn")]
out["green_exposed"] = [f.key for f in green.by_pass("exposed-collectives")]
out["exposed_dci_overlap"] = green.meta["exposed_s:dci"]
out["peak"] = [green.meta["peak_bytes_est"],
               green.meta["measured_peak_bytes"]]
defect = lint.smoke_cell("qwen3-32b", rules_patch=dict(lint.DEFECT_RULES),
                         spec="implicit-reshard", baseline=base,
                         device="cpu")
out["defect"] = [f.data["axes"] for f in defect.unsuppressed("warn")
                 if f.pass_name == "implicit-reshard"]
bad = lint.smoke_cell("qwen3-32b", overlap_sync=False, spec=spec,
                      device="cpu")
out["blocking"] = [(f.instruction, f.data.get("total_exposed_s"))
                   for f in bad.by_pass("exposed-collectives")]
cli = ["--device", "cpu", "--archs", "qwen3-32b", "--baseline",
       lint.BASELINE]
out["rc"] = {"green": lint.main(cli + ["--json", sys.argv[1]]),
             "reshard": lint.main(cli + ["--seed-defect", "reshard"]),
             "blocking": lint.main(cli + ["--seed-defect", "blocking"])}
with open(sys.argv[1]) as f:
    out["report"] = json.load(f)
print("RESULT " + json.dumps(out))
"""


@pytest.fixture(autouse=True)
def _port_state():
    tevents.reset_seq()
    tsession.reset_state()
    yield
    tsession.reset_state()


@pytest.fixture(scope="module")
def e2e(tmp_path_factory):
    report = tmp_path_factory.mktemp("lint") / "report.json"
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    r = subprocess.run([sys.executable, "-c", textwrap.dedent(_CHILD),
                        str(report)], capture_output=True, text=True,
                       env=env, timeout=900)
    assert r.returncode == 0, f"stdout:\n{r.stdout}\nstderr:\n{r.stderr}"
    line = next(ln for ln in r.stdout.splitlines()
                if ln.startswith("RESULT "))
    return json.loads(line[len("RESULT "):])


def test_e2e_seeded_reshard_defect_fires_and_green_is_quiet(e2e):
    assert e2e["green_live"] == []
    assert e2e["defect"], "the seeded reshard must fire"
    assert all(axes == ["model"] for axes in e2e["defect"])


def test_e2e_blocking_sync_trips_dci_budget_overlap_does_not(e2e):
    assert e2e["green_exposed"] == []
    assert e2e["exposed_dci_overlap"] <= 6e-05
    ((instruction, exposed_s),) = e2e["blocking"]
    assert instruction == "total[dci]"
    assert exposed_s > 6e-05


def test_e2e_peak_memory_estimate_tracks_measured_peak(e2e):
    est, measured = e2e["peak"]
    assert measured > 0
    assert 0.8 <= est / measured <= 1.2, (est, measured)


def test_lint_driver_exit_codes(e2e):
    assert e2e["rc"] == {"green": 0, "reshard": 1, "blocking": 1}
    rep = e2e["report"]
    assert rep["n_unsuppressed"] == 0 and rep["errors"] == {}
    (cell,) = rep["cells"]
    assert cell["label"] == "qwen3-32b.train.smoke"
    assert cell["n_suppressed"] > 0 and cell["meta"]["peak_bytes_est"] > 0
