"""BENCHMARK.json and every file a cell names parse and keep to the
benchmark's format: keys, names, units, bounds, the files under
``paths``, one reader for each metric."""

import importlib.util
import json
import re

import pytest

from conftest import ROOT
from portbench import harness

SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
METRIC_KEYS = {"name", "unit", "better", "source"}


def _line(text):
    return isinstance(text, str) and 1 <= len(text) <= 200 \
        and "\n" not in text and "\t" not in text


def test_top_level_keys_and_command():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert SPEC["command"] == ["python3", "portbench/run.py"]
    assert 1 <= len(SPEC["paths"]) <= 16
    for p in SPEC["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert (ROOT / p).is_dir() and not p.endswith("_torch")
    for word in SPEC["command"]:
        assert _line(word) and not word.startswith("/") and ".." not in word


def test_run_seconds_fits_a_full_check_of_24_cells():
    rs = SPEC["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    cells = 24
    assert (2 + 14 * cells) * (rs + 60) + cells * 2 * 90 + 1200 <= 43200


def test_names_units_and_uniqueness():
    metrics = SPEC["end_to_end"] + SPEC["per_layer"]
    for group in (SPEC["configs"], SPEC["workloads"], metrics):
        names = [x["name"] for x in group]
        assert len(names) == len(set(names))
        assert all(NAME.match(n) for n in names)
    for m in metrics:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for w in SPEC["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert _line(w["why"]) and w["chips"] in (1, 4)
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
    pairs = [(w["config"], w["traffic"]) for w in SPEC["workloads"]]
    assert len(pairs) == len(set(pairs))
    assert sum(w["chips"] == 4 for w in SPEC["workloads"]) <= max(
        1, len(SPEC["workloads"]) // 4)


@pytest.mark.parametrize("conf", SPEC["configs"], ids=lambda c: c["name"])
def test_configuration_file_and_reference(conf):
    from repro_torch.models.config import ModelConfig
    assert set(conf) == {"name", "source", "file", "reduced", "why"}
    assert _line(conf["source"]) and _line(conf["why"])
    assert conf["file"].startswith(SPEC["paths"][0] + "/")
    assert len(conf["reduced"]) <= 16 and all(NAME.match(k) for k in conf["reduced"])
    data = json.loads((ROOT / conf["file"]).read_text())
    assert data["name"] == conf["name"] and data["source"] == conf["source"]
    ModelConfig(**data["model"])
    ref = (ROOT / conf["file"]).with_suffix(".py")
    spec = importlib.util.spec_from_file_location("ref_" + conf["name"].replace("-", "_"), ref)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    for fn in ("hidden", "layout", "step_flops", "operators"):
        assert callable(getattr(mod, fn))
    assert any(w["config"] == conf["name"] for w in SPEC["workloads"])


@pytest.mark.parametrize("cell", SPEC["workloads"], ids=lambda w: w["name"])
def test_cell_files(cell):
    bench = ROOT / "portbench"
    traffic = json.loads((bench / "traffic" / f"{cell['traffic']}.json").read_text())
    loop = bench / "loops" / f"{traffic['loop']}.py"
    assert NAME.match(traffic["loop"]) and callable(harness.load_module(loop).run)
    assert traffic["batch"] > 0 and traffic["seq_len"] > 0
    session = json.loads((bench / "sessions" / f"{traffic['session']}.json").read_text())
    assert session["fine"] in (True, False) and session["stride"] > 0
    limits = json.loads((bench / "limits" / f"{cell['name']}.json").read_text())
    assert 0 < limits["logit_err"] < 1
    e2e = [m["name"] for m in SPEC["end_to_end"]
           if cell["name"] in m.get("workloads", [cell["name"]])]
    per_layer = [m["name"] for m in SPEC["per_layer"]
                 if cell["name"] in m.get("workloads", [cell["name"]])]
    assert "setup_s" in e2e and len(e2e) >= 2 and per_layer


def test_metrics():
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    cells = {w["name"] for w in SPEC["workloads"]}
    for m in SPEC["end_to_end"]:
        assert set(m) - {"workloads"} == METRIC_KEYS | {"bound"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    layers = (ROOT / "PERF.md").read_text()
    for m in SPEC["per_layer"]:
        assert set(m) - {"workloads"} == METRIC_KEYS | {"layer", "moves"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert m["moves"] in e2e and _line(m["layer"])
        assert f"| {m['layer']} |" in layers, m["layer"]
        for w in m.get("workloads", cells):
            assert w in cells
            assert w in e2e[m["moves"]].get("workloads", cells)
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        reader = ROOT / "portbench" / "metrics" / f"{m['name']}.py"
        spec = importlib.util.spec_from_file_location("m_" + m["name"], reader)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        assert callable(mod.read)
        if m["unit"] == "%" and ("roofline" in m["name"] or "mfu" in m["name"]):
            assert m["better"] == "higher"
