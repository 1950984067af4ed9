"""Tiny variants of the cells for CPU tests: the port's reduced widths in
the configurations' compute dtype, 2 x 64-token batches."""

import json
import time

from portbench import harness
from conftest import ROOT

#: a tiny model of each configuration
MODELS = {
    "glm4-9b": {"n_layers": 2, "d_model": 64, "n_heads": 4, "n_kv_heads": 1,
                "head_dim": 16, "d_ff": 128, "vocab_size": 256},
}
CELLS = tuple(w["name"] for w in
              json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"])
TRAFFIC = {"batch": 2, "seq_len": 64}


def cell(name, **model):
    config = name.split(".")[0]
    return harness.load_cell(ROOT, name, {**MODELS[config], **model}, TRAFFIC)


def run(name, seed=2 ** 31 + 5, seconds=0.0, trace=False, **model):
    return harness.run_cell(cell(name, **model), seed, seconds, trace, "cpu",
                            time.perf_counter())
