"""The benchmark's arithmetic on fixed inputs: the readers' rates and
shares, host spans' self time, a step's FLOPs, a trace launch's bytes,
the profile's busy and idle time, and the plain histograms."""

import importlib.util
import json
import types

import numpy as np
import pytest
import torch

from conftest import ROOT
from portbench import check, flops, harness, spans

H100 = json.loads((ROOT / "portbench" / "peaks.json").read_text())["NVIDIA H100 80GB HBM3"]


def reader(name):
    path = ROOT / "portbench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location("r_" + name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def test_rate_memory_and_step_readers():
    run = types.SimpleNamespace(
        tokens=3 * 16384, window_s=6.0, peak_window_bytes=58_205_585_920,
        setup_s=24.5, plain_step_s=1.5, step_s=[2.0, 3.0, 4.0], steps=3,
        flops_per_step=2.97e14, peaks=H100, spans={"op": 0.3,
                                                   "trace emission": 0.6,
                                                   "locator stack capture": 0.9},
        tools=["workingset", "locator"], window_buffers=600, analysis_s=3.0)
    assert reader("tokens_per_s")(run) == pytest.approx(8192.0)
    assert reader("peak_mem_gb")(run) == pytest.approx(58.20558592)
    assert reader("setup_s")(run) == 24.5
    assert reader("plain_step_ms")(run) == pytest.approx(1500.0)
    assert reader("slowdown_x")(run) == pytest.approx(2.0)
    assert reader("step_mfu")(run) == pytest.approx(100 * 2.97e14 / (3.0 * 989e12))
    assert reader("hook_ms_per_step")(run) == pytest.approx(100.0)
    assert reader("emit_ms_per_step")(run) == pytest.approx(200.0)
    assert reader("locator_ms_per_step")(run) == pytest.approx(300.0)
    assert reader("analysis_ms_per_buffer")(run) == pytest.approx(5.0)
    run.tools = ["workingset"]
    assert reader("locator_ms_per_step")(run) is None
    run.spans, run.plain_step_s = None, None
    assert reader("hook_ms_per_step")(run) is None
    assert reader("slowdown_x")(run) is None


def test_profile_readers():
    k = "void (anonymous namespace)::trace_aggregate_kernel(int const*)"
    p = {"device": [("gemm", 0.0, 60.0), (k, 70.0, 80.0), (k, 90.0, 95.0)],
         "window_us": 100.0, "busy_us": 75.0,
         "buffers": [{"n": 65536, "k": 20, "cells": 8964},
                     {"n": 1024, "k": 5, "cells": 8964}]}
    run = types.SimpleNamespace(profile=p, peaks=H100)
    assert reader("device_idle_share")(run) == pytest.approx(25.0)
    least = sum(flops.least_seconds(b["n"], b["k"], b["cells"], H100)
                for b in p["buffers"])
    assert reader("trace_kernels_roofline")(run) == pytest.approx(100 * least / 15e-6)
    p["buffers"] = p["buffers"][:1]          # a launch the profiler kept extra
    assert reader("trace_kernels_roofline")(run) is None


def test_host_spans_self_time(monkeypatch):
    clock = [0.0]
    monkeypatch.setattr(spans.time, "perf_counter", lambda: clock[0])
    hs = spans.HostSpans(table=())

    def inner():
        clock[0] += 2.0

    def outer(f):
        clock[0] += 1.0
        f()
        clock[0] += 3.0

    inner_w, outer_w = hs.wrap("inner", inner), hs.wrap("outer", outer)
    with hs.span("step"):
        outer_w(inner_w)
        clock[0] += 0.5
    assert hs.total_s["outer"] == 6.0 and hs.self_s["outer"] == 4.0
    assert hs.self_s["inner"] == 2.0
    assert hs.total_s["step"] == 6.5 and hs.self_s["step"] == 0.5


def test_host_spans_wrap_and_restore():
    from repro_torch.core.pool import MemoryPool
    before = MemoryPool.__dict__["alloc"]
    with spans.HostSpans() as hs:
        assert MemoryPool.__dict__["alloc"] is not before
        MemoryPool().alloc(1000)
    assert MemoryPool.__dict__["alloc"] is before
    assert hs.calls["pool alloc"] == 1


def _glm4():
    cfg = types.SimpleNamespace(**json.loads(
        (ROOT / "portbench" / "configs" / "glm4-9b.json").read_text())["model"])
    return cfg, harness.load_module(ROOT / "portbench" / "configs" / "glm4-9b.py")


def test_step_flops_glm4_by_hand():
    cfg, ref = _glm4()
    tokens = 8 * 2048
    per_token = 40 * (2 * 4096 * (4096 + 2 * 256) + 2 * 4096 * 4096
                      + 6 * 4096 * 13696) + 2 * 4096 * 151552
    attn = 40 * 8 * 2 * 32 * 128 * 2048 ** 2
    assert ref.step_flops(cfg, 8, 2048) == per_token * tokens + attn


def test_glm4_operators_by_hand():
    cfg, ref = _glm4()
    ops = ref.operators(cfg, 8, 2048)
    assert len(ops) == 2 + 5 * 40
    assert ops[0] == ("embed.lookup", [16384 * 4, 151552 * 4096 * 4,
                                       16384 * 4096 * 2])
    assert ops[2] == ("attn.qkv_proj", [16384 * 4096 * 2, 4096 * 4096 * 4,
                                        4096 * 256 * 4, 4096 * 256 * 4,
                                        16384 * 4096 * 2, 16384 * 256 * 2,
                                        16384 * 256 * 2])
    assert ops[5] == ("mlp.glu", [16384 * 4096 * 2, 4096 * 13696 * 4,
                                  4096 * 13696 * 4, 13696 * 4096 * 4,
                                  16384 * 13696 * 2, 16384 * 13696 * 2,
                                  16384 * 4096 * 2])
    assert ops[-1] == ("lm_head", [16384 * 4096 * 2, 16384 * 151552 * 2])
    assert [n for n, _ in ops[1:6]] == ["layer0", "attn.qkv_proj", "attn.sdpa",
                                        "attn.out_proj", "mlp.glu"]


def test_glm4_layout_holds_9_4_billion_parameters():
    from portbench import weights
    cfg, ref = _glm4()
    d, f, v = 4096, 13696, 151552
    layer = d * 4096 + 2 * d * 256 + 4096 * d + 3 * d * f + 2 * d
    assert weights.n_params(ref.layout(cfg)) == 2 * v * d + d + 40 * layer


def test_trace_launch_cost():
    assert flops.trace_launch_cost(65536, 10, 8964) == (
        8 * 65536 + 80 + 40 + 4 * 8964, 65536 * (4 + 1) + 2 * 65536)
    assert flops.trace_launch_cost(1000, 3, 0) == (4000 + 24 + 12, 1000 * 3)
    nbytes, _ = flops.trace_launch_cost(65536, 10, 8964)
    assert flops.least_seconds(65536, 10, 8964, H100) == nbytes / 3.35e12


class _Ev:
    def __init__(self, name, start, end, cuda):
        self.name = name
        self.time_range = types.SimpleNamespace(start=start, end=end)
        self.device_type = (torch.autograd.DeviceType.CUDA if cuda
                            else torch.autograd.DeviceType.CPU)


def test_profile_summary_busy_and_gaps():
    events = [_Ev(harness.WINDOW_SPAN, 0.0, 100.0, False),
              _Ev(harness.WINDOW_SPAN, 0.0, 100.0, True),   # mirrored range
              _Ev("step", 0.0, 100.0, False), _Ev("step", 0.0, 100.0, True),
              _Ev("op", 40.0, 60.0, False),
              _Ev("gemm", 10.0, 30.0, True), _Ev("copy", 20.0, 40.0, True),
              _Ev("kernel", 70.0, 90.0, True)]
    prof = types.SimpleNamespace(events=lambda: events)
    s = harness.profile_summary(prof, {"step", "op"})
    assert s["window_us"] == 100.0 and s["busy_us"] == 50.0
    assert [n for n, *_ in s["device"]] == ["gemm", "copy", "kernel"]
    assert s["idle_by_span"] == pytest.approx({"step": 20e-6, "op": 30e-6})
    assert s["ops_s"]["copy"] == pytest.approx(20e-6)


def _brute(recs, table, hot, step):
    counts = np.zeros(len(table), np.int64)
    row = np.zeros(hot["n_blocks"], np.int64)
    for a in recs:
        for i, (s, e) in enumerate(table):
            if s <= a < e:
                counts[i] += 1
        b = ((a >> 9) - (hot["base"] >> 9)) >> hot["block_shift"]
        if 0 <= b < hot["n_blocks"]:
            row[b] += 1
    return counts, row


def test_histograms_against_loops_and_the_ports_plain_kernels():
    from repro_torch.kernels import ref
    rng = np.random.default_rng(7)
    starts = np.sort(rng.choice(4000, 12, replace=False)) * 512 + (2 << 20)
    table = np.stack([starts, starts + 512 * rng.integers(1, 3, 12)], 1)
    table = table[np.concatenate([[True], table[1:, 0] >= table[:-1, 1]])]
    tensors = [(int(s), int(e - s)) for s, e in table[::3]] + [(int(table[-1, 1]) + 4096, 1024)]
    recs = check.records(tensors, 512, 8)
    hot = {"base": 2 << 20, "n_blocks": 7, "block_shift": 2, "n_tbins": 4, "t_max": 4.0}
    counts, row = _brute(recs, table, hot, 0)
    assert np.array_equal(check.object_counts(recs, table), counts)
    assert np.array_equal(check.hotness_row(recs, hot), row)
    units = torch.from_numpy((recs >> 9).astype(np.int32))
    s_u = torch.from_numpy((table[:, 0] >> 9).astype(np.int32))
    e_u = torch.from_numpy((table[:, 1] >> 9).astype(np.int32))
    assert np.array_equal(ref.object_histogram_ref(units, s_u, e_u).numpy(), counts)
    tb = torch.full_like(units, check.time_bin(6, hot))
    hist = ref.hotness_histogram_ref(units, tb, (2 << 20) >> 9, 7, 4, 2).numpy()
    assert np.array_equal(hist[3], row) and hist[:3].sum() == 0


def test_records_rule():
    recs = check.records([(1 << 21, 2048), (1 << 22, 512)], 512, 4)
    assert recs.tolist() == [1 << 21, (1 << 21) + 512, 1 << 22]
    assert len(check.records([(0, 1 << 30)], 512, 65536)) == 65536


def test_sample_rows_and_logit_err():
    b, s = check.sample_rows(2 ** 31 + 9, 8, 2048)
    assert len(b) == 8 * check.ROWS_PER_SEQUENCE
    assert all((s[b == i] == 2047).any() for i in range(8))
    b2, s2 = check.sample_rows(2 ** 31 + 9, 8, 2048)
    assert np.array_equal(s, s2)
    want = torch.tensor([[3.0, 4.0], [1.0, 0.0]])
    got = torch.tensor([[3.0, 4.0], [1.0, 0.5]])
    assert check.logit_err(got, want) == pytest.approx(0.5)
    assert check.logit_err(want, want) == 0.0


def test_classify_and_report_comparison():
    hot = np.array([[1, 0, 0], [2, 0, 0], [0, 5, 0], [1, 0, 0]])
    c = check.classify(hot, 0.75)
    assert c == {"persistent_blocks": [0], "bursty_blocks": [1],
                 "cold_blocks": 1, "total_accesses": 9}
    assert check.wrong_reports({"a": 1.0, "b": [1], "c": 3},
                               {"a": 1.0, "b": [2], "c": 3}) == ["b"]
