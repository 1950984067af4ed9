"""Port's host event pipeline and tools against the JAX package's.

The golden event streams of tests/test_batch.py and tests/test_session.py
are replayed through both packages (``repro.core`` and
``repro_torch.core``, trace reductions on the CPU); the report dicts of the
ported tools must be equal.  The processor's fused and two-pass branches
must attach equal aggregates.
"""

import numpy as np
import pytest

import repro.core as jpasta
import repro_torch.core as tpasta
from repro.core import events as jevents
from repro_torch.core import events as tevents
from repro_torch.core import session as tsession
from repro_torch.kernels import ops as tops

HOT_CFG = {"base": 2 << 20, "n_blocks": 64, "n_tbins": 4, "t_max": 1.0,
           "block_shift": 5}

KERNELS = [("fusion.1", 3, "train"), ("fusion.1", 2, "train"),
           ("dot.7", 5, ""), ("fusion.2", 1, "train"), ("copy", 4, ""),
           ("dot.7", 1, "eval"), ("fusion", 2, "")]


@pytest.fixture(autouse=True)
def _port_state(monkeypatch):
    monkeypatch.setenv("REPRO_PALLAS_INTERPRET", "0")   # reference: jnp path
    tevents.reset_seq()
    tsession.reset_state()
    yield
    tsession.reset_state()


def _kw(pasta):
    return {} if pasta is jpasta else {"device": "cpu"}


def _tools(pasta):
    return [pasta.KernelFrequencyTool(), pasta.MemoryTimelineTool(),
            pasta.WorkingSetTool(), pasta.HotnessTool(n_tbins=4, n_blocks=64),
            pasta.LocatorTool(capture_python_stack=False)]


def _emit_kernels(pasta, handler, batched):
    rows = KERNELS * 3
    attrs = []
    for _name, count, label in rows:
        a = {"count": count, "bytes": 1 << 20}
        if label:
            a["label"] = label
        attrs.append(a)
    if batched:
        handler.emit_batch(pasta.EventBatch.of(
            pasta.EventKind.KERNEL_LAUNCH, names=[r[0] for r in rows],
            attrs=attrs))
        return
    for (name, _c, _l), a in zip(rows, attrs):
        handler.emit(pasta.Event(pasta.EventKind.KERNEL_LAUNCH, name=name,
                                 attrs=a))


def _golden_batch_workload(pasta, events_mod, batched=False, capacity=None):
    """tests/test_batch.py's workload: kernels, pool alloc/free, an
    operator, a collective, a memcpy and one trace buffer."""
    events_mod.reset_seq()
    handler = pasta.EventHandler(buffer_capacity=capacity or 4096,
                                 buffered=capacity is not None)
    with pasta.EventProcessor(handler, tools=_tools(pasta), hotness=HOT_CFG,
                              **_kw(pasta)) as proc:
        handler.step_start(0)
        _emit_kernels(pasta, handler, batched)
        pool = pasta.MemoryPool(handler, chunk_size=1 << 20)
        ts = [pool.alloc((i + 1) << 12, f"t{i}") for i in range(6)]
        handler.operator_start(
            "op0", tensors=[(t.addr, t.size) for t in ts[:3]])
        handler.emit(pasta.Event(pasta.EventKind.COLLECTIVE,
                                 name="all-reduce.1", size=1 << 16,
                                 attrs={"mult": 2}))
        handler.memcpy(4096, "h2d")
        objs = sorted(t.addr_range() for t in pool.live_tensors())
        rng = np.random.default_rng(7)
        starts = np.asarray([s for s, _ in objs])
        sizes = np.asarray([e - s for s, e in objs])
        pick = rng.integers(0, len(objs), size=400)
        addrs = starts[pick] + rng.integers(0, sizes[pick])
        handler.trace_buffer(addrs, name="k0", kernel="k0", objects=objs,
                             object_sizes=sizes.tolist(), time=0.3)
        for t in ts[::2]:
            pool.free(t)
        if capacity is not None and capacity > 16:
            handler.flush()
        for t in ts[1::2]:
            pool.free(t)
        handler.step_end(0)
        return proc.finalize()


@pytest.mark.parametrize("batched,capacity", [
    (False, None), (True, None), (False, 1), (False, 3), (False, 7),
    (False, 64), (False, 4096), (True, 5)])
def test_golden_batch_stream_reports_equal(batched, capacity):
    """Equal to the reference under the same emission, and to the port's
    own scalar, unbuffered emission (kernel_freq and timeline promise
    identical reports under scalar and batched emission)."""
    want = _golden_batch_workload(jpasta, jevents, batched, capacity)
    got = _golden_batch_workload(tpasta, tevents, batched, capacity)
    assert got == want
    assert got == _golden_batch_workload(tpasta, tevents)
    n_kernels = sum(c for _n, c, _l in KERNELS) * 3
    assert got["WorkingSetTool"]["kernel_count"] == n_kernels
    assert got["KernelFrequencyTool"]["total_invocations"] == n_kernels
    assert got["MemoryTimelineTool"]["alloc_events"] == {"()": 6}
    assert got["HotnessTool"]["total_accesses"] == 400


def _session_drive(pasta, events_mod):
    """tests/test_session.py's deterministic session workload."""
    events_mod.reset_seq()
    kw = {} if pasta is jpasta else {"torch_device": "cpu"}
    with pasta.Session(tools="workingset,locator", name="solo", **kw) as s:
        h = s.handler
        h.step_start(0)
        for i in range(8):
            h.emit(pasta.Event(pasta.EventKind.KERNEL_LAUNCH,
                               name=f"fusion.{i % 3}",
                               attrs={"count": i + 1, "bytes": 1 << 20}))
        pool = pasta.MemoryPool(h, chunk_size=1 << 20)
        ts = [pool.alloc((i + 1) << 12, f"t{i}") for i in range(5)]
        h.operator_start("op0", tensors=[(t.addr, t.size) for t in ts[:3]])
        h.emit(pasta.Event(pasta.EventKind.COLLECTIVE, name="all-reduce.1",
                           size=1 << 16, attrs={"mult": 2}))
        for t in ts[::2]:
            pool.free(t)
        h.step_end(0)
    data = s.reports().data
    data["locator"].pop("python_stack")       # frames differ by package
    return data


def test_golden_session_stream_reports_equal():
    want = _session_drive(jpasta, jevents)
    got = _session_drive(tpasta, tevents)
    assert got == want
    assert got["locator"]["kernel"] == "fusion.1"      # count 8, i = 7


def _mk_trace(rng, k=5, n=800):
    sizes = rng.integers(512, 4 << 20, size=k) // 512 * 512
    starts = np.zeros(k, dtype=np.int64)
    addr = 2 << 20
    for i in range(k):
        starts[i] = addr
        addr += sizes[i] + (2 << 20)
    ends = starts + sizes
    hits = rng.integers(0, k, size=n)
    addrs = starts[hits] + rng.integers(0, sizes[hits])
    addrs[::11] = ends[-1] + 12345
    return addrs, starts, ends


def _aggregates(pasta, addrs, objs, device_analysis=True):
    handler = pasta.EventHandler()
    seen = []
    proc = pasta.EventProcessor(handler, hotness=HOT_CFG,
                                device_analysis=device_analysis,
                                **_kw(pasta))
    handler.subscribe(seen.append, kinds=("trace_buffer",))
    handler.trace_buffer(addrs, name="k", objects=objs,
                         object_sizes=[e - s for s, e in objs], time=0.25)
    proc.close()
    return seen[-1].attrs


def test_processor_fused_and_two_pass_agree(rng, monkeypatch):
    addrs, starts, ends = _mk_trace(rng)
    objs = list(zip(starts.tolist(), ends.tolist()))
    ref = _aggregates(jpasta, addrs, objs)
    fused = _aggregates(tpasta, addrs, objs)
    monkeypatch.setattr(tops, "can_fuse", lambda *a, **k: False)
    two_pass = _aggregates(tpasta, addrs, objs)
    for got in (fused, two_pass):
        np.testing.assert_array_equal(got["object_counts"],
                                      ref["object_counts"])
        np.testing.assert_array_equal(got["hotness_map"], ref["hotness_map"])
        assert got["analysis_mode"] == "device" and "records" not in got


def test_host_mode_matches_device_mode(rng):
    """The Fig. 2a host-resident baseline and the device-resident path
    attach the same aggregates."""
    addrs, starts, ends = _mk_trace(rng)
    objs = list(zip(starts.tolist(), ends.tolist()))
    host = _aggregates(tpasta, addrs, objs, device_analysis=False)
    dev = _aggregates(tpasta, addrs, objs)
    assert host["analysis_mode"] == "host"
    np.testing.assert_array_equal(host["object_counts"],
                                  dev["object_counts"])
    np.testing.assert_array_equal(host["hotness_map"], dev["hotness_map"])
