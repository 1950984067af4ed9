"""Port's trace-reduction kernels against the JAX package's.

``repro_torch.kernels.ops`` with ``device="cpu"`` (the plain PyTorch
versions) must equal ``repro.kernels.ops`` exactly, on the reference's jnp
backend and on its Pallas kernels in interpret mode, over the edge cases of
tests/test_kernels.py and tests/test_batch.py.  The CUDA kernels themselves
run only on the card (tests/test_torch_cuda.py; chip_smoke.py drives them
too).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.core import events as tevents
from repro_torch.core import session as tsession
from repro_torch.kernels import build, instrumented_matmul, ops, ref

BACKENDS = {"ref": "0", "interpret": "1"}


@pytest.fixture(autouse=True)
def _port_state():
    tevents.reset_seq()
    tsession.reset_state()
    yield
    tsession.reset_state()


@pytest.fixture(params=sorted(BACKENDS))
def jax_backend(request, monkeypatch):
    """Selects the reference's backend for the test (REPRO_PALLAS_INTERPRET
    is read at call time)."""
    monkeypatch.setenv("REPRO_PALLAS_INTERPRET", BACKENDS[request.param])
    return request.param


def _mk_objects(rng, k, max_size=4 << 20):
    sizes = rng.integers(512, max_size, size=k) // 512 * 512
    starts = np.zeros(k, dtype=np.int64)
    addr = 2 << 20
    for i in range(k):
        starts[i] = addr
        addr += sizes[i] + (2 << 20)
    return starts, starts + sizes


def _edge_trace(rng, starts, ends, n):
    """Records inside the objects plus: a < 0, below the first start, at
    the last end, beyond it."""
    hits = rng.integers(0, len(starts), size=n)
    addrs = starts[hits] + rng.integers(0, (ends - starts)[hits])
    if n >= 8:
        addrs[::7] = -4096
        addrs[1::9] = starts[0] - 512
        addrs[2::11] = ends[-1]
        addrs[3::13] = ends[-1] + 12345
    return addrs


@pytest.mark.parametrize("n,k", [(100, 3), (5000, 17), (2049, 40), (3, 1)])
def test_object_histogram_matches_reference(rng, jax_backend, n, k):
    starts, ends = _mk_objects(rng, k)
    addrs = _edge_trace(rng, starts, ends, n)
    want = jops.object_histogram(addrs, starts, ends)
    got = ops.object_histogram(addrs, starts, ends, device="cpu")
    assert got.dtype == np.int64
    np.testing.assert_array_equal(got, want)


def test_object_histogram_exact_counts(rng):
    starts = np.array([2 << 20, 8 << 20, 32 << 20], dtype=np.int64)
    ends = starts + np.array([1 << 20, 2 << 20, 512], dtype=np.int64)
    addrs = np.concatenate([
        rng.integers(starts[0], ends[0], 700),
        rng.integers(starts[1], ends[1], 300),
        np.full(5, starts[2]),
    ])
    got = ops.object_histogram(addrs, starts, ends, device="cpu")
    np.testing.assert_array_equal(got, [700, 300, 5])


def test_object_histogram_empty_ranges(jax_backend):
    """Empty ranges, one sharing its start with the next object: a record
    counts for the last object whose start is <= it, if below its end."""
    starts = np.array([1 << 20, 3 << 20, 3 << 20, 8 << 20], dtype=np.int64)
    ends = np.array([2 << 20, 3 << 20, 4 << 20, 8 << 20], dtype=np.int64)
    addrs = np.array([1 << 20, (3 << 20) + 512, 3 << 20, 8 << 20,
                      (8 << 20) + 512, (2 << 20) + 512], dtype=np.int64)
    want = jops.object_histogram(addrs, starts, ends)
    got = ops.object_histogram(addrs, starts, ends, device="cpu")
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, [1, 0, 2, 0])


@pytest.mark.parametrize("n", [1, 2047, 2048, 2049])
def test_tile_edges(rng, jax_backend, n):
    """Counts do not depend on N against the reference's tile multiples."""
    starts, ends = _mk_objects(rng, 5)
    addrs = starts[rng.integers(0, 5, n)] + 256
    want = jops.object_histogram(addrs, starts, ends)
    got = ops.object_histogram(addrs, starts, ends, device="cpu")
    np.testing.assert_array_equal(got, want)
    assert got.sum() == n


@pytest.mark.parametrize("n,nb,tb", [(100, 32, 8), (4096, 512, 64),
                                     (7, 512, 4), (3000, 600, 3)])
def test_hotness_matches_reference(rng, jax_backend, n, nb, tb):
    base = 2 << 20
    addrs = base + rng.integers(0, nb * (2 << 20), size=n)
    times = rng.random(n)
    want = jops.hotness_histogram(addrs, times, base, nb, tb, 1.0)
    got = ops.hotness_histogram(addrs, times, base, nb, tb, 1.0,
                                device="cpu")
    np.testing.assert_array_equal(got, want)
    assert got.sum() == n


def test_hotness_drops_and_clamps(jax_backend):
    """Blocks outside [0, n_blocks) and a < 0 drop; times at or beyond
    t_max clamp into the last bin; negative times drop."""
    base = 2 << 20
    blk = 2 << 20                     # 2 MiB blocks (BLOCK_SHIFT 12)
    addrs = np.array([base - 4096, -512, base + 8 * blk, base,
                      base + blk + 7, base + 7 * blk, base + 3 * blk],
                     dtype=np.int64)
    times = np.array([0.1, 0.1, 0.1, 1.0, 5.0, 0.99, -0.5])
    want = jops.hotness_histogram(addrs, times, base, 8, 4, 1.0)
    got = ops.hotness_histogram(addrs, times, base, 8, 4, 1.0, device="cpu")
    np.testing.assert_array_equal(got, want)
    assert got.sum() == 3 and got[3].sum() == 3


@pytest.mark.parametrize("n,nb,tb,shift", [(100, 64, 4, 5),
                                           (5000, 256, 8, 12),
                                           (3000, 16, 2, 3)])
def test_trace_aggregate_matches_reference(rng, jax_backend, n, nb, tb,
                                           shift):
    starts, ends = _mk_objects(rng, 17)
    addrs = _edge_trace(rng, starts, ends, n)
    times = rng.random(n) * 1.2
    base = 2 << 20
    want = jops.trace_aggregate(addrs, times, starts, ends, base, nb, tb, 1.0,
                                block_shift=shift)
    got = ops.trace_aggregate(addrs, times, starts, ends, base, nb, tb, 1.0,
                              block_shift=shift, device="cpu")
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    # fused == the two separate reductions
    np.testing.assert_array_equal(
        got[0], ops.object_histogram(addrs, starts, ends, device="cpu"))
    np.testing.assert_array_equal(
        got[1], ops.hotness_histogram(addrs, times, base, nb, tb, 1.0,
                                      block_shift=shift, device="cpu"))


@pytest.mark.parametrize("shift", [0, 3, 12])
def test_plain_versions_match_reference_oracles(rng, shift):
    """The tensor-level plain versions against the reference's jnp oracles
    on int32 units, with time bins outside [0, n_tbins) and addresses
    below zero, which the host API never produces."""
    starts, ends = _mk_objects(rng, 9)
    units = lambda x: (np.asarray(x) >> ops.UNIT_SHIFT).astype(np.int32)
    a = units(_edge_trace(rng, starts, ends, 3000))
    s, e = units(starts), units(ends)
    tb = rng.integers(-2, 7, size=a.shape[0]).astype(np.int32)
    base, nb, ntb = int(s[0]) + 3, 64, 5
    want_c = np.asarray(jref.object_histogram_ref(jnp.asarray(a),
                                                  jnp.asarray(s),
                                                  jnp.asarray(e)))
    want_h = np.asarray(jref.hotness_histogram_ref(
        jnp.asarray(a), jnp.asarray(tb), base, nb, ntb, shift))
    t = torch.from_numpy
    got_c, got_h = ref.trace_aggregate_ref(t(a), t(tb), t(s), t(e), base, nb,
                                           ntb, shift)
    np.testing.assert_array_equal(got_c.numpy(), want_c)
    np.testing.assert_array_equal(got_h.numpy(), want_h)
    assert got_c.dtype == got_h.dtype == torch.int32


def test_can_fuse_on_cpu():
    """The plain CPU version has no shared-memory limit."""
    assert ops.can_fuse(5000, 1024, 64, device="cpu")
    assert ops.can_fuse(100, 32768, 64, device="cpu")
    # the card's limit: 12 B per object + 4 B per hotness cell
    assert ops.fused_smem_bytes(100, 4096, 4) == 1200 + 65536


def test_wrappers_validate_inputs():
    a = torch.zeros(4, dtype=torch.int64)
    s = torch.zeros(1, dtype=torch.int32)
    with pytest.raises(ValueError):
        ops.object_histogram_t(a, s, s)
    with pytest.raises(ValueError):
        ops.hotness_histogram_t(s, s, 0, 8, 4, 31)
    with pytest.raises(ValueError):
        ops.trace_aggregate_t(s, s, s, s, 2**31, 8, 4, 5)


def test_cpu_path_never_counts_launches(rng):
    ops.reset_launches()
    starts, ends = _mk_objects(rng, 3)
    ops.object_histogram(starts, starts, ends, device="cpu")
    ops.trace_aggregate(starts, [0.0] * 3, starts, ends, 2 << 20, 8, 2, 1.0,
                        device="cpu")
    instrumented_matmul.matmul_traced(torch.ones((128, 8)),
                                      torch.ones((8, 128)))
    assert ops.launches == {"object_histogram": 0, "hotness_histogram": 0,
                            "trace_aggregate": 0, "instrumented_matmul": 0}


def test_failed_build_raises(tmp_path, monkeypatch):
    """No nvcc, no library: loading a kernel raises (there is no fallback
    to the plain version for a CUDA tensor)."""
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(build, "_libs", {})
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc"):
        build.load("trace_aggregate")


def test_library_name_tracks_its_source(tmp_path, monkeypatch):
    """An edited source gets a new library name, so a stale build is never
    loaded."""
    for f in ("object_histogram.cu", "common.cuh"):
        (tmp_path / f).write_bytes((build.CSRC / f).read_bytes())
    monkeypatch.setattr(build, "CSRC", tmp_path)
    before = build._library_path("object_histogram")
    with open(tmp_path / "common.cuh", "a") as f:
        f.write("// edited\n")
    assert build._library_path("object_histogram") != before


@pytest.mark.parametrize("edited", ["common.cuh", "records.cuh",
                                    "object_histogram.cu",
                                    "hotness_histogram.cu"])
def test_library_name_tracks_every_header(tmp_path, monkeypatch, edited):
    """An edited header renames the library of every kernel, so a kernel
    that includes it is rebuilt; an edited source renames only its own."""
    for f in build.CSRC.glob("*.cu*"):
        (tmp_path / f.name).write_bytes(f.read_bytes())
    monkeypatch.setattr(build, "CSRC", tmp_path)
    before = {name: build._library_path(name) for name in build.SIGNATURES}
    with open(tmp_path / edited, "a") as f:
        f.write("// edited\n")
    changed = {name for name in build.SIGNATURES
               if build._library_path(name) != before[name]}
    assert changed == (set(build.SIGNATURES) if edited.endswith(".cuh")
                       else {edited[:-3]})


def test_every_included_header_is_hashed():
    """Each header a source includes by a quoted name lies in ``csrc/``,
    where the library name's hash reads every header."""
    for name in build.SIGNATURES:
        src = (build.CSRC / f"{name}.cu").read_text()
        for line in src.splitlines():
            if line.startswith('#include "'):
                assert (build.CSRC / line.split('"')[1]).is_file(), line
