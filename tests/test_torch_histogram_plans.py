"""Launch plans of the object and hotness histograms, on the CPU.

``ops.object_plan`` and ``ops.hotness_plan`` pick how each kernel keeps its
accumulator (one cluster, several clusters, one tile of the map per block,
or global atomics) from the record count, the map and the card's opt-in
shared memory; ``ops.fused_shares`` and ``ops.tile_cells`` say which
records and cells each block takes, as the kernels compute them.  The
kernels themselves run on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py``).  Also the port's hotness map on the CPU against the
JAX package's plain reference at the unfusable fallback's 64 x 32768 map.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from repro.kernels import ref as jref
from repro_torch.core import events as tevents
from repro_torch.core import session as tsession
from repro_torch.kernels import ops

#: the opt-in shared memory of a block on an H100 (232,448 bytes, the
#: figure torch.cuda.get_device_properties reports there) and a smaller one
H100_SMEM = 232448
SMALL_SMEM = 101376
SMEMS = [H100_SMEM, SMALL_SMEM]
SMS = 132
NS = [0, 1, 45878, 2**18 + 1, 2**24 - 1]
#: (n_tbins, n_blocks) from one cell to the fallback's 8 MiB map: the main
#: path's 4 x 2241, a map just within and just beyond one H100 block's
#: shared memory (58,112 cells), and the fallback's 64 x 32768
MAPS = [(1, 1), (4, 2241), (1, 58112), (1, 58113), (4, 14529), (64, 32768)]


@pytest.fixture(autouse=True)
def _port_state():
    tevents.reset_seq()
    tsession.reset_state()
    yield
    tsession.reset_state()


def _cover(shares, n):
    """Contiguous, in order, from 0 to n: every record exactly once."""
    assert shares[0][0] == 0 and shares[-1][1] == n
    for (a, b), (c, _) in zip(shares, shares[1:]):
        assert a <= b == c


@pytest.mark.parametrize("smem", SMEMS)
@pytest.mark.parametrize("k", [1, 20, 19370, 19371, 30000])
@pytest.mark.parametrize("n", NS)
def test_object_plan_takes_every_record_once(n, k, smem):
    plan = ops.object_plan(n, k, SMS, smem)
    assert plan.kind == ("cluster" if 12 * k <= smem else "global")
    assert plan.smem <= smem and plan.threads <= 1024
    if plan.kind == "cluster":
        assert plan.cluster == ops.FUSED_CLUSTER
        assert plan.blocks % plan.cluster == 0 and plan.smem == 12 * k
        assert plan.blocks <= max(SMS, plan.cluster)
        shares = ops.fused_shares(n, plan.blocks)
        assert len(shares) == plan.blocks
        _cover(shares, n)
    else:
        # a grid-stride loop: record i goes to thread i mod (blocks*threads)
        assert plan.cluster == 0 and plan.smem == 0
        assert 1 <= plan.blocks <= 2 * SMS
    assert plan.fills == (plan.kind == "global" or plan.blocks > plan.cluster)


@pytest.mark.parametrize("n,blocks,fills", [
    (0, 8, False), (1, 8, False), (45878, 8, False), (2**18 + 1, 16, True),
    (2**24 - 1, 128, True)])
def test_object_plan_one_cluster_for_the_main_path(n, blocks, fills):
    """K = 20 on an H100: one cluster, which writes every count itself (no
    fill), for every buffer up to 4 rounds of loads; the main path's
    largest is 45,878 records, the quickstart's 46,006."""
    plan = ops.object_plan(n, 20, SMS, H100_SMEM)
    assert (plan.kind, plan.blocks, plan.fills) == ("cluster", blocks, fills)


@pytest.mark.parametrize("smem", SMEMS)
@pytest.mark.parametrize("n_tbins,n_blocks", MAPS)
@pytest.mark.parametrize("n", NS)
def test_hotness_plan_owns_every_cell_once(n, n_tbins, n_blocks, smem):
    """Every record is taken once (cluster and global kinds share the
    records; every tile block reads all of them and counts only its own
    cells), every cell has exactly one owner, and no block asks for more
    than the opt-in."""
    cells = n_tbins * n_blocks
    plan = ops.hotness_plan(n, n_tbins, n_blocks, SMS, smem)
    assert plan.kind in ops.KINDS
    assert plan.smem <= smem and plan.threads <= 1024
    if plan.kind == "cluster":
        assert 4 * cells <= smem and plan.smem == 4 * cells
        assert plan.blocks % plan.cluster == 0
        _cover(ops.fused_shares(n, plan.blocks), n)
    elif plan.kind == "tiles":
        assert 4 * cells > smem and plan.cluster == 0
        assert plan.smem % 16 == 0           # whole 16-byte stores
        tiles = ops.tile_cells(cells, plan)
        fewest = -(-cells // (smem // 16 * 4))
        assert len(tiles) == plan.blocks <= max(SMS, fewest)
        _cover(tiles, cells)
        assert all(lo < hi for lo, hi in tiles)      # no block idle
        # re-reading the trace once per tile moves no more than the map
        assert 8 * n * plan.blocks <= 4 * cells or n == 0
        assert not plan.fills
    else:
        assert plan.cluster == 0 and plan.smem == 0 and plan.fills
        # the fewest tiles would re-read more than the map's bytes
        assert 8 * n * -(-4 * cells // (smem // 16 * 16)) > 4 * cells


@pytest.mark.parametrize("n_tbins,n_blocks,n,kind,blocks", [
    (1, 1, 0, "cluster", 8), (1, 1, 45878, "cluster", 8),
    (1, 1, 2**18 + 1, "cluster", 16), (1, 1, 2**24 - 1, "cluster", 128),
    (4, 2241, 1, "cluster", 8), (4, 2241, 45878, "cluster", 8),
    (4, 2241, 2**24 - 1, "cluster", 128),
    (1, 58112, 45878, "cluster", 8),
    (1, 58113, 0, "tiles", 131), (1, 58113, 1, "tiles", 131),
    (1, 58113, 45878, "global", 23), (4, 14529, 2**18 + 1, "global", 129),
    (64, 32768, 0, "tiles", 132), (64, 32768, 1, "tiles", 132),
    (64, 32768, 576, "tiles", 132), (64, 32768, 7943, "tiles", 132),
    (64, 32768, 7944, "tiles", 131), (64, 32768, 28339, "tiles", 37),
    (64, 32768, 28340, "global", 14),
    (64, 32768, 45878, "global", 23), (64, 32768, 2**24 - 1, "global", 264)])
def test_hotness_plan_choice_on_an_h100(n_tbins, n_blocks, n, kind, blocks):
    """The choice at the H100's 132 SMs and 232,448 B: the main path's map
    fits one block; the fallback's 8 MiB map takes one tile per SM while a
    buffer's records are few (phase 5's are hundreds), fewer and larger
    tiles up to 28,339 records, then global atomics into a zeroed map."""
    plan = ops.hotness_plan(n, n_tbins, n_blocks, SMS, H100_SMEM)
    assert (plan.kind, plan.blocks) == (kind, blocks)


@pytest.mark.parametrize("n_records", [0, 1, 4096])
def test_hotness_fallback_map_equals_the_jax_reference(n_records):
    """The port's hotness map on the CPU equals the JAX package's plain
    reference at the fallback's 64 x 32768 map (32-unit blocks of 16 KiB),
    with records below, inside and beyond it and times over every bin."""
    rng = np.random.default_rng(n_records)
    n, n_tbins, n_blocks, shift, t_max = n_records, 64, 32768, 5, 2.0
    base = 2 << 20
    span = n_blocks << shift << ops.UNIT_SHIFT
    addrs = base + rng.integers(-span // 8, span + span // 8, size=n)
    addrs = addrs // 512 * 512
    times = rng.uniform(0.0, t_max, size=n)
    got = ops.hotness_histogram(addrs, times, base, n_blocks, n_tbins, t_max,
                                block_shift=shift, device="cpu")
    units = (addrs >> ops.UNIT_SHIFT).astype(np.int32)
    tbins = np.minimum((times / t_max * n_tbins).astype(np.int32),
                       n_tbins - 1)
    want = np.asarray(jref.hotness_histogram_ref(
        jnp.asarray(units), jnp.asarray(tbins), base >> ops.UNIT_SHIFT,
        n_blocks, n_tbins, shift)).astype(np.int64)
    assert got.shape == (n_tbins, n_blocks)
    assert np.array_equal(got, want)
    inside = (units >= base >> ops.UNIT_SHIFT) & (
        units < (base >> ops.UNIT_SHIFT) + (n_blocks << shift))
    assert int(got.sum()) == int(inside.sum())
