"""The port's pure launch plans, on the CPU: which body and K split
``matmul_traced`` takes (``instrumented_matmul._plan``), and how the fused
trace kernel spreads records over its clusters (``ops.fused_plan``,
``ops.fused_shares``).  The kernels compute the same splits on the card;
``tests/test_torch_cuda.py`` and ``chip_smoke.py`` hold their results
against the plain versions there.
"""

import pytest
import torch

from repro_torch.core import events as tevents
from repro_torch.core import session as tsession
from repro_torch.kernels import instrumented_matmul as im
from repro_torch.kernels import ops

#: clusters of the wgmma body an H100 SXM (132 SMs) holds at once, by
#: split, as cudaOccupancyMaxActiveClusters reported it on that card; and
#: a card with fewer SMs per GPC
RESIDENT = {"h100": {1: 132, 2: 66, 4: 30, 8: 15},
            "smaller": {1: 114, 2: 57, 4: 28, 8: 12}}
SMS = {"h100": 132, "smaller": 114}
SHAPES = [(128, 4096, 4096), (128, 4096, 13696), (128, 13696, 4096),
          (128, 4096, 151552), (128, 1000, 512), (256, 8, 128),
          (128, 13696, 512), (1024, 4096, 4096), (128, 64, 128),
          (384, 200, 256)]


@pytest.fixture(autouse=True)
def _port_state():
    tevents.reset_seq()
    tsession.reset_state()
    yield
    tsession.reset_state()


@pytest.mark.parametrize("card", sorted(RESIDENT))
@pytest.mark.parametrize("m,k,n", SHAPES)
def test_plan_tiles_k_completely(card, m, k, n):
    body, split = im._plan(m, k, n, torch.bfloat16, RESIDENT[card])
    assert body == "wgmma" and split in im.SPLITS
    ranges = im._slabs(k, split)
    assert len(ranges) == split
    assert ranges[0][0] == 0 and ranges[-1][1] == -(-k // im.BK)
    for (a, b), (c, _) in zip(ranges, ranges[1:]):
        assert b == c                      # contiguous, no slab twice
    assert all(a < b for a, b in ranges)   # no split without a slab


@pytest.mark.parametrize("card", sorted(RESIDENT))
@pytest.mark.parametrize("m,k,n", SHAPES)
def test_plan_keeps_clusters_resident(card, m, k, n):
    """S > 1 only when every tile's cluster is on the card at once, so
    tiles * S stays within the SM count; S = 1 for more tiles than SMs."""
    _, split = im._plan(m, k, n, torch.bfloat16, RESIDENT[card])
    tiles = (m // im.BM) * (n // im.BN)
    assert tiles * split <= max(tiles, SMS[card])
    if split > 1:
        assert tiles <= RESIDENT[card][split]


def test_plan_splits_the_narrow_glm4_products():
    """On the H100: wq and w_down (32 tiles) split 2 ways, since only 30
    clusters of 4 fit; w_gate (107 tiles) and lm_head (1184) do not."""
    h100 = RESIDENT["h100"]
    plans = {shape: im._plan(*shape, torch.bfloat16, h100)[1]
             for shape in SHAPES[:4]}
    assert list(plans.values()) == [2, 1, 2, 1]


@pytest.mark.parametrize("dtype,k,aligned,body", [
    (torch.float32, 4096, True, "simt"),
    (torch.float32, 64, True, "simt"),
    (torch.bfloat16, 4100, True, "simt"),
    (torch.bfloat16, 1, True, "simt"),
    (torch.bfloat16, 13697, True, "simt"),
    (torch.bfloat16, 0, True, "simt"),
    (torch.bfloat16, 4096, False, "simt"),
    (torch.bfloat16, 4104, True, "wgmma"),
    (torch.bfloat16, 8, True, "wgmma")])
def test_plan_body(dtype, k, aligned, body):
    got, split = im._plan(128, k, 256, dtype, RESIDENT["h100"], aligned)
    assert got == body
    if body == "simt":
        assert split == 1


def test_reset_launches_resets_the_body_counter():
    assert im.bodies is ops.bodies
    ops.bodies["wgmma"] += 3
    ops.launches["instrumented_matmul"] += 3
    ops.reset_launches()
    assert ops.bodies == {"wgmma": 0, "simt": 0}
    assert set(ops.launches) == {"object_histogram", "hotness_histogram",
                                 "trace_aggregate", "instrumented_matmul"}


def test_cpu_matmul_counts_no_body():
    ops.reset_launches()
    im.matmul_traced(torch.ones((128, 64), dtype=torch.bfloat16),
                     torch.ones((64, 128), dtype=torch.bfloat16))
    assert ops.bodies == {"wgmma": 0, "simt": 0}


@pytest.mark.parametrize("sms", [132, 114, 8])
@pytest.mark.parametrize("n", [0, 1, 7, 8, 45878, 2**18, 2**18 + 1,
                               2**24 - 1])
def test_fused_shares_cover_every_record_once(n, sms):
    clusters, threads = ops.fused_plan(n, sms)
    assert threads in ops.FUSED_THREADS
    blocks = clusters * ops.FUSED_CLUSTER
    assert clusters >= 1 and (clusters == 1 or blocks <= sms)
    shares = ops.fused_shares(n, blocks)
    assert len(shares) == blocks
    assert shares[0][0] == 0 and shares[-1][1] == n
    for (a, b), (c, _) in zip(shares, shares[1:]):
        assert a <= b == c
    # whole rounds of 16-byte loads: every share but the end starts aligned
    assert all(a % ops.FUSED_RECORDS == 0 for a, _ in shares if a < n)


@pytest.mark.parametrize("n,clusters,threads", [
    (0, 1, 512), (1, 1, 512), (21700, 1, 512), (32768, 1, 512),
    (32769, 1, 1024), (45878, 1, 1024), (262144, 1, 1024),
    (262145, 2, 1024), (2**24 - 1, 16, 1024)])
def test_fused_plan_one_cluster_for_main_path_buffers(n, clusters, threads):
    """One cluster (one launch, no fill) up to FUSED_ROUNDS rounds of
    loads per thread; the main path's buffers average 21,700 records and
    reach 45,878.  512 threads while a block's share takes one round."""
    assert ops.fused_plan(n, 132) == (clusters, threads)
    if clusters == 1:
        share = ops.fused_shares(n, ops.FUSED_CLUSTER)[0][1]
        per_round = threads * ops.FUSED_RECORDS
        assert -(-share // per_round) <= ops.FUSED_ROUNDS


def test_fused_cpu_outputs_are_separate_tensors():
    """The plain version's outputs keep their shapes (the card's are views
    of one buffer with the same shapes)."""
    a = torch.tensor([4096, 4100, 9000], dtype=torch.int32)
    t = torch.tensor([0, 1, 1], dtype=torch.int32)
    s = torch.tensor([4096], dtype=torch.int32)
    e = torch.tensor([4200], dtype=torch.int32)
    counts, hist = ops.trace_aggregate_t(a, t, s, e, 4096, 8, 2, 4)
    assert counts.tolist() == [2]
    assert hist.shape == (2, 8) and int(hist.sum()) == 2
