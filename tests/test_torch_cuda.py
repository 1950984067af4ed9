"""Card-only tests of the port (marker ``cuda``): each CUDA kernel against
its plain version, the analysis path of each model family on the card
against the CPU, the compiled-step capture of device kernels, the train
step on the card against the CPU, and the serving path's device-side
hazards: paged writes and gathers at the sentinel, blocked attention, and
the engine's tokens on the card against the CPU.

They import neither ``jax`` nor the JAX package, so they run where only
PyTorch is installed (``--noconftest`` skips ``tests/conftest.py``, which
imports the JAX package; the fixtures they need are defined here), and
skip where ``torch.cuda.is_available()`` is false.  On a machine with the
card::

    PYTHONPATH=src python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

import repro_torch.configs as configs
from repro_torch.core import events as tevents
from repro_torch.core import session as tsession
from repro_torch.kernels import instrumented_matmul as im
from repro_torch.kernels import ops, ref
from repro_torch.core import capture
from repro_torch.launch import analyze
from repro_torch.models import forward, init_params
from repro_torch.models import layers
from repro_torch.serve import SamplingParams, ServeEngine
from repro_torch.train import OptConfig, make_train_step
from repro_torch.train.optimizer import init_opt_state

pytestmark = pytest.mark.cuda


@pytest.fixture(autouse=True)
def _port_state():
    tevents.reset_seq()
    tsession.reset_state()
    yield
    tsession.reset_state()


@pytest.fixture()
def rng():
    return np.random.default_rng(0)


@pytest.fixture()
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _units(x, dev):
    return torch.from_numpy(np.asarray(x, dtype=np.int32)).to(dev)


def _table(rng, k):
    """``k`` sorted disjoint unit ranges, some empty, some sharing a start
    with the next one."""
    sizes = rng.integers(0, 4096, size=k)
    gaps = rng.integers(0, 2, size=k) * 64
    starts = 4096 + np.cumsum(np.concatenate([[0], (sizes + gaps)[:-1]]))
    return starts, starts + sizes


@pytest.mark.parametrize("k", [16, 30000])        # 12*30000 B > shared memory
@pytest.mark.parametrize("nb,ntb", [(512, 4), (32768, 64)])
def test_kernels_equal_plain_versions(rng, card, k, nb, ntb):
    starts, ends = _table(rng, k)
    a = starts[rng.integers(0, k, 65536)] + rng.integers(0, 4096, 65536)
    a[::7] = -5
    a[1::9] = ends[-1]
    a[2::11] = starts[0] - 1
    a, s, e = _units(a, card), _units(starts, card), _units(ends, card)
    t = _units(rng.integers(-1, ntb + 1, a.shape[0]), card)
    base = 4096
    ops.reset_launches()
    assert torch.equal(ops.object_histogram_t(a, s, e),
                       ref.object_histogram_ref(a, s, e))
    assert torch.equal(ops.hotness_histogram_t(a, t, base, nb, ntb, 3),
                       ref.hotness_histogram_ref(a, t, base, nb, ntb, 3))
    fused = ops.can_fuse(k, nb, ntb)
    assert fused == (k == 16 and nb == 512)
    if fused:
        got = ops.trace_aggregate_t(a, t, s, e, base, nb, ntb, 3)
        want = ref.trace_aggregate_ref(a, t, s, e, base, nb, ntb, 3)
        assert all(torch.equal(g, w) for g, w in zip(got, want))
    torch.cuda.synchronize()
    assert ops.launches == {"object_histogram": 1, "hotness_histogram": 1,
                            "trace_aggregate": int(fused),
                            "instrumented_matmul": 0}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,k,n", [(128, 1, 128), (128, 4096, 512),
                                   (256, 1000, 384), (384, 13696, 128)])
def test_matmul_traced_equals_plain_version(rng, card, m, k, n, dtype):
    """The trace exactly; out against the float64 product within the
    worst-case bound of a float32 FMA sum over K terms, gamma_K * |x|@|w|
    with gamma_K = K*u / (1 - K*u), u = 2**-24 (the kernel sums in another
    order than any reference, so an error growing with K is expected)."""
    x = torch.from_numpy(rng.standard_normal((m, k)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((k, n)).astype(np.float32))
    x, w = x.to(card, dtype), w.to(card, dtype)
    ops.reset_launches()
    out, trace = im.matmul_traced(x, w)
    torch.cuda.synchronize()
    assert ops.launches["instrumented_matmul"] == 1
    _, want_trace = im.matmul_traced_ref(x, w)
    assert torch.equal(trace, want_trace)
    exact = x.double() @ w.double()
    gamma = k * 2.0**-24 / (1 - k * 2.0**-24)
    bound = gamma * (x.double().abs() @ w.double().abs())
    assert bool(((out.double() - exact).abs() <= bound).all())


def _bf16(rng, shape, card):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)
                            ).to(card, torch.bfloat16)


@pytest.mark.parametrize("m,k,n", [(128, 4096, 4096), (128, 13696, 512),
                                   (256, 1000, 384)])
def test_matmul_traced_wgmma_split_k(rng, card, m, k, n):
    """Split-K shapes of the wgmma body: within the float32 bound of the
    float64 product, the trace exact, two calls bitwise equal."""
    x, w = _bf16(rng, (m, k), card), _bf16(rng, (k, n), card)
    body, split = im._plan(m, k, n, x.dtype, im._resident(x.device))
    assert body == "wgmma" and split > 1
    ops.reset_launches()
    out, trace = im.matmul_traced(x, w)
    again, _ = im.matmul_traced(x, w)
    torch.cuda.synchronize()
    assert im.bodies == {"wgmma": 2, "simt": 0}
    assert torch.equal(out, again)
    assert torch.equal(trace, im.matmul_traced_ref(x, w)[1])
    exact = x.double() @ w.double()
    gamma = k * 2.0**-24 / (1 - k * 2.0**-24)
    bound = gamma * (x.double().abs() @ w.double().abs())
    assert bool(((out.double() - exact).abs() <= bound).all())


def test_matmul_traced_wgmma_selects_rows_of_w(rng, card):
    """x picks row i % K of w for output row i, so out must be w's rows
    exactly: a wrong transpose, swizzle or box order of the N-major w tile
    moves values between columns or rows."""
    m, k, n = 256, 256, 384
    w = _bf16(rng, (k, n), card)
    x = torch.zeros((m, k), dtype=torch.bfloat16, device=card)
    x[torch.arange(m), torch.arange(m) % k] = 1
    ops.reset_launches()
    out, _ = im.matmul_traced(x, w)
    torch.cuda.synchronize()
    assert im.bodies["wgmma"] == 1
    assert torch.equal(out, w.float()[torch.arange(m) % k])


@pytest.mark.parametrize("dtype,k,body", [(torch.bfloat16, 64, "wgmma"),
                                          (torch.bfloat16, 4104, "wgmma"),
                                          (torch.bfloat16, 100, "simt"),
                                          (torch.float32, 64, "simt")])
def test_matmul_traced_body_counter(rng, card, dtype, k, body):
    x = _bf16(rng, (128, k), card).to(dtype)
    w = _bf16(rng, (k, 256), card).to(dtype)
    ops.reset_launches()
    im.matmul_traced(x, w)
    torch.cuda.synchronize()
    assert im.bodies == {"wgmma": int(body == "wgmma"),
                         "simt": int(body == "simt")}
    assert ops.launches["instrumented_matmul"] == 1


def _held_to_float64(out, x, w):
    """out within gamma_K * |x|@|w| of the float64 product (K terms)."""
    k = x.shape[1]
    exact = x.double() @ w.double()
    gamma = k * 2.0**-24 / (1 - k * 2.0**-24)
    bound = gamma * (x.double().abs() @ w.double().abs())
    return bool(((out.double() - exact).abs() <= bound).all())


def _simt_case(x, w, split, loader):
    """Two calls of the simt body with the plan's (split, loader): the
    trace exact, out within the float32 bound, the two bitwise equal."""
    m, k = x.shape
    n = w.shape[1]
    aligned = x.data_ptr() % 16 == 0 and w.data_ptr() % 16 == 0
    assert im._plan(m, k, n, x.dtype, im._resident(x.device),
                    aligned)[0] == "simt"
    assert im._simt_plan(m, k, n, ops._sms(x.device), x.dtype,
                         aligned) == (split, loader)
    ops.reset_launches()
    out, trace = im.matmul_traced(x, w)
    again, _ = im.matmul_traced(x, w)
    torch.cuda.synchronize()
    assert im.bodies == {"wgmma": 0, "simt": 2}
    assert ops.launches["instrumented_matmul"] == 2
    assert torch.equal(out, again)
    assert torch.equal(trace, im.matmul_traced_ref(x, w)[1])
    assert _held_to_float64(out, x, w)


def _f32(rng, shape, card):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)
                            ).to(card)


@pytest.mark.parametrize("m,k,n,split", [(128, 4096, 4096, 4),
                                         (128, 13696, 512, 30)])
def test_matmul_traced_simt_split_k(rng, card, m, k, n, split):
    """float32 split-K shapes of the simt body (the H100's splits; another
    card's come from its own SM count): cp.async loader, partials summed in
    split order."""
    x, w = _f32(rng, (m, k), card), _f32(rng, (k, n), card)
    want = im._simt_plan(m, k, n, ops._sms(card), torch.float32)
    if ops._sms(card) == 132:
        assert want == (split, "async")
    _simt_case(x, w, *want)


@pytest.mark.parametrize("k,loader", [(4004, "async"), (4098, "scalar")])
def test_matmul_traced_simt_selects_rows_of_w(card, rng, k, loader):
    """x picks row (31 i + 5) % K of w for output row i, spread over every
    split and the ragged last slab, so out must be those rows of w exactly:
    a wrong transpose or pad of x's k-major stage, a wrong column of w's
    stage, a slab summed twice or left out, or no zero fill moves, doubles
    or loses values."""
    m, n = 128, 512
    w = _f32(rng, (k, n), card)
    rows = (31 * torch.arange(m) + 5) % k
    x = torch.zeros((m, k), device=card)
    x[torch.arange(m), rows] = 1
    split, got = im._simt_plan(m, k, n, ops._sms(card), torch.float32)
    assert split > 1 and got == loader
    ops.reset_launches()
    out, _ = im.matmul_traced(x, w)
    torch.cuda.synchronize()
    assert im.bodies["simt"] == 1
    assert torch.equal(out, w[rows.to(card)])


@pytest.mark.parametrize("case", ["f32_k4098", "f32_misaligned_x",
                                  "bf16_k100", "f32_k4"])
def test_matmul_traced_simt_other_branches(rng, card, case):
    """The branches off the main products: float32 with K % 4 != 0 (scalar
    loader, split), float32 x at a 16-byte-misaligned address (scalar
    loader), bf16 with K % 8 != 0 (scalar loader, widened) and a K of one
    ragged slab (cp.async, no split)."""
    m, n = 128, 512
    if case == "f32_k4098":
        x, w, want = _f32(rng, (m, 4098), card), _f32(rng, (4098, n), card), \
            "scalar"
    elif case == "f32_misaligned_x":
        k = 4096
        flat = _f32(rng, (m * k + 1,), card)
        x, w, want = flat[1:].view(m, k), _f32(rng, (k, n), card), "scalar"
        assert x.is_contiguous() and x.data_ptr() % 16 != 0
    elif case == "bf16_k100":
        x, w, want = _bf16(rng, (m, 100), card), _bf16(rng, (100, n), card), \
            "scalar"
    else:
        x, w, want = _f32(rng, (m, 4), card), _f32(rng, (4, n), card), "async"
    k = x.shape[1]
    split, loader = im._simt_plan(m, k, n, ops._sms(card), x.dtype,
                                  x.data_ptr() % 16 == 0)
    assert loader == want
    _simt_case(x, w, split, loader)


def test_simt_entry_refuses_a_loader_off_its_operands(card):
    """The C entry returns an error, and the wrapper raises, for the
    cp.async loader on operands it cannot copy in 16 bytes."""
    m, k, n = 128, 4096, 128
    x = torch.zeros((m * k + 1,), device=card)[1:].view(m, k)
    w = torch.zeros((k, n), device=card)
    out = torch.empty((m, n), device=card)
    trace = torch.empty((1, 4), dtype=torch.int32, device=card)
    with pytest.raises(RuntimeError, match="kernel launch failed"):
        ops._launch("instrumented_matmul", card, x.data_ptr(), w.data_ptr(),
                    out.data_ptr(), trace.data_ptr(), None, m, k, n, 0, 0, 1,
                    im.LOADERS.index("async"), 0, 0)


def _fused_case(card, a, t, starts, ends, base, nb, ntb, shift):
    a, t = _units(a, card), _units(t, card)
    s, e = _units(starts, card), _units(ends, card)
    ops.reset_launches()
    got = ops.trace_aggregate_t(a, t, s, e, base, nb, ntb, shift)
    want = ref.trace_aggregate_ref(a, t, s, e, base, nb, ntb, shift)
    torch.cuda.synchronize()
    assert ops.launches["trace_aggregate"] == 1
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert got[1].shape == (ntb, nb)


@pytest.mark.parametrize("n", [1, 45878, 300000])
def test_fused_one_object_one_cell(rng, card, n):
    """Worst contention: every record in one object and one map cell."""
    starts, ends = _table(rng, 20)
    biggest = int(np.argmax(ends - starts))
    a = np.full(n, starts[biggest])
    _fused_case(card, a, np.full(n, 3), starts, ends, 4096, 2241, 4, 15)


def test_fused_large_buffer_merges_clusters(rng, card):
    """N = 2**24 - 1: several clusters merge into the zeroed outputs."""
    n = 2**24 - 1
    assert ops.fused_plan(n, ops._sms(card))[0] > 1
    starts, ends = _table(rng, 20)
    a = starts[rng.integers(0, 20, n)] + rng.integers(0, 4096, n)
    _fused_case(card, a, rng.integers(0, 4, n), starts, ends, 4096, 2241, 4,
                6)


@pytest.mark.parametrize("n", [7, 65537])
def test_fused_drops_out_of_range_bins_and_blocks(rng, card, n):
    starts, ends = _table(rng, 20)
    a = starts[rng.integers(0, 20, n)] + rng.integers(-8192, 8192, n)
    a[::5] = -2**31
    a[1::5] = 2**31 - 1
    t = rng.integers(-3, 7, n)
    _fused_case(card, a, t, starts, ends, 6000, 300, 4, 4)


def test_matmul_traced_rejects_non_contiguous(card):
    x = torch.ones((128, 256), device=card)
    with pytest.raises(ValueError, match="contiguous"):
        im.matmul_traced(x, torch.ones((128, 256), device=card).t())


@pytest.mark.parametrize("arch", ["glm4-9b", "zamba2-7b", "mamba2-2.7b",
                                  "dbrx-132b"])
def test_analyze_on_the_card_equals_the_cpu(card, arch):
    """Reduced models: the card's reports equal the CPU's, every trace
    buffer went through the fused kernel."""
    cfg = configs.reduced(configs.get(arch))
    buffers = []
    ops.reset_launches()
    got, logits, _ = analyze.run(
        cfg, 2, "cuda",
        observe=lambda s: s.handler.subscribe(buffers.append,
                                              kinds=("trace_buffer",)))
    want, _, _ = analyze.run(cfg, 2, "cpu")
    assert got.data == want.data
    assert ops.launches["trace_aggregate"] == len(buffers) > 0
    assert logits.device.type == "cuda" and bool(torch.isfinite(logits).all())


@pytest.mark.parametrize("arch", ["stablelm-1.6b", "gemma-7b", "qwen3-32b",
                                  "qwen2-vl-72b", "kimi-k2-1t-a32b",
                                  "musicgen-large"])
def test_analyze_new_archs_on_the_card_equals_the_cpu(card, arch):
    """stablelm-1.6b, gemma-7b, qwen3-32b, qwen2-vl-72b, kimi-k2 and
    musicgen-large, reduced: the card's reports equal the CPU's through
    the fused kernel."""
    test_analyze_on_the_card_equals_the_cpu(card, arch)


def test_capture_records_device_kernels(card):
    """A product captured on the card: its records are device kernels (a
    GEMM), not aten names, and its FLOPs are exact."""
    x = torch.randn((256, 256), device=card)
    stats = capture.analyze(capture.capture_step(lambda a: a @ a, x))
    names = [m["opcode"] for m in stats.kernel_meta.values()]
    assert names and not any(n.startswith("aten::") for n in names)
    assert any("gemm" in n.lower() for n in names)
    assert stats.flops == 2 * 256 ** 3
    assert stats.hbm_bytes == 3 * 256 * 256 * 4


def test_train_step_on_the_card_equals_the_cpu(card):
    """One float32 step of reduced paper-gpt2 (TF32 off) from the same
    weights and batch: loss and grad_norm within 1e-5 relative."""
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = configs.reduced(configs.get("paper-gpt2"))
    gen = torch.Generator().manual_seed(1)
    batch = {k: torch.randint(0, cfg.vocab_size, (2, 64), generator=gen,
                              dtype=torch.int32) for k in ("inputs",
                                                           "labels")}
    out = []
    for dev in ("cpu", card):
        params = _to_device(init_params(cfg, 0, "cpu"), dev)
        step = make_train_step(cfg, OptConfig(), microbatches=2)
        _p, _s, m = step(params, init_opt_state(params, OptConfig()),
                         {k: v.to(dev) for k, v in batch.items()})
        out.append({k: float(v) for k, v in m.items()})
    assert out[1]["loss"] == pytest.approx(out[0]["loss"], rel=1e-5)
    assert out[1]["grad_norm"] == pytest.approx(out[0]["grad_norm"],
                                                rel=1e-5)


def _to_device(tree, dev):
    if isinstance(tree, dict):
        return {k: _to_device(v, dev) for k, v in tree.items()}
    return tree.to(dev)


def _histograms(card, a, t, starts, ends, base, nb, ntb, shift):
    """Both unfused kernels against their plain versions, one launch each;
    returns the two plans taken."""
    a, t = _units(a, card), _units(t, card)
    s, e = _units(starts, card), _units(ends, card)
    ops.reset_launches()
    got_c = ops.object_histogram_t(a, s, e)
    got_h = ops.hotness_histogram_t(a, t, base, nb, ntb, shift)
    torch.cuda.synchronize()
    assert ops.launches["object_histogram"] == 1
    assert ops.launches["hotness_histogram"] == 1
    assert torch.equal(got_c, ref.object_histogram_ref(a, s, e))
    assert torch.equal(got_h, ref.hotness_histogram_ref(a, t, base, nb, ntb,
                                                        shift))
    props = torch.cuda.get_device_properties(card)
    sms, smem = props.multi_processor_count, \
        props.shared_memory_per_block_optin
    return (ops.object_plan(a.shape[0], starts.shape[0], sms, smem),
            ops.hotness_plan(a.shape[0], ntb, nb, sms, smem))


def _cells_per_block(card):
    return torch.cuda.get_device_properties(
        card).shared_memory_per_block_optin // 4


def test_object_histogram_above_the_opt_in(rng, card):
    """K one beyond what a block's shared memory holds: the global path."""
    k = _cells_per_block(card) // 3 + 1
    starts, ends = _table(rng, k)
    n = 65537
    a = starts[rng.integers(0, k, n)] + rng.integers(-64, 4096, n)
    plan, _ = _histograms(card, a, rng.integers(0, 4, n), starts, ends, 4096,
                          2241, 4, 6)
    assert plan.kind == "global"


@pytest.mark.parametrize("n", [1, 45878, 300000])
@pytest.mark.parametrize("nb,ntb", [(2241, 4), (32768, 64)])
def test_histograms_one_object_one_cell(rng, card, n, nb, ntb):
    """Worst contention: every record in one object and one map cell."""
    starts, ends = _table(rng, 20)
    biggest = int(np.argmax(ends - starts))
    a = np.full(n, starts[biggest])
    _histograms(card, a, np.full(n, 3), starts, ends, 4096, nb, ntb, 15)


@pytest.mark.parametrize("n", [1000, 45878])
@pytest.mark.parametrize("where", ["below", "above", "8 MiB"])
def test_hotness_maps_around_one_block(rng, card, n, where):
    """Maps just within and just beyond one block's shared memory, and the
    fallback's 8 MiB map: one cluster, owner tiles or global atomics."""
    cells = _cells_per_block(card)
    ntb, nb = {"below": (1, cells), "above": (1, cells + 1),
               "8 MiB": (64, 32768)}[where]
    starts, ends = _table(rng, 20)
    a = 4096 + rng.integers(-64, (nb + 64) << 2, n)
    _, plan = _histograms(card, a, rng.integers(0, ntb, n), starts, ends,
                          4096, nb, ntb, 2)
    want = "cluster" if where == "below" else \
        ("tiles" if n == 1000 else "global")
    assert plan.kind == want


@pytest.mark.parametrize("n", [7, 65537])
@pytest.mark.parametrize("nb,ntb", [(300, 4), (14529, 4), (32768, 64)])
def test_histograms_drop_out_of_range_bins_and_blocks(rng, card, n, nb, ntb):
    starts, ends = _table(rng, 20)
    a = starts[rng.integers(0, 20, n)] + rng.integers(-8192, 8192, n)
    a[::5] = -2**31
    a[1::5] = 2**31 - 1
    t = rng.integers(-3, ntb + 3, n)
    _histograms(card, a, t, starts, ends, 6000, nb, ntb, 4)


@pytest.mark.parametrize("nb,ntb", [(2241, 4), (32768, 64)])
def test_histograms_largest_buffer(rng, card, nb, ntb):
    """N = 2**24 - 1: several clusters (or global atomics) add into zeroed
    outputs."""
    n = 2**24 - 1
    starts, ends = _table(rng, 20)
    a = starts[rng.integers(0, 20, n)] + rng.integers(0, 4096, n)
    plan_c, plan_h = _histograms(card, a, rng.integers(0, ntb, n), starts,
                                 ends, 4096, nb, ntb, 6)
    assert plan_c.fills and plan_h.fills


def _to(tree, dev):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    return tree.to(dev)


def test_paged_decode_with_parked_rows_and_sentinels_equals_the_cpu(card):
    """A paged append where one row is parked at the span and the other's
    right-pad falls in sentinel table entries: on the card nothing indexes
    out of range (an assert there would end the CUDA context), and logits
    and pool bytes equal the CPU's."""
    cfg = configs.reduced(configs.get("paper-gpt2"))
    params = init_params(cfg, 0, "cpu")
    gen = torch.Generator().manual_seed(1)
    n_blocks, bs = 6, 4
    shape = (cfg.n_layers, n_blocks, bs, cfg.n_kv_heads, cfg.head_dim)
    pk, pv = torch.randn(shape, generator=gen), torch.randn(shape,
                                                            generator=gen)
    bt = torch.tensor([[4, 1, n_blocks, n_blocks], [0, 2, 3, n_blocks]],
                      dtype=torch.int32)
    x = torch.randint(0, cfg.vocab_size, (2, 12), generator=gen,
                      dtype=torch.int32)
    out = []
    for dev in ("cpu", card):
        cache = {"kv": {"pk": pk.clone().to(dev), "pv": pv.clone().to(dev),
                        "bt": bt.to(dev),
                        "length": torch.tensor([0, 16], dtype=torch.int32,
                                               device=dev)}}
        with torch.no_grad():
            logits, new = forward(_to(params, dev), x.to(dev), cfg,
                                  cache=cache, logits_mode="index",
                                  logits_index=torch.tensor([5, 0],
                                                            device=dev))
        out.append([t.cpu() for t in (logits, new["kv"]["pk"],
                                      new["kv"]["pv"])])
    for got, want in zip(out[1], out[0]):
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("causal", [True, False])
def test_blocked_attention_on_the_card_equals_the_cpu(card, causal):
    """bf16 blocked attention over 4 chunks on the card: within the stated
    bf16 bound (2**-6 of max|v|) of the CPU's, and of dense attention."""
    gen = torch.Generator().manual_seed(2)
    q = torch.randn((1, 512, 2, 4, 64), generator=gen).to(torch.bfloat16)
    k = torch.randn((1, 512, 2, 64), generator=gen).to(torch.bfloat16)
    v = torch.randn((1, 512, 2, 64), generator=gen).to(torch.bfloat16)
    cpu = layers._sdpa_blocked(q, k, v, causal, chunk=128).float()
    gpu = layers._sdpa_blocked(q.to(card), k.to(card), v.to(card), causal,
                               chunk=128).float().cpu()
    dense = layers._sdpa_dense(q.to(card), k.to(card), v.to(card),
                               causal).float().cpu()
    bound = 2 ** -6 * float(v.float().abs().max())
    assert float((gpu - cpu).abs().max()) <= bound
    assert float((gpu - dense).abs().max()) <= bound


@pytest.mark.parametrize("arch", ["paper-gpt2", "zamba2-7b"])
def test_engine_on_the_card_equals_the_cpu(card, arch):
    """Reduced float32, temperature 0, staggered ragged prompts: the
    engine's tokens on the card equal the CPU's."""
    cfg = configs.reduced(configs.get(arch))
    params = init_params(cfg, 0, "cpu")
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in (5, 17, 9, 12)]
    runs = []
    for p in (params, _to(params, card)):
        eng = ServeEngine(cfg, p, max_seq=40, max_slots=2, prefix_block=8)
        runs.append(eng.run([(q, SamplingParams(max_new_tokens=6))
                             for q in prompts]))
        assert eng.device.type == p["final_norm"].device.type
    assert {k: list(v) for k, v in runs[0].items()} == \
        {k: list(v) for k, v in runs[1].items()}


@pytest.mark.parametrize("arch,spec", [("paper-gpt2", 0), ("paper-gpt2", 2),
                                       ("zamba2-7b", 0)])
def test_decode_dispatch_never_waits_on_the_card(card, arch, spec):
    """One fused decode (a speculative verify with ``spec``) on the card
    under ``torch.cuda.set_sync_debug_mode("error")``: building the
    per-tick tables and tokens and running every layer wait on the card
    nowhere; the dispatch's one wait is the logits' copy to the host."""
    cfg = configs.reduced(configs.get(arch))
    eng = ServeEngine(cfg, init_params(cfg, 0, "cuda"), max_seq=40,
                      max_slots=2, spec_decode=spec)
    eng.submit(np.arange(1, 10, dtype=np.int32),
               SamplingParams(max_new_tokens=8))
    eng.step()                                    # prefill + one decode
    slots = eng.pool.slots
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        if eng.paged:
            lengths = np.full((slots,), eng.pool.blocks_per_seq
                              * eng.pool.block_size, np.int32)
            lengths[0] = 10
            cache = eng.pool.cache_view(lengths)
        else:
            cache = eng.pool.cache
        if spec:
            toks = eng._dev(np.zeros((slots, spec + 1), np.int32))
            logits, _ = eng._verify(eng.params, cache, toks,
                                    eng._verify_idx_dev)
        else:
            toks = eng._dev(eng.last_tokens[:, None])
            logits, _ = eng._decode(eng.params, cache, toks)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert bool(torch.isfinite(logits).all())
