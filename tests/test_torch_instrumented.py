"""The in-kernel fine-grained tier: the port's ``matmul_traced`` against the
JAX package's, on the CPU.

The same operands (numpy from a seed, cast to the dtype in each framework
by round-to-nearest-even) go to the reference's Pallas kernel in interpret
mode and to the port's wrapper, which runs its plain version on a CPU
tensor.  ``out`` must agree within rtol 1e-5, atol 1e-4 (the reference
test's own tolerance: float32 sums over K in a different order); the trace
must be exactly equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as jpasta
from repro.kernels.instrumented_matmul import matmul_traced as jmatmul_traced
import repro_torch.core as tpasta
from repro_torch.core import events as tevents
from repro_torch.core import session as tsession
from repro_torch.kernels import instrumented_matmul as im
from repro_torch.kernels import ops

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


@pytest.fixture(autouse=True)
def _port_state():
    tevents.reset_seq()
    tsession.reset_state()
    yield
    tsession.reset_state()


def _operands(rng, m, k, n, dtype):
    x = rng.standard_normal((m, k)).astype(np.float32)
    w = rng.standard_normal((k, n)).astype(np.float32)
    jdt, tdt = DTYPES[dtype]
    return (jnp.asarray(x, jdt), jnp.asarray(w, jdt),
            torch.from_numpy(x).to(tdt), torch.from_numpy(w).to(tdt))


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("m,k,n", [(128, 64, 128), (256, 128, 384),
                                   (384, 32, 128)])
def test_traced_matmul_matches_reference(rng, m, k, n, dtype):
    jx, jw, tx, tw = _operands(rng, m, k, n, dtype)
    want_out, want_trace = jmatmul_traced(jx, jw, interpret=True)
    ops.reset_launches()
    out, trace = im.matmul_traced(tx, tw)
    assert out.dtype == torch.float32 and trace.dtype == torch.int32
    np.testing.assert_allclose(out.numpy(), np.asarray(want_out), rtol=1e-5,
                               atol=1e-4)
    np.testing.assert_array_equal(trace.numpy(), np.asarray(want_trace))
    assert ops.launches["instrumented_matmul"] == 0     # plain version


def _flow(pasta, out_trace):
    """The reference test's flow: one TRACE_BUFFER carrying the trace's
    byte totals, seen by a subscriber, in a session without a hotness map
    (the records are not addresses)."""
    trace = np.asarray(out_trace)
    seen = []
    kw = {} if pasta is jpasta else {"torch_device": "cpu"}
    with pasta.Session(tools=(), name="instrumented", **kw) as s:
        s.handler.subscribe(seen.append, kinds=("trace_buffer",))
        s.handler.trace_buffer(trace, name="matmul", kernel="matmul_traced",
                               bytes_read=int(trace[:, 2].sum()),
                               bytes_written=int(trace[:, 3].sum()))
    return seen


def test_trace_buffer_flows_through_the_port(rng):
    jx, jw, tx, tw = _operands(rng, 256, 64, 256, "float32")
    want = _flow(jpasta, jmatmul_traced(jx, jw, interpret=True)[1])
    got = _flow(tpasta, im.matmul_traced(tx, tw)[1].numpy())
    assert len(got) == len(want) == 1
    for key in ("bytes_read", "bytes_written", "kernel"):
        assert got[0].attrs[key] == want[0].attrs[key], key
    assert got[0].attrs["bytes_read"] == (256 // im.BM) * (256 // im.BN) * \
        (im.BM * 64 * 4 + 64 * im.BN * 4)


@pytest.mark.parametrize("m,k,n", [(100, 64, 128), (128, 64, 200),
                                   (128, 64, 64)])
def test_shapes_off_the_tile_raise(m, k, n):
    with pytest.raises(ValueError, match="multiples"):
        im.matmul_traced(torch.ones((m, k)), torch.ones((k, n)))


def test_mismatched_operands_raise():
    x, w = torch.ones((128, 64)), torch.ones((64, 128))
    with pytest.raises(ValueError, match="bfloat16"):
        im.matmul_traced(x, w.to(torch.bfloat16))
    with pytest.raises(ValueError, match="bfloat16"):
        im.matmul_traced(x.half(), w.half())
    with pytest.raises(ValueError, match="chain"):
        im.matmul_traced(x, torch.ones((32, 128)))


@pytest.mark.parametrize("m,k,n,sms", [(128, 300, 128, 8),
                                       (256, 200, 256, 16)])
def test_simt_split_partials_sum_to_the_reference(rng, m, k, n, sms):
    """The simt body's split K, emulated in float32: each split's partial
    product over its ``_simt_slabs`` range, summed in split order 0..S-1 as
    its sum kernel does, agrees with the reference kernel within the
    reference test's tolerance (so the ranges cover K once)."""
    split, _ = im._simt_plan(m, k, n, sms, torch.float32)
    assert split > 1
    jx, jw, tx, tw = _operands(rng, m, k, n, "float32")
    want_out, _ = jmatmul_traced(jx, jw, interpret=True)
    got = None
    for a, b in im._simt_slabs(k, split):
        lo, hi = a * im.SIMT_BK, min(b * im.SIMT_BK, k)
        part = tx[:, lo:hi] @ tw[lo:hi]
        got = part if got is None else got + part
    np.testing.assert_allclose(got.numpy(), np.asarray(want_out), rtol=1e-5,
                               atol=1e-4)
