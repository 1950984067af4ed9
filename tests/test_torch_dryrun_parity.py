"""The port's dry-run held to the reference's, per device, cell by cell,
on the CPU.

The reference's side runs in a subprocess with eight forced XLA host
devices: ``repro.launch.dryrun.build_cell`` on a data 2 × model 4 mesh
built with Auto axes (jax 0.9.0 refuses ``with_sharding_constraint`` on
``jax.make_mesh``'s default Explicit axes), lowered and compiled, and
its HLO read by the reference's own walker (``repro.core.hlo``), as its
``run_cell`` does.  The port's side traces ``repro_torch.launch.dryrun``'s
``build_cell`` on a fake process group of the same logical mesh and rolls
the trace up with ``core.trace.analyze_trace``, as its ``run_cell`` does.

The cells are small, built as ``configs/shapes.py`` builds its specs:
reduced qwen3-32b (4 query heads, 1 KV head: the KV heads do not divide
``model``) train and prefill, reduced mamba2-2.7b long-context decode
(one row against a 4096-position SSM state).

The factor: FLOPs per device, port ÷ reference, within 0.8–1.25 where
both compute the same thing.  The two walkers count alike (matmul-class
FLOPs plus one per element of each elementwise result), and the matmul
FLOPs of the prefill cell are equal; what remains is elementwise ops
that XLA folds or adds.  Before the query heads were split over
``model``, the port's prefill cell counted 2.38× the reference's
(every ``model`` rank computed all four query heads).

Two differences are pinned here with their causes:

* **Train: the reference recomputes each layer's forward in the backward**
  (``remat="full"``, ``jax.checkpoint``; the port's autograd keeps the
  activations).  Held: against the reference compiled with
  ``remat="none"`` the ratio is within the factor; against the default,
  it is 0.82 — the reference's surplus is its rematerialized forward.
  The same recompute repeats the forward's tensor-parallel
  all-reduces, so the train cell's collective bytes read 0.83× the
  default reference and 0.92× the one without remat.  The rest is how
  each moves the same data: XLA's embedding lookup moves rows with
  all-to-all and collective-permute and it all-reduces weight gradients
  over ``data``, where the port all-gathers the data-sharded weights and
  table and reduce-scatters their gradients.
* **bf16 compute: XLA:CPU moves the matmuls' partial sums in float32.**
  Its bf16 dots accumulate in float32 and the tensor-parallel
  all-reduces carry that float32; the port's bf16 matmuls return bf16
  and reduce it.  Held on the prefill cell in bf16: the reference's
  all-reduce bytes equal its float32 cell's, the port's are half its
  float32 cell's.  All-reduce operands are whole tensors while an
  all-gather's is one rank's shard, so on the 16 × 16 production mesh
  the all-reduces dominate, and the full-size qwen3-32b cells read
  0.48–0.49× the reference's collective bytes (ROADMAP §3).
* **Decode of one row: the output projection.**  With one row the batch
  cannot split over ``data``, and ``w_out`` is data-sharded on
  ``d_model`` (FSDP).  XLA gathers ``w_out`` and computes every output
  column; the port's ``dist.sharding.einsum`` computes this rank's
  block of the columns and gathers the (1, 1, d_model) result.  The
  matmul FLOPs differ by exactly that projection's other ``data``
  blocks, ``n_layers · 2 · (d_inner / model) · d_model · (1 - 1/data)``;
  the cell reads 0.80.  At full size (mamba2-2.7b long_500k on 16 × 16)
  the same cause gives the 0.35× of ROADMAP §3.
"""

import dataclasses
import json
import os
import subprocess
import sys
import textwrap

import pytest

import repro.configs as RC
import repro_torch.configs as TC
from repro_torch.configs.shapes import Shape
from repro_torch.core import events as tevents
from repro_torch.core import session as tsession
from repro_torch.core.trace import analyze_trace, trace_step
from repro_torch.dist import sharding as tsh
from repro_torch.launch import dryrun

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MESH = (2, 4)
DIMS = ("data", "model")
#: port ÷ reference FLOPs per device where both compute the same thing
FACTOR = (0.8, 1.25)
#: name -> (arch, Shape fields, config overrides of the reduced config)
CELLS = {
    "train": ("qwen3-32b", dict(name="train", kind="train", seq_len=64,
                                global_batch=8), {}),
    "train_noremat": ("qwen3-32b", dict(name="train", kind="train",
                                        seq_len=64, global_batch=8),
                      {"remat": "none"}),
    "prefill": ("qwen3-32b", dict(name="prefill", kind="prefill",
                                  seq_len=256, global_batch=2), {}),
    "prefill_bf16": ("qwen3-32b", dict(name="prefill", kind="prefill",
                                       seq_len=256, global_batch=2),
                     {"dtype": "bfloat16"}),
    "long": ("mamba2-2.7b", dict(name="long", kind="decode", seq_len=4096,
                                 global_batch=1), {}),
}

_REFERENCE = """
import dataclasses, json, sys
import jax
from jax.sharding import AxisType
import repro.configs as C
import repro.core.hlo as hlo
from repro.configs.shapes import Shape
from repro.launch.dryrun import build_cell

cells = json.loads(sys.argv[1])
mesh = jax.make_mesh(tuple(cells.pop("__mesh__")), ("data", "model"),
                     axis_types=(AxisType.Auto,) * 2)
out = {}
for name, (arch, shape, over) in cells.items():
    cfg = dataclasses.replace(C.reduced(C.get(arch)), **over)
    fn, args, meta = build_cell(cfg, Shape(**shape), mesh)
    text = fn.lower(*args).compile().as_text()
    st = hlo.analyze_text(text, default_trip=meta["default_trip"])
    # the matmul-class FLOPs alone: the walker without its elementwise set
    arith = set(hlo._ARITH_OPCODES)
    hlo._ARITH_OPCODES.clear()
    dots = hlo.analyze_text(text, default_trip=meta["default_trip"]).flops
    hlo._ARITH_OPCODES.update(arith)
    out[name] = {"flops": st.flops, "dots": dots, "hbm": st.hbm_bytes,
                 "coll": dict(st.collective_bytes)}
print("RESULT " + json.dumps(out))
"""


@pytest.fixture(autouse=True)
def _port_state():
    tevents.reset_seq()
    tsession.reset_state()
    yield
    tsession.reset_state()
    tsh.set_mesh(None)


@pytest.fixture(scope="module")
def reference():
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    arg = json.dumps({"__mesh__": MESH, **CELLS})
    r = subprocess.run([sys.executable, "-c", textwrap.dedent(_REFERENCE),
                        arg], capture_output=True, text=True, env=env,
                       timeout=600)
    assert r.returncode == 0, f"stdout:\n{r.stdout}\nstderr:\n{r.stderr}"
    line = next(ln for ln in r.stdout.splitlines()
                if ln.startswith("RESULT "))
    return json.loads(line[len("RESULT "):])


@pytest.fixture(scope="module")
def port():
    """The port's figures of each cell but ``train_noremat`` (the port
    has no rematerialization: that cell is its ``train``)."""
    out = {}
    for name, (arch, shape, over) in CELLS.items():
        if name == "train_noremat":
            continue
        cfg = dataclasses.replace(TC.reduced(TC.get(arch)), **over)
        step, setup, _meta = dryrun.build_cell(
            cfg, Shape(**shape), dict(zip(DIMS, MESH)), device="cpu")
        trace = trace_step(step, mesh_shape=MESH, mesh_dims=DIMS,
                           device_type="cpu", setup=setup, params_at=0)
        st = analyze_trace(trace)
        out[name] = {"flops": st.flops, "hbm": st.hbm_bytes,
                     "coll": dict(st.collective_bytes),
                     "dots": sum(r.flops * r.mult for r in trace.records
                                 if not r.is_collective)}
    return out


def _ratio(port, reference, cell, key="flops", ref_cell=None):
    return port[cell][key] / reference[ref_cell or cell][key]


def _coll(figures):
    return sum(figures["coll"].values())


def test_reduced_configs_are_the_cells_the_docstring_names():
    for arch in ("qwen3-32b", "mamba2-2.7b"):
        t, j = TC.reduced(TC.get(arch)), RC.reduced(RC.get(arch))
        assert dataclasses.asdict(t) == dataclasses.asdict(j)
    q = TC.reduced(TC.get("qwen3-32b"))
    assert (q.n_heads, q.n_kv_heads) == (4, 1) and q.n_kv_heads % MESH[1]
    assert q.remat == "full"


def test_prefill_flops_per_device_match_the_reference(port, reference):
    assert FACTOR[0] <= _ratio(port, reference, "prefill") <= FACTOR[1]
    # the matmuls are the same matmuls: the query heads split over model
    assert _ratio(port, reference, "prefill", "dots") == pytest.approx(
        1.0, rel=1e-3)


def test_train_flops_match_the_reference_without_its_recompute(port,
                                                               reference):
    ratio = _ratio(port, reference, "train", ref_cell="train_noremat")
    assert FACTOR[0] <= ratio <= FACTOR[1]
    # the default reference recomputes each layer's forward (remat
    # "full"): its surplus over remat "none" is that forward, 0.82 here
    full = _ratio(port, reference, "train")
    assert full == pytest.approx(0.819, abs=0.02), full
    assert reference["train"]["dots"] > reference["train_noremat"]["dots"]


def test_long_decode_flops_differ_by_the_output_projection(port, reference):
    cfg = TC.reduced(TC.get("mamba2-2.7b"))
    data, model = MESH
    others = cfg.n_layers * 2 * (cfg.d_inner // model) * cfg.d_model \
        * (1 - 1 / data)
    assert reference["long"]["dots"] - port["long"]["dots"] == others
    assert _ratio(port, reference, "long") == pytest.approx(0.803, abs=0.02)


def test_train_collective_bytes_differ_by_recompute_and_lookup(port,
                                                               reference):
    full = _coll(port["train"]) / _coll(reference["train"])
    none = _coll(port["train"]) / _coll(reference["train_noremat"])
    assert full == pytest.approx(0.830, abs=0.02), full
    assert none == pytest.approx(0.921, abs=0.02), none
    # the lookup's row moves, which the port does not make
    assert reference["train"]["coll"].get("all-to-all", 0) > 0
    assert "all-to-all" not in port["train"]["coll"]


def test_bf16_partial_sums_cross_the_wire_in_float32_on_the_reference(
        port, reference):
    ar = lambda figures: figures["coll"]["all-reduce"]          # noqa: E731
    assert ar(reference["prefill_bf16"]) == ar(reference["prefill"])
    assert 2 * ar(port["prefill_bf16"]) == ar(port["prefill"])


def test_prefill_and_decode_collective_bytes_are_of_one_order(port,
                                                              reference):
    for cell in ("prefill", "long"):
        ratio = _coll(port[cell]) / _coll(reference[cell])
        assert 0.25 <= ratio <= 5.0, (cell, ratio)
