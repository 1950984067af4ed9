"""Distribution on the port against the JAX package: four gloo ranks on the
CPU, spawned once for the whole file (tests/_torch_dist_ranks.py runs
every case in them; the ranks import neither ``jax`` nor ``repro``), and
each case held here against the reference on the same inputs.

* Collectives, over the pod dimension of a pod 2 × data 2 mesh (world 2)
  and over all four ranks (world 4): ``compressed_psum`` equals the
  reference's ``simulate_compressed_psum`` of the participants' payloads
  within 1e-6 × max|x| (float32 sums in another order) and is within the
  reference's 1% of ``plain_psum``; pipelined ``psum_start``/``psum_wait``
  is exact on payloads whose sums are exact in float32 (multiples of 1/8),
  with the padding ragged shapes need; the blocking ``make_pod_sync`` of
  a data-sharded DTensor tree; a checkpoint of that DTensor, restored
  with other placements and by the reference.
* Sharded train steps against the reference's single-device step on the
  same weights and batch: reduced qwen3-32b with two KV heads (so that,
  as at full width, the model dimension shards them) on data 2 × model 2
  with microbatches 2 (the reference's own case; also with
  ``gather_params_once``), reduced dbrx-132b on data 2 × model 2 (the
  reference run with ``mesh_axis_size`` patched to the same group count,
  g = 2) and on model 2 with no data dimension (g = 1), its two
  replicas on a ``pipe`` dimension that no rule names; reduced
  mamba2-2.7b (ssm) and zamba2-7b (hybrid) on data 2 × model 2.  The loss within
  1e-5 relative, gradients within 1e-5 × max|g| per leaf, and the
  parameters after one step within the bounds tests/test_torch_train.py
  uses.
* The explicit pod sync (pod 2 × data 2, model left out — a size-1
  dimension resolves as an absent one; reduced paper-gpt2):
  blocking, overlapped and compressed, each against the reference's
  single-device step, with tests/test_dist.py's bounds: loss within 2e-3,
  grad norm within 2e-2, parameters within 1e-4 (5e-2 compressed).
* The GPipe ring on pipe 4 and on pipe 2 × data 2: the forward within
  1e-5 of the sequential layers (the reference's bound) and the gradients
  within 1e-5 of the sequential ones (``jax.grad`` of the reference's
  sequential loop).
* Decode on data 2 × model 2 (reduced glm4-9b with two KV heads, rows
  starting at different lengths): eight ``make_decode_step`` calls with
  K/V sharded over batch and sequence — placed by ``serve_shardings``,
  and by hand with blocks that do not divide evenly — against the
  reference's single-device decode: every step's logits and the whole
  caches within 1e-5 (rtol = atol).
"""

import dataclasses
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import repro.configs as RC
import repro.dist.sharding as jsh
from repro.dist.collectives import simulate_compressed_psum
from repro.models import cross_entropy as jcross_entropy
from repro.models import forward as jforward
from repro.models import init_params as jinit_params
from repro.train import OptConfig as JOptConfig
from repro.train import make_train_step as jmake_train_step
from repro.train import checkpoint as jckpt
from repro.train import optimizer as jopt
from repro_torch.core import events as tevents
from repro_torch.core import session as tsession

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 4
#: the whole spawn, every case (a reduced step takes seconds per rank)
SPAWN_TIMEOUT_S = 600
LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-5          # of max|g| per leaf
PARAM_ATOL = 1e-5         # tests/test_torch_train.py's bound
#: tests/test_torch_train.py's dbrx-132b bound after three steps
DBRX_PARAM = (3.0e-5, 1.3e-4)
SYNC_MODES = {"blocking": 1e-4, "overlap": 1e-4, "overlap_c": 5e-2}
ARCHS = {"qwen3-32b": (4, 32), "dbrx-132b": (4, 32), "paper-gpt2": (8, 32),
         "mamba2-2.7b": (4, 32), "zamba2-7b": (4, 32)}
#: config fields set on both packages' reduced configs: two KV heads, so
#: the model dimension shards the KV heads as it does at full width (the
#: reduced qwen3-32b has one)
OVERRIDES = {"qwen3-32b": {"n_kv_heads": 2}, "glm4-9b": {"n_kv_heads": 2}}
#: decode on data 2 × model 2: (batch, max_seq, each row's starting
#: length); "uneven" (K/V placed by hand, batch over data and sequence
#: over model) leaves the last data rank one row and the last model rank
#: a shorter block of the sequence (7 + 6), across which the writes run
DECODE = {"even": (4, 16, [0, 3, 5, 1]), "uneven": (3, 13, [0, 2, 5])}
DECODE_STEPS = 8
DECODE_TOL = 1e-5         # rtol = atol, float32 sums in another order


@pytest.fixture(autouse=True)
def _port_state():
    tevents.reset_seq()
    tsession.reset_state()
    yield
    tsession.reset_state()


def _flat(tree, prefix=""):
    out = {}
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def _inputs(arch):
    jcfg = dataclasses.replace(RC.reduced(RC.get(arch)),
                               **OVERRIDES.get(arch, {}))
    b, s = ARCHS[arch]
    rng = np.random.default_rng(len(arch))
    x = rng.integers(0, jcfg.vocab_size, size=(b, s)).astype(np.int32)
    y = rng.integers(0, jcfg.vocab_size, size=(b, s)).astype(np.int32)
    params = jinit_params(jax.random.PRNGKey(0), jcfg)
    return jcfg, params, x, y


def _collective_inputs():
    rng = np.random.default_rng(11)
    out = {"grad": rng.standard_normal((WORLD, 16, 48)).astype(np.float32),
           "ragged": rng.standard_normal((WORLD, 5, 7)).astype(np.float32),
           "tree": rng.standard_normal((8, 16)).astype(np.float32)}
    for i, shape in enumerate(((5, 7), (13,), (2, 3, 4))):
        out[f"sw{i}"] = (rng.integers(-64, 64, size=(WORLD, *shape))
                         / 8).astype(np.float32)
    return out


def _decode_params():
    jcfg = dataclasses.replace(RC.reduced(RC.get("glm4-9b")),
                               **OVERRIDES["glm4-9b"])
    return jcfg, jinit_params(jax.random.PRNGKey(0), jcfg)


def _decode_inputs(vocab: int) -> dict:
    rng = np.random.default_rng(5)
    out = {}
    for name, (b, max_seq, lengths) in DECODE.items():
        out[f"{name}_tokens"] = rng.integers(0, vocab, (b, DECODE_STEPS),
                                             dtype=np.int32)
        out[f"{name}_lengths"] = np.array(lengths, np.int32)
        out[f"{name}_max_seq"] = np.int64(max_seq)
    return out


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Write the inputs, spawn the ranks once, return the results dir."""
    d = str(tmp_path_factory.mktemp("ranks"))
    np.savez(os.path.join(d, "in_collectives.npz"), **_collective_inputs())
    with open(os.path.join(d, "overrides.json"), "w") as f:
        json.dump(OVERRIDES, f)
    for arch in ARCHS:
        _jcfg, params, x, y = _inputs(arch)
        np.savez(os.path.join(d, f"w_{arch}.npz"), **_flat(params))
        np.savez(os.path.join(d, f"in_{arch}.npz"), inputs=x, labels=y)
    jcfg, params = _decode_params()
    np.savez(os.path.join(d, "w_glm4-9b.npz"), **_flat(params))
    np.savez(os.path.join(d, "in_decode.npz"),
             **_decode_inputs(jcfg.vocab_size))
    rng = np.random.default_rng(0)
    np.savez(os.path.join(d, "in_pipeline.npz"),
             ws=(rng.standard_normal((8, 16, 16)) * 0.2).astype(np.float32),
             xs=rng.standard_normal((6, 4, 16)).astype(np.float32))
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    r = subprocess.run([sys.executable,
                        os.path.join(REPO, "tests", "_torch_dist_ranks.py"),
                        d, str(WORLD), str(SPAWN_TIMEOUT_S)],
                       capture_output=True, text=True, env=env,
                       timeout=SPAWN_TIMEOUT_S + 60)
    assert r.returncode == 0, r.stderr[-6000:]
    return d


def _load(d, name):
    with np.load(os.path.join(d, f"{name}.npz")) as f:
        return {k: f[k] for k in f.files}


def test_ranks_import_neither_jax_nor_reference(ranks):
    for rank in range(WORLD):
        with open(os.path.join(ranks, f"modules_r{rank}.json")) as f:
            assert json.load(f) == []


# ------------------------------------------------------------ collectives
def _groups():
    """(label, members) of the groups each rank reduced over: the pod
    dimension of a pod 2 × data 2 mesh (rank = 2·pod + data) and the
    world."""
    return [("pod", lambda r: [r % 2, r % 2 + 2]),
            ("world", lambda r: list(range(WORLD)))]


@pytest.mark.parametrize("payload", ["grad", "ragged"])
def test_compressed_psum_matches_reference_mirror(ranks, payload):
    inp = _collective_inputs()[payload]
    for rank in range(WORLD):
        got = _load(ranks, f"collectives_r{rank}")
        for label, members in _groups():
            stacked = inp[members(rank)]
            want = simulate_compressed_psum(stacked)
            cp = got[f"{payload}_cp_{label}"]
            tol = 1e-6 * np.abs(stacked).max()
            assert np.abs(cp - want).max() <= tol, (rank, label)
            plain = got[f"{payload}_pp_{label}"]
            np.testing.assert_allclose(plain, stacked.sum(0), rtol=0,
                                       atol=tol)
            rel = np.linalg.norm(cp - plain) / np.linalg.norm(plain)
            assert rel < 0.01, (rank, label, rel)


def test_psum_start_wait_is_exact_with_padding(ranks):
    inp = _collective_inputs()
    for rank in range(WORLD):
        got = _load(ranks, f"collectives_r{rank}")
        for i in range(3):
            want = inp[f"sw{i}"].sum(0)          # exact: multiples of 1/8
            np.testing.assert_array_equal(got[f"sw{i}_p"], want)
            # the compressed pipeline is the reference's mirror of it
            mirror = simulate_compressed_psum(inp[f"sw{i}"])
            tol = 1e-6 * np.abs(inp[f"sw{i}"]).max()
            assert np.abs(got[f"sw{i}_c"] - mirror).max() <= tol


def test_blocking_pod_sync_of_a_sharded_tree(ranks):
    g = _collective_inputs()["tree"]
    got = _load(ranks, "collectives_r0")
    np.testing.assert_array_equal(got["sync_p"], 2 * g)
    np.testing.assert_array_equal(got["sync_mean"], g)
    rel = np.linalg.norm(got["sync_c"] - 2 * g) / np.linalg.norm(2 * g)
    assert rel < 0.01, rel
    want = simulate_compressed_psum(np.stack([g[:4], g[:4]]))
    assert np.abs(got["sync_c"][:4] - want).max() <= 1e-6 * np.abs(g).max()


def test_checkpoint_of_a_dtensor_restores_with_new_placements(ranks):
    """Saved by four ranks (rank 0 writes the gathered tensor), restored
    by them as pod × data shards, and readable by the reference."""
    g = _collective_inputs()["tree"]
    for rank in range(WORLD):
        got = _load(ranks, f"collectives_r{rank}")
        np.testing.assert_array_equal(got["ckpt_w"], g)
        assert int(got["ckpt_n"]) == 3
    step, back = jckpt.restore(os.path.join(ranks, "ckpt"),
                               {"w": g, "n": np.int64(3)})
    assert step == 1
    np.testing.assert_array_equal(back["w"], g)


# --------------------------------------------------------- sharded steps
def _reference(arch, microbatches):
    """The reference's single-device step and full-batch loss/grads."""
    jcfg, params, x, y = _inputs(arch)
    opt_cfg = JOptConfig(lr=1e-3)

    def loss_fn(p):
        logits, _ = jforward(p, jnp.asarray(x), jcfg)
        return jcross_entropy(logits, jnp.asarray(y))[0]

    loss, grads = jax.value_and_grad(loss_fn)(params)
    step = jax.jit(jmake_train_step(jcfg, opt_cfg,
                                    microbatches=microbatches))
    p1, _o1, m1 = step(params, jopt.init_opt_state(params, opt_cfg),
                       {"inputs": jnp.asarray(x), "labels": jnp.asarray(y)})
    return float(loss), _flat(grads), _flat(p1), m1


def _hold(got, loss, grads, p1, m1, tag="", bounds=(PARAM_ATOL, 0.0)):
    assert float(got["loss_full"]) == pytest.approx(loss, rel=LOSS_RTOL)
    for k, g in grads.items():
        err = np.abs(got[f"grad/{k}"] - g).max()
        assert err <= GRAD_RTOL * max(np.abs(g).max(), 1e-30), (k, err)
    assert float(got[f"{tag}m/loss"]) == pytest.approx(float(m1["loss"]),
                                                       rel=LOSS_RTOL)
    assert float(got[f"{tag}m/grad_norm"]) == pytest.approx(
        float(m1["grad_norm"]), rel=1e-4)
    max_err, share = bounds
    for k, w in p1.items():
        d = np.abs(got[f"{tag}param/{k}"] - w)
        assert d.max() <= max_err, (tag, k, d.max())
        assert (d > PARAM_ATOL).mean() <= share, (tag, k)


def test_sharded_dense_step_matches_reference(ranks):
    got = _load(ranks, "step_qwen3")
    ref = _reference("qwen3-32b", microbatches=2)
    _hold(got, *ref)
    _hold(got, *ref, tag="once_")          # gather_params_once: same step


def _fixed_groups(monkeypatch, data):
    monkeypatch.setattr(jsh, "mesh_axis_size",
                        lambda name: {"data": data}.get(name, 1))


def test_sharded_moe_step_matches_reference_with_two_groups(ranks,
                                                            monkeypatch):
    _fixed_groups(monkeypatch, 2)
    _hold(_load(ranks, "step_dbrx"), *_reference("dbrx-132b", 1),
          bounds=DBRX_PARAM)


def test_sharded_moe_step_on_model_only_matches_reference(ranks):
    _hold(_load(ranks, "step_dbrx_model"), *_reference("dbrx-132b", 1),
          bounds=DBRX_PARAM)


@pytest.mark.parametrize("case,arch", [("step_ssm", "mamba2-2.7b"),
                                       ("step_hybrid", "zamba2-7b")])
def test_sharded_ssm_and_hybrid_steps_match_reference(ranks, case, arch):
    _hold(_load(ranks, case), *_reference(arch, 1))


# ------------------------------------------------------------ sync modes
@pytest.fixture(scope="module")
def gpt2_step():
    return _reference("paper-gpt2", microbatches=1)


@pytest.mark.parametrize("mode", sorted(SYNC_MODES))
def test_pod_sync_modes_match_single_device(ranks, gpt2_step, mode):
    _loss, _grads, p0, m0 = gpt2_step
    got = _load(ranks, "sync")
    loss0, gn0 = float(m0["loss"]), float(m0["grad_norm"])
    assert abs(float(got[f"{mode}/m/loss"]) - loss0) < 2e-3
    assert abs(float(got[f"{mode}/m/grad_norm"]) - gn0) < 2e-2 * max(gn0, 1)
    d = max(np.abs(got[f"{mode}/param/{k}"] - w).max()
            for k, w in p0.items())
    assert d < SYNC_MODES[mode], (mode, d)


# -------------------------------------------------------------- pipeline
@pytest.mark.parametrize("mesh", ["pipe4", "pipe2_data2"])
def test_pipeline_forward_and_grads_match_sequential(ranks, mesh):
    with np.load(os.path.join(ranks, "in_pipeline.npz")) as f:
        ws, xs = jnp.asarray(f["ws"]), jnp.asarray(f["xs"])

    def seq(w, x):
        for i in range(w.shape[0]):
            x = jnp.tanh(x @ w[i])
        return x

    want = jax.vmap(lambda x: seq(ws, x))(xs)
    gwant = jax.grad(lambda w: jax.vmap(lambda x: seq(w, x))(xs).sum())(ws)
    got = _load(ranks, "pipeline")
    assert np.abs(got[f"{mesh}/ys"] - np.asarray(want)).max() < 1e-5
    assert np.abs(got[f"{mesh}/grad"] - np.asarray(gwant)).max() < 1e-5
    assert np.abs(got[f"{mesh}/grad"]).sum() > 0


# ------------------------------------------------------- decode on a mesh
@pytest.mark.parametrize("name", sorted(DECODE))
def test_sharded_decode_matches_single_device(ranks, name):
    """``make_decode_step`` on data 2 × model 2 with the K/V caches
    sharded over batch and sequence (each rank writes its own block),
    even by ``serve_shardings`` and uneven by hand, against
    the reference's single-device decode from the same caches: every
    step's logits and the whole caches at the end."""
    from repro.models import init_cache as jinit_cache
    from repro.train import trainer as jtrainer
    jcfg, params = _decode_params()
    inp = _decode_inputs(jcfg.vocab_size)
    toks = inp[f"{name}_tokens"]
    b, max_seq, lengths = DECODE[name]
    jc = jinit_cache(jcfg, b, max_seq)
    jc["kv"]["length"] = jnp.asarray(lengths, jnp.int32)
    step = jtrainer.make_decode_step(jcfg)
    got = _load(ranks, "decode")
    for t in range(DECODE_STEPS):
        jl, jc = step(params, jc, toks[:, t:t + 1])
        np.testing.assert_allclose(got[f"{name}/logits{t}"], np.asarray(jl),
                                   rtol=DECODE_TOL, atol=DECODE_TOL,
                                   err_msg=f"step {t}")
    want = _flat(jc)
    for k, v in want.items():
        np.testing.assert_allclose(got[f"{name}/cache/{k}"], v,
                                   rtol=DECODE_TOL, atol=DECODE_TOL,
                                   err_msg=k)
