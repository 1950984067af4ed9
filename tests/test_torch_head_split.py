"""Attention on a mesh whose KV heads do not divide ``model``, and
``shard``'s gradient constraint, on four gloo ranks on the CPU (one spawn
of tests/_torch_dist_ranks.py for the file; the ranks import neither
``jax`` nor ``repro``).

* ``shard`` is the reference's sharding constraint on both sides: the
  gradient that leaves a site lies in the annotated placement, at a site
  whose input already had it (nothing moves forward) and at one whose
  input was moved.  A gradient that arrives as a partial sum over
  ``model`` is summed there.
* The query heads stay split over ``model`` where K/V stay replicated
  (reduced qwen3-32b variants on data 2 × model 2 and on model 4): the
  attention output keeps ``q``'s placements and each rank holds H/model
  heads.  Four layouts: heads in one group (4/1 on 2 × 2), one head a
  rank (4/1 on 1 × 4), ranks whose heads straddle groups (6/3 on 2 × 2,
  12/3 on 1 × 4).  The sharded loss, gradients and the parameters after
  one step are held against the reference's single-device step with
  tests/test_torch_dist.py's bounds: loss within 1e-5 relative,
  gradients within 1e-5 × max|g| per leaf, parameters within 1e-5.  A
  K/V gradient that lost its sum over the query heads' ranks fails the
  ``wk``/``wv`` gradients by far more.
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
from repro.models import cross_entropy as jcross_entropy
from repro.models import forward as jforward
from repro.models import init_params as jinit_params
from repro.train import OptConfig as JOptConfig
from repro.train import make_train_step as jmake_train_step
from repro.train import optimizer as jopt
from repro_torch.core import events as tevents
from repro_torch.core import session as tsession

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 4
SPAWN_TIMEOUT_S = 300
LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-5          # of max|g| per leaf
PARAM_ATOL = 1e-5
#: key -> (config overrides of reduced qwen3-32b, model size; data is
#: the rest of the four ranks)
CASES = {"heads_4_1_dm22": ({}, 2),
         "heads_4_1_dm14": ({}, 4),
         "heads_6_3_dm22": ({"n_heads": 6, "n_kv_heads": 3}, 2),
         "heads_12_3_dm14": ({"n_heads": 12, "n_kv_heads": 3}, 4)}
BATCH, SEQ = 4, 32


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


def _inputs(key):
    over, _model = CASES[key]
    jcfg = dataclasses.replace(RC.reduced(RC.get("qwen3-32b")), **over)
    rng = np.random.default_rng(7)
    x = rng.integers(0, jcfg.vocab_size, (BATCH, SEQ)).astype(np.int32)
    y = rng.integers(0, jcfg.vocab_size, (BATCH, SEQ)).astype(np.int32)
    return jcfg, jinit_params(jax.random.PRNGKey(0), jcfg), x, y


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("ranks"))
    with open(os.path.join(d, "overrides.json"), "w") as f:
        json.dump({k: over for k, (over, _m) in CASES.items()}, f)
    with open(os.path.join(d, "head_split.json"), "w") as f:
        json.dump({k: ["qwen3-32b", WORLD // m, m]
                   for k, (_o, m) in CASES.items()}, f)
    for key in CASES:
        _jcfg, params, x, y = _inputs(key)
        np.savez(os.path.join(d, f"w_{key}.npz"), **_flat(params))
        np.savez(os.path.join(d, f"in_{key}.npz"), inputs=x, labels=y)
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    r = subprocess.run([sys.executable,
                        os.path.join(REPO, "tests", "_torch_dist_ranks.py"),
                        d, str(WORLD), str(SPAWN_TIMEOUT_S),
                        "shard_grad,head_split"],
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


@pytest.mark.parametrize("site", ["placed", "moved"])
def test_shard_gradient_leaves_in_the_annotated_placement(ranks, site):
    """``shard(x, "batch", "embed")`` on data 2 × model 2: target
    (Shard(0), Replicate()).  Each model rank's share of the gradient is
    its coordinate + 1, so the summed gradient is 3 everywhere."""
    target = ["S0", "R"]
    for rank in range(WORLD):
        got = _load(ranks, f"shard_grad_r{rank}")
        assert list(got[f"{site}/y"]) == target
        assert list(got[f"{site}/grad"]) == target, (rank, site)
        np.testing.assert_array_equal(got[f"{site}/value"],
                                      np.full((4, 8), 3.0, np.float32))


@pytest.mark.parametrize("key", sorted(CASES))
def test_query_heads_stay_split_where_kv_heads_do_not_divide(ranks, key):
    over, model = CASES[key]
    jcfg = dataclasses.replace(RC.reduced(RC.get("qwen3-32b")), **over)
    assert jcfg.n_kv_heads % model          # K/V replicated on model
    for rank in range(WORLD):
        got = _load(ranks, f"{key}_heads_r{rank}")
        assert list(got["out"]) == list(got["q"])
        assert list(got["q"])[1] == "S2"
        assert int(got["local"][2]) == jcfg.n_heads // model


def _reference(key):
    jcfg, params, x, y = _inputs(key)
    opt_cfg = JOptConfig(lr=1e-3)

    def loss_fn(p):
        logits, _ = jforward(p, jnp.asarray(x), jcfg)
        return jcross_entropy(logits, jnp.asarray(y))[0]

    loss, grads = jax.value_and_grad(loss_fn)(params)
    step = jax.jit(jmake_train_step(jcfg, opt_cfg, microbatches=1))
    p1, _o1, m1 = step(params, jopt.init_opt_state(params, opt_cfg),
                       {"inputs": jnp.asarray(x), "labels": jnp.asarray(y)})
    return float(loss), _flat(grads), _flat(p1), m1


@pytest.mark.parametrize("key", sorted(CASES))
def test_head_split_step_matches_reference(ranks, key):
    got = _load(ranks, key)
    loss, grads, p1, m1 = _reference(key)
    assert float(got["loss_full"]) == pytest.approx(loss, rel=LOSS_RTOL)
    for k, g in grads.items():
        err = np.abs(got[f"grad/{k}"] - g).max()
        assert err <= GRAD_RTOL * max(np.abs(g).max(), 1e-30), (k, err)
    assert float(got["m/loss"]) == pytest.approx(float(m1["loss"]),
                                                 rel=LOSS_RTOL)
    assert float(got["m/grad_norm"]) == pytest.approx(
        float(m1["grad_norm"]), rel=1e-4)
    for k, w in p1.items():
        err = np.abs(got[f"param/{k}"] - w).max()
        assert err <= PARAM_ATOL, (k, err)
