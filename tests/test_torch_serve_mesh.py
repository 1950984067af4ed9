"""The port's serving engine on a mesh (gloo ranks on the CPU) against the
reference's engine on a mesh, and against the port's own world-1 runs.

Two spawns of gloo ranks (``tests/_torch_serve_mesh_ranks.py``): data 2 ×
model 1 and data 2 × model 2, each serving every case once, with a
``FileStore`` under the test's tmp dir and a timeout on the join.

* **Against the reference's ``ServeEngine`` on a mesh.**  The reference
  runs in one subprocess with four forced XLA host devices, on meshes
  built with Auto axes (jax 0.9.0 refuses ``with_sharding_constraint`` on
  ``jax.make_mesh``'s default Explicit axes) and registered with its
  ``set_mesh``; nothing in ``src/repro/`` changes.  The same staggered
  trace as ``tests/test_torch_serve_engine.py`` on the same weights:
  reduced glm4-9b on the paged pool with a 16-token shared prefix,
  prefix block 8 and a prefill chunk of 16, once with 2 KV heads (split
  over ``model`` on 2 × 2) and once with 1 (replicated); reduced
  zamba2-7b on the slot pool (rows over ``data``, the KV sequence and the
  SSM heads over ``model``).  Greedy tokens are held equal, in float32
  (the reduced configs' dtype).  Speculative decoding with a draft model
  (``spec_decode=2``): the target as its own draft, and the target's
  first layer as the draft (its weights cut from the reference's and
  placed on the ranks); tokens, and every rank's drafted and accepted
  counts, equal the reference's.
* **Against the port's world-1 run** of the same launcher flags: sampled
  tokens at temperature 0.8 with ``--spec-decode 2``, with the n-gram
  draft and with ``--draft model`` (and its counts); the request states
  of ``--chaos one-poison``; ``--policy edf --rate 50`` with rank 1's
  clock 1000 s ahead and running 3x fast (the ranks agree on rank 0's
  clock, so the tokens are world 1's).
* **Divergence:** one request more on rank 1, or one draft token
  different there, makes every rank raise ``RuntimeError`` naming the
  tick, within the join's timeout.
"""

import dataclasses
import json
import os
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest

import repro.configs as RC
from repro.models import init_params as jinit_params
from repro_torch.core import events as tevents
from repro_torch.core import session as tsession
from repro_torch.launch import serve

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPAWN_TIMEOUT_S = 300
MESHES = ("2x1", "2x2")
#: name -> (arch, config overrides, engine options, shared prefix)
ENGINE_CASES = {
    "glm4_kv2": ("glm4-9b", {"n_kv_heads": 2},
                 dict(prefix_block=8, prefill_chunk=16), 16),
    "glm4_kv1": ("glm4-9b", {}, dict(prefix_block=8, prefill_chunk=16), 16),
    "zamba2": ("zamba2-7b", {}, {}, 0),
    "glm4_kv2_draft_self": ("glm4-9b", {"n_kv_heads": 2},
                            dict(prefix_block=8, prefill_chunk=16,
                                 spec_decode=2, draft="model"), 16),
    # the draft: the target's first layer (``draft_layers`` is no engine
    # option: both sides cut the target's weights to it)
    "glm4_kv2_draft_layer0": ("glm4-9b", {"n_kv_heads": 2},
                              dict(prefix_block=8, prefill_chunk=16,
                                   spec_decode=2, draft="model",
                                   draft_layers=1), 16),
}
#: the reference's (drafted, accepted) on every mesh, as at world 1
SPEC_CASES = {"glm4_kv2_draft_self": (42, 28),
              "glm4_kv2_draft_layer0": (90, 4)}
LAUNCH = ["--arch", "glm4-9b", "--reduced", "--num-requests", "6",
          "--max-slots", "4", "--prompt-len", "24", "--max-new-tokens", "6",
          "--shared-prefix", "16", "--prefix-block", "8"]
#: name -> (mesh it runs on, launcher flags, skew rank 1's clock)
LAUNCHER_CASES = {
    "sampled_spec": ("2x1", LAUNCH + ["--temperature", "0.8",
                                      "--spec-decode", "2"], False),
    "chaos": ("2x1", LAUNCH + ["--max-slots", "2", "--chaos", "one-poison"],
              False),
    "skewed_clock": ("2x2", LAUNCH + ["--policy", "edf", "--rate", "50"],
                     True),
    "sampled_draft_model": ("2x2", LAUNCH + ["--temperature", "0.8",
                                             "--spec-decode", "2",
                                             "--draft", "model"], False),
}

_REFERENCE = """
import dataclasses, json, sys
import jax, numpy as np
from jax.sharding import AxisType
import repro.configs as RC
from repro.dist.sharding import set_mesh
from repro.models import init_params
from repro.serve import SamplingParams, ServeEngine
sys.path.insert(0, sys.argv[2])
from _torch_serve_mesh_ranks import MAX_NEW, prompts

cases = json.loads(sys.argv[1])
out = {}
for shape in cases.pop("__meshes__"):
    dims = tuple(int(x) for x in shape.split("x"))
    set_mesh(jax.make_mesh(dims, ("data", "model"),
                           axis_types=(AxisType.Auto,) * 2))
    for name, (arch, over, opts, shared) in cases.items():
        cfg = dataclasses.replace(RC.reduced(RC.get(arch)), **over)
        params = init_params(jax.random.PRNGKey(0), cfg)
        opts = dict(opts)
        cut = opts.pop("draft_layers", None)
        if cut:
            opts.update(draft_cfg=dataclasses.replace(cfg, n_layers=cut),
                        draft_params=dict(params, layers=jax.tree.map(
                            lambda x: x[:cut], params["layers"])))
        eng = ServeEngine(cfg, params, max_seq=64, max_slots=4, **opts)
        toks, rids, pending, tick = {}, {}, list(enumerate(
            prompts(cfg.vocab_size, shared))), 0
        while pending or eng.has_work:
            if pending and tick % 2 == 0:
                i, p = pending.pop(0)
                rids[eng.submit(p, SamplingParams(
                    max_new_tokens=MAX_NEW))] = i
            if eng.has_work:
                for rid in eng.step()["finished"]:
                    toks[str(rids[rid])] = [int(t) for t in
                                            eng.requests[rid].tokens]
            tick += 1
        out[f"{name}@{shape}"] = toks
        if eng.spec_k:
            out[f"{name}@{shape}:counts"] = {
                "drafted": eng.drafted_tokens,
                "accepted": eng.accepted_tokens, "ticks": eng.ticks}
    set_mesh(None)
print("RESULT " + json.dumps(out))
"""


@pytest.fixture(autouse=True)
def _port_state(monkeypatch):
    monkeypatch.setenv("REPRO_PALLAS_INTERPRET", "0")   # reference: jnp path
    tevents.reset_seq()
    tsession.reset_state()
    yield
    tsession.reset_state()


def _flat(tree, prefix="") -> dict:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's engine on its meshes (a subprocess, started first)
    and the port's two spawns of ranks, run side by side; returns
    ``(reference tokens, {mesh: [each rank's results]})``."""
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    arg = json.dumps({"__meshes__": MESHES, **ENGINE_CASES})
    ref = subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(_REFERENCE), arg,
         os.path.join(REPO, "tests")], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, env=env)
    spawns = {}
    for mesh in MESHES:
        d = tmp_path_factory.mktemp(f"ranks{mesh}")
        cases = {}
        for name, (arch, over, opts, shared) in ENGINE_CASES.items():
            cfg = dataclasses.replace(RC.reduced(RC.get(arch)), **over)
            w = jax.tree.map(np.asarray,
                             jinit_params(jax.random.PRNGKey(0), cfg))
            np.savez(d / f"w_{name}.npz", **_flat(w))
            cases[name] = {"kind": "engine", "arch": arch, "over": over,
                           "opts": opts, "shared": shared}
        for name, (on, argv, skew) in LAUNCHER_CASES.items():
            if on == mesh:
                cases[name] = {"kind": "launcher", "argv": argv,
                               "skew": skew}
        if mesh == "2x2":
            cases["diverge"] = {"kind": "diverge", "arch": "glm4-9b"}
            cases["diverge_draft"] = {"kind": "diverge_draft",
                                      "arch": "glm4-9b"}
            cases["draft_weights"] = {"kind": "draft_weights",
                                      "arch": "glm4-9b",
                                      "over": {"n_kv_heads": 2}}
        (d / "cases.json").write_text(json.dumps(cases))
        proc = subprocess.Popen(
            [sys.executable, os.path.join(REPO, "tests",
                                          "_torch_serve_mesh_ranks.py"),
             str(d), mesh, str(SPAWN_TIMEOUT_S)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True,
            env=dict(os.environ, PYTHONPATH=os.path.join(REPO, "src")))
        spawns[mesh] = (d, proc)
    port = {}
    for mesh, (d, proc) in spawns.items():
        log, _ = proc.communicate(timeout=SPAWN_TIMEOUT_S + 60)
        assert proc.returncode == 0, log[-4000:]
        world = int(np.prod([int(x) for x in mesh.split("x")]))
        port[mesh] = [json.loads((d / f"out_r{r}.json").read_text())
                      for r in range(world)]
    out, err = ref.communicate(timeout=600)
    assert ref.returncode == 0, f"stdout:\n{out}\nstderr:\n{err[-4000:]}"
    line = next(ln for ln in out.splitlines() if ln.startswith("RESULT "))
    return json.loads(line[len("RESULT "):]), port


@pytest.fixture(scope="module")
def world_one():
    """The launcher cases at world 1, in this process (through JSON, as
    the ranks write theirs)."""
    return {name: json.loads(json.dumps(serve.run(serve.parse_args(
                argv + ["--device", "cpu"]))["result"], default=str))
            for name, (_on, argv, _skew) in LAUNCHER_CASES.items()}


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("name", list(ENGINE_CASES))
def test_greedy_tokens_match_the_reference_mesh_engine(runs, mesh, name):
    reference, port = runs
    ranks = [r[name] for r in port[mesh]]
    want = reference[f"{name}@{mesh}"]
    for r in ranks:
        assert r["tokens"] == want
    assert len(want) == 7 and all(len(t) == 8 for t in want.values())
    if name.startswith("glm4"):
        assert ranks[0]["hits"] > 0
        assert ranks[0]["pool"]["duplicate_copy_bytes"] == 0
    else:
        assert ranks[0]["pool"]["paged"] is False


def test_sampled_speculative_tokens_equal_world_one(runs, world_one):
    _ref, port = runs
    want = world_one["sampled_spec"]
    assert sum(map(len, want["tokens"].values())) == 36
    for r in port["2x1"]:
        got = r["sampled_spec"]
        assert got["tokens"] == want["tokens"]
        assert got["mesh"] == "2x1"


def test_sampled_draft_model_tokens_and_counts_equal_world_one(
        runs, world_one):
    """``--draft model`` (the target drafting for itself) at temperature
    0.8 on 2 x 2: world 1's sampled tokens and drafted/accepted counts on
    every rank."""
    _ref, port = runs
    want = world_one["sampled_draft_model"]
    spec = want["summary"]["speculative"]
    assert sum(map(len, want["tokens"].values())) == 36
    assert spec["drafted_tokens"] > 0
    for r in port["2x2"]:
        got = r["sampled_draft_model"]
        assert got["tokens"] == want["tokens"]
        assert got["mesh"] == "2x2"
        assert got["speculative"] == {
            k: spec[k] for k in ("drafted_tokens", "accepted_tokens")}


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("name", list(SPEC_CASES))
def test_draft_counts_match_the_reference_mesh_engine(runs, mesh, name):
    """Every rank drafts and accepts as many tokens, in as many ticks, as
    the reference's engine on the same mesh; the rollout's cache grew
    placed, never through ``pad_cache_to``."""
    reference, port = runs
    want = reference[f"{name}@{mesh}:counts"]
    assert (want["drafted"], want["accepted"]) == SPEC_CASES[name]
    for r in port[mesh]:
        got = r[name]
        assert (got["drafted"], got["accepted"], got["ticks"]) == (
            want["drafted"], want["accepted"], want["ticks"])
        assert got["pad_calls"] == 0


def test_the_draft_on_a_mesh_shares_or_places_its_weights(runs):
    """On 2 x 2: without a draft config the draft reads the target's own
    placed tensors (no copy); a draft config's weights are drawn from
    seed 1 on every rank, each leaf placed as ``serve_shardings`` says
    and equal to the one-device draw; unplaced draft weights raise."""
    _ref, port = runs
    for r in port["2x2"]:
        got = r["draft_weights"]
        assert got["shares"] is True
        assert got["drawn_placed"] and all(got["drawn_placed"].values())
        assert got["unplaced_error"].startswith(
            "serving on a mesh needs placed weights")


def test_chaos_request_states_equal_world_one(runs, world_one):
    _ref, port = runs
    want = world_one["chaos"]
    assert sorted(want["request_states"].values()).count("failed") == 1
    for r in port["2x1"]:
        got = r["chaos"]
        assert got["states"] == want["request_states"]
        assert got["tokens"] == want["tokens"]


def test_a_skewed_clock_on_rank_one_still_agrees(runs, world_one):
    """Rank 1's ``time.perf_counter`` runs 3x fast and 1000 s ahead:
    every rank decides on rank 0's clock, so the ranks agree tick for
    tick and serve world 1's tokens."""
    _ref, port = runs
    got = [r["skewed_clock"] for r in port["2x2"]]
    assert len({g["ticks"] for g in got}) == 1
    for g in got:
        assert g["tokens"] == world_one["skewed_clock"]["tokens"]
        assert set(g["states"].values()) == {"finished"}


def test_a_diverging_rank_makes_every_rank_raise(runs):
    _ref, port = runs
    errors = [r["diverge"]["error"] for r in port["2x2"]]
    assert all(e is not None for e in errors), errors
    assert len(set(errors)) == 1
    assert errors[0].startswith("serving on a mesh: tick 1: rank 1's plan")
    assert all(r["diverge"]["ticks"] == 1 for r in port["2x2"])


def test_a_rank_drafting_differently_makes_every_rank_raise(runs):
    """A caller's proposer drafts one token differently on rank 1: every
    rank raises at that tick's drafts, before the verify."""
    _ref, port = runs
    got = [r["diverge_draft"] for r in port["2x2"]]
    errors = [g["error"] for g in got]
    assert all(e is not None for e in errors), errors
    assert len(set(errors)) == 1 and len({g["ticks"] for g in got}) == 1
    assert errors[0].startswith(
        f"serving on a mesh: tick {got[0]['ticks']}: rank 1's drafts "
        f"differs from rank 0's in 'slot ")


def test_the_ranks_import_neither_jax_nor_the_reference(runs):
    _ref, port = runs
    for mesh in MESHES:
        assert all(r["modules"] == [] for r in port[mesh])
