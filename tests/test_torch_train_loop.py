"""Checkpoints, the elastic loop and the train launcher on the port, against
the JAX package where the two meet, on the CPU.

* The counterparts of tests/test_system.py's loop, restart, exhaustion,
  watchdog, checkpoint and driver-resume tests, on reduced paper-gpt2.  A
  restart replays from the last checkpoint bit for bit (the data is
  step-indexed), and its losses equal an uninterrupted run's bit for bit.
* The on-disk layout is the reference's: a checkpoint written by the
  reference's ``save`` restores in the port and the other way round, for
  float32 and int8 leaves, bit for bit.
* A checkpoint saved by the launcher on two gloo ranks (data 2) restores on
  one and continues with the losses of an uninterrupted one-rank run,
  within 1e-5 relative (the two-rank steps sum their gradients in another
  float32 order).
* No fallback: without ``--device cpu`` the launcher goes to the card, and
  an NCCL group needs one; on a machine without a card both raise.
"""

import os
import shutil
import statistics
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from repro.train import checkpoint as jckpt
import repro_torch.configs as TC
import repro_torch.core as tpasta
from repro_torch.core import events as tevents
from repro_torch.core import session as tsession
from repro_torch.convert import params_from_numpy
from repro_torch.launch import train as tlaunch
from repro_torch.models import init_params
from repro_torch.train import (DataConfig, LoopConfig, OptConfig,
                               SyntheticTokens, TrainLoop, checkpoint as ckpt,
                               make_train_step)
from repro_torch.train.optimizer import init_opt_state, tree_paths

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: the train launcher's flags every run here shares
DRIVER = ["--device", "cpu", "--arch", "paper-gpt2", "--reduced",
          "--seq-len", "32", "--global-batch", "4", "--pasta-tools",
          "kernel_freq"]


@pytest.fixture(autouse=True)
def _port_state():
    tevents.reset_seq()
    tsession.reset_state()
    yield
    tsession.reset_state()


def _setup(steps=12, **loop_kw):
    cfg = TC.reduced(TC.get("paper-gpt2"))
    opt_cfg = OptConfig(lr=3e-3, total_steps=steps, warmup_steps=2)
    step = make_train_step(cfg, opt_cfg, microbatches=2)
    params = init_params(cfg, 0, "cpu")
    opt = init_opt_state(params, opt_cfg)
    src = SyntheticTokens(DataConfig(vocab_size=cfg.vocab_size, seq_len=64,
                                     global_batch=4))

    def place(b):
        return {k: torch.from_numpy(v) for k, v in b.items()}
    # no handler passed: the loop resolves the innermost active session
    loop = TrainLoop(LoopConfig(total_steps=steps, **loop_kw), step, src,
                     place)
    return params, opt, loop


def _run(loop, params, opt):
    seen = []
    params, opt, step = loop.run(params, opt, metrics_cb=lambda s, m:
                                 seen.append((s, m["loss"])))
    return params, step, seen


def test_train_loop_loss_decreases():
    params, opt, loop = _setup(steps=15)
    _p, step, seen = _run(loop, params, opt)
    losses = [l for _s, l in seen]
    assert step == 15 and len(losses) == 15
    assert np.mean(losses[-3:]) < np.mean(losses[:3]), losses


def test_elastic_restart_after_injected_failure(tmp_path):
    """A mid-run failure restores the last checkpoint and completes; the
    replayed steps and the steps after them equal an uninterrupted run's
    bit for bit, and the restart is a SYNC event."""
    syncs = []
    with tpasta.Session(name="elastic") as session:
        session.handler.subscribe(lambda ev: syncs.append(ev.name),
                                  kinds=("sync",))
        params, opt, loop = _setup(ckpt_dir=str(tmp_path), ckpt_every=4,
                                   inject_failure_at=6)
        p_end, step, seen = _run(loop, params, opt)
    assert step == 12 and loop.restarts == 1
    assert "restart_from_4" in syncs
    by_step, replayed = {}, 0
    for s, l in seen:
        if s in by_step:
            replayed += 1
            assert by_step[s] == l, s
        by_step[s] = l
    assert replayed == 2                         # steps 4 and 5
    assert ckpt.latest_step(str(tmp_path)) == 12
    params, opt, loop = _setup()
    p_ref, _step, ref = _run(loop, params, opt)
    assert [l for _s, l in ref] == [by_step[s] for s in range(12)]
    for (path, a), (_q, b) in zip(tree_paths(p_end), tree_paths(p_ref)):
        assert torch.equal(a, b), path


def test_failure_exhausts_restarts(tmp_path):
    params, opt, loop = _setup(steps=8, ckpt_dir=str(tmp_path),
                               ckpt_every=4)
    loop.cfg.max_restarts = 0
    loop.cfg.inject_failure_at = 5
    with pytest.raises(RuntimeError):
        loop.run(params, opt)


def test_failure_before_first_checkpoint_raises(tmp_path):
    params, opt, loop = _setup(steps=8, ckpt_dir=str(tmp_path),
                               ckpt_every=4, inject_failure_at=2)
    with pytest.raises(RuntimeError, match="before first checkpoint"):
        loop.run(params, opt)


def test_straggler_watchdog_counts():
    params, opt, loop = _setup(steps=10)
    orig = loop.train_step
    calls = {"n": 0}

    def slow_step(*a):
        calls["n"] += 1
        if calls["n"] == 8:
            # well beyond 3 × the median step, however loaded the machine
            time.sleep(1.5 + 4 * statistics.median(loop.durations))
        return orig(*a)

    loop.train_step = slow_step
    loop.run(params, opt)
    assert loop.stragglers >= 1


def test_checkpoint_restore_validates_manifest(tmp_path):
    """A checkpoint saved from a different model is refused with an error
    naming the mismatch."""
    state = {"params": {"w": torch.ones((4, 2)), "b": torch.zeros((2,))},
             "step_count": np.int32(7)}
    ckpt.save(str(tmp_path), 3, state)
    step, back = ckpt.restore(str(tmp_path), state)
    assert step == 3
    assert torch.equal(back["params"]["w"], state["params"]["w"])
    assert isinstance(back["step_count"], np.ndarray)

    wrong_shape = {"params": {"w": torch.ones((4, 3)),
                              "b": torch.zeros((2,))},
                   "step_count": np.int32(7)}
    with pytest.raises(ValueError, match=r"params/w"):
        ckpt.restore(str(tmp_path), wrong_shape)
    wrong_dtype = {"params": {"w": torch.ones((4, 2), dtype=torch.float16),
                              "b": torch.zeros((2,))},
                   "step_count": np.int32(7)}
    with pytest.raises(ValueError, match=r"float16"):
        ckpt.restore(str(tmp_path), wrong_dtype)
    wrong_tree = {"params": {"w": torch.ones((4, 2)),
                             "extra": torch.zeros((1,))},
                  "step_count": np.int32(7)}
    with pytest.raises(ValueError, match=r"tree mismatch"):
        ckpt.restore(str(tmp_path), wrong_tree)


def test_checkpoint_crash_mid_save_is_ignored(tmp_path):
    state = {"w": torch.arange(6, dtype=torch.float32)}
    ckpt.save(str(tmp_path), 2, state)
    tmp_dir = tmp_path / "step_00000004.tmp"     # never renamed
    tmp_dir.mkdir()
    (tmp_dir / "manifest.json").write_text("{}")
    (tmp_path / "step_00000006").mkdir()         # no COMMIT
    (tmp_path / "step_garbage").mkdir()
    (tmp_path / "step_notes.txt").write_text("x")
    assert ckpt.latest_step(str(tmp_path)) == 2
    step, back = ckpt.restore(str(tmp_path), state)
    assert step == 2 and torch.equal(back["w"], state["w"])


def test_async_save_and_bfloat16_leaves(tmp_path):
    state = {"w": torch.randn((3, 5), dtype=torch.bfloat16,
                              generator=torch.Generator().manual_seed(0)),
             "n": torch.tensor(4, dtype=torch.int32)}
    path = ckpt.save(str(tmp_path), 1, state, async_=True)
    deadline = time.monotonic() + 60
    while ckpt.latest_step(str(tmp_path)) != 1:
        assert time.monotonic() < deadline, "async save never published"
        time.sleep(0.01)
    assert path.endswith("step_00000001")
    _step, back = ckpt.restore(str(tmp_path), state)
    assert back["w"].dtype == torch.bfloat16
    assert torch.equal(back["w"], state["w"])
    assert torch.equal(back["n"], state["n"])


def _opt_tree(rng, moments):
    w = rng.standard_normal((4, 6)).astype(np.float32)
    if moments == "int8":
        mu = {"q": rng.integers(-127, 128, size=(4, 6)).astype(np.int8),
              "scale": rng.random((4, 1)).astype(np.float32)}
    else:
        mu = rng.standard_normal((4, 6)).astype(np.float32)
    return {"params": {"layers": {"w": w}, "embed": w[:2].copy()},
            "opt": {"mu": {"layers": {"w": mu}, "embed": w[:2] * 0},
                    "step": np.int32(3)}}


def _torch_tree(tree):
    if isinstance(tree, dict):
        return {k: _torch_tree(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree))


def _assert_same(got, want):
    for (path, a), (_q, b) in zip(ckpt._paths(got), ckpt._paths(want)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b), path)
        assert np.asarray(a).dtype == np.asarray(b).dtype, path


@pytest.mark.parametrize("moments", ["float32", "int8"])
def test_checkpoints_cross_between_packages(tmp_path, moments):
    tree = _opt_tree(np.random.default_rng(len(moments)), moments)
    jckpt.save(str(tmp_path / "ref"), 5, tree)
    step, back = ckpt.restore(str(tmp_path / "ref"), _torch_tree(tree))
    assert step == 5
    _assert_same(back, tree)
    assert ckpt._keys(back) == jckpt._keys(tree)
    ckpt.save(str(tmp_path / "port"), 7, _torch_tree(tree))
    step, back = jckpt.restore(str(tmp_path / "port"), tree)
    assert step == 7
    _assert_same(back, tree)


def test_train_driver_cli_resume(tmp_path, capsys):
    args = DRIVER + ["--steps", "6", "--ckpt-dir", str(tmp_path),
                     "--ckpt-every", "3"]
    assert tlaunch.main(args) == 0
    assert "done at step 6" in capsys.readouterr().out
    tsession.reset_state()
    assert tlaunch.main(args[:-6] + ["--steps", "8", "--ckpt-dir",
                                     str(tmp_path), "--ckpt-every", "3",
                                     "--resume"]) == 0
    out = capsys.readouterr().out
    assert "resumed from step 6" in out
    assert "done at step 8" in out


def test_resize_restore_from_two_ranks_to_one(tmp_path):
    """Saved on two gloo ranks (data 2, the parameters DTensors), restored
    on one: the same trajectory as an uninterrupted one-rank run.  The
    two-rank job runs the same 6-step schedule and checkpoints at steps 3
    and 6; dropping the step-6 checkpoint leaves the state of a job that
    died after step 3."""
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    r = subprocess.run([sys.executable, "-m", "repro_torch.launch.train",
                        *DRIVER, "--devices", "2", "--mesh", "2x1",
                        "--steps", "6", "--ckpt-dir", str(tmp_path),
                        "--ckpt-every", "3"],
                       capture_output=True, text=True, env=env, timeout=300)
    assert r.returncode == 0, r.stderr[-4000:]
    assert "done at step 6" in r.stdout
    shutil.rmtree(tmp_path / "step_00000006")
    assert ckpt.latest_step(str(tmp_path)) == 3
    resumed = tlaunch.run(tlaunch.parse_args(
        DRIVER + ["--steps", "6", "--ckpt-dir", str(tmp_path),
                  "--ckpt-every", "100", "--resume"]))
    tsession.reset_state()
    whole = tlaunch.run(tlaunch.parse_args(DRIVER + ["--steps", "6"]))
    got = dict(resumed["losses"])
    want = dict(whole["losses"])
    assert sorted(got) == [3, 4, 5]
    for s in got:
        assert got[s] == pytest.approx(want[s], rel=1e-5), s


def test_train_driver_refuses_compile_cache():
    with pytest.raises(NotImplementedError, match="compile-cache"):
        tlaunch.parse_args(DRIVER + ["--compile-cache", "/nonexistent"])


def test_train_driver_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present; the driver would train on it")
    with pytest.raises(RuntimeError, match="cuda"):
        tlaunch.run(tlaunch.parse_args(["--reduced", "--steps", "1"]))


def test_nccl_group_needs_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present; the group would form")
    with pytest.raises(RuntimeError, match="CUDA"):
        tlaunch.init_rank(0, 1, str(tmp_path / "store"), "cuda")


def test_restored_weights_match_converted_reference(tmp_path):
    """The port's checkpoint of weights that came from the reference (via
    numpy) restores them bit for bit into the reference's keys."""
    import jax
    import repro.configs as RC
    from repro.models import init_params as jinit_params
    jparams = jax.tree.map(np.asarray, jinit_params(
        jax.random.PRNGKey(0), RC.reduced(RC.get("zamba2-7b"))))
    ckpt.save(str(tmp_path), 1, {"params": params_from_numpy(jparams,
                                                            "cpu")})
    _step, back = jckpt.restore(str(tmp_path), {"params": jparams})
    _assert_same(back, {"params": jparams})
