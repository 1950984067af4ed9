"""Fault-tolerant training loop: checkpoint/restart, straggler watchdog.

  * every ``ckpt_every`` steps the full state publishes atomically
    (checkpoint.py); on ANY step failure the loop restores the latest
    complete checkpoint and replays — the data pipeline is step-indexed so
    replays are bit-exact;
  * a step-duration watchdog classifies slow steps (> ``straggler_factor`` ×
    rolling median) and emits PASTA SYNC events — the hook a cluster
    scheduler uses for checkpoint-and-rebalance;
  * ``inject_failure_at`` deterministically raises mid-run (used by the
    elasticity tests to prove restart works).

On a mesh every rank runs the loop; an injected failure fires on every
rank at the same step, and the restore places each leaf as the live state
is placed.
"""

from __future__ import annotations

import dataclasses
import statistics
import time

import repro_torch.core as pasta
from . import checkpoint as ckpt


@dataclasses.dataclass
class LoopConfig:
    total_steps: int = 100
    ckpt_every: int = 20
    ckpt_dir: str = ""
    max_restarts: int = 3
    straggler_factor: float = 3.0
    async_ckpt: bool = False
    inject_failure_at: int | None = None     # test hook


class TrainLoop:
    def __init__(self, loop_cfg: LoopConfig, train_step, source,
                 place_batch, handler=None):
        """``train_step(params, opt, batch) -> (params, opt, metrics)``;
        ``source.batch_at(step)``; ``place_batch(np_batch) -> batch of
        tensors``.  Without an explicit ``handler`` the loop emits through
        the innermost active :class:`~repro_torch.core.Session` (resolved
        per emission).
        """
        self.cfg = loop_cfg
        self.train_step = train_step
        self.source = source
        self.place_batch = place_batch
        self._handler = handler
        self.durations: list = []
        self.stragglers = 0
        self.restarts = 0

    @property
    def handler(self):
        return (self._handler if self._handler is not None
                else pasta.current_handler())

    # ---------------------------------------------------------------- loop
    def run(self, params, opt_state, start_step: int = 0,
            metrics_cb=None) -> tuple:
        """Train from ``start_step`` to ``total_steps``; returns (params,
        opt_state, step).  The loop keeps one reference to the live state,
        so a step's input state is freed when the step returns (the memory
        JAX's buffer donation gives back); a caller that passes its only
        references in lets the initial state go too."""
        state = {"params": params, "opt": opt_state}
        del params, opt_state
        step = start_step
        failed_once = set()
        while step < self.cfg.total_steps:
            try:
                step = self._run_span(state, step, failed_once, metrics_cb)
            except Exception as e:                          # noqa: BLE001
                self.restarts += 1
                if self.restarts > self.cfg.max_restarts:
                    raise
                if not self.cfg.ckpt_dir:
                    raise
                last = ckpt.latest_step(self.cfg.ckpt_dir)
                if last is None:
                    raise RuntimeError("failure before first checkpoint") \
                        from e
                # the failed step's frames may hold its tensors: let them go
                # before the restored state is placed beside the live one
                e.__traceback__ = None
                last, restored = ckpt.restore(self.cfg.ckpt_dir, state,
                                              step=last)
                state.update(restored)
                step = last
                self.handler.sync(f"restart_from_{last}")
        return state["params"], state["opt"], step

    def _run_span(self, state: dict, step, failed_once, metrics_cb):
        while step < self.cfg.total_steps:
            if self.cfg.inject_failure_at is not None \
                    and step == self.cfg.inject_failure_at \
                    and step not in failed_once:
                failed_once.add(step)
                raise RuntimeError(f"injected node failure at step {step}")
            self.handler.step_start(step)
            t0 = time.perf_counter()
            batch = self.place_batch(self.source.batch_at(step))
            state["params"], state["opt"], metrics = self.train_step(
                state["params"], state["opt"], batch)
            loss = float(metrics["loss"])              # sync point
            dur = time.perf_counter() - t0
            self._watchdog(step, dur)
            self.handler.step_end(step, loss=loss, duration_s=dur)
            if metrics_cb:
                metrics_cb(step, {k: float(v) for k, v in metrics.items()})
            step += 1
            if self.cfg.ckpt_dir and step % self.cfg.ckpt_every == 0:
                ckpt.save(self.cfg.ckpt_dir, step, state,
                          async_=self.cfg.async_ckpt)
        return step

    # ------------------------------------------------------------ watchdog
    def _watchdog(self, step: int, dur: float) -> None:
        self.durations.append(dur)
        hist = self.durations[-50:]
        if len(hist) >= 5:
            med = statistics.median(hist)
            if dur > self.cfg.straggler_factor * med:
                self.stragglers += 1
                self.handler.sync(f"straggler_step_{step}")
