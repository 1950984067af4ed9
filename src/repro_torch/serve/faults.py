"""Deterministic chaos injection for the serving engine.

A :class:`FaultPlan` is a seeded, reproducible schedule of runtime faults
the engine volunteers to suffer: the same ``(preset, seed)`` always yields
the same faults at the same scheduler ticks against the same request ids,
so a chaos run is a replayable artifact exactly like a traffic trace — a
failure found under chaos reproduces under the same plan, and CI can
assert recovery properties (zero innocent loss, byte-identical resumed
outputs) instead of eyeballing flakes.

Fault kinds (each a :class:`FaultSpec`):

=============== ========================================================
``tick_error``  the tick raises before the fused dispatch — transient and
                attributable to no request; the engine retries the tick
``poison``      whenever the target request is live in a tick, the tick
                raises.  NOT row-attributable: the engine must *bisect*
                the live set (``FaultPlan.probe``) to find the culprit
``nan_logits``  the target request's logits row turns NaN after the fused
                forward — row-attributable, no bisection needed (and the
                same guard catches genuine numeric blowups)
``stall``       the tick sleeps ``stall_s`` for ``duration`` ticks — the
                slow-tick signal the degradation ladder sheds load on
``pressure``    ``blocks`` pool blocks are held back from admission for
                ``duration`` ticks — the pool-pressure degradation signal
``preempt``     a host-preemption signal: evict ``count`` running
                requests this tick (parked losslessly, like any victim)
=============== ========================================================

The engine consumes a plan through five hooks (``tick_stall_s`` /
``held_blocks`` / ``preempt_signals`` / ``check_tick`` /
``corrupt_logits``) plus ``probe`` during blame bisection.  ``check_tick``
*consumes* one ttl charge per armed fault per real tick; ``probe`` never
consumes — bisection replays the same tick's verdict as often as it needs.
"""

from __future__ import annotations

import dataclasses

import numpy as np


class FaultInjected(RuntimeError):
    """An injected fault manifesting as a tick exception.

    ``attributable`` tells the recovery path whether blame bisection can
    find a culprit request (``poison``) or the whole tick is transient
    (``tick_error``).  The poisoned rid is deliberately NOT carried —
    recovery must earn it through :meth:`FaultPlan.probe`."""

    def __init__(self, kind: str, tick: int, attributable: bool):
        super().__init__(f"injected {kind} fault at tick {tick}")
        self.kind = kind
        self.tick = tick
        self.attributable = attributable


@dataclasses.dataclass
class FaultSpec:
    """One scheduled fault.  ``tick`` is the 1-based engine tick the fault
    arms at (``None`` = armed from the start for request-targeted kinds);
    ``ttl`` is how many separate ticks a request-targeted fault fires
    before clearing (a large ttl ~ a deterministic hard fault)."""

    kind: str                      # tick_error|poison|nan_logits|stall|
    #                                pressure|preempt
    tick: int | None = None
    rid: int | None = None         # poison / nan_logits target
    ttl: int = 1
    duration: int = 1              # stall / pressure window width in ticks
    stall_s: float = 0.0
    blocks: int = 0                # pressure: blocks withheld
    count: int = 1                 # preempt: victims this tick

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


_REQUEST_KINDS = ("poison", "nan_logits")
_WINDOW_KINDS = ("stall", "pressure")


class FaultPlan:
    """A deterministic schedule of :class:`FaultSpec` plus runtime state
    (remaining ttls, what fired when).  One plan drives one engine run;
    build a fresh plan (same specs/seed) to replay the chaos exactly."""

    def __init__(self, specs=(), seed: int = 0, name: str = "custom"):
        self.specs = [dataclasses.replace(s) for s in specs]
        self.seed = seed
        self.name = name
        self._ttl = {id(s): s.ttl for s in self.specs}
        #: request-targeted specs that fired in the current tick — what
        #: :meth:`probe` answers from during blame bisection
        self._fired_now: list = []
        self._fired_tick = -1
        #: (tick, kind, rid) log of every manifested fault
        self.fired: list = []

    # ------------------------------------------------------------- presets
    @classmethod
    def preset(cls, name: str, seed: int = 0) -> "FaultPlan":
        """Named chaos scenarios.  All schedules derive from ``seed``
        alone, so a preset run replays bit-for-bit.

        * ``one-poison`` — one request is persistently poisoned: every
          tick it participates in raises, retries exhaust, it must end
          ``failed`` while every other request finishes byte-identically.
        * ``transient`` — one short-lived poison plus one tick error;
          everything recovers, nothing may be lost.
        * ``storm`` — transient poisons, a NaN row, tick errors, a stall
          window, a pressure window and a host-preemption signal; zero
          requests may be lost.
        * ``pressure`` — sustained pool pressure + stalls, no poisons:
          exercises the degradation ladder end to end.
        """
        if name not in _PRESET_SALT:
            raise ValueError(
                f"unknown chaos preset {name!r}; known: {sorted(PRESETS)}")
        rng = np.random.default_rng([seed, _PRESET_SALT[name]])
        t = lambda lo, hi: int(rng.integers(lo, hi))        # noqa: E731
        if name == "one-poison":
            specs = [FaultSpec(kind="poison", rid=t(0, 4), ttl=1_000_000)]
        elif name == "transient":
            specs = [FaultSpec(kind="poison", rid=t(0, 4), ttl=1),
                     FaultSpec(kind="tick_error", tick=t(3, 8))]
        elif name == "storm":
            r1 = t(0, 4)
            r2 = (r1 + 1 + t(0, 3)) % 8
            specs = [
                FaultSpec(kind="poison", rid=r1, ttl=1),
                FaultSpec(kind="nan_logits", rid=r2, ttl=1),
                FaultSpec(kind="tick_error", tick=t(2, 6)),
                FaultSpec(kind="tick_error", tick=t(10, 16)),
                FaultSpec(kind="stall", tick=t(4, 8), duration=3,
                          stall_s=0.08),
                FaultSpec(kind="pressure", tick=t(6, 10), duration=4,
                          blocks=2),
                FaultSpec(kind="preempt", tick=t(8, 12), count=1),
            ]
        elif name == "pressure":
            specs = [
                FaultSpec(kind="pressure", tick=t(2, 4), duration=8,
                          blocks=4),
                FaultSpec(kind="stall", tick=t(3, 6), duration=4,
                          stall_s=0.1),
                FaultSpec(kind="stall", tick=t(10, 13), duration=3,
                          stall_s=0.1),
            ]
        else:
            raise ValueError(
                f"unknown chaos preset {name!r}; known: {sorted(PRESETS)}")
        return cls(specs, seed=seed, name=name)

    # ------------------------------------------------------- tick-level hooks
    def _roll_tick(self, tick: int) -> None:
        if tick != self._fired_tick:
            self._fired_tick = tick
            self._fired_now = []

    def _armed(self, s: FaultSpec, tick: int) -> bool:
        if self._ttl[id(s)] <= 0:
            return False
        return s.tick is None or s.tick <= tick

    def _in_window(self, s: FaultSpec, tick: int) -> bool:
        return s.tick is not None and s.tick <= tick < s.tick + s.duration

    def tick_stall_s(self, tick: int) -> float:
        """Seconds this tick must stall (sum of open ``stall`` windows)."""
        total = 0.0
        for s in self.specs:
            if s.kind == "stall" and self._in_window(s, tick):
                total += s.stall_s
                self.fired.append((tick, "stall", None))
        return total

    def held_blocks(self, tick: int) -> int:
        """Pool blocks withheld from admission this tick (``pressure``)."""
        held = 0
        for s in self.specs:
            if s.kind == "pressure" and self._in_window(s, tick):
                held += s.blocks
        return held

    def preempt_signals(self, tick: int) -> int:
        """Host-preemption victims demanded this tick (consumes the spec)."""
        n = 0
        for s in self.specs:
            if s.kind == "preempt" and s.tick == tick \
                    and self._ttl[id(s)] > 0:
                self._ttl[id(s)] = 0
                self.fired.append((tick, "preempt", None))
                n += s.count
        return n

    # --------------------------------------------------- dispatch-level hooks
    def check_tick(self, tick: int, rids) -> None:
        """Called before a fused dispatch with the participating rids.
        Consumes and raises for an armed ``tick_error`` at this tick, or
        for any armed ``poison`` whose target is among ``rids`` (ALL
        matching poisons are charged, so one bisection can find several
        culprits)."""
        self._roll_tick(tick)
        rids = set(rids)
        poisoned = False
        for s in self.specs:
            if s.kind == "tick_error" and s.tick == tick \
                    and self._ttl[id(s)] > 0:
                self._ttl[id(s)] = 0
                self.fired.append((tick, "tick_error", None))
                raise FaultInjected("tick_error", tick, attributable=False)
            if s.kind == "poison" and s.rid in rids and self._armed(s, tick):
                self._ttl[id(s)] -= 1
                self._fired_now.append(s)
                self.fired.append((tick, "poison", s.rid))
                poisoned = True
        if poisoned:
            raise FaultInjected("poison", tick, attributable=True)

    def corrupt_logits(self, tick: int, rid_rows: dict, logits) -> list:
        """Overwrite the logits rows of armed ``nan_logits`` targets with
        NaN in place; returns the corrupted rids.  ``rid_rows`` maps
        rid -> row index into ``logits``."""
        self._roll_tick(tick)
        hit = []
        for s in self.specs:
            if s.kind == "nan_logits" and s.rid in rid_rows \
                    and self._armed(s, tick):
                self._ttl[id(s)] -= 1
                self._fired_now.append(s)
                self.fired.append((tick, "nan_logits", s.rid))
                logits[rid_rows[s.rid]] = np.nan
                hit.append(s.rid)
        return hit

    def probe(self, rids) -> bool:
        """Blame-bisection oracle: would a tick restricted to ``rids``
        have manifested the fault that just fired?  True = the subset is
        poisoned.  Never consumes ttl — recovery may probe freely."""
        rids = set(rids)
        return any(s.rid in rids for s in self._fired_now)

    # -------------------------------------------------------------- reporting
    def to_dict(self) -> dict:
        return {"name": self.name, "seed": self.seed,
                "specs": [s.to_dict() for s in self.specs],
                "fired": list(self.fired)}

    def __repr__(self):
        return (f"FaultPlan(name={self.name!r}, seed={self.seed}, "
                f"specs={len(self.specs)}, fired={len(self.fired)})")


#: preset name -> rng stream salt (stable across preset additions)
_PRESET_SALT = {"one-poison": 1, "transient": 2, "storm": 3, "pressure": 4}

#: named presets for the launcher's ``--chaos`` flag
PRESETS = tuple(sorted(_PRESET_SALT))


def get_plan(spec, seed: int = 0) -> FaultPlan | None:
    """Resolve ``None`` | preset name | :class:`FaultPlan` instance."""
    if spec is None or isinstance(spec, FaultPlan):
        return spec
    return FaultPlan.preset(spec, seed=seed)
