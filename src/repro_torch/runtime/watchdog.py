"""Straggler mitigation: per-step wall-clock EWMA watchdog (a copy of
``repro.runtime.watchdog``, which imports no JAX).

On a real pod a straggler event triggers the controller to evict the slow
pod-slice and relaunch elastically (runtime/elastic.py + checkpoint
restore).  Here the detection logic itself is what we implement and test —
it is pure and clock-injectable.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable


@dataclasses.dataclass
class StragglerWatchdog:
    threshold: float = 3.0          # step slower than k x EWMA -> straggler
    alpha: float = 0.1              # EWMA smoothing
    warmup_steps: int = 5           # ignore compile/jit steps
    clock: Callable[[], float] = time.monotonic

    _ewma: float | None = None
    _seen: int = 0
    _t0: float | None = None
    events: list = dataclasses.field(default_factory=list)

    def step_start(self):
        self._t0 = self.clock()

    def step_end(self, step: int) -> bool:
        """Returns True if this step is flagged as a straggler."""
        assert self._t0 is not None, "step_end without step_start"
        dt = self.clock() - self._t0
        self._t0 = None
        self._seen += 1
        if self._seen <= self.warmup_steps:
            return False
        if self._ewma is None:
            self._ewma = dt
            return False
        flagged = dt > self.threshold * self._ewma
        if flagged:
            self.events.append({"step": step, "dt": dt, "ewma": self._ewma})
        else:
            # stragglers are excluded from the EWMA so one slow pod can't
            # desensitise the detector
            self._ewma = (1 - self.alpha) * self._ewma + self.alpha * dt
        return flagged
