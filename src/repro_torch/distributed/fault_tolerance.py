"""Fault tolerance and straggler detection, as in the reference's
``repro.distributed.fault_tolerance`` (pure Python, no device):

  * ``HeartbeatMonitor``: per-host heartbeats with deadlines; a missed
    deadline marks the host suspect, a second one failed.
  * ``StepTimer``: rolling per-step latency; a step over
    ``straggler_factor`` times the rolling median is a straggler (the
    trainer logs it).
  * ``RestartPolicy``: an exponential-backoff restart budget.
  * ``elastic_plan``: the largest (data, model) mesh on the surviving
    chips.  The port has no mesh yet (ROADMAP queue A item 22); the plan
    is arithmetic and is kept for that work.
"""

from __future__ import annotations

import collections
import time
from dataclasses import dataclass, field


@dataclass
class HeartbeatMonitor:
    hosts: list[str]
    suspect_after_s: float = 30.0
    fail_after_s: float = 120.0
    _last: dict = field(default_factory=dict)

    def beat(self, host: str, now: float | None = None):
        self._last[host] = time.monotonic() if now is None else now

    def status(self, now: float | None = None) -> dict:
        now = time.monotonic() if now is None else now
        out = {}
        for h in self.hosts:
            last = self._last.get(h)
            if last is None:
                out[h] = "unknown"
            elif now - last > self.fail_after_s:
                out[h] = "failed"
            elif now - last > self.suspect_after_s:
                out[h] = "suspect"
            else:
                out[h] = "healthy"
        return out

    def failed_hosts(self, now: float | None = None) -> list[str]:
        return [h for h, s in self.status(now).items() if s == "failed"]

    def should_restart(self, now: float | None = None) -> bool:
        return bool(self.failed_hosts(now))


class StepTimer:
    """Rolling step-latency tracker; flags straggler steps."""

    def __init__(self, window: int = 50, straggler_factor: float = 2.0):
        self.window = collections.deque(maxlen=window)
        self.factor = straggler_factor
        self.straggler_steps: list[int] = []
        self._step = 0

    def record(self, seconds: float) -> bool:
        """True if this step is a straggler outlier."""
        self._step += 1
        med = self.median()
        self.window.append(seconds)
        if med is not None and seconds > self.factor * med:
            self.straggler_steps.append(self._step)
            return True
        return False

    def median(self):
        if len(self.window) < 5:
            return None
        vals = sorted(self.window)
        return vals[len(vals) // 2]


@dataclass
class RestartPolicy:
    max_restarts: int = 10
    base_backoff_s: float = 5.0
    restarts: int = 0

    def next_backoff(self) -> float | None:
        """Seconds to wait before the next restart; None once the budget
        is spent."""
        if self.restarts >= self.max_restarts:
            return None
        delay = self.base_backoff_s * (2 ** self.restarts)
        self.restarts += 1
        return min(delay, 600.0)


def elastic_plan(surviving_chips: int, model_parallel: int = 16
                 ) -> tuple[int, int] | None:
    """Largest (data, model) mesh on the survivors with the model axis
    kept whole: the data axis shrinks to the largest power of two."""
    if surviving_chips < model_parallel:
        return None
    data = surviving_chips // model_parallel
    data = 2 ** (data.bit_length() - 1)
    return (data, model_parallel)
