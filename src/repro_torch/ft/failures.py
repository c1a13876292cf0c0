"""Fault-tolerance: failure injection, watchdog, restart supervision (the
port's copy of ``repro/ft/failures.py``, framework-free).

On a real cluster, node failures surface as collective timeouts / device
errors; the recovery path is identical to the one exercised here — die,
restart, auto-resume from the latest complete checkpoint, fast-forward the
data stream. The tests inject ``SimulatedFailure`` through the trainer's
``failure_hook`` and assert loss-trajectory equivalence with an unfailed
run (``tests/test_torch_train.py``).

Straggler mitigation at this layer: the data pipeline is random-access
(no replay on restart) and the Watchdog flags steps exceeding a deadline;
on real deployments the supervisor would re-schedule the slow host
(checkpoint-restart with a spare) — the mechanism exercised by
``run_with_restarts``.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Callable, Iterable, Optional, Set

log = logging.getLogger("repro_torch.ft")


class SimulatedFailure(RuntimeError):
    pass


class FailureInjector:
    """Raise SimulatedFailure the first time each configured step starts."""

    def __init__(self, fail_at: Iterable[int]):
        self.pending: Set[int] = set(fail_at)

    def __call__(self, step: int) -> None:
        if step in self.pending:
            self.pending.discard(step)
            raise SimulatedFailure(f"injected failure at step {step}")


class Watchdog:
    """Flags (and counts) steps that exceed a wall-clock deadline."""

    def __init__(self, deadline_s: float):
        self.deadline_s = deadline_s
        self.straggler_events = 0
        self._timer: Optional[threading.Timer] = None

    def _expire(self, step: int) -> None:
        self.straggler_events += 1
        log.warning("watchdog: step %d exceeded %.1fs deadline", step,
                    self.deadline_s)

    def step_started(self, step: int) -> None:
        self.step_finished()
        self._timer = threading.Timer(self.deadline_s, self._expire, (step,))
        self._timer.daemon = True
        self._timer.start()

    def step_finished(self) -> None:
        if self._timer is not None:
            self._timer.cancel()
            self._timer = None


def run_with_restarts(make_trainer: Callable[[], "object"],
                      max_restarts: int = 5):
    """Supervise a trainer factory: on SimulatedFailure, rebuild (which
    auto-resumes from the latest checkpoint) and continue. Returns the
    final trainer and the number of restarts consumed."""
    restarts = 0
    while True:
        trainer = make_trainer()
        try:
            trainer.run()
            return trainer, restarts
        except SimulatedFailure as e:
            restarts += 1
            log.warning("restart %d after %s", restarts, e)
            if restarts > max_restarts:
                raise
