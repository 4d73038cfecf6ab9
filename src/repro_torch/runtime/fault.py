"""Fault tolerance: checkpoint/restart, preemption, straggler mitigation.

On a 1000+-node cluster the failure model is: (a) hard node loss -> the job
controller restarts the process group and we must resume from the last
checkpoint with zero manual steps; (b) preemption notice (SIGTERM) -> save
NOW and exit cleanly; (c) stragglers -> detect persistent slow steps and
surface/act (re-shard, swap pod) rather than silently losing throughput.

This module implements all three for a single process (the port keeps its
own copy of the reference's module, which imports no JAX):
failures are injected by tests via `inject`, SIGTERM is registered for real,
and the straggler monitor is wall-clock based — the logic is exactly what a
multi-host deployment runs; only the restart transport differs.
"""
from __future__ import annotations

import dataclasses
import signal
import time
from typing import Callable, Optional


class PreemptionGuard:
    """SIGTERM/SIGINT -> set a flag the training loop checks each step."""

    def __init__(self, install: bool = True):
        self.preempted = False
        self._orig = {}
        if install:
            for sig in (signal.SIGTERM,):
                try:
                    self._orig[sig] = signal.signal(sig, self._handler)
                except ValueError:  # non-main thread
                    pass

    def _handler(self, signum, frame):
        self.preempted = True

    def restore(self):
        for sig, h in self._orig.items():
            signal.signal(sig, h)


@dataclasses.dataclass
class StragglerEvent:
    step: int
    dt: float
    median: float
    ratio: float


class StragglerMonitor:
    """Flags steps slower than `threshold` x the running median.

    On real hardware the actionable signal is per-host: the monitor would be
    fed per-host step times (from each rank's heartbeats) and the
    policy hook decides demote/evict/re-shard. Here the policy hook receives
    the event; the default action is to record it.
    """

    def __init__(self, threshold: float = 2.0, window: int = 50,
                 policy: Optional[Callable[[StragglerEvent], None]] = None):
        self.threshold = threshold
        self.window = window
        self.policy = policy
        self.times: list[float] = []
        self.events: list[StragglerEvent] = []

    def observe(self, step: int, dt: float):
        import statistics

        if len(self.times) >= 5:
            med = statistics.median(self.times[-self.window:])
            if dt > self.threshold * med:
                ev = StragglerEvent(step=step, dt=dt, median=med, ratio=dt / med)
                self.events.append(ev)
                if self.policy:
                    self.policy(ev)
        self.times.append(dt)


class FaultTolerantRunner:
    """Checkpoint/restart wrapper around a step loop.

    run() executes `step_fn(state, step) -> state` for `steps` steps,
    checkpointing every `ckpt_every` via save_fn(step, state) and restoring
    with restore_fn() -> (state, start_step) after a failure. Failures are
    retried up to `max_failures` times; each recovery resumes from the last
    durable checkpoint (losing at most ckpt_every-1 steps of work).
    """

    def __init__(
        self,
        step_fn: Callable,
        save_fn: Callable,
        restore_fn: Callable,
        ckpt_every: int = 10,
        max_failures: int = 3,
        straggler: Optional[StragglerMonitor] = None,
        preemption: Optional[PreemptionGuard] = None,
    ):
        self.step_fn = step_fn
        self.save_fn = save_fn
        self.restore_fn = restore_fn
        self.ckpt_every = ckpt_every
        self.max_failures = max_failures
        self.straggler = straggler or StragglerMonitor()
        self.preemption = preemption
        self.failures = 0
        self.log: list[str] = []

    def run(self, state, steps: int, start_step: int = 0):
        step = start_step
        while step < steps:
            try:
                t0 = time.perf_counter()
                state = self.step_fn(state, step)
                dt = time.perf_counter() - t0
                self.straggler.observe(step, dt)
                step += 1
                if self.ckpt_every and step % self.ckpt_every == 0:
                    self.save_fn(step, state)
                if self.preemption is not None and self.preemption.preempted:
                    self.save_fn(step, state)
                    self.log.append(f"preempted at step {step}; checkpointed")
                    return state, step
            except Exception as e:  # noqa: BLE001 — any step failure
                self.failures += 1
                self.log.append(f"step {step} failed ({type(e).__name__}: {e}); "
                                f"failure {self.failures}/{self.max_failures}")
                if self.failures > self.max_failures:
                    raise
                state, step = self.restore_fn()
                self.log.append(f"restored; resuming at step {step}")
        return state, step
