"""The reference's fault-tolerance tests (``tests/test_train_infra.py``) on
the port's own copy, ``repro_torch.runtime.fault``: checkpoint/restart
with no lost or repeated step, giving up after ``max_failures``, the
straggler monitor's median rule and the SIGTERM flag."""
import os
import signal

import pytest

pytest.importorskip("torch")

from repro_torch.runtime import fault as PF  # noqa: E402


def test_fault_tolerant_runner_recovers():
    saves = {}
    injected = {"done": False}

    def step_fn(st, step):
        if step == 5 and not injected["done"]:
            injected["done"] = True
            raise RuntimeError("injected node failure")
        return {"v": st["v"] + 1}

    def save_fn(step, st):
        saves[step] = dict(st)

    def restore_fn():
        step = max(saves)
        return dict(saves[step]), step

    runner = PF.FaultTolerantRunner(step_fn, save_fn, restore_fn, ckpt_every=2,
                                    max_failures=2)
    final, step = runner.run({"v": 0}, steps=10)
    assert step == 10
    assert final["v"] == 10  # no lost or duplicated steps
    assert runner.failures == 1
    assert any("restored" in line for line in runner.log)


def test_fault_runner_gives_up_after_max_failures():
    def step_fn(st, step):
        raise RuntimeError("permanent failure")

    runner = PF.FaultTolerantRunner(step_fn, lambda s, st: None, lambda: ({}, 0),
                                    max_failures=2)
    with pytest.raises(RuntimeError):
        runner.run({}, steps=3)
    assert runner.failures == 3


def test_straggler_monitor():
    events = []
    mon = PF.StragglerMonitor(threshold=2.0, policy=events.append)
    for i in range(10):
        mon.observe(i, 0.1)
    mon.observe(10, 0.5)  # 5x median
    assert len(mon.events) == 1 and events == mon.events
    assert mon.events[0].ratio == pytest.approx(5.0, rel=0.01)


def test_runner_checkpoints_on_preemption():
    saves = {}
    guard = PF.PreemptionGuard(install=False)

    def step_fn(st, step):
        if step == 2:
            guard.preempted = True
        return {"v": st["v"] + 1}

    runner = PF.FaultTolerantRunner(step_fn, lambda s, st: saves.update({s: st}),
                                    lambda: ({}, 0), ckpt_every=0, preemption=guard)
    final, step = runner.run({"v": 0}, steps=10)
    assert step == 3 and final["v"] == 3 and saves == {3: {"v": 3}}
    assert runner.log[-1] == "preempted at step 3; checkpointed"


def test_preemption_guard_flag():
    guard = PF.PreemptionGuard(install=True)
    try:
        os.kill(os.getpid(), signal.SIGTERM)
        assert guard.preempted
    finally:
        guard.restore()
