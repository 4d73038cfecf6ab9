"""The trace reduction on synthetic events (times in microseconds)."""
import types

import pytest
from torch.autograd import DeviceType

from gpubench.profiling import labels, reduce_events


def ev(name, start, end, device=False, annotation=False):
    return types.SimpleNamespace(
        name=name, time_range=types.SimpleNamespace(start=start, end=end),
        device_type=DeviceType.CUDA if device else DeviceType.CPU,
        is_user_annotation=annotation)


def test_busy_is_the_union_and_idle_time_goes_to_the_innermost_op():
    events = [
        ev("gpubench.step", 0, 1000),
        ev("gpubench._resolve", 100, 300),
        ev("aten::copy_", 500, 520),
        ev("kernel_a", 0, 100, device=True),
        ev("kernel_b", 50, 120, device=True),   # overlaps a: counted once
        ev("kernel_c", 300, 500, device=True),
        ev("gpubench.step", 0, 1000, device=True, annotation=True),  # mirrored range
        ev("kernel_d", 900, 1000, device=True),
    ]
    out = reduce_events(events, window_s=0.001)
    assert out["busy_s"] == pytest.approx((120 + 200 + 100) * 1e-6)
    assert out["window_s"] == 0.001
    assert [k for k, _ in out["device_ops"]] == ["kernel_c", "kernel_a", "kernel_d", "kernel_b"]
    idle = dict(out["idle_gaps"])
    # 120-300 lies inside _resolve for 180 us: the innermost op covering it
    assert idle["gpubench._resolve"] == pytest.approx(180e-6)
    # 500-900 lies in step, its first 20 us also in copy_
    assert idle["aten::copy_"] == pytest.approx(20e-6)
    assert idle["gpubench.step"] == pytest.approx(380e-6)
    assert sum(idle.values()) == pytest.approx(1e-3 - out["busy_s"])


def test_labels_wrap_and_restore():
    class Server:
        def tick(self, x):
            return x + 1

    original = Server.__dict__["tick"]
    with labels((Server, "tick")):
        assert Server().tick(1) == 2
        assert Server.__dict__["tick"] is not original
    assert Server.__dict__["tick"] is original


def test_labels_pass_over_targets_the_program_no_longer_has():
    """A program change that removes or renames a labelled call costs that
    label only: the traced run goes on."""
    class Server:
        size = 3

        def tick(self, x):
            return x + 1

    original = Server.__dict__["tick"]
    gone = types.ModuleType("gone")
    with labels((Server, "_check_compat"), (Server, "size"), (gone, "pack_algorithm"),
                "gpubench_no_such_module:pack_algorithm",
                "gpubench.profiling:NoSuchClass.run_batch",
                "gpubench.profiling:no_such_function",
                (Server, "tick")):
        assert Server().tick(1) == 2
        assert Server.__dict__["tick"] is not original
        assert Server.size == 3 and not hasattr(Server, "_check_compat")
    assert Server.__dict__["tick"] is original
    assert not hasattr(gone, "pack_algorithm")


def test_labels_find_targets_by_dotted_name():
    import gpubench.profiling as prof

    original = prof.__dict__["reduce_events"]
    with labels("gpubench.profiling:reduce_events", "gpubench.profiling:DeviceWindow._sync"):
        assert prof.reduce_events is not original
        assert prof.DeviceWindow.__dict__["_sync"].__wrapped__ is not None
    assert prof.reduce_events is original
