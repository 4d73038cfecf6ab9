"""Reading the device's share of a sub-window from ``torch.profiler``.

`DeviceWindow` profiles the code inside it (host ops and, on a card, the
device's kernels, copies and fills) and reduces the trace to:

* ``busy_s``: the union of the device's intervals (kernels, copies and
  fills; not the ranges that ``record_function`` mirrors onto the device's
  timeline), so two overlapping operations count once and any kernel,
  whatever its name, counts;
* ``window_s``: the sub-window's length by the host clock, from entering
  to leaving, after a synchronise;
* ``device_ops``: the ten device operations that took most time, summed
  by name;
* ``idle_gaps``: the device's idle time, each instant of it given to the
  innermost host operation open then, summed by name, the ten largest.

Mark the caller's own phases with ``torch.profiler.record_function`` so
that an idle gap inside them reads as that phase; `labels` does so for
calls into the program, from outside it, while the profiler runs.
"""
from __future__ import annotations

import contextlib
import functools
import sys
import time
from collections import defaultdict

import torch

TOP = 10


def _union(intervals: list[tuple[float, float]]) -> list[tuple[float, float]]:
    merged: list[list[float]] = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return [(s, e) for s, e in merged]


def _name_gaps(gaps, host) -> dict[str, float]:
    """Idle seconds by the host op the host was innermost in: each instant
    of a gap goes to the shortest op open at that instant (ops of one
    thread nest, so that is the innermost), or to ``(no host op)``."""
    points = []
    for i, (s, e, _) in enumerate(host):
        points += [(s, 1, i), (e, 0, i)]
    for s, e in gaps:
        points += [(s, 3, -1), (e, 2, -1)]
    # at one instant: ops end, ops start, a gap ends, a gap starts
    points.sort()
    out: dict[str, float] = defaultdict(float)
    open_ops: dict[int, float] = {}
    in_gap, prev = False, None
    for t, kind, i in points:
        if in_gap and t > prev:
            if open_ops:
                name = host[min(open_ops, key=open_ops.__getitem__)][2]
            else:
                name = "(no host op)"
            out[name] += (t - prev) * 1e-6
        prev = t
        if kind == 0:
            open_ops.pop(i, None)
        elif kind == 1:
            open_ops[i] = host[i][1] - host[i][0]
        else:
            in_gap = kind == 3
    return out


def _annotation(e) -> bool:
    """A ``record_function`` range mirrored on the device's timeline: it
    marks the host's phase and is no device work."""
    return bool(getattr(e, "is_user_annotation", False)) or e.name.startswith("gpubench.")


def reduce_events(events, window_s: float) -> dict:
    """The numbers of a profiled sub-window from its events."""
    from torch.autograd import DeviceType

    dev, host = [], []
    for e in events:
        s, t = float(e.time_range.start), float(e.time_range.end)
        if e.device_type == DeviceType.CPU:
            host.append((s, t, e.name))
        elif t > s and not _annotation(e):
            dev.append((s, t, e.name))
    busy = _union([(s, t) for s, t, _ in dev])
    by_op: dict[str, float] = defaultdict(float)
    for s, t, name in dev:
        by_op[name] += (t - s) * 1e-6
    gaps = []
    if host:
        lo = min(min(h[0] for h in host), busy[0][0] if busy else float("inf"))
        hi = max(max(h[1] for h in host), busy[-1][1] if busy else float("-inf"))
        cur = lo
        for s, t in busy:
            if s > cur:
                gaps.append((cur, s))
            cur = max(cur, t)
        if hi > cur:
            gaps.append((cur, hi))
    idle = _name_gaps(gaps, host)
    top = sorted(by_op.items(), key=lambda kv: -kv[1])[:TOP]
    top_idle = sorted(idle.items(), key=lambda kv: -kv[1])[:TOP]
    return {
        "busy_s": sum(t - s for s, t in busy) * 1e-6,
        "window_s": window_s,
        "device_ops": [[k[:120], v] for k, v in top],
        "idle_gaps": [[k[:120], v] for k, v in top_idle],
    }


class DeviceWindow:
    """``with DeviceWindow(device) as w: ...``; then ``w.result``."""

    def __init__(self, device: torch.device) -> None:
        self.device = device
        self.result: dict | None = None

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def __enter__(self) -> "DeviceWindow":
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        self._sync()
        self._prof = profile(activities=acts)
        self._prof.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> bool:
        self._sync()
        window_s = time.perf_counter() - self._t0
        self._prof.__exit__(*exc)
        if exc[0] is None:
            t = time.perf_counter()
            self.result = reduce_events(self._prof.events(), window_s)
            print(f"gpubench: profiled {window_s:.3f} s, read the trace in "
                  f"{time.perf_counter() - t:.3f} s", file=sys.stderr, flush=True)
        return False


def _target(spec):
    """``(owner, name)`` for ``"module:attr"`` or ``"module:Class.attr"``
    (or an ``(owner, name)`` pair, passed through); None where the module
    or the owner is gone."""
    if not isinstance(spec, str):
        return spec
    import importlib

    module, _, path = spec.partition(":")
    try:
        owner = importlib.import_module(module)
    except ImportError:
        return None
    *outer, name = path.split(".")
    for part in outer:
        owner = getattr(owner, part, None)
        if owner is None:
            return None
    return owner, name


@contextlib.contextmanager
def labels(*targets):
    """Inside the block, each target callable runs under
    ``record_function("gpubench.<name>")``: an idle gap while the host is
    in it reads as that call. A target is ``"module:function"``,
    ``"module:Class.method"`` or an ``(owner, name)`` pair; the originals
    are put back on leaving. A target the program no longer has (a module,
    class or call renamed or removed) is passed over: it loses its label,
    and the run goes on."""
    from torch.profiler import record_function

    saved = []

    def wrap(fn, label):
        @functools.wraps(fn)
        def labelled(*args, **kwargs):
            with record_function(label):
                return fn(*args, **kwargs)
        return labelled

    try:
        for spec in targets:
            target = _target(spec)
            if target is None:
                continue
            owner, name = target
            fn = (owner.__dict__.get(name) if isinstance(owner, type)
                  else getattr(owner, name, None))
            if not callable(fn):
                continue
            saved.append((owner, name, fn))
            setattr(owner, name, wrap(fn, f"gpubench.{name}"))
        yield
    finally:
        for owner, name, fn in reversed(saved):
            setattr(owner, name, fn)
