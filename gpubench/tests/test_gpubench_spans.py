"""The readers of the device's idle time under the program's spans, on a
CPU trace of the program (no device: every instant of it is idle) reduced
by `profiling.reduce_events`."""
import time

import numpy as np
import pytest

from gpubench.harness import load_module
from gpubench.profiling import reduce_events

SERVE = ("admit_idle_pct", "resolve_idle_pct")
PREP = ("prep_idle_pct",)


def _graph():
    from repro_torch.graphs import generators as gen

    g = gen.powerlaw_cluster(400, 4, p=0.5, seed=1)
    return gen.with_random_weights(g, lo=0.1, hi=1.0, seed=3)


def _serve(trace):
    from repro_torch.serving import GraphServer

    g = _graph()
    srv = GraphServer(g, slots=4, bs=64, rounds_per_batch=8, backend="kernel",
                      sweeps_per_call=4, rank=np.random.default_rng(0).permutation(g.n),
                      trace=trace, device="cpu")
    for s in range(8):
        srv.submit("ppr", {"seeds": [s]})
    srv.run()


def _solve(trace):
    from repro_torch import get_algorithm, solve

    g = _graph()
    solve(get_algorithm("ppr", g, seeds=[1, 2, 3]), backend="kernel", bs=64,
          sweeps_per_call=4, device="cpu", rank=np.random.default_rng(1).permutation(g.n),
          trace=trace)


def _record(fn, traced):
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.obs.trace import Tracer

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        t0 = time.perf_counter()
        fn(Tracer() if traced else None)
        window_s = time.perf_counter() - t0
    return {"profile": reduce_events(prof.events(), window_s)}


@pytest.mark.parametrize("fn, names", [(_serve, SERVE), (_solve, PREP)],
                         ids=["serve", "solve"])
def test_readers_read_the_program_spans(fn, names):
    rec = _record(fn, traced=True)
    for name in names:
        value = load_module("metrics", name).read(rec)
        assert value is not None and 0.0 < value <= 100.0, (name, value)


@pytest.mark.parametrize("fn, names", [(_serve, SERVE), (_solve, PREP)],
                         ids=["serve", "solve"])
def test_readers_find_nothing_without_a_tracer(fn, names):
    rec = _record(fn, traced=False)
    assert rec["profile"]["idle_gaps"]
    for name in names:
        assert load_module("metrics", name).read(rec) is None
    assert load_module("metrics", names[0]).read({"profile": None}) is None
