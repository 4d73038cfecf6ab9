"""The port's span tracer on the CPU: ids and parents, tickets shared by
one query's spans, self time, `child` without an open span, and the
program's spans on a `torch.profiler` timeline."""
import collections

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch.profiler import ProfilerActivity, profile  # noqa: E402

import repro_torch as rt  # noqa: E402
from repro_torch.graphs import generators as TG  # noqa: E402
from repro_torch.obs.trace import (  # noqa: E402
    NULL_SPAN,
    SPAN_NAMES,
    Tracer,
    child,
    self_times,
    tspan,
)
from repro_torch.serving import GraphServer  # noqa: E402

N = 400
PER_TICKET = ("query_build", "query_check", "install", "swap_in", "resolve")


def _graph():
    g = TG.scrambled(TG.powerlaw_cluster(N, 4, p=0.5, seed=1), seed=11)
    return TG.with_random_weights(g, lo=0.1, hi=1.0, seed=3)


def _serve(trace, queries=12, algos=("ppr",)):
    """A small kernel-backend server (multi-sweep, ranked) through to idle;
    ``queries`` tickets of each of ``algos`` (ppr, sssp), submitted in turn."""
    g = _graph()
    srv = GraphServer(g, slots=4, bs=64, rounds_per_batch=8, backend="kernel",
                      sweeps_per_call=4, rank=np.random.default_rng(0).permutation(N),
                      trace=trace, device="cpu")
    for s in range(queries):
        for algo in algos:
            srv.submit(algo, {"seeds": [s]} if algo == "ppr" else {"source": s})
    srv.run()
    return srv


def _ranked_solve(trace):
    g = _graph()
    algo = rt.get_algorithm("ppr", g, seeds=[1, 2, 3])
    return rt.solve(algo, backend="kernel", bs=64, sweeps_per_call=4, device="cpu",
                    rank=np.random.default_rng(1).permutation(N), trace=trace)


def test_ids_parents_and_tickets():
    tr = Tracer()
    _serve(tr)
    spans = list(tr.spans)
    names = collections.Counter(s.name for s in spans)
    assert set(names) <= set(SPAN_NAMES)
    assert {"tick", "batch", "pack", "relabel", "pack_tiles", *PER_TICKET} <= set(names)
    by_id = {s.id: s for s in spans}
    assert len(by_id) == len(spans)
    for s in spans:
        if s.parent is not None:
            p = by_id[s.parent]   # a parent finishes after its children
            assert p.t_start <= s.t_start and s.t_end <= p.t_end
    assert all(by_id[s.parent].name == "tick" for s in spans
               if s.name in ("batch", "query_build", "install", "resolve"))
    assert all(s.parent is None for s in tr.find("tick"))
    assert {by_id[s.parent].name for s in tr.find("swap_in")} <= {"install", "resolve"}
    # every per-ticket span carries its ticket, swap_in by its parent's
    tickets = collections.defaultdict(set)
    for s in spans:
        if s.name in PER_TICKET:
            tickets[s.attrs["ticket"]].add(s.name)
    assert len(tickets) == 12
    assert all({"query_build", "install", "swap_in", "resolve"} <= v for v in tickets.values())
    # the multi-sweep batch carries each sweep's share of blocks swept
    for b in tr.find("batch"):
        assert len(b.attrs["active"]) >= 1
        assert all(0.0 <= a <= 1.0 for a in b.attrs["active"])
    assert all(s.attrs["touched"] >= 1 for s in tr.find("swap_in"))
    js = spans[0].to_json()
    assert list(js)[:5] == ["name", "t_start", "duration_s", "id", "parent"]


def test_query_build_reads_the_edges_once_a_family():
    """Only a family's probe is built over the edges (``edges`` = m); every
    later ticket of the family is built from its columns (``edges`` = 0)."""
    tr = Tracer()
    srv = _serve(tr, algos=("ppr", "sssp"))
    builds = tr.find("query_build")
    assert len(builds) == 24 and srv.stats.failed == 0
    # tickets 0 and 1 open the ppr and the sssp family; the other 22 read 0
    probes = [s for s in builds if s.attrs["edges"] != 0]
    assert sorted(s.attrs["ticket"] for s in probes) == [0, 1]
    assert all(s.attrs["edges"] == srv.g.m for s in probes)
    assert len(tr.find("query_check")) == 22


def test_self_time():
    tr = Tracer()
    _serve(tr)
    recs = [s.to_json() for s in tr.spans]
    own = self_times(recs)
    assert set(own) == {r["id"] for r in recs}
    assert all(0.0 <= own[r["id"]] <= r["duration_s"] for r in recs)
    # by hand: children cover [1, 5] (two overlap) and [7, 8] of [0, 10]
    recs = [dict(name="p", t_start=0.0, duration_s=10.0, id=1, parent=None),
            dict(name="a", t_start=1.0, duration_s=2.0, id=2, parent=1),
            dict(name="b", t_start=2.0, duration_s=3.0, id=3, parent=1),
            dict(name="c", t_start=7.0, duration_s=1.0, id=4, parent=1),
            dict(name="d", t_start=7.5, duration_s=0.25, id=5, parent=4)]
    own = self_times(recs)
    assert own[1] == pytest.approx(5.0) and own[4] == pytest.approx(0.75)
    assert (own[2], own[3], own[5]) == (2.0, 3.0, 0.25)


def test_child_without_an_open_span_records_nothing():
    assert child("relabel") is NULL_SPAN
    off = Tracer(enabled=False)
    assert tspan(off, "solve") is NULL_SPAN and off.span("solve") is NULL_SPAN
    with off.span("solve"):
        assert child("relabel") is NULL_SPAN
    assert not off.spans
    tr = Tracer()
    with tr.span("solve") as sp:
        with child("relabel") as c:
            assert c is not NULL_SPAN
    assert child("relabel") is NULL_SPAN
    assert [(s.name, s.parent) for s in tr.spans] == [("relabel", sp.id), ("solve", None)]


def _profiled(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    return {e.name for e in prof.events()}


def test_profiler_holds_the_program_spans():
    names = _profiled(lambda: _serve(Tracer(), queries=6))
    assert {"repro_torch.query_build", "repro_torch.swap_in",
            "repro_torch.resolve", "repro_torch.tick"} <= names
    names = _profiled(lambda: _ranked_solve(Tracer()))
    assert {"repro_torch.solve", "repro_torch.relabel",
            "repro_torch.pack_tiles"} <= names
    off = _profiled(lambda: (_serve(None, queries=6), _ranked_solve(None)))
    assert not {n for n in off if n.startswith("repro_torch.")}
