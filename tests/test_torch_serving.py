"""The port's GraphServer against the reference's, on the CPU.

Both servers get the same graph, the same tickets in the same ticks and the
same deltas (numpy, carried with `repro_torch.interop`). Backends pair up as
torch <-> jax and kernel <-> pallas (the reference interprets its Pallas
kernel off-TPU; the port runs its kernel's plain version on CPU tensors).
Lattice tickets (sssp, bfs) must match bitwise in state and rounds; PPR
tickets within ``atol=1e-5`` and one round (their stopping round is float32
noise of the summation order).
"""
import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

torch = pytest.importorskip("torch")

from repro.engine import get_algorithm as r_get_algorithm  # noqa: E402
from repro.engine import run_async_block as r_run_async_block  # noqa: E402
from repro.graphs import generators as RG  # noqa: E402
from repro.graphs.delta import GraphDelta as RDelta  # noqa: E402
from repro.graphs.delta import random_delta  # noqa: E402
from repro.graphs.graph import Graph as RGraph  # noqa: E402
from repro.serving import GraphServer as RServer  # noqa: E402

import repro_torch as rt  # noqa: E402
from repro_torch.engine.async_block import AsyncBlockSession  # noqa: E402
from repro_torch.graphs.graph import Graph as TGraph  # noqa: E402
from repro_torch.interop import algo_from_arrays, algo_fields  # noqa: E402
from repro_torch.interop import delta_fields, delta_from_arrays  # noqa: E402
from repro_torch.serving import GraphServer, Scheduler, family_key  # noqa: E402
from repro_torch.serving.scheduler import COLUMN_PARAMS, canon  # noqa: E402

N = 350
BS = 64
BACKENDS = {"torch": "jax", "kernel": "pallas"}
SUM_ALGOS = ("ppr", "pagerank", "katz", "php", "adsorption")


def _tgraph(g) -> TGraph:
    return TGraph(g.n, g.src.copy(), g.dst.copy(), None if g.w is None else g.w.copy())


def _tdelta(d):
    return delta_from_arrays(delta_fields(d))


def _base_graph():
    g = RG.scrambled(RG.powerlaw_cluster(N, 4, p=0.4, seed=1), seed=9)
    return RG.with_random_weights(g, lo=0.1, hi=1.0, seed=2)


GW = _base_graph()
TGW = _tgraph(GW)


def _servers(rgraph=GW, backend="torch", **kw):
    """A reference server and a port server with the same knobs; the port's
    on the CPU."""
    r = RServer(rgraph, backend=BACKENDS[backend], **kw)
    t = GraphServer(_tgraph(rgraph), backend=backend, device="cpu", **kw)
    return r, t


def _check_pair(t, r):
    """The port's ticket against the reference's ticket for one query."""
    assert t.done and r.done, (t.status, r.status)
    assert (t.status, t.converged, t.from_cache) == (r.status, r.converged, r.from_cache)
    if t.status == "failed":
        assert t.error == r.error
        return
    assert t.result.shape == r.result.shape
    if t.algo in SUM_ALGOS:
        np.testing.assert_allclose(t.result, r.result, atol=1e-5, rtol=0)
        assert abs(t.rounds - r.rounds) <= 1, (t.rounds, r.rounds)
    else:
        np.testing.assert_array_equal(t.result, r.result, err_msg=str(t.params))
        assert t.rounds == r.rounds, (t.params, t.rounds, r.rounds)


def _submit_both(r, t, algo, params, **kw):
    return r.submit(algo, params, **kw), t.submit(algo, params, **kw)


def _params(algo, src):
    return {"seeds": [src]} if algo == "ppr" else {"source": src}


# ---------------------------------------------------------------------------
# any arrival schedule: the port's tickets == the reference's
# ---------------------------------------------------------------------------

@st.composite
def schedules(draw):
    n_q = draw(st.integers(3, 9))
    queries = sorted(
        (
            draw(st.integers(0, 5)),                       # arrival tick
            draw(st.sampled_from(["sssp", "bfs", "ppr"])),
            draw(st.integers(0, N - 1)),                   # source/seed
            draw(st.integers(0, 3)),                       # priority
        )
        for _ in range(n_q)
    )
    rpb = draw(st.sampled_from([1, 2, 3, 5]))
    slots = draw(st.sampled_from([2, 3, 4]))
    policy = draw(st.sampled_from(["fifo", "priority", "deadline"]))
    return queries, rpb, slots, policy


@given(schedules())
@settings(max_examples=6, deadline=None)
def test_any_arrival_schedule_matches_reference_server(schedule):
    queries, rpb, slots, policy = schedule
    r, t = _servers(slots=slots, bs=BS, rounds_per_batch=rpb, policy=policy,
                    cache=False)
    pending = list(queries)
    pairs = []
    tick = 0
    while pending or t.scheduler.total_pending() or t._busy():
        while pending and pending[0][0] <= tick:
            _, algo, src, prio = pending.pop(0)
            pairs.append(_submit_both(r, t, algo, _params(algo, src), priority=prio))
        r.step()
        t.step()
        tick += 1
    assert not (r.scheduler.total_pending() or r._busy())
    for rt_, tt in pairs:
        _check_pair(tt, rt_)
    if not any(tt.algo == "ppr" for _, tt in pairs):   # lattice rounds are exact
        assert t.stats.rounds_total == r.stats.rounds_total


@pytest.mark.parametrize("sweeps", [1, 2])
def test_kernel_backend_matches_reference_pallas(sweeps):
    """backend="kernel" (the kernel's plain version here) against the
    reference's interpreted Pallas kernel, one sweep per launch and two."""
    r, t = _servers(backend="kernel", slots=2, bs=BS, rounds_per_batch=2,
                    sweeps_per_call=sweeps, cache=False)
    qs = [("sssp", 0), ("ppr", 7), ("sssp", 100), ("bfs", 3), ("ppr", 200)]
    pairs = [_submit_both(r, t, a, _params(a, s)) for a, s in qs]
    r.run()
    t.run()
    for rt_, tt in pairs:
        _check_pair(tt, rt_)
    # lattice tickets also equal a solo run of the reference
    for (a, s), (_, tt) in zip(qs, pairs, strict=True):
        if a != "ppr":
            solo = r_run_async_block(r_get_algorithm(a, GW, **_params(a, s)), bs=BS)
            assert tt.rounds == solo.rounds
            np.testing.assert_array_equal(tt.result, solo.x)


def test_session_report_and_accounting_match_reference():
    """AsyncBlockSession alone: the per-batch reports and the cumulative
    accounting across a swap equal the reference session's."""
    from repro.engine.async_block import AsyncBlockSession as RSession

    rq = r_get_algorithm("ms_sssp", GW, sources=[0, 5, 9])
    tq = algo_from_arrays(algo_fields(rq))
    rs = RSession(rq, bs=BS, backend="pallas", sweeps_per_call=2)
    ts = AsyncBlockSession(tq, bs=BS, backend="kernel", sweeps_per_call=2, device="cpu")
    nq = r_get_algorithm("sssp", GW, source=33)
    for step in range(5):
        rrep, trep = rs.run_batch(2), ts.run_batch(2)
        assert trep.rounds == rrep.rounds
        np.testing.assert_array_equal(trep.col_done, rrep.col_done)
        np.testing.assert_array_equal(trep.col_rounds, rrep.col_rounds)
        np.testing.assert_array_equal(ts.col_rounds.numpy(), np.asarray(rs.col_rounds))
        np.testing.assert_array_equal(ts.col_done.numpy(), np.asarray(rs.col_done))
        np.testing.assert_array_equal(ts.state.numpy(), np.asarray(rs.state))
        np.testing.assert_array_equal(ts.dirty.numpy(), np.asarray(rs.dirty))
        if step == 1:
            for s in (rs, ts):
                s.swap_in(1, nq.x0[:, 0], nq.c[:, 0], nq.fixed[:, 0])
    with pytest.raises(ValueError, match="multiple"):
        ts.run_batch(3)


# ---------------------------------------------------------------------------
# live deltas, push absorption, cache
# ---------------------------------------------------------------------------

def _delta_run(delta_mode, loosening, backend, push_threshold=0.0):
    kw = dict(slots=3, bs=BS, rounds_per_batch=2, delta_mode=delta_mode,
              push_threshold=push_threshold)
    if backend == "kernel":
        kw["sweeps_per_call"] = 2
    r, t = _servers(backend=backend, **kw)
    pairs = [_submit_both(r, t, "sssp", {"source": 0}),
             _submit_both(r, t, "ppr", {"seeds": [7]})]
    r.step()
    t.step()
    assert pairs[0][1].status == "running"   # mid-convergence when it lands
    delta = random_delta(
        GW, frac_add=0.01 if push_threshold == 0 else 0.001,
        frac_del=0.003 if loosening else 0.0,
        frac_rew=0.003 if loosening else 0.0,
        n_add_vertices=3, seed=5,
    )
    r.apply_delta(delta)
    t.apply_delta(_tdelta(delta))
    assert t.graph_version == r.graph_version == 1
    # arrives the same batch the delta lands: runs on the new graph
    pairs.append(_submit_both(r, t, "sssp", {"source": 11}))
    r.run()
    t.run()
    return r, t, pairs


@pytest.mark.parametrize("backend", ["torch", "kernel"])
@pytest.mark.parametrize("delta_mode", ["warm", "restart"])
@pytest.mark.parametrize("loosening", [False, True])
def test_delta_in_flight_matches_reference(delta_mode, loosening, backend):
    r, t, pairs = _delta_run(delta_mode, loosening, backend)
    assert t.g.n == r.g.n == N + 3
    for rt_, tt in pairs:
        _check_pair(tt, rt_)
    # the in-flight lattice query reaches the new fixpoint bit for bit
    solo = r_run_async_block(r_get_algorithm("sssp", r.g, source=0), bs=BS)
    np.testing.assert_array_equal(pairs[0][1].result, solo.x)


@pytest.mark.parametrize("backend", ["torch", "kernel"])
def test_push_absorption_matches_reference(backend):
    """A sparse warm delta (depth-1 closure under the threshold) is absorbed
    by the push engine during the rebuild in both servers."""
    r, t, pairs = _delta_run("warm", False, backend, push_threshold=0.5)
    for rt_, tt in pairs:
        _check_pair(tt, rt_)
    solo = r_run_async_block(r_get_algorithm("sssp", r.g, source=0), bs=BS)
    np.testing.assert_array_equal(pairs[0][1].result, solo.x)


def test_push_absorption_runs_the_torch_push(monkeypatch):
    from repro_torch.engine import api

    calls = []
    real = api.solve

    def spy(algo, engine="async_block", options=None, **kw):
        calls.append((engine, kw.get("backend"), kw.get("device")))
        return real(algo, engine, options, **kw)

    monkeypatch.setattr(api, "solve", spy)
    _delta_run("warm", False, "kernel", push_threshold=0.5)
    assert calls and set(calls) == {("push", "torch", "cpu")}


def _two_component_graph():
    ga = RG.powerlaw_cluster(3 * BS, 4, p=0.3, seed=3)
    gb = RG.powerlaw_cluster(3 * BS, 4, p=0.3, seed=4)
    g = RGraph(ga.n + gb.n, np.concatenate([ga.src, gb.src + ga.n]),
               np.concatenate([ga.dst, gb.dst + ga.n]))
    return RG.with_random_weights(g, lo=0.1, hi=1.0, seed=7), ga.n


def test_cache_promotion_and_invalidation_match_reference():
    g2c, n_a = _two_component_graph()
    r, t = _servers(g2c, slots=2, bs=BS, rounds_per_batch=4)
    pairs = [_submit_both(r, t, "sssp", {"source": 5}),
             _submit_both(r, t, "sssp", {"source": n_a + 5})]
    r.run()
    t.run()
    delta = RDelta(add_src=[n_a + 10, n_a + 40], add_dst=[n_a + 90, n_a + 120],
                   add_w=[0.5, 0.5])
    r.apply_delta(delta)
    t.apply_delta(_tdelta(delta))
    hit = _submit_both(r, t, "sssp", {"source": 5})
    miss = _submit_both(r, t, "sssp", {"source": n_a + 5})
    assert hit[1].status == "cached" and miss[1].status != "cached"
    r.run()
    t.run()
    # a vertex appended to component B extends the promoted A entry
    grow = RDelta(n_add=1, add_src=[n_a + 3], add_dst=[g2c.n], add_w=[0.5])
    r.apply_delta(grow)
    t.apply_delta(_tdelta(grow))
    ext = _submit_both(r, t, "sssp", {"source": 5})
    assert ext[1].status == "cached" and ext[1].result.shape == (g2c.n + 1,)
    for rt_, tt in pairs + [hit, miss, ext]:
        _check_pair(tt, rt_)
    assert t.cache.stats() == r.cache.stats()
    assert t.cache.stats()["promoted"] >= 2


def test_cache_budget_and_resubmit_match_reference():
    per_entry = GW.n * 4 + 256
    r, t = _servers(slots=2, bs=BS, rounds_per_batch=4, cache_max_bytes=2 * per_entry)
    pairs = [_submit_both(r, t, "ppr", {"seeds": [s]}) for s in (0, 3, 9, 14)]
    r.run()
    t.run()
    pairs.append(_submit_both(r, t, "ppr", {"seeds": [14]}))
    for rt_, tt in pairs:
        _check_pair(tt, rt_)
    assert pairs[-1][1].from_cache
    assert t.cache.stats() == r.cache.stats()
    assert t.stats.cache_hits == r.stats.cache_hits == 1


# ---------------------------------------------------------------------------
# tenants, policies, refill, swap_order, telemetry
# ---------------------------------------------------------------------------

def _second_graph():
    g = RG.scrambled(RG.powerlaw_cluster(N + 40, 4, p=0.4, seed=11), seed=3)
    return RG.with_random_weights(g, lo=0.1, hi=1.0, seed=4)


def test_multi_tenant_fairness_and_scoped_delta_match_reference():
    gw2 = _second_graph()
    r = RServer(graphs={"a": GW, "b": gw2}, slots=2, bs=BS, rounds_per_batch=2)
    t = GraphServer(graphs={"a": TGW, "b": _tgraph(gw2)}, slots=2, bs=BS,
                    rounds_per_batch=2, device="cpu")
    pairs = []
    for s in (0, 3, 9, 14):
        pairs.append(_submit_both(r, t, "ppr", {"seeds": [s]}, tenant="a"))
        pairs.append(_submit_both(r, t, "sssp", {"source": s}, tenant="b"))
    r.run()
    t.run()
    tb = t.stats.tenant_batches
    assert tb == r.stats.tenant_batches and abs(tb["a"] - tb["b"]) <= 1
    delta = random_delta(GW, frac_add=0.01, seed=5)
    r.apply_delta(delta, tenant="a")
    t.apply_delta(_tdelta(delta), tenant="a")
    assert (t.tenants["a"].graph_version, t.tenants["b"].graph_version) == (1, 0)
    pairs.append(_submit_both(r, t, "sssp", {"source": 3}, tenant="b"))
    pairs.append(_submit_both(r, t, "ppr", {"seeds": [3]}, tenant="a"))
    assert pairs[-2][1].from_cache and not pairs[-1][1].from_cache
    r.run()
    t.run()
    for rt_, tt in pairs:
        _check_pair(tt, rt_)
    with pytest.raises(KeyError, match="unknown tenant"):
        t.submit("sssp", {"source": 0}, tenant="nope")
    with pytest.raises(ValueError, match="duplicate tenant"):
        t.add_tenant("b", TGW)


@pytest.mark.parametrize("policy,submits,want", [
    ("priority", [("lo", 3, {"priority": 0}), ("hi", 17, {"priority": 5}),
                  ("mid", 29, {"priority": 2})], ["hi", "mid", "lo"]),
    ("deadline", [("late", 3, {"deadline": 100.0}), ("soon", 17, {"deadline": 1.0}),
                  ("none", 29, {})], ["soon", "late", "none"]),
    ("fifo", [("a", 3, {"priority": 0}), ("b", 17, {"priority": 9}), ("c", 29, {})],
     ["a", "b", "c"]),
])
def test_policies_order_admission_as_reference(policy, submits, want):
    r, t = _servers(slots=1, bs=BS, rounds_per_batch=4, policy=policy, cache=False)
    pairs = {label: _submit_both(r, t, "sssp", {"source": s}, **kw)
             for label, s, kw in submits}
    r.run()
    t.run()
    for rt_, tt in pairs.values():
        _check_pair(tt, rt_)
    order = sorted(pairs, key=lambda k: pairs[k][1].resolved_at)
    assert order == want == sorted(pairs, key=lambda k: pairs[k][0].resolved_at)


def test_scheduler_and_family_key_match_reference():
    from repro.serving import scheduler as RS

    assert COLUMN_PARAMS == RS.COLUMN_PARAMS
    for algo, params in [("sssp", {"source": 1}), ("sssp", {"source": 1, "eps": 2.5}),
                         ("ppr", {"seeds": np.array([3, 4])}),
                         ("pagerank", {"damping": np.float32(0.5)}), ("custom", {"a": [1]})]:
        assert family_key(algo, params) == RS.family_key(algo, params)
        assert canon(params) == RS.canon(params)
    with pytest.raises(ValueError, match="policy"):
        Scheduler("lifo")


def test_static_refill_and_validation_match_reference():
    for refill in ("continuous", "static"):
        r, t = _servers(slots=2, bs=BS, rounds_per_batch=2, refill=refill, cache=False)
        pairs = [_submit_both(r, t, "sssp", {"source": s}) for s in (0, 7, 100, 250)]
        pairs.append(_submit_both(r, t, "ppr", {"seeds": [1, 2, 3]}))   # d = 3
        pairs.append(_submit_both(r, t, "sssp", {"source": N + 5}))     # out of range
        r.run()
        t.run()
        for rt_, tt in pairs:
            _check_pair(tt, rt_)
        assert t.stats.rounds_total == r.stats.rounds_total
        assert t.stats.failed == r.stats.failed == 2
    with pytest.raises(KeyError, match="unknown algorithm"):
        t.submit("dijkstra", {})
    for bad in ({"refill": "lazy"}, {"slots": 0}, {"rounds_per_batch": 0},
                {"rounds_per_batch": 3, "sweeps_per_call": 2}, {"delta_mode": "x"},
                {"transfer_guard": "sometimes"}, {"push_threshold": 2.0}):
        with pytest.raises(ValueError):
            GraphServer(TGW, device="cpu", **bad)


def test_swap_order_and_online_reorder_match_reference():
    """An explicit order swap mid-run, then a reweighting delta with online
    reordering armed: tickets match the reference, and so do the re-ranks."""
    from repro.core.gograph import gograph_order as r_gograph_order

    rank = r_gograph_order(GW)
    kw = dict(rank=rank, slots=3, bs=BS, rounds_per_batch=2, backend="kernel",
              sweeps_per_call=2, reorder_threshold=0.9, reorder_regions=4)
    r = RServer(GW, **{**kw, "backend": "pallas"})
    t = GraphServer(TGW, device="cpu", **kw)
    pairs = [_submit_both(r, t, a, _params(a, s))
             for a, s in [("sssp", 0), ("ppr", 7), ("bfs", 40), ("sssp", 90)]]
    r.step()
    t.step()
    new_rank = np.random.default_rng(4).permutation(N)
    r.swap_order(new_rank)
    t.swap_order(new_rank)
    r.step()
    t.step()
    delta = random_delta(GW, frac_add=0.02, frac_del=0.01, seed=12)
    r.apply_delta(delta)
    t.apply_delta(_tdelta(delta))
    pairs.append(_submit_both(r, t, "sssp", {"source": 5}))
    r.run()
    t.run()
    np.testing.assert_array_equal(t.tenants["default"].rank, r.tenants["default"].rank)
    assert t.stats.reorders == r.stats.reorders and t.stats.reorders["default"] >= 2
    for rt_, tt in pairs:
        _check_pair(tt, rt_)


def test_metrics_text_and_trace_match_reference():
    from repro.obs.trace import Tracer as RTracer
    from repro_torch.obs.trace import Tracer

    r_tr, t_tr = RTracer(), Tracer()
    r = RServer(GW, slots=2, bs=BS, rounds_per_batch=2, trace=r_tr)
    t = GraphServer(TGW, slots=2, bs=BS, rounds_per_batch=2, trace=t_tr, device="cpu")
    for a, s in [("sssp", 0), ("sssp", 9), ("bfs", 3)]:
        _submit_both(r, t, a, _params(a, s))
    r.run()
    t.run()
    _submit_both(r, t, "sssp", {"source": 0})   # a cache hit
    delta = random_delta(GW, frac_add=0.01, seed=2)
    r.apply_delta(delta)
    t.apply_delta(_tdelta(delta))

    def strip_time(text):
        return [ln for ln in text.splitlines()
                if "seconds" not in ln]   # latency / wait are wall clocks

    assert strip_time(t.metrics_text()) == strip_time(r.metrics_text())
    names = [s.name for s in t_tr.spans]
    assert names == [s.name for s in r_tr.spans]
    assert {"pack", "batch", "sweep_call", "resolve", "delta_apply"} >= set(names) - {"solve"}
    with pytest.raises(TypeError, match="Tracer"):
        GraphServer(TGW, trace=r_tr, device="cpu")


def test_top_level_exports():
    assert rt.GraphServer is GraphServer
    assert rt.Ticket.__name__ == "Ticket"
