"""The port's metric tracker, metrics registry and serving helpers against
the reference's, on the CPU.

Everything here is numpy or pure Python in both packages (the device
helpers run on CPU tensors), so results must be identical: M and per-region
M at every step of a delta script, the Prometheus text after the same
calls, and the swap/gather/support helpers bit for bit. The last test
reruns ``benchmarks/reorder_bench.py``'s procedure on the port and must
count the reference's rounds and the ones ``BENCH_reorder.json`` records.
"""
import json
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import gograph as r_gograph  # noqa: E402
from repro.core import metric as r_metric  # noqa: E402
from repro.engine import convergence as r_conv  # noqa: E402
from repro.engine import harness as r_harness  # noqa: E402
from repro.engine.algorithms import get_algorithm as r_get_algorithm  # noqa: E402
from repro.engine.api import solve as r_solve  # noqa: E402
from repro.graphs import generators as RG  # noqa: E402
from repro.graphs.delta import random_delta  # noqa: E402
from repro.obs import metrics as r_obs  # noqa: E402

from repro_torch.core import gograph as t_gograph  # noqa: E402
from repro_torch.core import metric as t_metric  # noqa: E402
from repro_torch.engine import convergence as t_conv  # noqa: E402
from repro_torch.engine import harness as t_harness  # noqa: E402
from repro_torch.engine.algorithms import get_algorithm  # noqa: E402
from repro_torch.engine.api import solve  # noqa: E402
from repro_torch.graphs.graph import Graph as TGraph  # noqa: E402
from repro_torch.interop import delta_fields, delta_from_arrays  # noqa: E402
from repro_torch.obs import metrics as t_obs  # noqa: E402

N = 320
ROOT = Path(__file__).resolve().parent.parent


def _tgraph(g) -> TGraph:
    return TGraph(g.n, g.src.copy(), g.dst.copy(), None if g.w is None else g.w.copy())


def _graph(seed=1):
    g = RG.scrambled(RG.powerlaw_cluster(N, 4, p=0.4, seed=seed), seed=9)
    return RG.with_random_weights(g, lo=0.1, hi=1.0, seed=2)


def _assert_tracker_equal(t, r):
    assert t.M == r.M and t.m_edges == r.m_edges
    np.testing.assert_array_equal(t.region_m, r.region_m)
    np.testing.assert_array_equal(t.region_edges, r.region_edges)
    np.testing.assert_array_equal(t.region_of, r.region_of)
    np.testing.assert_array_equal(t.rank, r.rank)
    np.testing.assert_array_equal(t.fractions(), r.fractions())
    assert t.m_frac == r.m_frac


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_metric_tracker_matches_reference_every_step(seed):
    """A random script of insert/delete/reweight/append deltas, with a
    regional re-rank whenever a region decays: the port's tracker equals the
    reference's (and the O(m) recount) after every delta."""
    rg = _graph(seed)
    tg = _tgraph(rg)
    rank = r_gograph.gograph_order(rg)
    rtr = r_metric.MetricTracker(rg, rank, regions=8)
    ttr = t_metric.MetricTracker(tg, rank, regions=8)
    rmaint, tmaint = r_gograph.RankMaintainer(rank), t_gograph.RankMaintainer(rank)
    _assert_tracker_equal(ttr, rtr)
    for step in range(6):
        d = random_delta(rg, frac_add=0.02, frac_del=0.01, frac_rew=0.01,
                         n_add_vertices=2 if step % 2 else 0, seed=seed * 10 + step)
        td = delta_from_arrays(delta_fields(d))
        rg, tg = d.apply(rg), td.apply(tg)
        r_rank, t_rank = rmaint.extend(rg), tmaint.extend(tg)
        np.testing.assert_array_equal(t_rank, r_rank)
        rtr.apply_delta(d, rank_new=r_rank if d.n_add else None)
        ttr.apply_delta(td, rank_new=t_rank if td.n_add else None)
        _assert_tracker_equal(ttr, rtr)
        assert ttr.M == t_metric.metric_m(tg, t_rank)
        dec = rtr.decayed_regions(0.55)
        np.testing.assert_array_equal(ttr.decayed_regions(0.55), dec)
        if len(dec):
            members = rtr.region_members(dec)
            np.testing.assert_array_equal(ttr.region_members(dec), members)
            r_rank = r_gograph.regional_rerank(rg, r_rank, members)
            t_rank = t_gograph.regional_rerank(tg, t_rank, members)
            np.testing.assert_array_equal(t_rank, r_rank)
            rtr.rebase(rg, r_rank)
            ttr.rebase(tg, t_rank)
            rmaint, tmaint = r_gograph.RankMaintainer(r_rank), t_gograph.RankMaintainer(t_rank)
            _assert_tracker_equal(ttr, rtr)


def test_metric_tracker_validation_matches_reference():
    rg = _graph()
    tg = _tgraph(rg)
    rank = np.arange(rg.n)
    for bad in ({"regions": 0},):
        with pytest.raises(ValueError, match="regions"):
            t_metric.MetricTracker(tg, rank, **bad)
    with pytest.raises(ValueError, match="shape"):
        t_metric.MetricTracker(tg, rank[:-1])
    d = random_delta(rg, frac_add=0.01, n_add_vertices=1, seed=3)
    with pytest.raises(ValueError, match="rank_new"):
        t_metric.MetricTracker(tg, rank).apply_delta(delta_from_arrays(delta_fields(d)))


def test_edge_span_and_metric_table_match_reference():
    rg = _graph()
    tg = _tgraph(rg)
    ranks = {"id": np.arange(rg.n), "gograph": r_gograph.gograph_order(rg)}
    for r in ranks.values():
        assert t_metric.edge_span(tg, r) == r_metric.edge_span(rg, r)
    assert t_metric.metric_table(tg, ranks, bs=16) == r_metric.metric_table(rg, ranks, bs=16)
    empty = TGraph(3, np.zeros(0, np.int32), np.zeros(0, np.int32))
    assert t_metric.edge_span(empty, np.arange(3)) == 0.0


def _drive_registry(mod):
    reg = mod.MetricsRegistry(max_samples=8)
    c = reg.counter("repro_q_total", "Queries", ("tenant",))
    g = reg.gauge("repro_occ", "Occupancy")
    h = reg.histogram("repro_lat_seconds", "Latency", ("tenant", "family"))
    hr = reg.histogram("repro_rounds", "Rounds", ("tenant",), buckets=(1.0, 4.0, 16.0))
    rng = np.random.default_rng(5)
    for i in range(40):
        ten = ["a", 'b"\\x', "c\nd"][i % 3]
        c.inc(int(rng.integers(0, 3)), tenant=ten)
        g.set(float(rng.random()))
        h.observe(float(rng.exponential(0.3)), tenant=ten, family=["ppr", "sssp"][i % 2])
        hr.observe(int(rng.integers(0, 30)), tenant=ten)
    assert reg.counter("repro_q_total", "Queries", ("tenant",)) is c
    with pytest.raises(ValueError, match="re-declared"):
        reg.gauge("repro_q_total", "x", ("tenant",))
    with pytest.raises(ValueError, match="labels"):
        c.inc(tenant="a", extra="b")
    with pytest.raises(ValueError, match="only go up"):
        c.inc(-1, tenant="a")
    return reg, c, h


def test_metrics_registry_prometheus_text_matches_reference():
    t_reg, t_c, t_h = _drive_registry(t_obs)
    r_reg, r_c, r_h = _drive_registry(r_obs)
    assert t_reg.prometheus_text() == r_reg.prometheus_text()
    assert t_reg.summary() == r_reg.summary()
    assert t_c.per_label("tenant") == r_c.per_label("tenant")
    for q in (0, 50, 99, 100):
        assert t_h.percentile(q) == r_h.percentile(q)
        assert t_h.percentile(q, tenant="a", family="ppr") == \
            r_h.percentile(q, tenant="a", family="ppr")
    assert t_obs.MetricsRegistry().prometheus_text() == ""


@pytest.mark.parametrize("q", [0, 1, 37.5, 50, 99, 100])
def test_percentile_and_bounded_append_match_reference(q):
    rng = np.random.default_rng(int(q * 10))
    for size in (0, 1, 7, 100):
        vals = rng.normal(size=size).tolist()
        assert t_obs.percentile(vals, q) == r_obs.percentile(vals, q)
    a, b = [], []
    for v in range(50):
        t_obs.bounded_append(a, v, 16)
        r_obs.bounded_append(b, v, 16)
    assert a == b


def test_trim_trace_matches_reference():
    res = np.arange(10, dtype=np.float32)
    sums = -np.arange(10, dtype=np.float32)
    for k in (0, 3, 10, 12):
        got = t_conv.trim_trace(res, sums, k)
        want = r_conv.trim_trace(res, sums, k)
        for a, b in zip(got, want, strict=True):
            np.testing.assert_array_equal(a, b)


def test_reinit_columns_on_tensors_matches_numpy():
    done = np.array([True, True, False, True])
    rounds = np.array([5, 9, 3, 7], np.int32)
    want = r_conv.reinit_columns(done, rounds, [1, 3])
    td, tr = torch.from_numpy(done.copy()), torch.from_numpy(rounds.copy())
    got = t_conv.reinit_columns(td, tr, [1, 3])
    np.testing.assert_array_equal(got[0].numpy(), want[0])
    np.testing.assert_array_equal(got[1].numpy(), want[1])
    assert bool(td[1]) and int(tr[1]) == 9  # inputs untouched


@pytest.mark.parametrize("algo", ["sssp", "ppr", "reachability"])
def test_column_support_matches_reference(algo):
    rg = _graph()
    p = {"seeds": [4]} if algo == "ppr" else {"source": 4}
    q = r_get_algorithm(algo, rg, **p)
    x = np.asarray(r_solve(q, bs=64).x)
    assert t_harness.X0_FILL == r_harness.X0_FILL
    for xs in (None, x):
        kw = dict(reduce=q.semiring.reduce, c_fill=q.c_pad_fill, x=xs)
        np.testing.assert_array_equal(
            t_harness.column_support(q.x0[:, 0], q.c[:, 0], q.fixed[:, 0], **kw),
            r_harness.column_support(q.x0[:, 0], q.c[:, 0], q.fixed[:, 0], **kw),
        )


@pytest.mark.parametrize("fixed_dtype", [np.bool_, np.float32])
def test_swap_in_column_matches_reference(fixed_dtype):
    """Host and device column swaps equal the reference's on the packed
    operands of a 3-column family, padding rows kept."""
    rg = _graph()
    q = r_get_algorithm("sssp", rg, source=7)
    n, d, bs = q.n, 3, 64
    npad = -(-n // bs) * bs
    rng = np.random.default_rng(0)
    x = rng.normal(size=(npad, d)).astype(np.float32)
    x0 = np.full((npad, d), q.semiring.identity, np.float32)
    c = np.full((npad, d), q.c_pad_fill, np.float32)
    fixed = np.ones((npad, d), fixed_dtype)
    args = (1, n, q.x0[:, 0], q.c[:, 0], q.fixed[:, 0])
    host = [a.copy() for a in (x, x0, c, fixed)]
    r_host = [a.copy() for a in (x, x0, c, fixed)]
    t_harness.swap_in_column(*host, *args)
    r_harness.swap_in_column(*r_host, *args)
    for a, b in zip(host, r_host, strict=True):
        np.testing.assert_array_equal(a, b)
    fills = dict(x0_fill=q.semiring.identity, c_fill=q.c_pad_fill)
    got = t_harness.swap_in_column_device(
        *(torch.from_numpy(a.copy()) for a in (x, x0, c, fixed)), *args, **fills)
    want = r_harness.swap_in_column_device(x, x0, c, fixed, *args, **fills)
    for a, b in zip(got, want, strict=True):
        assert a.numpy().dtype == np.asarray(b).dtype
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert (got[1].numpy()[n:] == q.semiring.identity).all()


def test_gather_rows_matches_reference():
    rng = np.random.default_rng(3)
    x = rng.normal(size=(50, 4)).astype(np.float32)
    idx = rng.permutation(50)
    want = np.asarray(r_harness.gather_rows(x, idx))
    np.testing.assert_array_equal(t_harness.gather_rows(torch.from_numpy(x), idx).numpy(), want)
    got = t_harness.gather_rows(torch.from_numpy(x[:, 1].copy()), torch.from_numpy(idx))
    np.testing.assert_array_equal(got.numpy(), want[:, 1])


# ---------------------------------------------------------------------------
# benchmarks/reorder_bench.py's procedure on the port
# ---------------------------------------------------------------------------

def _reorder_stream():
    """The benchmark's full-size stream (not the fast one): a shuffled
    2,048-vertex path, 8 segment reversals of 170 hops, 4 tail vertices
    after every second one."""
    from benchmarks.reorder_bench import _extend_tail, _reverse_segment, _shuffled_path

    n, n_deltas, seed = 2048, 8, 23
    seg = n // 12
    g, rank, chain = _shuffled_path(n, seed)
    rng = np.random.default_rng(seed)
    deltas, chunk = [], (n - 2) // n_deltas
    for i in range(n_deltas):
        lo = 1 + i * chunk + int(rng.integers(0, max(1, chunk - seg - 2)))
        deltas.append(_reverse_segment(chain, lo, lo + seg))
        if i % 2 == 1:
            deltas.append(_extend_tail(chain, len(chain), 4))
    return g, rank, chain[0], deltas


def _orders(pkg, g, rank0, deltas):
    """(fresh, online, decayed) ranks after the stream, and the re-ranks."""
    decay, online = pkg["maint"](rank0), pkg["maint"](rank0)
    tracker = pkg["tracker"](g, rank0, regions=16)
    reranks = 0
    for d in deltas:
        g = d.apply(g)
        rank_decay, rank_online = decay.extend(g), online.extend(g)
        tracker.apply_delta(d, rank_new=rank_online if d.n_add else None)
        assert tracker.M == pkg["metric_m"](g, rank_online)
        decayed = tracker.decayed_regions(0.9)
        if len(decayed):
            rank_online = pkg["rerank"](g, rank_online, tracker.region_members(decayed))
            tracker.rebase(g, rank_online)
            online = pkg["maint"](rank_online)
            reranks += 1
    return g, {"fresh": pkg["gograph"](g), "online": rank_online,
               "decayed": rank_decay}, reranks


def test_reorder_bench_procedure_reproduces_reference_rounds():
    rg0, rank0, head, r_deltas = _reorder_stream()
    ref = {"maint": r_gograph.RankMaintainer, "tracker": r_metric.MetricTracker,
           "metric_m": r_metric.metric_m, "rerank": r_gograph.regional_rerank,
           "gograph": r_gograph.gograph_order}
    port = {"maint": t_gograph.RankMaintainer, "tracker": t_metric.MetricTracker,
            "metric_m": t_metric.metric_m, "rerank": t_gograph.regional_rerank,
            "gograph": t_gograph.gograph_order}
    rg, r_ranks, r_reranks = _orders(ref, rg0, rank0, r_deltas)
    tg, t_ranks, t_reranks = _orders(
        port, _tgraph(rg0), rank0, [delta_from_arrays(delta_fields(d)) for d in r_deltas])
    assert t_reranks == r_reranks
    got, want = {}, {}
    for name in ("fresh", "online", "decayed"):
        np.testing.assert_array_equal(t_ranks[name], r_ranks[name])
        got[name] = solve(get_algorithm("sssp", tg, source=head), engine="async_block",
                          bs=8, inner=8, rank=t_ranks[name], device="cpu").rounds
        want[name] = r_solve(r_get_algorithm("sssp", rg, source=head), engine="async_block",
                             bs=8, inner=8, rank=r_ranks[name]).rounds
    assert got == want
    bench = json.loads((ROOT / "BENCH_reorder.json").read_text())
    assert got == bench["rounds"] == {"fresh": 4, "online": 10, "decayed": 171}
    assert t_reranks == bench["reranks"] == 8
