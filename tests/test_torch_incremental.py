"""The port's graph deltas and incremental engine against the reference's,
on the CPU.

Deltas, edge diffs, warm states, dense residuals and affected regions are
numpy in both packages and must be identical. ``run_incremental`` gets the
same instances and the same prior state (numpy) in both packages; backends
pair up as torch <-> jax and kernel <-> pallas. Lattice results (sssp, sswp,
batched ms_sssp) are compared exactly; the sum results (a batched PPR) are
held to ``atol=20*eps, rtol=1e-5`` and rounds within one, the tolerance of
the push engine against the sweeps.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro  # noqa: E402
import repro.engine.api as R_api  # noqa: E402
from repro.core.gograph import gograph_order as r_gograph_order  # noqa: E402
from repro.engine import incremental as RI  # noqa: E402
from repro.engine import remake as r_remake  # noqa: E402
from repro.graphs import delta as RD  # noqa: E402
from repro.graphs import generators as RG  # noqa: E402
from repro.graphs.graph import Graph as RGraph  # noqa: E402

import repro_torch as rt  # noqa: E402
import repro_torch.engine.api as T_api  # noqa: E402
from repro_torch.engine import incremental as TI  # noqa: E402
from repro_torch.engine.algorithms import remake  # noqa: E402
from repro_torch.graphs import delta as TD  # noqa: E402
from repro_torch.graphs.graph import Graph as TGraph  # noqa: E402
from repro_torch.interop import (  # noqa: E402
    algo_fields, algo_from_arrays, delta_fields, delta_from_arrays,
)

N = 300
_G = {}


def _graphs():
    if not _G:
        g = RG.scrambled(RG.powerlaw_cluster(N, 4, p=0.4, seed=1), seed=9)
        _G["g"] = g
        _G["gw"] = RG.with_random_weights(g, lo=0.1, hi=1.0, seed=2)
    return _G["g"], _G["gw"]


def _tgraph(g) -> TGraph:
    return TGraph(g.n, g.src.copy(), g.dst.copy(), None if g.w is None else g.w.copy())


DELTAS = {
    "insert": dict(frac_add=0.02),
    "churn": dict(frac_add=0.02, frac_del=0.01, frac_rew=0.01, n_add_vertices=3),
}


def _same_graph(a, b):
    assert a.n == b.n
    for f in ("src", "dst", "weights"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
        assert getattr(a, f).dtype == getattr(b, f).dtype


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("kind", sorted(DELTAS))
@pytest.mark.parametrize("seed", [0, 3])
def test_random_delta_and_apply_identical(kind, weighted, seed):
    g = _graphs()[1 if weighted else 0]
    kw = dict(DELTAS[kind], w_lo=0.1, w_hi=1.0, seed=seed)
    rd = RD.random_delta(g, **kw)
    td = TD.random_delta(_tgraph(g), **kw)
    rf, tf = delta_fields(rd), delta_fields(td)
    assert rf.keys() == tf.keys()
    for k in rf:
        if rf[k] is None:
            assert tf[k] is None
        else:
            np.testing.assert_array_equal(tf[k], rf[k])
            assert np.asarray(tf[k]).dtype == np.asarray(rf[k]).dtype
    assert td.size == rd.size
    _same_graph(td.apply(_tgraph(g)), rd.apply(g))
    # carried across as plain data, the reference's delta applies the same
    _same_graph(delta_from_arrays(rf).apply(_tgraph(g)), rd.apply(g))


def test_apply_semantics_and_rejections_identical():
    w = np.array([1.0, 2.0, 3.0], np.float32)
    kw = dict(n_add=1, add_src=[3, 4], add_dst=[4, 0], add_w=[5.0, 6.0],
              del_src=[0], del_dst=[1], rew_src=[1], rew_dst=[2], rew_w=[9.0])
    rg2 = RD.GraphDelta(**kw).apply(RGraph(4, [0, 1, 2], [1, 2, 3], w))
    tg2 = TD.GraphDelta(**kw).apply(TGraph(4, [0, 1, 2], [1, 2, 3], w))
    _same_graph(tg2, rg2)
    for bad in (dict(del_src=[0], del_dst=[9]), dict(rew_src=[7], rew_dst=[0], rew_w=[1.0])):
        with pytest.raises(ValueError, match="out of range"):
            RD.GraphDelta(**bad).apply(RGraph(4, [0], [1]))
        with pytest.raises(ValueError, match="out of range"):
            TD.GraphDelta(**bad).apply(TGraph(4, [0], [1]))
    for bad in (dict(add_src=[0, 1], add_dst=[1]), dict(n_add=-1)):
        with pytest.raises(ValueError):
            RD.GraphDelta(**bad)
        with pytest.raises(ValueError):
            TD.GraphDelta(**bad)


@pytest.mark.parametrize("depth", [0, 1, 2])
def test_out_closure_and_touched_vertices_identical(depth):
    g = _graphs()[0]
    seeds = np.array([3, 50, 77])
    mask = np.zeros(N, bool)
    mask[seeds] = True
    for s in (seeds, mask):
        np.testing.assert_array_equal(
            TD.out_closure(g.src, g.dst, s, N, depth=depth),
            RD.out_closure(g.src, g.dst, s, N, depth=depth))
    rd = RD.random_delta(g, **DELTAS["churn"], seed=5)
    td = delta_from_arrays(delta_fields(rd))
    g2 = rd.apply(g)
    np.testing.assert_array_equal(
        td.touched_vertices(_tgraph(g2), closure=depth),
        rd.touched_vertices(g2, closure=depth))
    with pytest.raises(ValueError, match="post-apply graph"):
        td.touched_vertices(closure=1)


ALGOS = {
    "sssp": dict(name="sssp", weighted=True, kw={"source": 3}),
    "sswp": dict(name="sswp", weighted=True, kw={"source": 3}),
    "ms_sssp3": dict(name="ms_sssp", weighted=True, kw={"sources": [0, 42, 99]}),
    "ppr3": dict(name="ppr", weighted=False, kw={"seeds": [1, 5, 9]}),
}


def _scenario(algo_key: str, kind: str, seed: int = 4):
    """(reference old/new instances, port old/new instances, prior x): the
    port rebuilds the mutated instance through its own delta and remake."""
    spec = ALGOS[algo_key]
    g = _graphs()[1 if spec["weighted"] else 0]
    rd = RD.random_delta(g, **DELTAS[kind], w_lo=0.1, w_hi=1.0, seed=seed)
    ra_old = repro.get_algorithm(spec["name"], g, **spec["kw"])
    ra_new = r_remake(ra_old, rd.apply(g))
    ta_old = algo_from_arrays(algo_fields(ra_old))
    tg_new = delta_from_arrays(delta_fields(rd)).apply(_tgraph(g))
    ta_new = remake(ta_old, tg_new)
    for f in ("src", "dst", "w", "x0", "c", "fixed"):
        np.testing.assert_array_equal(getattr(ta_new, f), getattr(ra_new, f))
    prior = np.asarray(repro.solve(ra_old, bs=64).x)
    return ra_old, ra_new, ta_old, ta_new, prior


def _check(ra, r, t):
    if ra.semiring.reduce == "sum":
        np.testing.assert_allclose(t.x, np.asarray(r.x), atol=20 * ra.eps, rtol=1e-5)
        assert abs(t.rounds - r.rounds) <= 1
    else:
        np.testing.assert_array_equal(t.x, np.asarray(r.x))
        assert t.rounds == r.rounds
        np.testing.assert_array_equal(t.col_rounds, r.col_rounds)
        assert t.push_stats == r.push_stats
    assert t.converged == r.converged


RUNS = [
    ("async_block", "torch", "jax", {"bs": 64}),
    ("async_block", "kernel", "pallas", {"bs": 64, "sweeps_per_call": 4}),
    ("push", "torch", "jax", {}),
    ("push", "kernel", "pallas", {}),
]


@pytest.mark.parametrize("run", RUNS, ids=[f"{e}-{b}" for e, b, _, _ in RUNS])
@pytest.mark.parametrize("kind", sorted(DELTAS))
@pytest.mark.parametrize("algo_key", sorted(ALGOS))
def test_run_incremental_matches_reference(algo_key, kind, run):
    engine, backend, ref_backend, kw = run
    ra_old, ra_new, ta_old, ta_new, prior = _scenario(algo_key, kind)
    r = repro.run_incremental(ra_new, ra_old, prior, engine=engine,
                              backend=ref_backend, **kw)
    t = rt.run_incremental(ta_new, ta_old, prior, engine=engine, backend=backend,
                           device="cpu", **kw)
    _check(ra_new, r, t)
    if ra_new.semiring.reduce != "sum":
        # and the new fixpoint is the cold one, bitwise
        cold = rt.solve(ta_new, bs=64, device="cpu")
        np.testing.assert_array_equal(t.x, cold.x)


@pytest.mark.parametrize("engine", ["async_block", "push"])
@pytest.mark.parametrize("algo_key", ["sssp", "ppr3"])
def test_run_incremental_with_rank(algo_key, engine):
    ra_old, ra_new, ta_old, ta_new, prior = _scenario(algo_key, "churn")
    rank = r_gograph_order(RGraph(ra_new.n, ra_new.src, ra_new.dst, ra_new.w))
    r = repro.run_incremental(ra_new, ra_old, prior, engine=engine, rank=rank)
    t = rt.run_incremental(ta_new, ta_old, prior, engine=engine, rank=rank, device="cpu")
    _check(ra_new, r, t)


@pytest.mark.parametrize("kind", sorted(DELTAS))
@pytest.mark.parametrize("algo_key", ["sssp", "ppr3"])
def test_seeded_frontier_matches_reference(algo_key, kind, monkeypatch):
    """backend kernel/pallas with sweeps_per_call=4 seeds the sweep kernel's
    frontier from the delta; the two packages seed the same vertices."""
    ra_old, ra_new, ta_old, ta_new, prior = _scenario(algo_key, kind)
    seen = {}

    def spy(tag, solve):
        def wrapped(algo, engine="async_block", options=None, **kw):
            seen[tag] = kw.get("frontier")
            return solve(algo, engine, options, **kw)
        return wrapped

    monkeypatch.setattr(R_api, "solve", spy("ref", R_api.solve))
    monkeypatch.setattr(T_api, "solve", spy("port", T_api.solve))
    r = repro.run_incremental(ra_new, ra_old, prior, backend="pallas", bs=64,
                              sweeps_per_call=4)
    t = rt.run_incremental(ta_new, ta_old, prior, backend="kernel", bs=64,
                           sweeps_per_call=4, device="cpu")
    assert seen["ref"] is not None and seen["ref"].any()
    np.testing.assert_array_equal(seen["port"], seen["ref"])
    np.testing.assert_allclose(t.active_block_fraction, r.active_block_fraction)
    _check(ra_new, r, t)


@pytest.mark.parametrize("algo_key", ["sssp", "sswp", "ms_sssp3"])
def test_edge_diff_warm_state_region_identical(algo_key):
    ra_old, ra_new, ta_old, ta_new, prior = _scenario(algo_key, "churn")
    rdiff = RI.instance_edge_diff(ra_old, ra_new)
    tdiff = TI.instance_edge_diff(ta_old, ta_new)
    for f in dataclasses.fields(rdiff):
        np.testing.assert_array_equal(getattr(tdiff, f.name), getattr(rdiff, f.name))
    assert tdiff.loosening == rdiff.loosening
    np.testing.assert_array_equal(TI.warm_state(ta_new, ta_old, prior),
                                  RI.warm_state(ra_new, ra_old, prior))
    seeds = np.concatenate([rdiff.removed_dst, rdiff.loosened_dst])
    np.testing.assert_array_equal(TI.affected_region(ta_new, seeds),
                                  RI.affected_region(ra_new, seeds))


def test_dense_residual_and_warm_state_identical():
    ra_old, ra_new, ta_old, ta_new, prior = _scenario("ppr3", "churn")
    rx = RI.warm_state(ra_new, ra_old, prior)
    tx = TI.warm_state(ta_new, ta_old, prior)
    np.testing.assert_array_equal(tx, rx)
    r_res = RI.dense_residual(ra_new, rx)
    t_res = TI.dense_residual(ta_new, tx)
    assert t_res.dtype == r_res.dtype == np.float32
    assert t_res.tobytes() == r_res.tobytes()
    with pytest.raises(ValueError, match="edge diffs"):
        TI.instance_edge_diff(ta_old, ta_new)


def test_incremental_rejections_match_reference():
    ra_old, ra_new, ta_old, ta_new, prior = _scenario("sssp", "insert")
    # Aitken on a lattice semiring
    with pytest.raises(NotImplementedError):
        RI.run_incremental(ra_new, ra_old, prior, extrapolate_every=4)
    with pytest.raises(NotImplementedError):
        TI.run_incremental(ta_new, ta_old, prior, extrapolate_every=4, device="cpu")
    # a different algorithm or width
    other = algo_from_arrays(algo_fields(repro.get_algorithm("bfs", _graphs()[0], source=3)))
    with pytest.raises(ValueError, match="instance mismatch"):
        TI.run_incremental(ta_new, other, prior, device="cpu")
    # the sync engine is not ported: it raises through solve
    with pytest.raises(T_api.EngineUnsupportedError, match="ROADMAP"):
        TI.run_incremental(ta_new, ta_old, prior, engine="sync", device="cpu")
    # a period of 1 on the sum delta system
    pa_old, pa_new, pt_old, pt_new, pprior = _scenario("ppr3", "insert")
    with pytest.raises(R_api.EngineOptionsError):
        RI.run_incremental(pa_new, pa_old, pprior, extrapolate_every=1, bs=64)
    with pytest.raises(T_api.EngineOptionsError):
        TI.run_incremental(pt_new, pt_old, pprior, extrapolate_every=1, bs=64, device="cpu")
