"""The port's synchronous (Jacobi) engine against the reference's, on the CPU.

Both packages get the same instance (carried with `repro_torch.interop`):
every family of ``get_algorithm`` at d = 1 and d = 3, warm starts, Aitken
extrapolation, ``rank=``, a cut-off run and ``run_incremental``. Lattice
semirings (min/max) match exactly in state, ``rounds`` and ``col_rounds``.
Sum semirings match the state within ``rtol=1e-5`` and an ``atol`` of
``10 * eps`` and the rounds within one: the two packages sum each vertex's
in-edges in another order, and the last residuals of these runs are a few
float32 ulps, so the stopping round follows the summation order (ROADMAP
§C).
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
from repro.engine.sync import run_sync as r_run_sync  # noqa: E402
from repro.graphs import delta as RD  # noqa: E402
from repro.graphs import generators as RG  # noqa: E402

import repro_torch as rt  # noqa: E402
import repro_torch.engine.api as T_api  # noqa: E402
from repro_torch.engine import incremental as TI  # noqa: E402
from repro_torch.engine.sync import run_sync  # noqa: E402
from repro_torch.interop import algo_fields, algo_from_arrays  # noqa: E402
from repro_torch.obs.trace import Tracer  # noqa: E402

N = 311
SUM = ("pagerank", "katz", "php", "adsorption", "ppr")
LATTICE = ("sssp", "bfs", "cc", "sswp", "reachability", "ms_sssp")
FAMILIES = SUM + LATTICE
_G: dict = {}


def _graph(kind: str):
    if kind not in _G:
        if kind == "ic":
            g = RG.scrambled(RG.powerlaw_cluster(N, 4, p=0.5, seed=1), seed=11)
        else:
            g = RG.erdos_renyi(N, 3.0, seed=4)
        _G[kind] = RG.with_random_weights(g, lo=0.1, hi=1.0, seed=3)
    return _G[kind]


def _one(name: str, g, col: int):
    """The family's instance for one column: a source, target or seed at
    ``col`` where the family takes one."""
    if name in ("sssp", "bfs", "sswp", "reachability"):
        return repro.get_algorithm(name, g, source=col)
    if name == "php":
        return repro.get_algorithm(name, g, target=col)
    if name == "ppr":
        return repro.get_algorithm(name, g, seeds=[col])
    if name == "ms_sssp":
        return repro.get_algorithm(name, g, sources=[col])
    if name == "adsorption":
        return repro.get_algorithm(name, g, seeds=np.array([col, col + 7]))
    return repro.get_algorithm(name, g)


def _instance(name: str, d: int, kind: str = "ic"):
    """A reference instance with d query columns: the batched constructors
    for ppr and ms_sssp, else d single-column instances side by side."""
    g = _graph(kind)
    cols = [int(c) for c in np.random.default_rng(d).choice(N - 8, size=d, replace=False)]
    if name == "ppr":
        return repro.get_algorithm(name, g, seeds=cols)
    if name == "ms_sssp":
        return repro.get_algorithm(name, g, sources=cols)
    parts = [_one(name, g, c) for c in cols]
    if d == 1:
        return parts[0]
    return dataclasses.replace(
        parts[0],
        x0=np.concatenate([p.x0.reshape(N, 1) for p in parts], axis=1),
        c=np.concatenate([p.c.reshape(N, 1) for p in parts], axis=1),
        fixed=np.concatenate([p.fixed.reshape(N, 1) for p in parts], axis=1),
        params=None,
    )


def _port(ra):
    return algo_from_arrays(algo_fields(ra))


def _check(name: str, r, t, eps: float):
    assert t.x.shape == np.asarray(r.x).shape
    assert t.converged == r.converged
    if name in SUM:
        np.testing.assert_allclose(t.x, np.asarray(r.x), rtol=1e-5, atol=10 * eps)
        assert abs(t.rounds - r.rounds) <= 1
        assert np.all(np.abs(np.asarray(t.col_rounds) - np.asarray(r.col_rounds)) <= 1)
    else:
        np.testing.assert_array_equal(t.x, np.asarray(r.x))
        assert t.rounds == r.rounds
        np.testing.assert_array_equal(t.col_rounds, r.col_rounds)
        np.testing.assert_array_equal(t.residuals, np.asarray(r.residuals))
    np.testing.assert_array_equal(t.col_converged, r.col_converged)
    assert t.convergence_trace.rounds == t.rounds


@pytest.mark.parametrize("kind", ["ic", "er"])
@pytest.mark.parametrize("d", [1, 3])
@pytest.mark.parametrize("name", FAMILIES)
def test_solve_sync_matches_reference(name, d, kind):
    ra = _instance(name, d, kind)
    r = repro.solve(ra, engine="sync")
    t = rt.solve(_port(ra), engine="sync", device="cpu")
    assert t.converged
    _check(name, r, t, ra.eps)


@pytest.mark.parametrize("d", [1, 3])
@pytest.mark.parametrize("name", FAMILIES)
def test_run_sync_is_solve(name, d):
    """The legacy shim is the entry path, bit for bit, and matches the
    reference's shim."""
    ra = _instance(name, d)
    ta = _port(ra)
    t = run_sync(ta, device="cpu")
    s = rt.solve(ta, engine="sync", device="cpu")
    assert t.x.tobytes() == s.x.tobytes() and t.rounds == s.rounds
    _check(name, r_run_sync(ra), t, ra.eps)


@pytest.mark.parametrize("d", [1, 3])
@pytest.mark.parametrize("name", FAMILIES)
def test_warm_start_matches_reference(name, d):
    """``x_init`` from a run cut after 3 rounds: the same resumed run in
    both packages; resuming the port's converged state is one round and a
    no-op for the lattice families."""
    ra = _instance(name, d)
    ta = _port(ra)
    prior = np.asarray(repro.solve(ra, engine="sync", max_iters=3).x)
    r = repro.solve(ra, engine="sync", x_init=prior)
    t = rt.solve(ta, engine="sync", x_init=prior, device="cpu")
    _check(name, r, t, ra.eps)
    again = rt.solve(ta, engine="sync", x_init=t.x, device="cpu")
    assert again.rounds == 1
    if name in LATTICE:
        assert again.x.tobytes() == t.x.tobytes()


@pytest.mark.parametrize("d", [1, 3])
@pytest.mark.parametrize("name", FAMILIES)
def test_cut_off_run_matches_reference(name, d):
    """A run stopped by ``max_iters`` (most families need more than two
    rounds)."""
    ra = _instance(name, d)
    r = repro.solve(ra, engine="sync", max_iters=2)
    t = rt.solve(_port(ra), engine="sync", max_iters=2, device="cpu")
    assert t.rounds == r.rounds
    assert t.converged == r.converged
    np.testing.assert_array_equal(t.col_converged, r.col_converged)
    if name in SUM:
        np.testing.assert_allclose(t.x, np.asarray(r.x), rtol=1e-5, atol=1e-7)
    else:
        np.testing.assert_array_equal(t.x, np.asarray(r.x))


@pytest.mark.parametrize("every", [2, 4, 8])
@pytest.mark.parametrize("name", SUM)
def test_extrapolation_matches_reference(name, every):
    ra = _instance(name, 1)
    r = repro.solve(ra, engine="sync", extrapolate_every=every)
    t = rt.solve(_port(ra), engine="sync", extrapolate_every=every, device="cpu")
    assert t.converged
    _check(name, r, t, ra.eps)


@pytest.mark.parametrize("name", FAMILIES)
def test_rank_matches_reference(name):
    """``rank=`` relabels, solves and returns the caller's id space."""
    ra = _instance(name, 1)
    rank = r_gograph_order(_graph("ic"))
    r = repro.solve(ra, engine="sync", rank=rank)
    t = rt.solve(_port(ra), engine="sync", rank=rank, device="cpu")
    _check(name, r, t, ra.eps)
    if name in LATTICE:
        plain = rt.solve(_port(ra), engine="sync", device="cpu")
        np.testing.assert_array_equal(t.x, plain.x)


_DELTAS = {
    "insert": dict(frac_add=0.02),
    "churn": dict(frac_add=0.02, frac_del=0.01, frac_rew=0.01, n_add_vertices=3),
}


@pytest.mark.parametrize("delta", sorted(_DELTAS))
@pytest.mark.parametrize("name", ["sssp", "sswp", "ms_sssp", "ppr", "pagerank"])
def test_run_incremental_sync_matches_reference(name, delta):
    ra_old = _instance(name, 3 if name in ("ms_sssp", "ppr") else 1)
    g = _graph("ic")
    gd = RD.random_delta(g, seed=5, **_DELTAS[delta])
    ra_new = r_remake(ra_old, gd.apply(g))
    prior = repro.solve(ra_old, engine="sync")
    r = RI.run_incremental(ra_new, ra_old, prior, engine="sync")
    t = TI.run_incremental(_port(ra_new), _port(ra_old), np.asarray(prior.x),
                           engine="sync", device="cpu")
    _check(name, r, t, ra_new.eps)


def test_sync_kernel_backend_raises_as_reference():
    ra = _instance("sssp", 1)
    with pytest.raises(R_api.EngineUnsupportedError):
        repro.solve(ra, engine="sync", backend="pallas")
    with pytest.raises(T_api.EngineUnsupportedError, match="has no kernel"):
        rt.solve(_port(ra), engine="sync", backend="kernel", device="cpu")


@pytest.mark.parametrize("bad", [dict(inner=2), dict(sweeps_per_call=4),
                                 dict(frontier=np.ones(N, bool)), dict(extrapolate_every=1)])
def test_sync_option_rejections_match_reference(bad):
    ra = _instance("pagerank", 1)
    with pytest.raises(R_api.EngineOptionsError) as r_err:
        repro.solve(ra, engine="sync", **bad)
    with pytest.raises(T_api.EngineOptionsError) as t_err:
        rt.solve(_port(ra), engine="sync", device="cpu", **bad)
    assert type(t_err.value).__name__ == type(r_err.value).__name__


def test_sync_trace_spans():
    tr = Tracer()
    t = rt.solve(_port(_instance("sssp", 1)), engine="sync", trace=tr, device="cpu")
    (solve_span,) = tr.find("solve")
    assert solve_span.attrs["engine"] == "sync"
    assert solve_span.attrs["rounds"] == t.rounds
    assert len(tr.find("pack")) == 1


def test_sync_cuda_without_gpu_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_sync(_port(_instance("sssp", 1)))
