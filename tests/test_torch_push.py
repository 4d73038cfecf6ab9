"""The port's push engine and ``engine="auto"`` router against the
reference's, on the CPU.

Both packages get the same instance (carried with `repro_torch.interop`).
Backends pair up as torch <-> jax and kernel <-> pallas (the reference
interprets its Pallas kernel off-TPU; the port runs its kernel's plain
version for CPU tensors). Lattice semirings match the reference's push run
exactly in state, rounds, per-column rounds and ``push_stats``, and equal
``run_async_block``'s state bitwise. Sum semirings are held to
``atol=20*eps, rtol=1e-5`` of ``run_async_block`` (the reference's own
tolerance for push against the sweeps) and to the reference's push run
within the same tolerance and one round.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro  # noqa: E402
from repro.engine import run_async_block as r_run_async_block  # noqa: E402
from repro.engine import run_push as r_run_push  # noqa: E402
from repro.engine.api import EngineOptions as REngineOptions  # noqa: E402
from repro.engine.api import validate_options as r_validate_options  # noqa: E402
from repro.engine.push import estimate_frontier_fraction as r_estimate  # noqa: E402
from repro.graphs import generators as RG  # noqa: E402

import repro_torch as rt  # noqa: E402
from repro_torch.engine import api as T_api  # noqa: E402
from repro_torch.engine.push import estimate_frontier_fraction  # noqa: E402
from repro_torch.interop import algo_fields, algo_from_arrays  # noqa: E402
from repro_torch.obs.trace import Tracer  # noqa: E402

BS = 64
LATTICE = ["sssp", "bfs", "cc", "sswp", "reachability"]
SUM = ["pagerank", "katz", "php", "adsorption"]
BACKENDS = [("torch", "jax"), ("kernel", "pallas")]
_G = {}


def _graphs():
    if not _G:
        g = RG.scrambled(RG.powerlaw_cluster(400, 4, p=0.4, seed=1), seed=9)
        _G["g"] = g
        _G["gw"] = RG.with_random_weights(g, lo=0.1, hi=1.0, seed=2)
    return _G["g"], _G["gw"]


def _pair(name, **kw):
    g, gw = _graphs()
    graph = gw if name in ("sssp", "sswp", "ms_sssp") else g
    ra = repro.get_algorithm(name, graph, **kw)
    return ra, algo_from_arrays(algo_fields(ra))


def _check_lattice(r, t):
    np.testing.assert_array_equal(t.x, np.asarray(r.x))
    assert t.rounds == r.rounds and t.converged == r.converged
    np.testing.assert_array_equal(t.col_rounds, r.col_rounds)
    assert t.push_stats == r.push_stats
    np.testing.assert_array_equal(t.convergence_trace.residual, r.convergence_trace.residual)
    np.testing.assert_array_equal(t.convergence_trace.work, r.convergence_trace.work)


@pytest.mark.parametrize("backend,ref_backend", BACKENDS, ids=["torch", "kernel"])
@pytest.mark.parametrize("name", LATTICE)
def test_lattice_cold_bitwise(name, backend, ref_backend):
    ra, ta = _pair(name)
    r = repro.solve(ra, engine="push", backend=ref_backend)
    t = rt.solve(ta, engine="push", backend=backend, device="cpu")
    assert t.converged
    _check_lattice(r, t)
    np.testing.assert_array_equal(t.x, np.asarray(r_run_async_block(ra, bs=BS).x))


@pytest.mark.parametrize("backend,ref_backend", BACKENDS, ids=["torch", "kernel"])
@pytest.mark.parametrize("name", SUM)
def test_sum_cold_within_eps(name, backend, ref_backend):
    ra, ta = _pair(name)
    r = repro.solve(ra, engine="push", backend=ref_backend)
    t = rt.solve(ta, engine="push", backend=backend, device="cpu")
    assert t.converged and r.converged
    tol = dict(atol=20 * ra.eps, rtol=1e-5)
    np.testing.assert_allclose(t.x, np.asarray(r_run_async_block(ra, bs=BS).x), **tol)
    np.testing.assert_allclose(t.x, np.asarray(r.x), **tol)
    assert abs(t.rounds - r.rounds) <= 1
    assert t.convergence_trace.rounds == t.rounds


@pytest.mark.parametrize("backend,ref_backend", BACKENDS, ids=["torch", "kernel"])
def test_batched_ms_sssp_bitwise(backend, ref_backend):
    ra, ta = _pair("ms_sssp", sources=[0, 42, 99])
    r = repro.solve(ra, engine="push", backend=ref_backend)
    t = rt.solve(ta, engine="push", backend=backend, device="cpu")
    assert t.x.shape == (400, 3) and bool(t.col_converged.all())
    _check_lattice(r, t)


@pytest.mark.parametrize("buckets", [1, 3, 16])
def test_bucket_counts_bitwise(buckets):
    ra, ta = _pair("ms_sssp", sources=[3, 17])
    r = repro.solve(ra, engine="push", backend="pallas", buckets=buckets)
    t = rt.solve(ta, engine="push", backend="kernel", buckets=buckets, device="cpu")
    _check_lattice(r, t)


def test_batched_ppr_per_column_rounds():
    ra, ta = _pair("ppr", seeds=[0, 5, 77])
    for backend, ref_backend in BACKENDS:
        r = repro.solve(ra, engine="push", backend=ref_backend)
        t = rt.solve(ta, engine="push", backend=backend, device="cpu")
        np.testing.assert_allclose(t.x, np.asarray(r.x), atol=20 * ra.eps, rtol=1e-5)
        assert np.all(np.abs(t.col_rounds - r.col_rounds) <= 1)


CASES = {
    "ppr_one_seed": lambda: _pair("ppr", seeds=[5]),
    "pagerank": lambda: _pair("pagerank"),
    "sssp": lambda: _pair("sssp"),
    "sswp": lambda: _pair("sswp"),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_estimate_frontier_fraction_equal(case):
    ra, ta = CASES[case]()
    assert estimate_frontier_fraction(ta) == r_estimate(ra)


def test_estimate_warm_start_equal():
    ra, ta = _pair("sssp")
    x = np.asarray(r_run_async_block(ra, bs=BS).x).copy()
    x[::7] = np.float32(3.0e38)
    assert estimate_frontier_fraction(ta, x) == r_estimate(ra, x)


@pytest.mark.parametrize("case,threshold", [
    ("ppr_one_seed", 0.05), ("pagerank", 0.05), ("sssp", 0.05), ("ppr_one_seed", 0.0),
])
def test_router_arms_match_reference(case, threshold):
    ra, ta = CASES[case]()
    r = repro.solve(ra, engine="auto", backend="pallas", bs=BS, push_threshold=threshold)
    t = rt.solve(ta, engine="auto", backend="kernel", bs=BS, push_threshold=threshold,
                 device="cpu")
    assert (t.push_stats is None) == (r.push_stats is None)
    if threshold == 0.0 or case == "pagerank":
        assert t.push_stats is None  # the sweep arm
    else:
        assert t.push_stats is not None
    if ra.semiring.reduce == "sum":
        np.testing.assert_allclose(t.x, np.asarray(r.x), atol=20 * ra.eps, rtol=1e-5)
    else:
        np.testing.assert_array_equal(t.x, np.asarray(r.x))


def test_router_drops_sweep_knobs_when_push_wins():
    ra, ta = _pair("ppr", seeds=[5])
    frontier = np.zeros(400, bool)
    frontier[5] = True
    kw = dict(backend="kernel", bs=BS, sweeps_per_call=4, frontier=frontier,
              extrapolate_every=4)
    t = rt.solve(ta, engine="auto", device="cpu", **kw)
    r = repro.solve(ra, engine="auto", **dict(kw, backend="pallas"))
    assert t.push_stats is not None and r.push_stats is not None
    np.testing.assert_allclose(t.x, np.asarray(r.x), atol=20 * ra.eps, rtol=1e-5)
    with pytest.raises(T_api.EngineOptionsError):
        rt.solve(ta, engine="push", device="cpu", **kw)


def test_transfer_guard_and_trace_on_cpu():
    _, ta = _pair("ms_sssp", sources=[1, 2])
    plain = rt.solve(ta, engine="push", backend="kernel", device="cpu")
    tr = Tracer()
    guarded = rt.solve(ta, engine="push", backend="kernel", device="cpu",
                       transfer_guard="disallow", trace=tr)
    assert guarded.x.tobytes() == plain.x.tobytes()
    names = [s.name for s in tr.spans]
    assert names.count("solve") == 1 and names.count("pack") == 1
    assert tr.find("solve")[0].attrs["engine"] == "push"


@pytest.mark.parametrize("backend,ref_backend", BACKENDS, ids=["torch", "kernel"])
def test_beta_below_one_matches_reference(backend, ref_backend):
    ra, ta = _pair("ppr", seeds=[5, 9])
    r = repro.solve(ra, engine="push", backend=ref_backend, beta=0.5)
    t = rt.solve(ta, engine="push", backend=backend, beta=0.5, device="cpu")
    assert t.converged
    np.testing.assert_allclose(t.x, np.asarray(r.x), atol=20 * ra.eps, rtol=1e-5)
    assert abs(t.rounds - r.rounds) <= 1
    full = rt.solve(ta, engine="push", backend=backend, device="cpu")
    assert t.push_stats["pushed"] < full.push_stats["pushed"]


def test_run_push_shim():
    ra, ta = _pair("sswp")
    r = r_run_push(ra, backend="pallas", buckets=2)
    t = rt.run_push(ta, backend="kernel", buckets=2, device="cpu")
    _check_lattice(r, t)


# (engine, overrides) the reference rejects for the push entries
BAD = [
    ("push", {"sweeps_per_call": 2}),
    ("push", {"frontier": np.zeros(400, bool)}),
    ("push", {"inner": 2}),
    ("push", {"extrapolate_every": 2}),
    ("push", {"backend": "bogus"}),
    ("push", {"beta": 1.5}),
    ("push", {"buckets": 0}),
    ("push", {"push_threshold": -0.1}),
]


@pytest.mark.parametrize("engine,kw", BAD, ids=[f"{e}-{sorted(k)}" for e, k in BAD])
def test_push_option_validation_parity(engine, kw):
    ra, ta = _pair("sssp")
    with pytest.raises(repro.EngineOptionsError) as ref_exc:
        r_validate_options(engine, REngineOptions(**kw), ra)
    with pytest.raises(T_api.EngineOptionsError) as exc:
        rt.solve(ta, engine=engine, device="cpu", **kw)
    assert type(exc.value).__name__ == type(ref_exc.value).__name__


def test_push_on_cuda_without_gpu_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, ta = _pair("sssp")
    for engine in ("push", "auto"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            rt.solve(ta, engine=engine, backend="kernel")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        rt.run_push(ta)


def test_sum_push_gap_to_sweep_is_the_reference_s():
    """On a 3,000-vertex graph of the main path's family the push engine's
    PPR state solves the fixpoint to eps, yet lies further than 20 eps from
    the sweep's state — in the reference as in the port, so a full-size
    check holds push to its residual, not to the sweep."""
    from repro.engine.incremental import dense_residual as r_dense_residual

    from repro_torch.engine.incremental import dense_residual

    n = 3000
    g = RG.scrambled(RG.powerlaw_cluster(n, 6, p=0.5, seed=1), seed=11)
    seeds = np.random.default_rng(0).choice(n, size=8, replace=False)
    ra = repro.personalized_pagerank(g, seeds=seeds)
    ta = algo_from_arrays(algo_fields(ra))
    r = repro.solve(ra, engine="push", backend="pallas")
    t = rt.solve(ta, engine="push", backend="kernel", device="cpu")
    sweep = np.asarray(r_run_async_block(ra, bs=BS).x)
    np.testing.assert_allclose(t.x, np.asarray(r.x), atol=20 * ra.eps, rtol=1e-5)
    assert np.abs(r_dense_residual(ra, np.asarray(r.x))).max() <= 2 * ra.eps
    assert np.abs(dense_residual(ta, t.x)).max() <= 2 * ta.eps
    ref_gap = np.abs(np.asarray(r.x) - sweep).max()
    assert ref_gap > 20 * ra.eps
    assert abs(np.abs(t.x - sweep).max() - ref_gap) <= 20 * ra.eps


@pytest.mark.parametrize("d", [1, 3])
def test_torch_round_sum_matches_reference_round(d):
    """One plus_times push round of the torch backend (per-destination
    sorted segment sums) against the reference's jax round (scatter-add),
    from the same random state and active set."""
    import jax.numpy as jnp

    from repro.engine.push import _make_round_jax
    from repro_torch.engine.push import _TorchRound

    ra, ta = _pair("ppr", seeds=list(range(0, 3 * d, 3)))
    rng = np.random.default_rng(d)
    p = rng.random((ra.n, d)).astype(np.float32)
    r = (rng.random((ra.n, d)) * 1e-3).astype(np.float32)
    active = rng.random(ra.n) < 0.4
    live = np.ones(d, bool)
    live[-1] = d == 1
    want = _make_round_jax(ra, "plus_times")(
        jnp.asarray(p), jnp.asarray(r), jnp.asarray(active), jnp.asarray(live))
    got = _TorchRound(ta, "plus_times", torch.device("cpu"))(
        torch.from_numpy(p), torch.from_numpy(r), torch.from_numpy(active),
        torch.from_numpy(live))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), rtol=1e-6, atol=1e-9)
    again = _TorchRound(ta, "plus_times", torch.device("cpu"))(
        torch.from_numpy(p), torch.from_numpy(r), torch.from_numpy(active),
        torch.from_numpy(live))
    assert torch.equal(again[1], got[1])
