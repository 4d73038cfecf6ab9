"""The port's ``solve`` against the reference's, on the CPU.

Both packages get the same instance (carried with `repro_torch.interop`).
Backends pair up as torch <-> jax and kernel <-> pallas (the reference
interprets its Pallas kernel off-TPU; the port runs its kernel's plain
version for CPU tensors). Lattice semirings match exactly in state, rounds
and per-column rounds; sum semirings match the state within
``atol=10*eps, rtol=1e-4`` and rounds within one (their stopping round
depends on summation order at f32 ulp level, as between the reference's own
two backends).
"""
import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro  # noqa: E402
from repro.core.gograph import gograph_order as r_gograph_order  # noqa: E402
from repro.engine.api import EngineOptions as REngineOptions  # noqa: E402
from repro.engine.api import validate_options as r_validate_options  # noqa: E402
from repro.graphs import generators as RG  # noqa: E402

import repro_torch as rt  # noqa: E402
from repro_torch.core.gograph import gograph_order  # noqa: E402
from repro_torch.engine import api as T_api  # noqa: E402
from repro_torch.graphs import generators as TG  # noqa: E402
from repro_torch.interop import algo_fields, algo_from_arrays  # noqa: E402
from repro_torch.obs.trace import Tracer  # noqa: E402

K = importlib.import_module("repro_torch.kernels.gs_sweep")

N = 311
_REF = {}


def _graph():
    if "g" not in _REF:
        g = RG.scrambled(RG.powerlaw_cluster(N, 4, p=0.5, seed=1), seed=11)
        _REF["g"] = RG.with_random_weights(g, lo=0.1, hi=1.0, seed=3)
        _REF["rank"] = r_gograph_order(_REF["g"])
    return _REF["g"], _REF["rank"]


def _instance(name: str, d: int):
    g, _ = _graph()
    cols = np.random.default_rng(d).choice(N, size=d, replace=False)
    if name == "ppr":
        return repro.personalized_pagerank(g, seeds=cols)
    if name == "ms_sssp":
        return repro.multi_source_sssp(g, sources=cols)
    assert d == 1
    return repro.get_algorithm(name, g, source=int(cols[0]))


def _check(name, r, t):
    assert t.x.shape == np.asarray(r.x).shape
    assert t.d == r.d
    if name == "ppr":
        np.testing.assert_allclose(t.x, r.x, atol=10 * 1e-6, rtol=1e-4)
        assert abs(t.rounds - r.rounds) <= 1
        assert np.all(np.abs(t.col_rounds - r.col_rounds) <= 1)
    else:
        np.testing.assert_array_equal(t.x, r.x)
        assert t.rounds == r.rounds
        np.testing.assert_array_equal(t.col_rounds, r.col_rounds)
    assert t.converged == r.converged
    assert t.convergence_trace.rounds == t.rounds


CASES = (
    [("torch", 1)]   # torch <-> jax
    + [("kernel", 1), ("kernel", 4)]  # kernel <-> pallas
)


@pytest.mark.parametrize("ordered", [False, True], ids=["identity", "gograph"])
@pytest.mark.parametrize("d", [1, 3])
@pytest.mark.parametrize("backend,spc", CASES, ids=lambda v: str(v))
@pytest.mark.parametrize("name", ["ppr", "ms_sssp"])
def test_solve_matches_reference(name, backend, spc, d, ordered):
    _, rank = _graph()
    ra = _instance(name, d)
    ta = algo_from_arrays(algo_fields(ra))
    rk = rank if ordered else None
    ref_backend = {"torch": "jax", "kernel": "pallas"}[backend]
    r = repro.solve(ra, backend=ref_backend, bs=64, rank=rk, sweeps_per_call=spc)
    before = K.launches
    t = rt.solve(ta, backend=backend, bs=64, rank=rk, sweeps_per_call=spc, device="cpu")
    assert K.launches == before  # CPU tensors never launch the kernel
    _check(name, r, t)
    if backend == "kernel" and spc > 1:
        np.testing.assert_allclose(t.active_block_fraction, r.active_block_fraction)


@pytest.mark.parametrize("name", ["sswp", "reachability"])
def test_solve_other_lattice_pairs(name):
    ra = _instance(name, 1)
    ta = algo_from_arrays(algo_fields(ra))
    for backend, ref_backend in (("torch", "jax"), ("kernel", "pallas")):
        r = repro.solve(ra, backend=ref_backend, bs=32)
        t = rt.solve(ta, backend=backend, bs=32, device="cpu")
        _check(name, r, t)


def test_inner_and_warm_start_match_reference():
    ra = _instance("ms_sssp", 3)
    ta = algo_from_arrays(algo_fields(ra))
    r = repro.solve(ra, backend="jax", bs=32, inner=2)
    t = rt.solve(ta, backend="torch", bs=32, inner=2, device="cpu")
    _check("ms_sssp", r, t)
    # a restart from the converged state is one bitwise no-op round
    t2 = rt.solve(ta, backend="torch", bs=32, x_init=t.x, device="cpu")
    assert t2.rounds == 1
    assert t2.x.tobytes() == t.x.tobytes()
    t3 = rt.solve(ta, backend="kernel", bs=32, x_init=t.x, device="cpu")
    assert t3.rounds == 1
    assert t3.x.tobytes() == t.x.tobytes()


def test_extrapolation_and_frontier_match_reference():
    ra = _instance("ppr", 3)
    ta = algo_from_arrays(algo_fields(ra))
    r = repro.solve(ra, backend="jax", bs=64, extrapolate_every=4)
    t = rt.solve(ta, backend="torch", bs=64, extrapolate_every=4, device="cpu")
    _check("ppr", r, t)
    sa = _instance("ms_sssp", 3)
    frontier = np.zeros(N, bool)
    frontier[np.random.default_rng(3).choice(N, size=3, replace=False)] = True
    sb = algo_from_arrays(algo_fields(sa))
    r = repro.solve(sa, backend="pallas", bs=64, sweeps_per_call=4, frontier=frontier)
    t = rt.solve(sb, backend="kernel", bs=64, sweeps_per_call=4, frontier=frontier,
                 device="cpu")
    _check("ms_sssp", r, t)


# (engine, overrides) that the reference rejects; backends named as in the
# reference and mapped to the port's names
BAD = [
    ("bogus", {}),
    ("async_block", {"backend": "bogus"}),
    ("async_block", {"bs": 0}),
    ("async_block", {"inner": 0}),
    ("async_block", {"max_iters": 0}),
    ("async_block", {"sweeps_per_call": 0}),
    ("async_block", {"x_init": np.zeros((2, 2, 2))}),
    ("async_block", {"axis": ""}),
    ("async_block", {"mesh": object()}),
    ("async_block", {"transfer_guard": "sometimes"}),
    ("async_block", {"push_threshold": 2.0}),
    ("async_block", {"beta": -0.5}),
    ("async_block", {"buckets": 0}),
    ("async_block", {"rank": np.zeros((2, 2), np.int64)}),
    ("async_block", {"trace": "not a tracer"}),
    ("async_block", {"backend": "pallas", "inner": 2}),
    ("sync", {"backend": "pallas"}),
    ("async_block", {"sweeps_per_call": 4}),
    ("async_block", {"frontier": np.zeros(N, bool)}),
    ("async_block", {"extrapolate_every": 1}),
    ("async_block", {"extrapolate_every": 4, "backend": "pallas", "sweeps_per_call": 4}),
    ("push", {"sweeps_per_call": 2}),
    ("push", {"extrapolate_every": 2}),
    ("sync", {"inner": 2}),
]


@pytest.mark.parametrize("engine,kw", BAD, ids=[f"{e}-{sorted(k)}" for e, k in BAD])
def test_validate_options_parity(engine, kw):
    g, _ = _graph()
    ra = repro.get_algorithm("pagerank", g)
    ta = algo_from_arrays(algo_fields(ra))
    with pytest.raises(repro.EngineOptionsError) as ref_exc:
        r_validate_options(engine, REngineOptions(**kw), ra)
    port_kw = dict(kw)
    if "backend" in port_kw:
        port_kw["backend"] = {"jax": "torch", "pallas": "kernel"}.get(
            port_kw["backend"], port_kw["backend"])
    with pytest.raises(T_api.EngineOptionsError) as exc:
        T_api.validate_options(engine, T_api.EngineOptions(**port_kw), ta)
    assert type(exc.value).__name__ == type(ref_exc.value).__name__
    assert isinstance(exc.value, ValueError)


def test_extrapolation_on_lattice_unsupported():
    ta = algo_from_arrays(algo_fields(_instance("ms_sssp", 1)))
    with pytest.raises(T_api.EngineUnsupportedError, match="sum-semiring"):
        rt.solve(ta, extrapolate_every=4, device="cpu")


def test_cuda_device_without_gpu_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ta = algo_from_arrays(algo_fields(_instance("ms_sssp", 1)))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        rt.solve(ta, bs=64)  # the default device is "cuda"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        rt.solve(ta, bs=64, backend="kernel")


def test_unknown_option_and_device_rejected():
    ta = algo_from_arrays(algo_fields(_instance("ms_sssp", 1)))
    with pytest.raises(T_api.EngineOptionsError, match="unknown EngineOptions"):
        rt.solve(ta, device="cpu", not_a_knob=1)
    with pytest.raises(T_api.EngineOptionsError, match="not a torch device"):
        rt.solve(ta, device="abacus")


def test_trace_spans_and_transfer_guard_on_cpu():
    ta = algo_from_arrays(algo_fields(_instance("ms_sssp", 3)))
    _, rank = _graph()
    tr = Tracer()
    plain = rt.solve(ta, backend="kernel", bs=64, sweeps_per_call=4, device="cpu",
                     rank=rank)
    traced = rt.solve(ta, backend="kernel", bs=64, sweeps_per_call=4, device="cpu",
                      rank=rank, trace=tr, transfer_guard="disallow")
    assert traced.x.tobytes() == plain.x.tobytes()
    names = [s.name for s in tr.spans]
    assert names.count("solve") == 1 and names.count("pack") == 1
    (solve,), (pack,) = tr.find("solve"), tr.find("pack")
    # the solve span covers the relabel; the tiles are packed inside pack
    assert [s.parent for s in tr.find("relabel")] == [solve.id]
    assert [s.parent for s in tr.find("pack_tiles")] == [pack.id]
    assert [s.parent for s in tr.find("pack_operands")] == [pack.id]
    assert pack.parent == solve.id and solve.parent is None
    assert solve.attrs["rounds"] == traced.rounds


def test_paper_result_on_small_ic_like_graph():
    """GoGraph's order cuts rounds against the default (scrambled) order on
    the fast ic-like graph, and the port counts the reference's rounds."""
    rg = RG.scrambled(RG.powerlaw_cluster(400, 6, p=0.5, seed=1), seed=11)
    rank = r_gograph_order(rg)
    tg = TG.scrambled(TG.powerlaw_cluster(400, 6, p=0.5, seed=1), seed=11)
    np.testing.assert_array_equal(gograph_order(tg), rank)
    rounds = {}
    for name, kw in (("php", {"target": 5}), ("ppr", {"seeds": [1, 2, 3]})):
        ra = repro.get_algorithm(name, rg, **kw)
        ta = algo_from_arrays(algo_fields(ra))
        for order, rk in (("identity", None), ("gograph", rank)):
            r = repro.solve(ra, backend="jax", bs=16, rank=rk)
            t = rt.solve(ta, backend="torch", bs=16, rank=rk, device="cpu")
            assert abs(t.rounds - r.rounds) <= 1, (name, order)
            rounds[name, order] = t.rounds
        assert rounds[name, "gograph"] < rounds[name, "identity"], rounds


@pytest.mark.parametrize("n,gograph_cuts", [(10_000, True), (30_000, False)])
def test_ppr64_order_effect_matches_reference(n, gograph_cuts):
    """The d=64 PPR batch of the chip smoke's main path (same generator,
    seeds and bs) at sizes the CPU reaches: the reference and the port count
    the same rounds under both orders. GoGraph's cut shrinks as n grows and
    is gone at n=30,000 in the reference as in the port, so a tie at full
    size is the order's, not the port's."""
    rg = RG.scrambled(RG.powerlaw_cluster(n, 6, p=0.5, seed=1), seed=11)
    rank = r_gograph_order(rg)
    seeds = np.random.default_rng(0).choice(n, size=64, replace=False)
    ra = repro.personalized_pagerank(rg, seeds=seeds)
    ta = algo_from_arrays(algo_fields(ra))
    ref, port = {}, {}
    for order, rk in (("identity", None), ("gograph", rank)):
        ref[order] = repro.solve(ra, backend="jax", bs=64, rank=rk).rounds
        port[order] = rt.solve(ta, backend="torch", bs=64, rank=rk, device="cpu").rounds
        assert abs(port[order] - ref[order]) <= 1, (order, ref, port)
    print(f"n={n} rounds reference {ref} port {port}")
    assert (ref["gograph"] < ref["identity"]) == gograph_cuts, ref
    assert (port["gograph"] < port["identity"]) == gograph_cuts, port
