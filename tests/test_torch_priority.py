"""The port's priority-scheduled block engine against the reference's, on the
CPU, and the block dependency skeleton it schedules over.

Both packages get the same instance: every family of ``get_algorithm`` at
d = 1 and d = 3, under the identity and the GoGraph order, at three
(bs, select_frac) settings. Lattice families (min/max) match exactly in
state and in ``rounds`` (their priorities are sums of state moves that both
packages select on alike). Sum families match the state within
``rtol=1e-5`` and an ``atol`` of ``10 * eps`` (tighter than the reference's
own priority test, which holds PageRank to its exact fixpoint within
``atol=2e-4, rtol=1e-3``), and ``rounds`` within one equivalent sweep:
the stopping test compares the total priority mass, a float32 sum that the
two packages add in another order, with eps, and the last rounds' deltas
are float32 rounding noise, so the round at which the mass first falls
below eps moves by a few block updates (at most 0.8 of a sweep on these
cases).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.gograph import gograph_order as r_gograph_order  # noqa: E402
from repro.engine.priority import run_priority_block as r_run_priority_block  # noqa: E402
from repro.graphs import blocked as RB  # noqa: E402
from repro.graphs import generators as RG  # noqa: E402

from repro_torch.engine import run_priority_block  # noqa: E402
from repro_torch.graphs import blocked as TB  # noqa: E402
from tests.test_torch_sync import FAMILIES, SUM, _graph, _instance, _port  # noqa: E402

SETTINGS = [(16, 0.25), (32, 0.125), (64, 0.5)]
_RANK: dict = {}


def _rank():
    if "ic" not in _RANK:
        _RANK["ic"] = r_gograph_order(_graph("ic"))
    return _RANK["ic"]


@pytest.mark.parametrize("bs,frac", SETTINGS, ids=lambda v: str(v))
@pytest.mark.parametrize("order", ["identity", "gograph"])
@pytest.mark.parametrize("d", [1, 3])
@pytest.mark.parametrize("name", FAMILIES)
def test_priority_matches_reference(name, d, order, bs, frac):
    ra = _instance(name, d)
    if order == "gograph":
        ra = ra.relabel(_rank())
    r = r_run_priority_block(ra, bs=bs, select_frac=frac)
    t = run_priority_block(_port(ra), bs=bs, select_frac=frac, device="cpu")
    assert t.converged and r.converged
    assert t.x.shape == np.asarray(r.x).shape
    assert t.col_rounds is None and r.col_rounds is None
    np.testing.assert_array_equal(t.col_converged, r.col_converged)
    if name in SUM:
        np.testing.assert_allclose(t.x, np.asarray(r.x), rtol=1e-5, atol=10 * ra.eps)
        assert abs(t.rounds - r.rounds) <= 1.0
    else:
        np.testing.assert_array_equal(t.x, np.asarray(r.x))
        assert t.rounds == r.rounds
        np.testing.assert_array_equal(t.state_sums, np.asarray(r.state_sums))


@pytest.mark.parametrize("name", ["sssp", "pagerank"])
def test_priority_round_budget_matches_reference(name):
    """A run cut by ``max_rounds``: the same block updates and verdict."""
    ra = _instance(name, 1)
    r = r_run_priority_block(ra, bs=32, select_frac=0.25, max_rounds=3)
    t = run_priority_block(_port(ra), bs=32, select_frac=0.25, max_rounds=3, device="cpu")
    assert t.rounds == r.rounds and t.converged == r.converged is False
    if name in SUM:
        np.testing.assert_allclose(t.x, np.asarray(r.x), rtol=1e-5, atol=1e-7)
    else:
        np.testing.assert_array_equal(t.x, np.asarray(r.x))


def test_priority_reaches_the_exact_fixpoint():
    """The reference's own check: SSSP on a high-diameter graph reaches the
    exact fixpoint with less work than full sweeps would need."""
    g = RG.scrambled(RG.barabasi_albert(600, 1, seed=3), seed=7)
    gw = RG.with_random_weights(g, seed=2)
    import repro

    ra = repro.get_algorithm("sssp", gw).relabel(r_gograph_order(g))
    t = run_priority_block(_port(ra), bs=32, select_frac=0.125, device="cpu")
    assert t.converged
    np.testing.assert_allclose(t.x, ra.exact(), atol=2e-5, rtol=1e-4)
    np.testing.assert_array_equal(t.x, r_run_priority_block(ra, bs=32, select_frac=0.125).x)


@pytest.mark.parametrize("name", ["sssp", "bfs", "sswp", "ms_sssp"])
def test_priority_eps_zero_reaches_the_fixpoint_as_reference(name):
    """With eps = 0 the scheduler stops only when nothing moves and no
    priority is pending: the lattice fixpoint, bit for bit, in both
    packages (the instances' own eps of 0.5 is an L1 mass here, and may
    stop short of it)."""
    import dataclasses

    import repro

    ra = dataclasses.replace(_instance(name, 3 if name == "ms_sssp" else 1), eps=0.0)
    fix = np.asarray(repro.solve(ra, engine="sync").x)
    r = r_run_priority_block(ra, bs=32, select_frac=0.125)
    t = run_priority_block(_port(ra), bs=32, select_frac=0.125, device="cpu")
    assert t.converged and t.rounds == r.rounds
    np.testing.assert_array_equal(t.x, np.asarray(r.x))
    np.testing.assert_array_equal(t.x, fix)


def test_priority_cuda_without_gpu_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_priority_block(_port(_instance("sssp", 1)))


@pytest.mark.parametrize("bs", [1, 7, 16, 64, 311, 512])
@pytest.mark.parametrize("kind", ["ic", "er"])
def test_block_dependency_structure_identical(kind, bs):
    g = _graph(kind)
    r = RB.block_dependency_structure(g.src, g.dst, g.n, bs)
    t = TB.block_dependency_structure(g.src.copy(), g.dst.copy(), g.n, bs)
    for a, b in zip(r, t):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()


def test_block_dependency_structure_empty_graph():
    e = np.zeros(0, np.int32)
    r = RB.block_dependency_structure(e, e, 100, 16)
    t = TB.block_dependency_structure(e, e, 100, 16)
    for a, b in zip(r, t):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()


@pytest.mark.parametrize("bs", [16, 64])
def test_priority_mass_sorted_sums_match_scatter_add(bs):
    """The mass each block receives, summed per dependent block in pair
    order, equals a scatter-add over the reference's dependency pairs."""
    from repro_torch.engine.priority import _block_dependency
    from repro_torch.engine import torch_ops as T

    ra = _instance("pagerank", 1, "ic")
    ta = _port(ra)
    _, rows, cols = RB.block_dependency_structure(ra.src, ra.dst, ra.n, bs)
    lengths, dep_src = _block_dependency(ta, bs)
    nb = len(lengths)
    delta = np.random.default_rng(bs).random(nb).astype(np.float32)
    want = np.zeros(nb, np.float64)
    np.add.at(want, rows, delta[cols])
    got = T.segment_reduce_sorted(
        "sum", torch.from_numpy(delta)[torch.from_numpy(dep_src.astype(np.int64))],
        torch.from_numpy(lengths), 0.0)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)
    np.testing.assert_array_equal(dep_src, cols)
