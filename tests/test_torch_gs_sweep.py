"""The sweep kernel's plain version against the reference kernel (Pallas,
interpret mode) and its numpy oracle, on the reference's own operands.

Lattice pairs are compared exactly on all four outputs (no tolerance;
``assert_array_equal``, the reference's own test standard, which counts
+0.0 and -0.0 as equal: max_times multiplies the in-tile fill 0 by the
-BIG padding state, and numpy, jax and torch break the resulting signed-zero
ties of ``max`` differently). plus_times sums
in another order (a batched matmul per block instead of a sequential tile
walk), so its state and deltas are held to ``atol=1e-5, rtol=1e-4``; its
active counts and dirty bitmap are compared exactly.
"""
import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.engine import algorithms as RA  # noqa: E402
from repro.graphs import generators as RG  # noqa: E402
from repro.graphs.blocked import frontier_blocks as r_frontier_blocks  # noqa: E402
from repro.kernels.gs_sweep import gs_multisweep_pallas  # noqa: E402
from repro.kernels.gs_sweep import or_dirty_blocks as r_or_dirty_blocks  # noqa: E402
from repro.kernels.ops import pack_algorithm as r_pack_algorithm  # noqa: E402
from repro.kernels.ref import ref_gs_multisweep, ref_gs_sweep  # noqa: E402

from repro_torch.interop import operands_from_arrays  # noqa: E402

K = importlib.import_module("repro_torch.kernels.gs_sweep")

N, BS = 311, 64
PAIRS = ["plus_times", "min_plus", "max_min", "max_times"]


def _reference_instance(pair: str, d: int):
    g = RG.with_random_weights(
        RG.scrambled(RG.powerlaw_cluster(N, 4, p=0.5, seed=5), seed=6),
        lo=0.1, hi=1.0, seed=7,
    )
    srcs = np.random.default_rng(d).choice(N, size=d, replace=False)
    if pair == "plus_times":
        return RA.make_personalized_pagerank(g, seeds=srcs), srcs
    if pair == "min_plus":
        return RA.make_multi_source_sssp(g, sources=srcs), srcs
    make = RA.make_sswp if pair == "max_min" else RA.make_reachability
    cols = [make(g, source=int(s)) for s in srcs]
    algo = cols[0]
    algo.x0 = np.concatenate([a.x0 for a in cols], axis=1)
    algo.c = np.repeat(algo.c, d, axis=1)
    algo.fixed = np.repeat(algo.fixed, d, axis=1)
    return algo, srcs


_CACHE: dict = {}


def _operands(pair: str, d: int):
    if (pair, d) not in _CACHE:
        algo, srcs = _reference_instance(pair, d)
        ref = r_pack_algorithm(algo, BS)
        host = {k: np.asarray(ref[k]) for k in (
            "rowptr", "tilecols", "revptr", "revrows", "tiles", "c", "x0", "fixed")}
        _CACHE[pair, d] = (algo, srcs, ref, host)
    return _CACHE[pair, d]


def _dirty(frontier: str, srcs, nb: int) -> np.ndarray:
    if frontier == "all":
        return np.ones(nb, np.int32)
    mask = np.zeros(N, bool)
    mask[srcs] = True
    return r_frontier_blocks(mask, N, BS)


def _check(pair, got, want):
    x, deltas, active, dirty = (np.asarray(a) for a in got)
    wx, wdeltas, wactive, wdirty = (np.asarray(a) for a in want)
    np.testing.assert_array_equal(active.reshape(-1), wactive.reshape(-1))
    np.testing.assert_array_equal(dirty, wdirty)
    if pair == "plus_times":
        np.testing.assert_allclose(x, wx, atol=1e-5, rtol=1e-4)
        np.testing.assert_allclose(deltas, wdeltas, atol=1e-5, rtol=1e-4)
    else:
        np.testing.assert_array_equal(x, wx)
        np.testing.assert_array_equal(deltas, wdeltas)


@pytest.mark.parametrize("frontier", ["all", "seeded"])
@pytest.mark.parametrize("sweeps", [1, 4])
@pytest.mark.parametrize("d", [1, 3])
@pytest.mark.parametrize("pair", PAIRS)
def test_plain_matches_pallas_and_oracle(pair, d, sweeps, frontier):
    algo, srcs, ref, host = _operands(pair, d)
    nb = host["rowptr"].shape[0] - 1
    dirty = _dirty(frontier, srcs, nb)
    kw = dict(semiring=ref["semiring"], combine=ref["combine"],
              res_kind=algo.residual, bs=BS, sweeps=sweeps, eps=float(algo.eps))
    ops = operands_from_arrays({**host, "dirty": dirty, "x": host["x0"]}, device="cpu")
    before = K.launches
    got = K.gs_multisweep_plain(
        ops["rowptr"], ops["tilecols"], ops["revptr"], ops["revrows"], ops["dirty"],
        ops["tiles"], ops["c"], ops["x0"], ops["fixed"], ops["x"], **kw)
    assert K.launches == before  # the plain version launches nothing
    oracle = ref_gs_multisweep(
        host["rowptr"], host["tilecols"], host["revptr"], host["revrows"], dirty,
        host["tiles"], host["c"], host["x0"], host["fixed"], host["x0"],
        **{k: v for k, v in kw.items() if k != "bs"})
    _check(pair, got, oracle)
    pallas = gs_multisweep_pallas(
        *(jnp.asarray(host[k]) for k in ("rowptr", "tilecols", "revptr", "revrows")),
        jnp.asarray(dirty),
        *(jnp.asarray(host[k]) for k in ("tiles", "c", "x0", "fixed", "x0")),
        interpret=True, **kw)
    _check(pair, got, pallas)


@pytest.mark.parametrize("pair", PAIRS)
def test_wrapper_on_cpu_runs_plain(pair):
    algo, srcs, ref, host = _operands(pair, 3)
    nb = host["rowptr"].shape[0] - 1
    dirty = _dirty("seeded", srcs, nb)
    kw = dict(semiring=ref["semiring"], combine=ref["combine"], bs=BS, sweeps=4,
              eps=float(algo.eps))
    a = operands_from_arrays({**host, "dirty": dirty, "x": host["x0"]}, device="cpu")
    b = operands_from_arrays({**host, "dirty": dirty, "x": host["x0"]}, device="cpu")
    before = K.launches
    got = K.gs_multisweep(a["rowptr"], a["tilecols"], a["revptr"], a["revrows"],
                          a["dirty"], a["tiles"], a["c"], a["x0"], a["fixed"], a["x"], **kw)
    want = K.gs_multisweep_plain(b["rowptr"], b["tilecols"], b["revptr"], b["revrows"],
                                 b["dirty"], b["tiles"], b["c"], b["x0"], b["fixed"],
                                 b["x"], **kw)
    assert K.launches == before
    assert got[0] is a["x"]  # in place, as the kernel
    for u, v in zip(got, want, strict=True):
        assert torch.equal(u, v)


@pytest.mark.parametrize("pair", PAIRS)
def test_gs_sweep_matches_oracle(pair):
    algo, _, ref, host = _operands(pair, 3)
    ops = operands_from_arrays({**host, "x": host["x0"]}, device="cpu")
    x = ops["x"]
    for _ in range(2):
        x = K.gs_sweep(ops["rowptr"], ops["tilecols"], ops["tiles"], ops["c"],
                       ops["x0"], ops["fixed"], x, semiring=ref["semiring"],
                       combine=ref["combine"], bs=BS)
    want = host["x0"]
    for _ in range(2):
        want = ref_gs_sweep(host["rowptr"], host["tilecols"], host["tiles"], host["c"],
                            host["x0"], host["fixed"], want, semiring=ref["semiring"],
                            combine=ref["combine"])
    if pair == "plus_times":
        np.testing.assert_allclose(x.numpy(), want, atol=1e-5, rtol=1e-4)
    else:
        np.testing.assert_array_equal(x.numpy(), want)


def test_unsupported_pair_and_sweeps_rejected():
    _, _, _, host = _operands("min_plus", 1)
    ops = operands_from_arrays({**host, "dirty": np.ones(5, np.int32), "x": host["x0"]},
                               device="cpu")
    args = [ops[k] for k in ("rowptr", "tilecols", "revptr", "revrows", "dirty",
                             "tiles", "c", "x0", "fixed", "x")]
    with pytest.raises(NotImplementedError, match="unsupported semiring/combine"):
        K.gs_multisweep(*args, semiring="min_plus", combine="replace", bs=BS)
    with pytest.raises(ValueError, match="sweeps"):
        K.gs_multisweep(*args, semiring="min_plus", combine="min_old", bs=BS, sweeps=0)


def test_or_dirty_blocks_matches_reference():
    dirty = np.zeros(5, np.int32)
    dirty[1] = 1
    mask = np.zeros(N, bool)
    mask[[3, 300]] = True
    want = r_or_dirty_blocks(dirty, mask, N, BS)
    np.testing.assert_array_equal(K.or_dirty_blocks(dirty, mask, N, BS), want)
    got_t = K.or_dirty_blocks(torch.from_numpy(dirty), mask, N, BS)
    assert got_t.dtype == torch.int32
    np.testing.assert_array_equal(got_t.numpy(), want)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_or_dirty_blocks_on_a_tensor_stages_the_bitmap(seed):
    """On a tensor the host bitmap is staged through ``harness.to_device``:
    the same bits as the host path and the reference, a new int32 tensor on
    the input's device, the input untouched."""
    rng = np.random.default_rng(seed)
    nb = -(-N // BS)
    dirty = (rng.random(nb) < 0.3).astype(np.int32)
    mask = rng.random(N) < 0.01
    want = r_or_dirty_blocks(dirty, mask, N, BS)
    before = torch.from_numpy(dirty.copy())
    got = K.or_dirty_blocks(before, mask, N, BS)
    assert got.dtype == torch.int32 and got.device == before.device
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), K.or_dirty_blocks(dirty, mask, N, BS))
    np.testing.assert_array_equal(before.numpy(), dirty)


def _run_plain(host, dirty, kw, order=None):
    h = dict(host)
    if order is not None:  # the kernel's per-block tile order
        h["tiles"], h["tilecols"] = host["tiles"][order], host["tilecols"][order]
    ops = operands_from_arrays({**h, "dirty": dirty, "x": host["x0"]}, device="cpu")
    return K.gs_multisweep_plain(
        ops["rowptr"], ops["tilecols"], ops["revptr"], ops["revrows"], ops["dirty"],
        ops["tiles"], ops["c"], ops["x0"], ops["fixed"], ops["x"], **kw)


@pytest.mark.parametrize("frontier", ["all", "seeded"])
@pytest.mark.parametrize("sweeps", [1, 4, 16])
@pytest.mark.parametrize("d", [1, 3])
@pytest.mark.parametrize("pair", PAIRS)
def test_kernel_tile_order_matches_block_order(pair, d, sweeps, frontier):
    """The plain version over the tiles in the kernel's order (each block's
    tiles reading j >= i first, then j < i) equals it over the packed order:
    exactly for the lattice pairs, to 1e-6 relative for plus_times (only
    the summation order moves; the deltas, differences of states, to 1e-6 of
    the largest state); at 16 sweeps also the reference kernel."""
    algo, srcs, ref, host = _operands(pair, d)
    nb = host["rowptr"].shape[0] - 1
    order = K.sweep_tile_order(host["rowptr"], host["tilecols"])
    rows = np.repeat(np.arange(nb), np.diff(host["rowptr"]))
    assert sorted(order.tolist()) == list(range(len(order)))
    assert np.array_equal(rows[order], rows)  # tiles stay in their block
    cols = host["tilecols"][order]
    for i in range(nb):
        c = cols[host["rowptr"][i]:host["rowptr"][i + 1]]
        k = int((c >= i).sum())
        assert (c[:k] >= i).all() and (np.diff(c[:k]) > 0).all()
        assert (c[k:] < i).all() and (np.diff(c[k:]) > 0).all()
    dirty = _dirty(frontier, srcs, nb)
    kw = dict(semiring=ref["semiring"], combine=ref["combine"],
              res_kind=algo.residual, bs=BS, sweeps=sweeps, eps=float(algo.eps))
    got = _run_plain(host, dirty, kw, order)
    want = _run_plain(host, dirty, kw)
    scale = float(np.abs(want[0].numpy()).max())
    for name, a, b in zip(("x", "deltas", "active", "dirty"), got, want):
        if pair == "plus_times" and name in ("x", "deltas"):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6,
                                       atol=0 if name == "x" else 1e-6 * scale)
        else:
            np.testing.assert_array_equal(a.numpy(), b.numpy())
    if sweeps == 16:
        pallas = gs_multisweep_pallas(
            *(jnp.asarray(host[k]) for k in ("rowptr", "tilecols", "revptr", "revrows")),
            jnp.asarray(dirty),
            *(jnp.asarray(host[k]) for k in ("tiles", "c", "x0", "fixed", "x0")),
            interpret=True, **kw)
        _check(pair, got, pallas)


@pytest.mark.parametrize("tmax", [0, 4, 128])
def test_units_cut_each_block_into_parts(tmax):
    """The kernel's units of a sweep: every block in order, cut into
    ceil(tiles / tmax) parts (one when tmax is 0), in a list sized for the
    most units the tiles can make."""
    _, _, _, host = _operands("plus_times", 3)
    rowptr = torch.as_tensor(host["rowptr"])
    nnz = int(rowptr[-1])
    block, part, nunits = K._units(rowptr, nnz, tmax)
    nt = np.diff(host["rowptr"])
    parts = np.maximum(1, -(-nt // tmax)) if tmax else np.ones_like(nt)
    want_b = np.repeat(np.arange(len(nt)), parts)
    want_p = np.concatenate([np.arange(k) for k in parts])
    n = int(nunits[0])
    assert n == parts.sum() <= len(block) == len(nt) + (nnz // tmax if tmax else 0)
    np.testing.assert_array_equal(block[:n].numpy(), want_b)
    np.testing.assert_array_equal(part[:n].numpy(), want_p)
    assert block.dtype == part.dtype == nunits.dtype == torch.int32
