"""The BSR SpMM kernel's plain version and the port's public entry point
``repro_torch.kernels.bsr_spmm`` (CPU tensors) against the reference's
``repro.kernels.bsr_spmm`` (Pallas, interpret mode) and its oracle
``ref_bsr_spmm``, on the reference's own packed operands.

Lattice pairs are compared exactly (``assert_array_equal``, which counts
+0.0 and -0.0 as equal, as in the reference's own tests). plus_times sums in
another order (a batched matmul per row-block, not a sequential tile walk),
so it is held to ``rtol=1e-5, atol=1e-6`` on values of order 1 to 10.

The graph is n = 311 (a padding-heavy last block) with every in-edge of
row-block 1 removed, so the pack has empty row-blocks.
"""
import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import repro.kernels as RK  # noqa: E402
from repro.engine.algorithms import BIG  # noqa: E402
from repro.graphs import generators as RG  # noqa: E402
from repro.graphs.blocked import pack_bsr_flat  # noqa: E402
from repro.graphs.graph import Graph as RGraph  # noqa: E402
from repro.kernels.ref import ref_bsr_spmm  # noqa: E402
from repro.kernels.semirings import TILE_FILL  # noqa: E402

import repro_torch.kernels as TK  # noqa: E402
from repro_torch.kernels.bsr_spmm import bsr_spmm_plain  # noqa: E402

KMOD = importlib.import_module("repro_torch.kernels.bsr_spmm")

N = 311
PAIRS = ["plus_times", "min_plus", "max_min", "max_times"]


def _graph(bs: int):
    g = RG.with_random_weights(
        RG.scrambled(RG.powerlaw_cluster(N, 4, p=0.5, seed=51), seed=52),
        lo=0.1, hi=1.0, seed=53,
    )
    keep = (g.dst // bs) != 1  # row-block 1 has no tiles at all
    return RGraph(N, g.src[keep], g.dst[keep], g.w[keep])


def _state(pair: str, npad: int, d: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    if pair == "plus_times":
        return rng.uniform(0.0, 1.0, (npad, d)).astype(np.float32)
    x = rng.uniform(0.0, 5.0, (npad, d))
    if pair == "min_plus":
        x[rng.random((npad, d)) < 0.3] = BIG
    elif pair == "max_min":
        x[rng.random((npad, d)) < 0.3] = -BIG
    return x.astype(np.float32)


def _operands(pair: str, bs: int, d: int, g=None):
    bsr = pack_bsr_flat(_graph(bs) if g is None else g, bs, fill=TILE_FILL[pair])
    x = _state(pair, bsr.nb * bs, d, seed=61 + d)
    return bsr, x


def _port_args(bsr, x):
    return (torch.as_tensor(bsr.rowptr), torch.as_tensor(bsr.tilerows),
            torch.as_tensor(bsr.tilecols), torch.as_tensor(bsr.tiles),
            torch.as_tensor(x))


def _ref_args(bsr, x):
    return (jnp.asarray(bsr.rowptr), jnp.asarray(bsr.tilerows),
            jnp.asarray(bsr.tilecols), jnp.asarray(bsr.tiles), jnp.asarray(x))


def _assert_same(pair, got, want):
    if pair == "plus_times":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    else:
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("d", [1, 3, 8])
@pytest.mark.parametrize("bs", [16, 64])
@pytest.mark.parametrize("pair", PAIRS)
def test_matches_reference_and_oracle(pair, bs, d):
    bsr, x = _operands(pair, bs, d)
    assert np.any(bsr.rowptr[1:] == bsr.rowptr[:-1])  # empty row-blocks exist
    want = ref_bsr_spmm(bsr.rowptr, bsr.tilecols, bsr.tiles, x, semiring=pair)
    ref = np.asarray(RK.bsr_spmm(*_ref_args(bsr, x), semiring=pair))
    plain = bsr_spmm_plain(*_port_args(bsr, x), semiring=pair, bs=bs, dj=d).numpy()
    before = KMOD.launches
    port = TK.bsr_spmm(*_port_args(bsr, x), semiring=pair).numpy()
    assert KMOD.launches == before  # CPU tensors never launch the kernel
    _assert_same(pair, plain, want)
    _assert_same(pair, plain, ref)
    np.testing.assert_array_equal(port, plain)
    empty = np.repeat(bsr.rowptr[1:] == bsr.rowptr[:-1], bs)
    np.testing.assert_array_equal(
        port[empty], np.full((int(empty.sum()), d), want[empty][0, 0], np.float32))


@pytest.mark.parametrize("pair", PAIRS)
def test_dj_chooses_tiling_not_results(pair):
    bsr, x = _operands(pair, 16, 8)
    full = TK.bsr_spmm(*_port_args(bsr, x), semiring=pair).numpy()
    for dj in (1, 2, 4, 8):
        got = TK.bsr_spmm(*_port_args(bsr, x), semiring=pair, dj=dj).numpy()
        np.testing.assert_array_equal(got, full)
    with pytest.raises(ValueError, match="must divide"):
        TK.bsr_spmm(*_port_args(bsr, x), semiring=pair, dj=3)


@pytest.mark.parametrize("pair", PAIRS)
def test_empty_graph_is_identity(pair):
    g = RGraph(N, np.zeros(0, np.int32), np.zeros(0, np.int32))
    bsr, x = _operands(pair, 64, 3, g=g)
    ref = np.asarray(RK.bsr_spmm(*_ref_args(bsr, x), semiring=pair))
    port = TK.bsr_spmm(*_port_args(bsr, x), semiring=pair).numpy()
    np.testing.assert_array_equal(port, ref)
    assert np.all(port == port.flat[0])


def test_unknown_semiring_rejected():
    bsr, x = _operands("plus_times", 16, 1)
    with pytest.raises(NotImplementedError, match="unknown semiring"):
        TK.bsr_spmm(*_port_args(bsr, x), semiring="min_times")


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_heavy_first_orders_rows_by_tiles(seed):
    """The tensor-core path's work order: row-blocks by tile count,
    heaviest first, ties by id (a stable sort), as int32."""
    B = importlib.import_module("repro_torch.kernels.bsr_spmm")
    lens = np.random.default_rng(seed).integers(0, 5, size=40)
    rowptr = torch.as_tensor(np.concatenate([[0], np.cumsum(lens)]).astype(np.int32))
    order = B.heavy_first(rowptr)
    assert order.dtype == torch.int32
    np.testing.assert_array_equal(order.numpy(), np.argsort(-lens, kind="stable"))
