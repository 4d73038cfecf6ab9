"""Block packing of a (reordered) graph for the block engines and the kernel.

Counterpart of ``repro.graphs.blocked``. Three packings:

* :class:`BlockedInEdges` — per-destination-block padded in-edge lists, used
  by the torch-ops block Gauss–Seidel engine (`engine/async_block.py`).

* :class:`FlatBSRMatrix` — the **ragged flat** block-sparse layout the
  hand-written sweep kernel (`kernels/gs_sweep.py`) walks: one dense
  ``(bs, bs)`` tile per *nonzero* block of the in-adjacency matrix, stored in
  CSR-of-tiles form (``tiles[nnz_blocks, bs, bs]`` + ``rowptr[nb+1]`` /
  ``tilecols[nnz_blocks]``).

* :class:`BSRMatrix` — the dense-padded block-sparse rows the flat layout
  replaced (every row-block pays for the densest one's ``k_max`` tiles),
  kept as the locality benchmark's baseline and for its ``stats()``.

:func:`block_dependency_structure` is the tile structure alone, without
payloads: the skeleton the priority engine schedules over.

The index arrays stay host numpy. :func:`pack_bsr_flat` and
:func:`pack_bsr` scatter the tile payload with torch on the requested device
(``"cuda"`` unless asked otherwise): at a graph of 10^5 vertices the tiles
are several GB, so building them where they are used saves the host copy
and the transfer. On the CPU the tiles equal the reference packers' byte for
byte.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.graphs.graph import Graph


def num_blocks(n: int, bs: int) -> int:
    return (n + bs - 1) // bs


def padded_n(n: int, bs: int) -> int:
    return num_blocks(n, bs) * bs


@dataclasses.dataclass
class BlockedInEdges:
    """Padded per-destination-block in-edge lists.

    For destination block i, edge slot j:
      esrc[i, j]   global source vertex id (0 for pads)
      edst[i, j]   destination vertex id *local to the block* (0 for pads)
      ew[i, j]     edge weight (0 for pads; pads also masked)
      emask[i, j]  True for real edges
    """

    bs: int
    n: int  # real vertex count (before padding)
    esrc: np.ndarray
    edst: np.ndarray
    ew: np.ndarray
    emask: np.ndarray

    @property
    def nb(self) -> int:
        return self.esrc.shape[0]


def pack_in_edges(g: Graph, bs: int) -> BlockedInEdges:
    nb = num_blocks(g.n, bs)
    blk = g.dst // bs
    order = np.argsort(blk, kind="stable")
    src_s, dst_s, w_s = g.src[order], g.dst[order], g.weights[order]
    blk_s = blk[order]
    counts = np.bincount(blk, minlength=nb)
    e_max = max(1, int(counts.max()) if len(counts) else 1)
    esrc = np.zeros((nb, e_max), dtype=np.int32)
    edst = np.zeros((nb, e_max), dtype=np.int32)
    ew = np.zeros((nb, e_max), dtype=np.float32)
    emask = np.zeros((nb, e_max), dtype=bool)
    offsets = np.zeros(nb + 1, dtype=np.int64)
    np.cumsum(counts, out=offsets[1:])
    slot = np.arange(len(blk_s), dtype=np.int64) - offsets[blk_s]
    esrc[blk_s, slot] = src_s
    edst[blk_s, slot] = dst_s - blk_s * bs
    ew[blk_s, slot] = w_s
    emask[blk_s, slot] = True
    return BlockedInEdges(bs=bs, n=g.n, esrc=esrc, edst=edst, ew=ew, emask=emask)


@dataclasses.dataclass
class FlatBSRMatrix:
    """Ragged flat BSR of the in-adjacency: CSR over (bs, bs) tiles.

    For destination block i, tiles ``rowptr[i]..rowptr[i+1]`` hold its
    nonzero column-blocks in ascending column order:

        y_blk[i] = REDUCE_{t in [rowptr[i], rowptr[i+1])} tiles[t] (x) x_blk[tilecols[t]]

    ``tiles[t]`` has layout (dst_local, src_local); absent edges inside a
    nonzero tile carry ``fill``. Empty graphs keep one never-referenced tile
    so device buffers are never zero-sized; ``nnz_blocks`` reads the real
    count from ``rowptr[-1]``. ``tiles`` is a torch tensor on the device it
    was packed for; the index arrays are host numpy.
    """

    bs: int
    n: int
    rowptr: np.ndarray    # int32[nb + 1]
    tilecols: np.ndarray  # int32[max(nnz_blocks, 1)]
    tilerows: np.ndarray  # int32[max(nnz_blocks, 1)]  (derived)
    tiles: torch.Tensor   # float32[max(nnz_blocks, 1), bs, bs]
    fill: float

    @property
    def nb(self) -> int:
        return self.rowptr.shape[0] - 1

    @property
    def nnz_blocks(self) -> int:
        return int(self.rowptr[-1])

    @property
    def k_max(self) -> int:
        """Densest row-block."""
        if self.nb == 0:
            return 1
        return max(1, int(np.diff(self.rowptr).max()))

    def reverse_deps(self) -> tuple[np.ndarray, np.ndarray]:
        """Block reverse-dependency CSR (see :func:`block_reverse_deps`)."""
        return block_reverse_deps(self.rowptr, self.tilecols)

    def stats(self) -> dict:
        """Layout statistics: tile counts and bytes."""
        per_row = np.diff(self.rowptr)
        nnz = self.nnz_blocks
        k_max = self.k_max
        diag = int(np.count_nonzero(self.tilecols[:nnz] == self.tilerows[:nnz]))
        tile_bytes = nnz * self.bs * self.bs * 4
        dense_tile_bytes = self.nb * k_max * self.bs * self.bs * 4
        return {
            "nb": self.nb,
            "k_max": k_max,
            "nnz_blocks": nnz,
            "mean_colblocks_per_rowblock": float(per_row.mean()) if self.nb else 0.0,
            "max_colblocks_per_rowblock": int(per_row.max()) if self.nb else 0,
            "diag_fraction": diag / max(1, self.nb),
            "tile_bytes": tile_bytes,
            "dense_tile_bytes": dense_tile_bytes,
            "tile_bytes_saved": dense_tile_bytes - tile_bytes,
            "padding_waste": 1.0 - nnz / max(1, self.nb * k_max),
        }


@dataclasses.dataclass
class BSRMatrix:
    """Dense-padded block-sparse rows (legacy layout, benchmark baseline).

    tiles[i, k] has layout (dst_local, src_local): row r of tile (i,k) holds
    the weights of edges into vertex i*bs+r from vertices cols[i,k]*bs + c.
    Padding tiles point at column-block 0 with `fill` values so semiring
    reduction ignores them (0 for plus_times, +inf for min_plus). Every
    row-block pays for the global k_max; `stats()['padding_waste']` is the
    fraction of tile memory that padding is. ``tiles`` is a torch tensor on
    the device it was packed for; ``cols`` and ``colmask`` are host numpy.
    """

    bs: int
    n: int
    cols: np.ndarray      # int32[nb, k_max]
    colmask: np.ndarray   # bool[nb, k_max]
    tiles: torch.Tensor   # float32[nb, k_max, bs, bs]
    fill: float

    @property
    def nb(self) -> int:
        return self.cols.shape[0]

    @property
    def k_max(self) -> int:
        return self.cols.shape[1]

    def stats(self) -> dict:
        """Locality proxies: tile counts per row-block, diagonal share,
        bytes and padding."""
        nnz_blocks = int(self.colmask.sum())
        per_row = self.colmask.sum(axis=1)
        diag = int(np.count_nonzero(
            np.any((self.cols == np.arange(self.nb)[:, None]) & self.colmask,
                   axis=1)
        ))
        return {
            "nb": self.nb,
            "k_max": self.k_max,
            "nnz_blocks": nnz_blocks,
            "mean_colblocks_per_rowblock": float(per_row.mean()) if self.nb else 0.0,
            "max_colblocks_per_rowblock": int(per_row.max()) if self.nb else 0,
            "diag_fraction": diag / max(1, self.nb),
            "tile_bytes": self.tiles.numel() * self.tiles.element_size(),
            "padding_waste": 1.0 - nnz_blocks / max(1, self.nb * self.k_max),
        }


def _sorted_tile_edges(g: Graph, bs: int):
    """Edges sorted by (dst block, src block) with their tile grouping,
    shared by the dense and flat packers so both layouts hold the same
    tiles."""
    nb = num_blocks(g.n, bs)
    bi = (g.dst // bs).astype(np.int64)  # row (dst) block
    bk = (g.src // bs).astype(np.int64)  # col (src) block
    key = bi * nb + bk
    order = np.argsort(key, kind="stable")
    src_s, dst_s, w_s = g.src[order], g.dst[order], g.weights[order]
    key_s = key[order]
    uniq, tile_of_edge = np.unique(key_s, return_inverse=True)
    rows = (uniq // nb).astype(np.int64)
    cols_of = (uniq % nb).astype(np.int64)
    return nb, src_s, dst_s, w_s, tile_of_edge, rows, cols_of


def _scatter_tiles(shape, flat: np.ndarray, w: np.ndarray, fill: float,
                   device) -> torch.Tensor:
    """A ``shape`` tile payload at ``fill`` on ``device``, edge weights ``w``
    scattered to flat positions ``flat``."""
    tiles = torch.full(shape, fill, dtype=torch.float32, device=device)
    tiles.view(-1)[torch.from_numpy(flat).to(device)] = torch.from_numpy(
        np.ascontiguousarray(w, dtype=np.float32)
    ).to(device)
    return tiles


def pack_bsr(
    g: Graph, bs: int, fill: float = 0.0, device: str | torch.device = "cuda"
) -> BSRMatrix:
    """Pack the in-adjacency into the dense-padded layout; the payload is
    filled and scattered on ``device``, as :func:`pack_bsr_flat` does."""
    nb, src_s, dst_s, w_s, tile_of_edge, rows, cols_of = _sorted_tile_edges(g, bs)
    per_row = np.bincount(rows, minlength=nb)
    k_max = max(1, int(per_row.max()) if nb else 1)
    cols = np.zeros((nb, k_max), dtype=np.int32)
    colmask = np.zeros((nb, k_max), dtype=bool)
    # tiles arrive sorted by (row, col), so a tile's k-slot is its index
    # minus its row's first tile index
    row_start = np.zeros(nb + 1, dtype=np.int64)
    np.cumsum(per_row, out=row_start[1:])
    slot = np.arange(len(rows), dtype=np.int64) - row_start[rows]
    cols[rows, slot] = cols_of
    colmask[rows, slot] = True
    er = rows[tile_of_edge]       # per-edge destination block
    ec = cols_of[tile_of_edge]    # per-edge source block
    flat = ((er * k_max + slot[tile_of_edge]) * bs + (dst_s - er * bs)) * bs + (src_s - ec * bs)
    tiles = _scatter_tiles((nb, k_max, bs, bs), flat, w_s, fill, device)
    return BSRMatrix(bs=bs, n=g.n, cols=cols, colmask=colmask, tiles=tiles, fill=fill)


def pack_bsr_flat(
    g: Graph, bs: int, fill: float = 0.0, device: str | torch.device = "cuda"
) -> FlatBSRMatrix:
    """Pack the in-adjacency into the ragged flat layout the kernel walks.

    The (tile, row, col) index of every edge is computed on the host; the
    ``nnz_blocks * bs * bs`` payload is filled and scattered on ``device``.
    Graphs hold no duplicate (src, dst) pair (the generators deduplicate):
    which copy of a duplicate would win is unspecified on the GPU.
    """
    nb, src_s, dst_s, w_s, tile_of_edge, rows, cols_of = _sorted_tile_edges(g, bs)
    nnz = len(rows)
    per_row = np.bincount(rows, minlength=nb)
    rowptr = np.zeros(nb + 1, dtype=np.int64)
    np.cumsum(per_row, out=rowptr[1:])
    er = rows[tile_of_edge]
    ec = cols_of[tile_of_edge]
    flat = (tile_of_edge.astype(np.int64) * bs + (dst_s - er * bs)) * bs + (src_s - ec * bs)
    tiles = _scatter_tiles((max(1, nnz), bs, bs), flat, w_s, fill, device)
    tilecols = cols_of.astype(np.int32) if nnz else np.zeros(1, np.int32)
    tilerows = rows.astype(np.int32) if nnz else np.zeros(1, np.int32)
    return FlatBSRMatrix(
        bs=bs, n=g.n, rowptr=rowptr.astype(np.int32), tilecols=tilecols,
        tilerows=tilerows, tiles=tiles, fill=fill,
    )


def block_reverse_deps(
    rowptr: np.ndarray, tilecols: np.ndarray
) -> tuple[np.ndarray, np.ndarray]:
    """CSC of the tile structure: ``(revptr[nb+1], revrows)`` where source
    (column) block j's dependents — the destination blocks holding a tile
    that reads j — are ``revrows[revptr[j]:revptr[j+1]]``, in ascending row
    order. The empty structure keeps one never-referenced zero entry."""
    rowptr = np.asarray(rowptr)
    nb = len(rowptr) - 1
    nnz = int(rowptr[-1])
    cols = np.asarray(tilecols)[:nnz]
    rows = np.repeat(np.arange(nb, dtype=np.int32), np.diff(rowptr))
    order = np.argsort(cols, kind="stable")
    revrows = rows[order].astype(np.int32) if nnz else np.zeros(1, np.int32)
    revptr = np.zeros(nb + 1, dtype=np.int64)
    np.cumsum(np.bincount(cols, minlength=nb), out=revptr[1:])
    return revptr.astype(np.int32), revrows


def frontier_blocks(frontier, n: int, bs: int) -> np.ndarray:
    """Pack a vertex-level dirty mask into the per-row-block bitmap the
    kernel's frontier consumes: block i is dirty iff any of its vertices is.
    ``frontier=None`` marks every block dirty — the only always-safe cold
    start, since a clean block claims its state already satisfies its update
    equation."""
    nb = num_blocks(n, bs)
    if frontier is None:
        return np.ones(nb, np.int32)
    f = np.asarray(frontier)
    if f.shape != (n,):
        raise ValueError(
            f"frontier must be a vertex-level mask of shape ({n},), got {f.shape}"
        )
    fp = np.zeros(nb * bs, bool)
    fp[:n] = f != 0
    return fp.reshape(nb, bs).any(axis=1).astype(np.int32)


def pad_state(x: np.ndarray, bs: int, fill=0.0) -> np.ndarray:
    """Pad a per-vertex state array (n, ...) up to a whole number of blocks
    along axis 0 with ``fill``."""
    n = x.shape[0]
    np_ = padded_n(n, bs)
    if np_ == n:
        return x.copy()
    pad_width = [(0, np_ - n)] + [(0, 0)] * (x.ndim - 1)
    return np.pad(x, pad_width, constant_values=fill)


def block_dependency_structure(
    src: np.ndarray, dst: np.ndarray, n: int, bs: int
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The nonzero block structure only — ``(rowptr, tilerows, tilecols)``
    over unique (dst block, src block) pairs, no tile payloads. This is the
    O(nnz_blocks) skeleton the priority scheduler propagates deltas over
    (``prio[tilerows] += delta[tilecols]``) instead of a dense (nb, nb)
    indicator matmul."""
    nb = num_blocks(n, bs)
    key = (np.asarray(dst, np.int64) // bs) * nb + (np.asarray(src, np.int64) // bs)
    uniq = np.unique(key)
    rows = (uniq // nb).astype(np.int32)
    cols = (uniq % nb).astype(np.int32)
    rowptr = np.zeros(nb + 1, dtype=np.int64)
    np.cumsum(np.bincount(rows, minlength=nb), out=rowptr[1:])
    return rowptr.astype(np.int32), rows, cols
