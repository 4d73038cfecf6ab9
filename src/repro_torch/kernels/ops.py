"""Public kernel entry points and AlgoInstance -> kernel operands (port of
``repro.kernels.ops``).

:func:`bsr_spmm` and :func:`gs_sweep` take the reference's arguments
(without ``interpret``) and derive ``bs`` from the tiles. :func:`pack_algorithm`
turns an `AlgoInstance` into the ragged flat-BSR operands the sweep kernel
walks, as torch tensors on the requested device. There is no interpret
switch: the device the operands live on decides whether a wrapper launches
its kernel (CUDA) or its plain version (CPU).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.engine.algorithms import AlgoInstance
from repro_torch.graphs.blocked import pack_bsr_flat, pad_state, padded_n
from repro_torch.graphs.graph import Graph
from repro_torch.kernels.semirings import TILE_FILL


def bsr_spmm(rowptr, tilerows, tilecols, tiles, x, *, semiring="plus_times",
             dj=None):
    """One synchronous semiring round over the flat BSR (see
    `kernels.bsr_spmm`). ``dj=None`` narrows the column chunk for the
    broadcast semirings as the reference does; it chooses tiling only."""
    from repro_torch.kernels.bsr_spmm import bsr_spmm as kernel

    bs = tiles.shape[-1]
    d = x.shape[1]
    if dj is None:
        dj = d if semiring == "plus_times" else max(
            1, min(d, (512 * 1024) // (bs * bs * 4))
        )
        while d % dj:
            dj -= 1
    return kernel(rowptr, tilerows, tilecols, tiles, x, semiring=semiring,
                  bs=bs, dj=dj)


def gs_sweep(rowptr, tilecols, tiles, c, x0, fixed, x, *,
             semiring="plus_times", combine="replace"):
    """One full Gauss–Seidel sweep, all blocks dirty (see
    `kernels.gs_sweep.gs_sweep`); ``x`` is updated in place and returned."""
    from repro_torch.kernels.gs_sweep import gs_sweep as kernel

    return kernel(rowptr, tilecols, tiles, c, x0, fixed, x, semiring=semiring,
                  combine=combine, bs=tiles.shape[-1])


# (reduce, edge_op) -> kernel semiring
_KERNEL_SEMIRING = {
    ("sum", "mul"): "plus_times",
    ("min", "add"): "min_plus",
    ("max", "min"): "max_min",
    ("max", "mul"): "max_times",
}


def pack_algorithm(
    algo: AlgoInstance, bs: int, d: int | None = None,
    device: str | torch.device = "cuda",
) -> dict:
    """Pack an algorithm's graph + vectors into flat-BSR kernel operands on
    ``device``.

    The state is (n_padded, d). ``d`` defaults to ``algo.d``; a larger ``d``
    broadcasts a scalar (``algo.d == 1``) instance across the batch.
    ``x0_host`` keeps a host copy of the padded x0 so warm starts never read
    it back from the device.
    """
    key = (algo.semiring.reduce, algo.semiring.edge_op)
    if key not in _KERNEL_SEMIRING:
        raise NotImplementedError(
            f"no kernel semiring for reduce={key[0]!r} edge_op={key[1]!r}; "
            f"supported: {sorted(_KERNEL_SEMIRING)}"
        )
    from repro_torch.engine.harness import audited_sync, to_device

    semiring = _KERNEL_SEMIRING[key]
    device = torch.device(device)
    g = Graph(algo.n, algo.src, algo.dst, algo.w)
    with audited_sync():  # staging the tile payload on the device
        bsr = pack_bsr_flat(g, bs, fill=TILE_FILL[semiring], device=device)
    npad = padded_n(algo.n, bs)
    d = algo.d if d is None else d
    if d != algo.d and algo.d != 1:
        raise ValueError(f"cannot broadcast a d={algo.d} instance to d={d}")

    def padm(a, fillv):
        out = pad_state(np.asarray(a, np.float32), bs, fill=fillv)
        if d != algo.d:
            out = np.repeat(out, d, axis=1)
        return out

    def dev(a):
        return to_device(a, device)

    x0pad = padm(algo.x0, algo.semiring.identity)
    revptr, revrows = bsr.reverse_deps()
    return {
        "rowptr": dev(bsr.rowptr),
        "tilecols": dev(bsr.tilecols),
        "tilerows": dev(bsr.tilerows),
        "revptr": dev(revptr),
        "revrows": dev(revrows),
        "tiles": bsr.tiles,
        "c": dev(padm(algo.c, algo.c_pad_fill)),
        "x0": dev(x0pad),
        "x0_host": x0pad,
        "fixed": dev(padm(algo.fixed, 1.0)),  # pads pinned
        "x": dev(x0pad.copy()),
        "semiring": semiring,
        "combine": algo.combine,
        "bsr_stats": bsr.stats(),
        "npad": npad,
    }
