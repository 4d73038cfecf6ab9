"""Block-sparse (flat BSR) x dense semiring product, one synchronous round:
the CUDA kernel's wrapper and its plain version.

Replaces the TPU kernel ``bsr_spmm_pallas`` of
``src/repro/kernels/bsr_spmm.py`` with a hand-written CUDA C++ kernel for
Hopper, ``csrc/bsr_spmm.cu``:

    y[i] = REDUCE_t tiles[t] (x) x[tilecols[t]],  t in [rowptr[i], rowptr[i+1])

for plus_times, min_plus, max_min and max_times; row-blocks with no tiles
get the reduce identity (the semantics of ``repro.kernels.ref.ref_bsr_spmm``).

What bounds it on the card: the tiles are read once (``nnz * bs * bs * 4``
bytes) and the product does ``2 * nnz * bs * bs * d`` operations. At the
main path's shape (bs and d multiples of 64) plus_times runs on the tensor
cores in 3xTF32 (each operand split into two TF32 parts, three products
summed in f32), so the tile stream bounds it: persistent CTAs take
row-blocks heaviest first (:func:`heavy_first`, a device-side sort) through
an atomic counter, a producer warp keeps three stages of tile and source
slices in flight with TMA, and a warpgroup runs ``wgmma``.
The lattice pairs keep one CTA per (row-block, chunk of at most 64 columns)
with the output block in registers. Every output element is summed in one
fixed order, so the result is deterministic and independent of the column
chunk ``dj``.

:func:`bsr_spmm` launches the kernel for CUDA tensors and runs
:func:`bsr_spmm_plain` for CPU tensors; there is no fallback from one to the
other. ``repro_torch.kernels.ops.bsr_spmm`` is the public entry point.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.semirings import ACC_IDENTITY, SEMIRING_CODE

# kernel launches since the count was last set to 0
launches = 0


def reset_launches() -> None:
    """Set the launch count to 0."""
    global launches
    launches = 0


def _check(rowptr, tilerows, tilecols, tiles, x, semiring: str, bs: int, dj: int):
    if semiring not in ACC_IDENTITY:
        raise NotImplementedError(
            f"bsr_spmm: unknown semiring {semiring!r}; "
            f"supported: {sorted(ACC_IDENTITY)}"
        )
    nb = rowptr.shape[0] - 1
    nnz = tiles.shape[0]
    n, d = x.shape
    if n != nb * bs or tuple(tiles.shape[1:]) != (bs, bs):
        raise ValueError(f"bsr_spmm: x has {n} rows and tiles {tuple(tiles.shape)}, "
                         f"expected nb*bs = {nb}*{bs} rows and ({bs}, {bs}) tiles")
    if dj < 1 or d % dj:
        raise ValueError(f"bsr_spmm: dj={dj} must divide d={d}")
    if not (tilerows.shape[0] == tilecols.shape[0] == nnz):
        raise ValueError("bsr_spmm: tilerows/tilecols must have one entry per tile")


def bsr_spmm_plain(rowptr, tilerows, tilecols, tiles, x, *,
                   semiring: str = "plus_times", bs: int, dj: int):
    """Torch mirror of ``ref_bsr_spmm``, on whatever device the tensors are
    on: row-block by row-block, the tile reduction as batched torch ops
    (the sweep kernel's plain arithmetic, `gs_sweep._block_agg`; plus_times
    sums in another order than a sequential tile walk). ``dj`` is checked
    and otherwise ignored. Returns a new ``f32[nb * bs, d]``."""
    from repro_torch.kernels.gs_sweep import _block_agg

    _check(rowptr, tilerows, tilecols, tiles, x, semiring, bs, dj)
    dev = x.device
    rowptr_h = torch.as_tensor(rowptr).cpu().tolist()
    cols = torch.as_tensor(tilecols).to(device=dev, dtype=torch.long)
    nb = len(rowptr_h) - 1
    d = x.shape[1]
    xs = x.view(nb, bs, d)
    ident = ACC_IDENTITY[semiring]
    y = torch.full((nb * bs, d), ident, dtype=torch.float32, device=dev)
    chunk = max(1, (1 << 25) // (bs * bs * max(d, 1)))
    for i in range(nb):
        lo, hi = rowptr_h[i], rowptr_h[i + 1]
        if lo == hi:
            continue
        acc = torch.full((bs, d), ident, dtype=torch.float32, device=dev)
        y[i * bs:(i + 1) * bs] = _block_agg(semiring, tiles, xs, lo, hi,
                                            cols[lo:hi], acc, chunk)
    return y


def _lib():
    from repro_torch.kernels._build import load

    lib = load("bsr_spmm")
    if not getattr(lib, "_spmm_typed", False):
        vp = ctypes.c_void_p
        lib.bsr_spmm_launch.argtypes = [ctypes.c_int] + [vp] * 7 + [ctypes.c_int] * 5 + [vp]
        lib.bsr_spmm_launch.restype = ctypes.c_int
        lib._spmm_typed = True
    return lib


def _require(t, name: str, dtype, device) -> None:
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"bsr_spmm: {name} must be a torch.Tensor")
    if t.device != device:
        raise ValueError(f"bsr_spmm: {name} is on {t.device}, x on {device}")
    if t.dtype != dtype:
        raise TypeError(f"bsr_spmm: {name} must be {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"bsr_spmm: {name} must be contiguous")


def heavy_first(rowptr: torch.Tensor) -> torch.Tensor:
    """Row-block ids by tile count, heaviest first (ties by id), as
    ``int32``: the order in which the tensor-core path hands out its work.
    A stable sort on the tensors' device; no host readout."""
    lens = rowptr[1:] - rowptr[:-1]
    return torch.sort(lens, descending=True, stable=True).indices.to(torch.int32)


def _launch(rowptr, tilecols, tiles, x, *, semiring, bs, dj):
    global launches
    dev = x.device
    n, d = x.shape
    nb = rowptr.shape[0] - 1
    for name, t in (("rowptr", rowptr), ("tilecols", tilecols)):
        _require(t, name, torch.int32, dev)
    for name, t in (("tiles", tiles), ("x", x)):
        _require(t, name, torch.float32, dev)
    lib = _lib()
    with torch.cuda.device(dev):
        y = torch.empty((n, d), dtype=torch.float32, device=dev)
        order = heavy_first(rowptr)
        counter = torch.zeros(1, dtype=torch.int32, device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.bsr_spmm_launch(
            SEMIRING_CODE[semiring], rowptr.data_ptr(), tilecols.data_ptr(),
            tiles.data_ptr(), x.data_ptr(), y.data_ptr(), order.data_ptr(),
            counter.data_ptr(), nb, tiles.shape[0], bs, d, dj, stream,
        )
    if err:
        raise RuntimeError(f"bsr_spmm: kernel launch failed with CUDA error {err}")
    launches += 1
    return y


def bsr_spmm(rowptr, tilerows, tilecols, tiles, x, *,
             semiring: str = "plus_times", bs: int, dj: int):
    """One synchronous semiring round over the flat BSR; the port of
    ``bsr_spmm_pallas`` (same arguments, without ``interpret``). ``dj``
    must divide ``d`` and chooses the column chunk per CTA (at most 64), never
    the result. Returns a new ``f32[nb * bs, d]``. CUDA tensors launch the
    kernel (asynchronously, on the current stream) or raise; CPU tensors run
    :func:`bsr_spmm_plain`."""
    _check(rowptr, tilerows, tilecols, tiles, x, semiring, bs, dj)
    if x.device.type == "cpu":
        return bsr_spmm_plain(rowptr, tilerows, tilecols, tiles, x,
                              semiring=semiring, bs=bs, dj=dj)
    if x.device.type != "cuda":
        raise ValueError(f"bsr_spmm: no kernel for device {x.device}")
    return _launch(rowptr, tilecols, tiles, x, semiring=semiring, bs=bs, dj=dj)
