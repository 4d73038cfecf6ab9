"""Multi-sweep block Gauss–Seidel: the CUDA kernel's wrapper and its plain
version.

Replaces the TPU kernel ``gs_multisweep_pallas`` of
``src/repro/kernels/gs_sweep.py`` (and ``gs_sweep_pallas``, its one-sweep
form) with a hand-written CUDA C++ kernel for Hopper, ``csrc/gs_sweep.cu``.
Per destination block i, in block order, for up to ``sweeps`` sweeps:

    agg  = REDUCE_t tiles[t] (x) x[tilecols[t]],  t in [rowptr[i], rowptr[i+1])
    newb = combine(c[i], agg, oldb);  newb = fixed ? x0 : newb;  x[i] <- newb

gated by a dirty-block frontier, with per-sweep per-column deltas, active
block counts and a sticky all-columns-below-eps early-out (the semantics of
``repro.kernels.ref.ref_gs_multisweep``).

What bounds it on the card: a full sweep reads every tile once
(``nnz * bs * bs * 4`` bytes) plus one gathered ``(bs, d)`` source block per
tile, and does ``2 * nnz * bs * bs * d`` f32 operations — at d = 64 the
operations dominate — and block i cannot finish before the blocks j < i it
reads. The kernel is one persistent cooperative launch per batch of sweeps
that keeps many blocks in flight: CTAs claim (sweep, part of a block) units
in ascending order (a block's tiles cut into parts of at most 128, listed by
:func:`_units`), each block waits only for the in-sweep sources it reads
(per-block publication words), the state is ping-ponged between ``x`` and a
scratch buffer so no block overwrites rows an earlier block has yet to
read, and one wait per sweep closes it. A block reduces its tiles in a
fixed order (:func:`sweep_tile_order`), so plus_times is repeatable bit for
bit. The frontier is read off the tiles (a block is dirty iff a block it
reads changed since its turn), so ``revptr``/``revrows`` must be the
reverse of ``(rowptr, tilecols)``, as ``ops.pack_algorithm`` builds them.

:func:`gs_multisweep` launches the kernel for CUDA tensors and runs
:func:`gs_multisweep_plain` for CPU tensors; there is no fallback from one
to the other.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.kernels.semirings import (
    ACC_IDENTITY,
    DELTA_METRIC,
    RES_KIND_CODE,
    SEMIRING_CODE,
    delta_cols,
)

# kernel launches since the count was last set to 0
launches = 0

_SUPPORTED = {
    ("plus_times", "replace"),
    ("min_plus", "min_old"),
    ("max_min", "max_old"),
    ("max_times", "max_old"),
}


def reset_launches() -> None:
    """Set the launch count to 0."""
    global launches
    launches = 0


def _check_pair(semiring: str, combine: str) -> None:
    if (semiring, combine) not in _SUPPORTED:
        raise NotImplementedError(
            f"gs_sweep: unsupported semiring/combine pair "
            f"({semiring!r}, {combine!r}); supported: {sorted(_SUPPORTED)}"
        )


def or_dirty_blocks(dirty, vertex_mask, n: int, bs: int):
    """OR a vertex-level support mask into a per-row-block dirty bitmap.

    ``dirty`` may be host numpy or a torch tensor; a tensor is OR-ed on its
    own device and stays there (the host bitmap is staged through
    `harness.to_device`, an audited copy)."""
    from repro_torch.engine.harness import to_device
    from repro_torch.graphs.blocked import frontier_blocks

    add = frontier_blocks(np.asarray(vertex_mask), n, bs)
    if isinstance(dirty, torch.Tensor):
        return torch.maximum(dirty, to_device(add, dirty.device)).to(torch.int32)
    return np.maximum(np.asarray(dirty, np.int32), add).astype(np.int32)


def sweep_tile_order(rowptr, tilecols) -> np.ndarray:
    """The order in which the kernel reduces each block's tiles: first the
    tiles reading blocks ``j >= i`` (the last sweep's rows), then those
    reading ``j < i`` (this sweep's), each ascending by column. Returns the
    permutation of tile indices; ``rowptr`` is unchanged by it. The kernel
    indexes this order without moving tiles."""
    rowptr = np.asarray(torch.as_tensor(rowptr).cpu(), np.int64)
    cols = np.asarray(torch.as_tensor(tilecols).cpu(), np.int64)
    nb = len(rowptr) - 1
    rows = np.repeat(np.arange(nb), np.diff(rowptr))
    t = np.arange(int(rowptr[-1]))
    return np.lexsort((cols[t], cols[t] < rows, rows)).astype(np.int64)


# ---------------------------------------------------------------------------
# plain version
# ---------------------------------------------------------------------------

def _block_agg(semiring: str, tiles: torch.Tensor, xs: torch.Tensor,
               lo: int, hi: int, cols: torch.Tensor, acc: torch.Tensor,
               chunk: int) -> torch.Tensor:
    """acc <- acc (reduce) REDUCE_{t in [lo, hi)} tiles[t] (x) xs[cols[t]]."""
    for a in range(lo, hi, chunk):
        b = min(hi, a + chunk)
        T = tiles[a:b]           # (k, bs, bs)
        X = xs[cols[a - lo:b - lo]]  # (k, bs, d)
        if semiring == "plus_times":
            acc = acc + torch.bmm(T, X).sum(dim=0)
        elif semiring == "min_plus":
            part = torch.amin(T[:, :, :, None] + X[:, None, :, :], dim=(0, 2))
            acc = torch.minimum(acc, part)
        elif semiring == "max_min":
            part = torch.amax(torch.minimum(T[:, :, :, None], X[:, None, :, :]),
                              dim=(0, 2))
            acc = torch.maximum(acc, part)
        elif semiring == "max_times":
            part = torch.amax(T[:, :, :, None] * X[:, None, :, :], dim=(0, 2))
            acc = torch.maximum(acc, part)
        else:
            raise ValueError(semiring)
    return acc


def _combine(kind: str, agg, c, old, fixed, x0):
    if kind == "replace":
        new = c + agg
    elif kind == "min_old":
        new = torch.minimum(old, torch.minimum(c, agg))
    elif kind == "max_old":
        new = torch.maximum(old, torch.maximum(c, agg))
    else:
        raise ValueError(kind)
    return torch.where(fixed != 0, x0, new)


def gs_multisweep_plain(
    rowptr, tilecols, revptr, revrows, dirty, tiles, c, x0, fixed, x, *,
    semiring: str = "plus_times", combine: str = "replace",
    res_kind: str | None = None, bs: int, sweeps: int = 1, eps: float = -1.0,
):
    """Torch mirror of ``ref_gs_multisweep``: up to ``sweeps``
    frontier-gated sweeps with in-place state updates, on whatever device
    the tensors are on. The index arrays and the dirty bitmap are walked on
    the host; the tile arithmetic runs as batched torch ops per block
    (sum order differs from a sequential tile walk only for plus_times).

    Returns ``(x, deltas[sweeps, d], active[sweeps, 1], dirty_out[nb])``;
    ``x`` is the input tensor, updated in place.
    """
    _check_pair(semiring, combine)
    if res_kind is None:
        res_kind = DELTA_METRIC[semiring]
    dev = x.device
    rowptr = np.asarray(torch.as_tensor(rowptr).cpu())
    revptr = np.asarray(torch.as_tensor(revptr).cpu())
    revrows = np.asarray(torch.as_tensor(revrows).cpu())
    cols_all = torch.as_tensor(tilecols).to(device=dev, dtype=torch.long)
    nb = len(rowptr) - 1
    d = x.shape[1]
    xs = x.view(nb, bs, d)
    dirty_s = np.asarray(torch.as_tensor(dirty).cpu(), np.int32).copy()
    deltas = torch.zeros((sweeps, d), dtype=torch.float32, device=dev)
    active = torch.zeros((sweeps, 1), dtype=torch.float32, device=dev)
    ident = ACC_IDENTITY[semiring]
    chunk = max(1, (1 << 25) // (bs * bs * max(d, 1)))
    done = False
    for s in range(sweeps):
        if done:
            continue
        dacc = torch.zeros((d,), dtype=torch.float32, device=dev)
        for i in range(nb):
            if not dirty_s[i]:
                continue
            dirty_s[i] = 0
            lo, hi = int(rowptr[i]), int(rowptr[i + 1])
            acc = torch.full((bs, d), ident, dtype=torch.float32, device=dev)
            acc = _block_agg(semiring, tiles, xs, lo, hi, cols_all[lo:hi], acc,
                             chunk)
            sl = slice(i * bs, (i + 1) * bs)
            old = x[sl].clone()
            new = _combine(combine, acc, c[sl], old, fixed[sl], x0[sl])
            dblk = delta_cols(res_kind, new, old)
            if res_kind == "linf":
                dacc = torch.maximum(dacc, dblk)
            else:
                dacc = dacc + dblk
            active[s] += 1.0
            x[sl] = new
            if bool((new != old).any()):
                for t in range(int(revptr[i]), int(revptr[i + 1])):
                    dirty_s[revrows[t]] = 1
        deltas[s] = dacc
        if bool((dacc <= eps).all()):
            done = True
    return x, deltas, active, torch.as_tensor(dirty_s, device=dev)


# ---------------------------------------------------------------------------
# kernel wrapper
# ---------------------------------------------------------------------------

def _lib():
    from repro_torch.kernels._build import load

    lib = load("gs_sweep")
    if not getattr(lib, "_gs_typed", False):
        vp = ctypes.c_void_p
        lib.gs_multisweep_plan.argtypes = [
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_longlong, ctypes.c_int, ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_longlong), ctypes.POINTER(ctypes.c_longlong),
            ctypes.POINTER(ctypes.c_int),
        ]
        lib.gs_multisweep_plan.restype = ctypes.c_int
        lib.gs_multisweep_launch.argtypes = (
            [ctypes.c_int, ctypes.c_int] + [vp] * 16
            + [ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_int, ctypes.c_int, vp]
        )
        lib.gs_multisweep_launch.restype = ctypes.c_int
        lib._gs_typed = True
    return lib


def _require(t: torch.Tensor, name: str, dtype, shape, device) -> None:
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"gs_multisweep: {name} must be a torch.Tensor")
    if t.device != device:
        raise ValueError(f"gs_multisweep: {name} is on {t.device}, x on {device}")
    if t.dtype != dtype:
        raise TypeError(f"gs_multisweep: {name} must be {dtype}, got {t.dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"gs_multisweep: {name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"gs_multisweep: {name} must be contiguous")


def _overlaps(a: torch.Tensor, b: torch.Tensor) -> bool:
    a0, b0 = a.data_ptr(), b.data_ptr()
    return a0 < b0 + b.numel() * b.element_size() and b0 < a0 + a.numel() * a.element_size()


def _units(rowptr, nnz: int, tmax: int):
    """The units of a sweep, in the order the kernel claims them: block by
    block, each block split into ``ceil(tiles / tmax)`` parts of its fixed
    tile order (one part when ``tmax`` is 0). Returns ``(unit_block,
    unit_part, nunits[1])`` as int32 tensors on the device, sized for the
    most units ``nnz`` tiles can make, with no host synchronisation."""
    nb = rowptr.shape[0] - 1
    dev = rowptr.device
    nt = (rowptr[1:] - rowptr[:-1]).to(torch.int64)
    parts = torch.clamp((nt + tmax - 1) // tmax, min=1) if tmax else torch.ones_like(nt)
    cum = torch.cumsum(parts, 0)
    idx = torch.arange(nb + (nnz // tmax if tmax else 0), device=dev)
    block = torch.searchsorted(cum, idx, right=True).clamp_(max=nb - 1)
    part = idx - (cum - parts)[block]
    return block.to(torch.int32), part.to(torch.int32), cum[-1:].to(torch.int32)


def _launch(rowptr, tilecols, revptr, revrows, dirty, tiles, c, x0, fixed, x,
            *, semiring, res_kind, bs, sweeps, eps):
    global launches
    dev = x.device
    n, d = x.shape
    nb = rowptr.shape[0] - 1
    if nb < 1 or n != nb * bs:
        raise ValueError(f"gs_multisweep: x has {n} rows, expected nb*bs = {nb}*{bs}")
    nnz = tiles.shape[0]
    i32, f32 = torch.int32, torch.float32
    _require(rowptr, "rowptr", i32, (nb + 1,), dev)
    _require(tilecols, "tilecols", i32, (nnz,), dev)
    _require(revptr, "revptr", i32, (nb + 1,), dev)
    _require(revrows, "revrows", i32, None, dev)
    _require(dirty, "dirty", i32, (nb,), dev)
    _require(tiles, "tiles", f32, (nnz, bs, bs), dev)
    for name, t in (("c", c), ("x0", x0), ("fixed", fixed), ("x", x)):
        _require(t, name, f32, (n, d), dev)
    for name, t in (("x0", x0), ("c", c), ("fixed", fixed)):
        if _overlaps(x, t):
            raise ValueError(f"gs_multisweep: the state x must not share memory with {name}")
    lib = _lib()
    sr, rk = SEMIRING_CODE[semiring], RES_KIND_CODE[res_kind]
    grid = ctypes.c_int(0)
    ctrl_n = ctypes.c_longlong(0)
    scratch_n = ctypes.c_longlong(0)
    tmax = ctypes.c_int(0)
    aligned = all(t.data_ptr() % 16 == 0 for t in (x, tiles, c, x0, fixed))
    with torch.cuda.device(dev):
        err = lib.gs_multisweep_plan(sr, rk, bs, d, nb, nnz, int(aligned), ctypes.byref(grid),
                                     ctypes.byref(ctrl_n), ctypes.byref(scratch_n),
                                     ctypes.byref(tmax))
        if err:
            raise RuntimeError(f"gs_multisweep: planning failed with CUDA error {err} "
                               f"(bs={bs}, d={d}, nb={nb})")
        unit_block, unit_part, nunits = _units(rowptr, nnz, tmax.value)
        deltas = torch.empty((sweeps, d), dtype=f32, device=dev)
        active = torch.empty((sweeps, 1), dtype=f32, device=dev)
        dirty_out = torch.empty((nb,), dtype=i32, device=dev)
        ctrl = torch.zeros((ctrl_n.value,), dtype=i32, device=dev)
        scratch = torch.empty((scratch_n.value,), dtype=f32, device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.gs_multisweep_launch(
            sr, rk, rowptr.data_ptr(), tilecols.data_ptr(), dirty.data_ptr(),
            tiles.data_ptr(), c.data_ptr(), x0.data_ptr(), fixed.data_ptr(),
            x.data_ptr(), deltas.data_ptr(), active.data_ptr(), dirty_out.data_ptr(),
            ctrl.data_ptr(), scratch.data_ptr(), unit_block.data_ptr(),
            unit_part.data_ptr(), nunits.data_ptr(), nb, bs, d, sweeps, float(eps),
            tmax.value, grid.value, stream,
        )
    if err:
        raise RuntimeError(f"gs_multisweep: kernel launch failed with CUDA error {err}")
    launches += 1
    return x, deltas, active, dirty_out


def gs_multisweep(
    rowptr, tilecols, revptr, revrows, dirty, tiles, c, x0, fixed, x, *,
    semiring: str = "plus_times", combine: str = "replace",
    res_kind: str | None = None, bs: int, sweeps: int = 1, eps: float = -1.0,
):
    """Run up to ``sweeps`` Gauss–Seidel sweeps; the port of
    ``gs_multisweep_pallas``.

    Returns ``(x, deltas[sweeps, d], active[sweeps, 1], dirty_out[nb])``,
    with ``x`` updated in place. ``eps=-1`` disables the early-out. CUDA
    tensors launch the kernel (asynchronously, on the current stream) or
    raise; CPU tensors run :func:`gs_multisweep_plain`.
    """
    _check_pair(semiring, combine)
    if sweeps < 1:
        raise ValueError(f"sweeps must be >= 1, got {sweeps}")
    if res_kind is None:
        res_kind = DELTA_METRIC[semiring]
    if res_kind not in RES_KIND_CODE:
        raise ValueError(res_kind)
    if x.device.type == "cpu":
        return gs_multisweep_plain(
            rowptr, tilecols, revptr, revrows, dirty, tiles, c, x0, fixed, x,
            semiring=semiring, combine=combine, res_kind=res_kind, bs=bs,
            sweeps=sweeps, eps=eps,
        )
    if x.device.type != "cuda":
        raise ValueError(f"gs_multisweep: no kernel for device {x.device}")
    return _launch(rowptr, tilecols, revptr, revrows, dirty, tiles, c, x0, fixed,
                   x, semiring=semiring, res_kind=res_kind, bs=bs,
                   sweeps=sweeps, eps=eps)


def gs_sweep(rowptr, tilecols, tiles, c, x0, fixed, x, *,
             semiring: str = "plus_times", combine: str = "replace", bs: int):
    """One full sweep, all blocks dirty, outputs other than the state
    discarded — the port of ``gs_sweep_pallas``. ``x`` is updated in place."""
    nb = rowptr.shape[0] - 1
    dev = x.device
    x_new, _, _, _ = gs_multisweep(
        rowptr, tilecols,
        torch.zeros((nb + 1,), dtype=torch.int32, device=dev),
        torch.zeros((1,), dtype=torch.int32, device=dev),
        torch.ones((nb,), dtype=torch.int32, device=dev),
        tiles, c, x0, fixed, x,
        semiring=semiring, combine=combine, bs=bs, sweeps=1, eps=-1.0,
    )
    return x_new
