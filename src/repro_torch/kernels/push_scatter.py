"""Bucketed residual-push scatter: the CUDA kernel's wrapper and its plain
version.

Replaces the TPU kernel ``push_scatter_pallas`` of
``src/repro/kernels/push_scatter.py`` with a hand-written CUDA C++ kernel
for Hopper, ``csrc/push_scatter.cu``. One launch is one push round of the
push engine (`engine.push`) over a slot list the host has bucketed. Per slot
``k`` in flat ``b * cap + j`` order with ``u = vid[k] >= 0``, on the state
``p, r f32[n, d]`` in place:

    sum (plus_times):   push = r[u];  p[u] += push
    lattice (min/max):  push = combine(p[u], r[u]);  p[u] = push
    then                r[u] = ACC_IDENTITY
    then, for each out-edge (v, w) in nbrs/ew[seg_start[k] : +seg_len[k]]:
                        r[v] = reduce(r[v], edge_op(push, w))

Every slot sees all earlier slots' writes (the semantics of
``repro.kernels.ref.ref_push_round``); ``pushed[b]`` and ``edges[b]`` count
settled vertices and scattered edges per bucket.

What bounds it on the card: per slot the kernel reads and writes u's two
rows (``4 * d * 4`` bytes), per edge it reads the edge (8 bytes) and reads
and writes one residual row (``2 * d * 4`` bytes). The columns are
independent, so the kernel gives each column one thread, which walks every
slot and edge in order: the sequential semantics with no atomics and no
grid barrier, and bitwise repeatable. At d = 64 that is two warps, so the
kernel is bound by the latency of its dependent row loads, far above the
byte bound (measured in PERF.md).

:func:`push_scatter` launches the kernel for CUDA tensors and runs
:func:`push_scatter_plain` for CPU tensors; there is no fallback from one to
the other.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.kernels.semirings import ACC_IDENTITY, SEMIRING_CODE

# kernel launches since the count was last set to 0
launches = 0



def reset_launches() -> None:
    """Set the launch count to 0."""
    global launches
    launches = 0


def _check_semiring(semiring: str) -> None:
    if semiring not in SEMIRING_CODE:
        raise NotImplementedError(
            f"push_scatter: unsupported semiring {semiring!r}; "
            f"supported: {sorted(SEMIRING_CODE)}"
        )


def _check_shapes(vid, seg_start, seg_len, nbrs, ew, p, r, buckets, cap):
    if buckets < 1 or cap < 1:
        raise ValueError(f"buckets/cap must be >= 1, got {(buckets, cap)}")
    if p.ndim != 2 or tuple(r.shape) != tuple(p.shape):
        raise ValueError(f"push_scatter: p {tuple(p.shape)} and r {tuple(r.shape)} "
                         "must be the same (n, d)")
    slots = (buckets * cap,)
    for name, t in (("vid", vid), ("seg_start", seg_start), ("seg_len", seg_len)):
        if tuple(t.shape) != slots:
            raise ValueError(f"push_scatter: {name} has shape {tuple(t.shape)}, "
                             f"expected {slots}")
    if nbrs.ndim != 1 or tuple(nbrs.shape) != tuple(ew.shape):
        raise ValueError("push_scatter: nbrs and ew must be 1-D and the same length")


# ---------------------------------------------------------------------------
# plain version
# ---------------------------------------------------------------------------

def _edge_update(semiring: str, rv: torch.Tensor, push: torch.Tensor,
                 w: torch.Tensor) -> torch.Tensor:
    """reduce(r[v], edge_op(push, w)), rows of ``rv`` against one ``push``;
    the product is rounded before the add, as in the oracle."""
    if semiring == "plus_times":
        return rv + w * push
    if semiring == "min_plus":
        return torch.minimum(rv, push + w)
    if semiring == "max_min":
        return torch.maximum(rv, torch.minimum(push, w))
    return torch.maximum(rv, push * w)


def push_scatter_plain(vid, seg_start, seg_len, nbrs, ew, p, r, *,
                       semiring: str = "plus_times", buckets: int, cap: int):
    """Torch mirror of ``ref_push_round`` over the bucketed slot list, on
    whatever device the tensors are on. The slot list and segments are
    walked on the host; each slot's edges are one gather and scatter when
    their destinations are distinct, else one edge at a time (a parallel
    edge must see its twin's update). Returns ``(p, r, pushed, edges)``
    with ``p`` and ``r`` updated in place."""
    _check_semiring(semiring)
    _check_shapes(vid, seg_start, seg_len, nbrs, ew, p, r, buckets, cap)
    dev = p.device
    vid_h = np.asarray(torch.as_tensor(vid).cpu(), np.int64)
    lo_h = np.asarray(torch.as_tensor(seg_start).cpu(), np.int64)
    len_h = np.asarray(torch.as_tensor(seg_len).cpu(), np.int64)
    nbrs_h = np.asarray(torch.as_tensor(nbrs).cpu(), np.int64)
    nbrs_d = torch.as_tensor(nbrs_h, device=dev)
    ew_d = torch.as_tensor(ew).to(device=dev, dtype=torch.float32)
    ident = ACC_IDENTITY[semiring]
    pushed = np.zeros((buckets, 1), np.float32)
    edges = np.zeros((buckets, 1), np.float32)
    for k in range(buckets * cap):
        u = int(vid_h[k])
        if u < 0:
            continue
        if semiring == "plus_times":
            push = r[u].clone()
            p[u] = p[u] + push
        elif semiring == "min_plus":
            push = torch.minimum(p[u], r[u])
            p[u] = push
        else:
            push = torch.maximum(p[u], r[u])
            p[u] = push
        r[u] = ident  # before the scatter: a self-loop lands on the empty row
        lo, deg = int(lo_h[k]), int(len_h[k])
        if deg:
            seg = nbrs_h[lo:lo + deg]
            if len(np.unique(seg)) == deg:
                vs = nbrs_d[lo:lo + deg]
                w = ew_d[lo:lo + deg, None]
                r[vs] = _edge_update(semiring, r[vs], push[None, :], w)
            else:
                for t in range(lo, lo + deg):
                    v = int(nbrs_h[t])
                    r[v] = _edge_update(semiring, r[v], push, ew_d[t])
        b = k // cap
        pushed[b, 0] += np.float32(1.0)
        edges[b, 0] += np.float32(deg)
    return (p, r, torch.as_tensor(pushed, device=dev),
            torch.as_tensor(edges, device=dev))


# ---------------------------------------------------------------------------
# kernel wrapper
# ---------------------------------------------------------------------------

def _lib():
    from repro_torch.kernels._build import load

    lib = load("push_scatter")
    if not getattr(lib, "_push_typed", False):
        vp = ctypes.c_void_p
        lib.push_scatter_launch.argtypes = (
            [ctypes.c_int] + [vp] * 9 + [ctypes.c_int] * 4 + [vp]
        )
        lib.push_scatter_launch.restype = ctypes.c_int
        lib._push_typed = True
    return lib


def _require(t, name: str, dtype, device) -> None:
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"push_scatter: {name} must be a torch.Tensor")
    if t.device != device:
        raise ValueError(f"push_scatter: {name} is on {t.device}, p on {device}")
    if t.dtype != dtype:
        raise TypeError(f"push_scatter: {name} must be {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"push_scatter: {name} must be contiguous")


def _launch(vid, seg_start, seg_len, nbrs, ew, p, r, *, semiring, buckets, cap):
    global launches
    dev = p.device
    n, d = p.shape
    i32, f32 = torch.int32, torch.float32
    for name, t in (("vid", vid), ("seg_start", seg_start), ("seg_len", seg_len),
                    ("nbrs", nbrs)):
        _require(t, name, i32, dev)
    for name, t in (("ew", ew), ("p", p), ("r", r)):
        _require(t, name, f32, dev)
    if p.data_ptr() == r.data_ptr():
        raise ValueError("push_scatter: p and r must be separate buffers")
    lib = _lib()
    with torch.cuda.device(dev):
        pushed = torch.empty((buckets, 1), dtype=f32, device=dev)
        edges = torch.empty((buckets, 1), dtype=f32, device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.push_scatter_launch(
            SEMIRING_CODE[semiring], vid.data_ptr(), seg_start.data_ptr(),
            seg_len.data_ptr(), nbrs.data_ptr(), ew.data_ptr(), p.data_ptr(),
            r.data_ptr(), pushed.data_ptr(), edges.data_ptr(),
            buckets, cap, n, d, stream,
        )
    if err:
        raise RuntimeError(f"push_scatter: kernel launch failed with CUDA error {err}")
    launches += 1
    return p, r, pushed, edges


def push_scatter(vid, seg_start, seg_len, nbrs, ew, p, r, *,
                 semiring: str = "plus_times", buckets: int, cap: int):
    """One bucketed push round; the port of ``push_scatter_pallas``, without
    its ``ecap`` (a TPU DMA chunk size): ``nbrs``/``ew`` need no tail padding.

    Returns ``(p, r, pushed f32[buckets, 1], edges f32[buckets, 1])`` with
    ``p`` and ``r`` updated in place. The wrapper checks shapes, dtypes,
    devices and contiguity; the slot and neighbour ids are trusted (the push
    engine builds them from the graph's CSR). CUDA tensors launch the kernel
    (asynchronously, on the current stream) or raise; CPU tensors run
    :func:`push_scatter_plain`.
    """
    _check_semiring(semiring)
    _check_shapes(vid, seg_start, seg_len, nbrs, ew, p, r, buckets, cap)
    if p.device.type == "cpu":
        return push_scatter_plain(vid, seg_start, seg_len, nbrs, ew, p, r,
                                  semiring=semiring, buckets=buckets, cap=cap)
    if p.device.type != "cuda":
        raise ValueError(f"push_scatter: no kernel for device {p.device}")
    return _launch(vid, seg_start, seg_len, nbrs, ew, p, r, semiring=semiring,
                   buckets=buckets, cap=cap)
