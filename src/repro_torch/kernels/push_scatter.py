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
and writes one residual row (``2 * d * 4`` bytes). The slots are sequential
only where their closed out-sets ``{u} + N_out(u)`` meet, so the round runs
as *waves*: maximal runs of consecutive slots whose closed sets are pairwise
disjoint, which share no address and so give the sequential bits when run
at once. :func:`push_schedule` finds the conflicts with torch ops on the
device, the kernel's one-warp pass cuts the waves, and the round kernel runs
them in order, one CTA per chunk of columns (csrc/push_scatter.cu). The
round then costs about two dependent memory latencies per wave.

:func:`push_scatter` launches the kernels for CUDA tensors and runs
:func:`push_scatter_plain` for CPU tensors; there is no fallback from one to
the other. :func:`push_scatter_waves`, the schedule executed wave by wave
with torch ops, is the plain version of the wave design, for the tests.
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
# the schedule: conflict-free waves
# ---------------------------------------------------------------------------

# slots per wave at most: PS_WMAX of csrc/push_scatter.cu (a wave's pushed
# values live in the kernel's shared memory)
WMAX = 256
# rounds of at most this many slots skip the schedule: its torch ops cost
# ~1 ms whatever the round (they span the graph's edge array), more than
# running a few slots one after another
SEQUENTIAL_SLOTS = 64
_NO_KEY = 1 << 62  # sorts after every (vertex, slot) key


def push_schedule(vid, seg_start, seg_len, nbrs, ew) -> dict:
    """The state-independent part of one round, as torch ops on the
    operands' device with no host synchronisation.

    A slot reads and writes only the rows of its closed set
    ``{u} + N_out(u)``. Every (vertex, slot) pair of those sets is sorted by
    vertex; a pair's predecessor on the same vertex is an earlier slot it
    conflicts with. Returns:

    * ``prev`` int32[S]: the last earlier live slot whose closed set meets
      slot k's (-1 for none and for dead slots);
    * ``sv`` int32[S]: -1 for a dead slot, ``u``, or ``-(u + 2)`` for a slot
      whose segment repeats a destination (a parallel edge), which the
      kernel walks in order;
    * ``eoff`` int32[S + 1] and ``e_v`` int32, ``e_w`` f32, ``e_k`` int32
      [E]: the live slots' edges flattened in slot and edge order
      (destination, weight, slot); slot k's edges are
      ``[eoff[k], eoff[k + 1])``;
    * ``pushed``, ``edges``: the per-slot counts (f32[S]).

    The flattened list has room for ``E = len(nbrs)`` edges, which segments
    of distinct vertices of one CSR never exceed. If the live segments hold
    more (overlapping segments), every slot becomes its own wave and is
    walked in order: still the sequential result.
    """
    dev = vid.device
    S, E = int(vid.shape[0]), int(nbrs.shape[0])
    i64 = torch.int64
    live = vid >= 0
    slen = torch.where(live, seg_len.to(i64), 0)
    eoff = torch.zeros(S + 1, dtype=i64, device=dev)
    eoff[1:] = torch.cumsum(slen, 0)
    overflow = eoff[-1] > E
    pos = torch.arange(E, dtype=i64, device=dev)
    valid = pos < eoff[-1]
    k_e = torch.searchsorted(eoff[1:], pos, right=True).clamp_(max=S - 1)
    t = torch.where(valid, seg_start.to(i64)[k_e] + pos - eoff[k_e], 0)
    e_v = nbrs[t]
    e_w = ew[t]
    ks = torch.arange(S, dtype=i64, device=dev)
    key_u = torch.where(live, (vid.to(i64) * S + ks) * 2, _NO_KEY)
    key_e = torch.where(valid, (e_v.to(i64) * S + k_e) * 2 + 1, _NO_KEY)
    sk, _ = torch.sort(torch.cat([key_u, key_e]))
    vk = sk >> 1
    v_s, k_s = vk // S, vk % S
    real = sk[1:] != _NO_KEY
    # pairs past the real ones land on slots of their own past S: one
    # shared dummy slot would serialise their atomics
    at = torch.where(real, k_s[1:], S + torch.arange(len(real), device=dev))
    conflict = real & (v_s[1:] == v_s[:-1]) & (k_s[:-1] < k_s[1:])
    prev = torch.full((S + len(real),), -1, dtype=i64, device=dev).scatter_reduce_(
        0, at, torch.where(conflict, k_s[:-1], -1), reduce="amax")[:S]
    repeat = real & (sk[1:] == sk[:-1]) & ((sk[1:] & 1) == 1)
    dup = torch.zeros(S + len(real), dtype=i64, device=dev).scatter_reduce_(
        0, at, repeat.to(i64), reduce="amax")[:S]
    prev = torch.where(overflow, ks - 1, prev)
    dup = torch.where(overflow, 1, dup)
    eoff = torch.where(overflow, 0, eoff)
    sv = torch.where(live, torch.where(dup > 0, -(vid.to(i64) + 2), vid.to(i64)), -1)
    i32 = torch.int32
    return {
        "prev": torch.where(live, prev, -1).to(i32), "sv": sv.to(i32),
        "eoff": eoff.to(i32), "e_v": e_v.to(i32).contiguous(),
        "e_w": e_w.to(torch.float32).contiguous(), "e_k": k_e.to(i32),
        "pushed": live.to(torch.float32), "edges": slen.to(torch.float32),
    }


def sequential_schedule(vid, seg_start, seg_len, nbrs, ew) -> dict:
    """The schedule of a small round: every live slot its own wave, its
    edges walked in order (``sv = -(u + 2)``), no flattened edges. The same
    keys as :func:`push_schedule`."""
    S = int(vid.shape[0])
    live = vid >= 0
    ks = torch.arange(S, dtype=torch.int32, device=vid.device)
    return {
        "prev": torch.where(live, ks - 1, -1).to(torch.int32),
        "sv": torch.where(live, -(vid + 2), -1).to(torch.int32),
        "eoff": torch.zeros(S + 1, dtype=torch.int32, device=vid.device),
        "e_v": nbrs[:0], "e_w": ew[:0], "e_k": nbrs[:0],
        "pushed": live.to(torch.float32),
        "edges": torch.where(live, seg_len, 0).to(torch.float32),
    }


def wave_bounds_plain(vid, prev, wmax: int = WMAX) -> list[tuple[int, int]]:
    """The wave cut, walked on the host: maximal runs of consecutive slots
    in which no live slot's ``prev`` reaches the run's start, also cut at
    ``wmax`` slots. Dead slots open and close no wave. Returns the slot
    ranges ``[(ws, we), ...]`` in order (the plain version of the cut the
    kernel's ``push_waves_kernel`` makes)."""
    vid = np.asarray(torch.as_tensor(vid).cpu())
    prev = np.asarray(torch.as_tensor(prev).cpu())
    waves: list[tuple[int, int]] = []
    ws = last = -1
    for k in np.flatnonzero(vid >= 0):
        if ws < 0 or prev[k] >= ws or k - ws >= wmax:
            if ws >= 0:
                waves.append((ws, last + 1))
            ws = int(k)
        last = int(k)
    if ws >= 0:
        waves.append((ws, last + 1))
    return waves


def _schedule(vid, seg_start, seg_len, nbrs, ew) -> dict:
    """The schedule the kernel runs: :func:`sequential_schedule` for rounds
    of at most ``SEQUENTIAL_SLOTS`` slots, else :func:`push_schedule`."""
    fn = sequential_schedule if vid.shape[0] <= SEQUENTIAL_SLOTS else push_schedule
    return fn(vid, seg_start, seg_len, nbrs, ew)


def push_waves(vid, seg_start, seg_len, nbrs, ew):
    """The waves of one round: ``(wstart, wend, nw)``. On CUDA tensors the
    schedule and the kernel's wave cut run on the device (``wstart`` and
    ``wend`` have room for S waves, ``nw`` is a one-element tensor); on CPU
    tensors the cut is :func:`wave_bounds_plain`."""
    sched = _schedule(vid, seg_start, seg_len, nbrs, ew)
    if vid.device.type == "cpu":
        waves = wave_bounds_plain(vid, sched["prev"])
        b = torch.tensor(waves, dtype=torch.int32).reshape(-1, 2)
        return b[:, 0], b[:, 1], torch.tensor([len(waves)], dtype=torch.int32)
    return _waves_on_device(vid, sched)[:3]


def push_scatter_waves(vid, seg_start, seg_len, nbrs, ew, p, r, *,
                       semiring: str = "plus_times", buckets: int, cap: int):
    """The scheduled plain version: the kernel's schedule, executed wave by
    wave with torch ops — each wave's settles as one gather and scatter,
    the edges of its in-order slots one at a time, its other edges as one
    gather and scatter. Equal to :func:`push_scatter_plain` bit for bit,
    because slots within a wave share no row. Returns
    ``(p, r, pushed, edges)`` with ``p`` and ``r`` updated in place."""
    _check_semiring(semiring)
    _check_shapes(vid, seg_start, seg_len, nbrs, ew, p, r, buckets, cap)
    sched = push_schedule(vid, seg_start, seg_len, nbrs, ew)
    sv = sched["sv"].long()
    eoff = np.asarray(sched["eoff"].cpu())
    lo_h = np.asarray(seg_start.cpu(), np.int64)
    len_h = np.asarray(seg_len.cpu(), np.int64)
    nbrs_h = np.asarray(nbrs.cpu(), np.int64)
    ident = ACC_IDENTITY[semiring]
    for ws, we in wave_bounds_plain(vid, sched["prev"]):
        ks = torch.arange(ws, we)[sv[ws:we].cpu() != -1].to(p.device)
        us = torch.where(sv[ks] >= 0, sv[ks], -sv[ks] - 2)
        if semiring == "plus_times":
            push = r[us].clone()
            p[us] = p[us] + push
        else:
            lat = torch.minimum if semiring == "min_plus" else torch.maximum
            push = lat(p[us], r[us])
            p[us] = push
        r[us] = ident
        for i in torch.nonzero(sv[ks] < -1).flatten().tolist():
            k = int(ks[i])
            for t in range(lo_h[k], lo_h[k] + len_h[k]):
                v = int(nbrs_h[t])
                r[v] = _edge_update(semiring, r[v], push[i], ew[t])
        q = torch.arange(int(eoff[ws]), int(eoff[we]), device=p.device)
        ek = sched["e_k"][q].long()
        q = q[sv[ek] >= 0]
        if len(q):
            at = torch.searchsorted(ks, sched["e_k"][q].long())
            v = sched["e_v"][q].long()
            r[v] = _edge_update(semiring, r[v], push[at], sched["e_w"][q, None])
    return (p, r, sched["pushed"].view(buckets, cap).sum(1, keepdim=True),
            sched["edges"].view(buckets, cap).sum(1, keepdim=True))


# ---------------------------------------------------------------------------
# kernel wrapper
# ---------------------------------------------------------------------------

def _lib():
    from repro_torch.kernels._build import load

    lib = load("push_scatter")
    if not getattr(lib, "_push_typed", False):
        vp = ctypes.c_void_p
        lib.push_waves_launch.argtypes = [vp, vp, ctypes.c_int, vp, vp, vp, vp]
        lib.push_waves_launch.restype = ctypes.c_int
        lib.push_scatter_launch.argtypes = (
            [ctypes.c_int] + [vp] * 12 + [ctypes.c_int, vp]
        )
        lib.push_scatter_launch.restype = ctypes.c_int
        lib.push_scatter_wmax.argtypes = []
        lib.push_scatter_wmax.restype = ctypes.c_int
        if lib.push_scatter_wmax() != WMAX:
            raise RuntimeError("push_scatter: WMAX disagrees with csrc/push_scatter.cu")
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


def _waves_on_device(vid, sched):
    """Launch the wave cut; returns ``(wstart, wend, nw, lib)``."""
    lib = _lib()
    dev = vid.device
    S = int(vid.shape[0])
    with torch.cuda.device(dev):
        wstart = torch.zeros(S, dtype=torch.int32, device=dev)
        wend = torch.zeros(S, dtype=torch.int32, device=dev)
        nw = torch.empty(1, dtype=torch.int32, device=dev)
        err = lib.push_waves_launch(
            vid.data_ptr(), sched["prev"].data_ptr(), S, wstart.data_ptr(),
            wend.data_ptr(), nw.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"push_scatter: wave cut launch failed with CUDA error {err}")
    return wstart, wend, nw, lib


def _launch(vid, seg_start, seg_len, nbrs, ew, p, r, *, semiring, buckets, cap):
    global launches
    dev = p.device
    d = p.shape[1]
    i32, f32 = torch.int32, torch.float32
    for name, t in (("vid", vid), ("seg_start", seg_start), ("seg_len", seg_len),
                    ("nbrs", nbrs)):
        _require(t, name, i32, dev)
    for name, t in (("ew", ew), ("p", p), ("r", r)):
        _require(t, name, f32, dev)
    if p.data_ptr() == r.data_ptr():
        raise ValueError("push_scatter: p and r must be separate buffers")
    sched = _schedule(vid, seg_start, seg_len, nbrs, ew)
    wstart, wend, nw, lib = _waves_on_device(vid, sched)
    eoff = sched["eoff"]
    # per wave: slot range and flattened-edge range (past nw: zeros)
    wb = torch.stack([wstart, wend, eoff[wstart.long()], eoff[wend.long()]], 1).contiguous()
    with torch.cuda.device(dev):
        err = lib.push_scatter_launch(
            SEMIRING_CODE[semiring], seg_start.data_ptr(), seg_len.data_ptr(),
            nbrs.data_ptr(), ew.data_ptr(), sched["sv"].data_ptr(),
            sched["e_v"].data_ptr(), sched["e_w"].data_ptr(), sched["e_k"].data_ptr(),
            wb.data_ptr(), nw.data_ptr(), p.data_ptr(), r.data_ptr(), d,
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if err:
        raise RuntimeError(f"push_scatter: kernel launch failed with CUDA error {err}")
    launches += 1
    pushed = sched["pushed"].view(buckets, cap).sum(1, keepdim=True)
    edges = sched["edges"].view(buckets, cap).sum(1, keepdim=True)
    return p, r, pushed, edges


def push_scatter(vid, seg_start, seg_len, nbrs, ew, p, r, *,
                 semiring: str = "plus_times", buckets: int, cap: int):
    """One bucketed push round; the port of ``push_scatter_pallas``, without
    its ``ecap`` (a TPU DMA chunk size): ``nbrs``/``ew`` need no tail padding.

    Returns ``(p, r, pushed f32[buckets, 1], edges f32[buckets, 1])`` with
    ``p`` and ``r`` updated in place. The wrapper checks shapes, dtypes,
    devices and contiguity; the slot and neighbour ids are trusted (the push
    engine builds them from the graph's CSR). CUDA tensors run the schedule
    (:func:`push_schedule`) and launch the wave cut and the round
    (asynchronously, on the current stream, with no host synchronisation)
    or raise; CPU tensors run :func:`push_scatter_plain`.
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
