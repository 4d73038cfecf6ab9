"""Shared packed-run harness for the iterative engines (port of
``repro.engine.harness``).

* :func:`check_extrapolation` — the Aitken guard `run_incremental` applies.
* :func:`pack` — the one block-padding path (min/max-semiring pads are the
  reduce identity; ``c`` pads are 0.0 under the ``replace`` combine).
* :func:`block_segments` — each block's in-edges grouped by destination,
  for the block engines' order-fixed reductions.
* :func:`loop` — the per-sweep round driver with per-column convergence
  freezing. The reference runs it inside one ``lax.while_loop``; here it is
  a Python loop over device tensors that asks the device once per round
  whether every column is done. Frozen columns make any extra round a
  bitwise no-op, so checking less often would change no result.
* :func:`sweep_batched_loop` — the host driver of the multi-sweep kernel:
  one readout per batch of sweeps.
* :func:`finalize` — raw loop outputs to a host :class:`RunResult`.
"""
from __future__ import annotations

import contextlib
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.engine.algorithms import AlgoInstance
from repro_torch.engine.convergence import RunResult, converge_step, freeze_columns
from repro_torch.engine import torch_ops as T
from repro_torch.graphs.blocked import pack_in_edges, pad_state, padded_n
from repro_torch.graphs.graph import Graph
from repro_torch.obs.telemetry import trace_from_col_rounds
from repro_torch.obs.trace import tspan


@contextlib.contextmanager
def audited_sync():
    """Mark a deliberate device->host readout: lifts
    ``torch.cuda.set_sync_debug_mode`` (the ``transfer_guard`` sanitizer)
    for its body, so only unaudited synchronisations trip it."""
    mode = torch.cuda.get_sync_debug_mode() if torch.cuda.is_available() else 0
    if mode == 0:  # no sanitizer armed
        yield
        return
    torch.cuda.set_sync_debug_mode(0)
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(mode)


def to_device(a, device) -> torch.Tensor:
    """A host array as a fresh tensor on ``device``: a deliberate staging
    copy. From pageable host memory torch synchronises the copy, so it is
    audited like a readout."""
    host = torch.as_tensor(np.ascontiguousarray(a))
    if torch.device(device).type == "cpu":
        return host.clone()
    with audited_sync():
        return host.to(device)


def check_extrapolation(algo: AlgoInstance, extrapolate_every: int) -> None:
    """Aitken extrapolation assumes a *linear* update (sum-semiring
    "replace" combine); reject it on min/max lattice sweeps, and reject a
    period of 1 (it diverges)."""
    if extrapolate_every and algo.semiring.reduce != "sum":
        raise NotImplementedError(
            f"extrapolate_every is only valid for linear sum-semiring "
            f"systems; {algo.name!r} uses reduce={algo.semiring.reduce!r}"
        )
    if extrapolate_every and not extrapolate_every >= 2:
        raise ValueError(
            f"extrapolate_every must be 0 (off) or >= 2, got {extrapolate_every}"
        )


def pack(algo: AlgoInstance, bs: int):
    """Pad the algorithm's (n, d) vertex arrays up to whole blocks of ``bs``.

    Returns ``(be, x0, c, fixed, npad)`` with host f32[npad, d] state arrays
    (``fixed`` bool). Padding rows are pinned at the reduce identity.
    """
    g = Graph(algo.n, algo.src, algo.dst, algo.w)
    be = pack_in_edges(g, bs)
    npad = padded_n(algo.n, bs)
    ident = algo.semiring.identity
    x0 = pad_state(algo.x0, bs, fill=ident)
    c = pad_state(algo.c, bs, fill=algo.c_pad_fill)
    fixed = pad_state(algo.fixed, bs, fill=True)
    return be, x0, c, fixed, npad


def block_segments(be, device) -> list[tuple[torch.Tensor, torch.Tensor, torch.Tensor]]:
    """Each destination block's real in-edges as ``(src, lengths, w)`` on
    ``device``, grouped by the block's local destination (in slot order
    within one destination), ``lengths[v]`` edges into its vertex v: the
    operands of `torch_ops.segment_reduce_sorted`."""
    nb, bs = be.nb, be.bs
    counts = be.emask.sum(axis=1)
    blk = np.repeat(np.arange(nb), counts)
    local = be.edst[be.emask].astype(np.int64)
    by_dst = np.lexsort((local, blk))
    src = to_device(be.esrc[be.emask].astype(np.int64)[by_dst], device)
    w = to_device(be.ew[be.emask][by_dst], device)
    lengths = to_device(np.bincount(blk * bs + local, minlength=nb * bs).reshape(nb, bs), device)
    offsets = [0, *np.cumsum(counts).tolist()]
    return [(src[a:b], lengths[i], w[a:b])
            for i, (a, b) in enumerate(zip(offsets[:-1], offsets[1:]))]


def init_state(x0_packed: np.ndarray, x_init, n: int) -> np.ndarray:
    """Overlay a resume state onto the packed x0. ``x_init`` may be (n,),
    (n, 1) or (n, d)."""
    if x_init is None:
        return x0_packed.copy()
    x = np.asarray(x_init, dtype=x0_packed.dtype)
    if x.size % n:
        raise ValueError(
            f"x_init has {x.shape} elements, expected (n, d) rows for n={n}"
        )
    x = x.reshape(n, -1)
    if x.shape[1] != x0_packed.shape[1]:
        raise ValueError(
            f"x_init has {x.shape[1]} columns, run has {x0_packed.shape[1]}"
        )
    out = x0_packed.copy()
    out[:n, :] = x
    return out


def permute_state(x: np.ndarray, rank: np.ndarray) -> np.ndarray:
    """Carry a state across a relabel: vertex v's row moves to ``rank[v]``
    — the same transform `AlgoInstance.relabel` applies to x0."""
    rank = np.asarray(rank)
    inv = np.empty_like(rank)
    inv[rank] = np.arange(len(rank))
    return np.asarray(x)[inv]


# Aitken extrapolation clamps the contraction-rate estimate here.
_RHO_MAX = 0.95


def loop(
    round_fn: Callable[[torch.Tensor], torch.Tensor],
    x0: torch.Tensor,
    *,
    res_kind: str,
    eps: float,
    max_iters: int,
    real_mask: Optional[torch.Tensor] = None,
    extrapolate_every: int = 0,
):
    """Drive ``x -> round_fn(x)`` with per-column convergence freezing.

    ``round_fn`` must return a new tensor and leave its argument intact.
    Returns ``(x, k, col_done, col_rounds, res_buf, sum_buf, change_norm)``
    with the reference's semantics: a column converging at round k keeps its
    *pre-sweep* state (the sweep that measured residual <= eps is a
    verification sweep), so resuming from a converged state is one round
    and a bitwise no-op. Frozen columns stay put. ``extrapolate_every`` > 0
    adds per-column Aitken jumps (linear sum systems only).
    """
    d = x0.shape[1]
    dev = x0.device
    res_buf = torch.zeros((max_iters,), dtype=torch.float32, device=dev)
    sum_buf = torch.zeros((max_iters,), dtype=torch.float32, device=dev)
    col_done = torch.zeros((d,), dtype=torch.bool, device=dev)
    col_rounds = torch.zeros((d,), dtype=torch.int32, device=dev)
    prev_norm = torch.zeros((d,), dtype=torch.float32, device=dev)

    def mask_rows(x):
        if real_mask is None:
            return x
        return torch.where(real_mask[:, None], x, 0.0)

    x = x0
    k = 0
    while k < max_iters:
        with audited_sync():
            if bool(col_done.all()):  # the once-per-round convergence check
                break
        x_cand = round_fn(x)
        xm_cand = mask_rows(x_cand)
        xm_old = mask_rows(x)
        res_col = T.residual_cols(res_kind, xm_cand, xm_old)
        newly_done, active, col_done, col_rounds = converge_step(
            res_col, eps, col_done, col_rounds
        )
        x_keep = x_cand
        norm_col = prev_norm
        if extrapolate_every:
            norm_col = torch.sum(torch.abs(xm_cand - xm_old), dim=0)
            do_ex = k > 0 and (k + 1) % extrapolate_every == 0
            rho = torch.clamp(
                norm_col / torch.clamp(prev_norm, min=1e-30), 0.0, _RHO_MAX
            )
            factor = torch.where(
                (prev_norm > 0) & do_ex, rho / (1.0 - rho),
                torch.zeros_like(rho),
            )
            x_keep = x_cand + (xm_cand - xm_old) * factor[None, :]
        x = freeze_columns(x_keep, x, active, newly_done)
        res_buf[k] = torch.amax(torch.where(active, res_col, 0.0))
        xm = mask_rows(x)
        sum_buf[k] = torch.sum(torch.where(torch.abs(xm) < 1e30, xm, 0.0))
        prev_norm = norm_col
        k += 1
    return x, k, col_done, col_rounds, res_buf, sum_buf, prev_norm


def sweep_batched_loop(
    batch_fn: Callable,
    x0: torch.Tensor,
    dirty0: torch.Tensor,
    *,
    eps: float,
    max_iters: int,
    sweeps: int,
    nb: int,
    real_mask: Optional[torch.Tensor] = None,
    tracer=None,
):
    """Host-side round driver for the multi-sweep kernel.

    ``batch_fn(x, dirty) -> (x, deltas[sweeps, d], active[sweeps, 1],
    dirty)`` runs up to ``sweeps`` sweeps in one launch; this loop reads the
    per-sweep delta trace once per batch and replays it to reconstruct the
    per-column round counts :func:`loop` would have produced. As in the
    reference, columns are not frozen mid-batch, and a batch may run up to
    ``sweeps - 1`` sweeps past the stop (their results are kept).

    Returns ``(x, k, col_done, col_rounds, res_trace, sum_trace,
    active_trace, dirty)``.
    """
    x = x0
    dirty = dirty0
    d = int(x.shape[1])
    col_done = np.zeros(d, bool)
    col_rounds = np.zeros(d, np.int32)
    res_trace: list[float] = []
    sum_trace: list[float] = []
    act_trace: list[float] = []
    k = 0
    while k < max_iters and not col_done.all():
        with tspan(tracer, "sweep_call", sweeps=sweeps, nb=nb, k=k) as sp:
            x, deltas, active, dirty = batch_fn(x, dirty)
            xm = x if real_mask is None else torch.where(real_mask[:, None], x, 0.0)
            batch_sum_t = torch.sum(torch.where(torch.abs(xm) < 1e30, xm, 0.0))
            with audited_sync():  # once-per-batch convergence trace readout
                deltas_np = deltas.cpu().numpy()
                active_np = active.cpu().numpy()
                batch_sum = float(batch_sum_t)
            sp.set(
                max_delta=float(np.max(deltas_np)),
                active_blocks=[float(a) for a in active_np[:, 0]],
            )
        for s in range(sweeps):
            if k >= max_iters or col_done.all():
                break
            res_col = deltas_np[s]
            _, active_cols, col_done, col_rounds = converge_step(
                res_col, eps, col_done, col_rounds
            )
            res_trace.append(float(np.max(np.where(active_cols, res_col, 0.0))))
            sum_trace.append(batch_sum)
            act_trace.append(float(active_np[s, 0]) / max(1, nb))
            k += 1
    return (
        x, k, col_done, col_rounds,
        np.asarray(res_trace, np.float32), np.asarray(sum_trace, np.float32),
        np.asarray(act_trace, np.float32), dirty,
    )


def _host(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def finalize(
    algo: AlgoInstance, x, k, col_done, col_rounds, res_buf, sum_buf, *_extra
) -> RunResult:
    """Convert raw loop outputs into a host RunResult (d = 1 keeps 1-D x);
    the one end-of-run device->host readout."""
    with audited_sync():
        x, col_done, col_rounds, res_buf, sum_buf = (
            _host(a) for a in (x, col_done, col_rounds, res_buf, sum_buf)
        )
    k = int(k)
    xr = x[: algo.n]
    if algo.d == 1:
        xr = xr[:, 0]
    col_conv = np.asarray(col_done)
    col_rounds = np.asarray(col_rounds)
    residuals = np.asarray(res_buf)[:k]
    return RunResult(
        x=xr,
        rounds=k,
        converged=bool(col_conv.all()),
        residuals=residuals,
        state_sums=np.asarray(sum_buf)[:k],
        col_rounds=col_rounds,
        col_converged=col_conv,
        convergence_trace=trace_from_col_rounds(
            residuals, col_rounds, rounds=k, n=algo.n, d=algo.d
        ),
    )
