"""Uniform convergence telemetry: the per-round residual/work trace.

Every engine already surfaces, at its existing host readout, enough to
reconstruct *what each round cost and bought*:

* the per-sweep round driver returns a per-round residual buffer plus
  ``col_rounds[j]`` — the round at which column j froze — from which the
  number of still-active columns at round k is ``sum(col_rounds > k)``;
* the sweep-batched kernel additionally reports ``active_block_fraction``
  — the fraction of row-blocks its frontier actually swept each round.

:class:`ConvergenceTrace` normalizes both into one shape — ``residual[k]``,
``active_fraction[k]``, ``work[k]``. The builders consume host arrays the
engines already read back, so telemetry adds no device transfer.

``work`` units (named in ``unit``):

``swept_vertex_cols``   per-sweep driver: active columns × n vertices.
``swept_block_cells``   sweep-batched kernel: active blocks × bs rows × d
                        columns — the frontier-skipping engine's bill.
``pushed_vertices``     push engine: vertices settled this round (its
                        verification rounds push nothing: work 0, residual 0).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np


@dataclasses.dataclass
class ConvergenceTrace:
    """Per-round telemetry for one solve, uniform across engines.

    All arrays have length ``rounds`` (the number of rounds the run
    executed). ``residual[k]`` is the max-over-active-columns residual
    after round k — the engine's own convergence criterion, so
    ``final_residual <= eps`` iff the run converged within budget.
    """

    residual: np.ndarray         # f32[rounds]
    active_fraction: np.ndarray  # f32[rounds], in [0, 1]
    work: np.ndarray             # f32[rounds], unit below
    unit: str

    @property
    def rounds(self) -> int:
        return int(self.residual.shape[0])

    @property
    def final_residual(self) -> float:
        """Residual after the last executed round (inf for a 0-round run)."""
        return float(self.residual[-1]) if self.rounds else float("inf")

    @property
    def total_work(self) -> float:
        return float(self.work.sum())

    def to_json(self) -> dict:
        return {
            "unit": self.unit,
            "rounds": self.rounds,
            "residual": [float(v) for v in self.residual],
            "active_fraction": [float(v) for v in self.active_fraction],
            "work": [float(v) for v in self.work],
        }


def active_columns_per_round(col_rounds: np.ndarray, rounds: int) -> np.ndarray:
    """``out[k] = number of columns still active during round k``.

    ``col_rounds[j]`` counts the rounds column j paid for before freezing,
    so column j was active in rounds ``0..col_rounds[j]-1`` — the count at
    round k is simply ``sum(col_rounds > k)``. Pure host arithmetic on the
    already-transferred bookkeeping; no device access.
    """
    col_rounds = np.asarray(col_rounds).reshape(-1)
    if rounds <= 0:
        return np.zeros((0,), dtype=np.float32)
    ks = np.arange(rounds, dtype=col_rounds.dtype)
    return (ks[:, None] < col_rounds[None, :]).sum(axis=1).astype(np.float32)


def trace_from_col_rounds(
    residuals: np.ndarray,
    col_rounds: Optional[np.ndarray],
    *,
    rounds: int,
    n: int,
    d: int,
) -> ConvergenceTrace:
    """Trace for the loop engines (sync / async_block / distributed).

    Each active column pays one full vertex sweep per round, so
    ``work[k] = active_cols[k] * n``. When per-column bookkeeping is
    absent (priority-block scheduling has no per-query rounds) every
    executed round is billed at full width.
    """
    res = np.asarray(residuals, dtype=np.float32).reshape(-1)[:rounds]
    if col_rounds is not None:
        active = active_columns_per_round(col_rounds, rounds)
    else:
        active = np.full((rounds,), float(d), dtype=np.float32)
    return ConvergenceTrace(
        residual=res,
        active_fraction=active / max(d, 1),
        work=active * float(n),
        unit="swept_vertex_cols",
    )


def trace_from_block_activity(
    residuals: np.ndarray,
    block_fraction: np.ndarray,
    *,
    rounds: int,
    nb: int,
    bs: int,
    d: int,
) -> ConvergenceTrace:
    """Trace for the sweep-batched megakernel.

    ``block_fraction[k]`` is the fraction of the nb row-blocks the frontier
    actually swept in round k, so the bill is
    ``work[k] = block_fraction[k] * nb * bs * d`` state cells touched —
    strictly finer than the loop engines' column-granular accounting.
    """
    res = np.asarray(residuals, dtype=np.float32).reshape(-1)[:rounds]
    frac = np.asarray(block_fraction, dtype=np.float32).reshape(-1)[:rounds]
    return ConvergenceTrace(
        residual=res,
        active_fraction=frac,
        work=frac * float(nb) * float(bs) * float(d),
        unit="swept_block_cells",
    )


def trace_from_push_counts(
    residuals: Sequence[float],
    pushed: Sequence[float],
    *,
    n: int,
) -> ConvergenceTrace:
    """Trace for the push engine's host driver.

    One entry per round, *including* the empty-frontier verification
    rounds (residual 0, work 0) so the trace length equals the round count
    and the final entry is the residual that decided convergence.
    """
    res = np.asarray(list(residuals), dtype=np.float32)
    work = np.asarray(list(pushed), dtype=np.float32)
    return ConvergenceTrace(
        residual=res,
        active_fraction=work / max(n, 1),
        work=work,
        unit="pushed_vertices",
    )
