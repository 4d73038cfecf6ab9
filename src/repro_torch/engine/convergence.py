"""Convergence bookkeeping shared by the engines (port of
``repro.engine.convergence``).

:class:`RunResult` is the engines' host-side result. ``converge_step`` is
the one implementation of per-column convergence accounting; it uses only
operators numpy arrays and torch tensors share, so the same code runs in
the device-side round driver (``harness.loop``) and on the host numpy
bookkeeping of the sweep-batched driver (``harness.sweep_batched_loop``).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.obs.telemetry import ConvergenceTrace


@dataclasses.dataclass
class RunResult:
    """Outcome of an iterative run.

    ``rounds`` counts full passes over the edge set. Batched (d > 1) runs set
    ``x`` to the (n, d) state matrix and fill the per-column fields:
    ``col_rounds[j]`` is the round at which query j first met eps,
    ``col_converged[j]`` whether it did within the budget. Scalar (d = 1)
    runs return a 1-D ``x``. All fields are host numpy.
    """

    x: np.ndarray
    rounds: int
    converged: bool
    residuals: np.ndarray  # per-round residual trace
    state_sums: np.ndarray  # per-round sum(x)
    col_rounds: Optional[np.ndarray] = None    # int32[d]
    col_converged: Optional[np.ndarray] = None  # bool[d]
    # sweep-batched kernel runs only: fraction of row-blocks updated per sweep
    active_block_fraction: Optional[np.ndarray] = None  # f32[rounds]
    # push-engine runs only: "pushed" (vertex settles over all rounds),
    # "edges" (scatter messages), "touched" / "touched_fraction" (distinct
    # vertices ever active) and "rounds"
    push_stats: Optional[dict] = None
    convergence_trace: Optional[ConvergenceTrace] = None

    @property
    def d(self) -> int:
        """Number of batched queries in this result."""
        return int(self.x.shape[1]) if self.x.ndim == 2 else 1

    def distance_trace(self, x_star_sum: float) -> np.ndarray:
        """dist_t = |sum x* - sum x_t|."""
        return np.abs(x_star_sum - self.state_sums[: self.rounds])


def trim_trace(residuals, sums, rounds: int) -> tuple[np.ndarray, np.ndarray]:
    """The first ``rounds`` entries of a run's residual and state-sum
    traces, as host arrays."""
    residuals = np.asarray(residuals)[:rounds]
    sums = np.asarray(sums)[:rounds]
    return residuals, sums


def converge_step(res_col, eps: float, col_done, col_rounds):
    """One round of per-column convergence accounting.

    Returns ``(newly_done, active, col_done, col_rounds)``: a column is
    *active* while not yet converged (it pays this round, so ``col_rounds``
    advances), and *newly done* the first round its residual drops to eps.
    Works on numpy arrays and torch tensors alike.
    """
    active = ~col_done
    newly_done = active & (res_col <= eps)
    if isinstance(active, torch.Tensor):
        step = active.to(col_rounds.dtype)
    else:
        step = active.astype(col_rounds.dtype)
    return newly_done, active, col_done | newly_done, col_rounds + step


def freeze_columns(x_cand: torch.Tensor, x_prev: torch.Tensor,
                   active: torch.Tensor, newly_done: torch.Tensor) -> torch.Tensor:
    """Active, not-yet-converged columns advance to the candidate state;
    columns converging *this* round keep their pre-sweep state; frozen
    columns stay put bitwise."""
    advance = active & ~newly_done
    return torch.where(advance[None, :], x_cand, x_prev)


def device_index(cols, device) -> torch.Tensor:
    """Column indices as an int64 tensor built on ``device`` by fills, so
    nothing crosses from the host (indexing or assigning with host values
    stages them through a copy that synchronises with the card)."""
    cols = np.asarray(cols, np.int64).reshape(-1).tolist()
    if not cols:
        return torch.zeros(0, dtype=torch.int64, device=device)
    return torch.cat([torch.full((1,), j, dtype=torch.int64, device=device)
                      for j in cols])


def reinit_columns(col_done, col_rounds, cols):
    """Reset exactly the given columns' bookkeeping (done flag cleared,
    round count zeroed) — the inverse of the freeze. Accepts numpy arrays or
    torch tensors; inputs are not mutated."""
    if isinstance(col_done, torch.Tensor):
        idx = device_index(cols, col_done.device)
        return col_done.index_fill(0, idx, False), col_rounds.index_fill(0, idx, 0)
    cols = np.asarray(cols, dtype=np.int64).reshape(-1)
    col_done = np.asarray(col_done).copy()
    col_rounds = np.asarray(col_rounds).copy()
    col_done[cols] = False
    col_rounds[cols] = 0
    return col_done, col_rounds
