"""Personalized PageRank by Jacobi iteration to the fixed point.

Column j solves ``x = (1 - a) e_{s_j} + a * sum_{u -> v} x_u w_uv / out(u)``
with ``a`` the damping, ``out(u)`` the number of u's out-edges (at least 1)
and ``w`` the edge weights: the restart puts ``1 - a`` on the seed. Jacobi
contracts by ``a`` a step, so stopping once no entry moves by more than
``tol`` leaves every entry within ``tol * a / (1 - a)`` of the fixed point.
"""
from __future__ import annotations

import numpy as np
import torch

from gpubench.reference.precision import tf32


def ppr(n: int, src: np.ndarray, dst: np.ndarray, w: np.ndarray,
        seeds: np.ndarray, damping: float, *, device: str = "cpu",
        dtype: torch.dtype = torch.float64, round_tf32: bool = False,
        tol: float = 1e-13, max_iters: int = 100_000) -> np.ndarray:
    """``(n, len(seeds))`` PPR scores. ``round_tf32`` rounds both operands
    of every product to TF32 (the control; use ``dtype=torch.float32``):
    its iterates may hop between neighbouring TF32 values for ever, so it
    returns its last iterate after ``max_iters`` instead of raising."""
    dev = torch.device(device)
    s = torch.as_tensor(np.asarray(src, np.int64), device=dev)
    t = torch.as_tensor(np.asarray(dst, np.int64), device=dev)
    out = torch.bincount(s, minlength=n).clamp_(min=1).to(dtype)
    coef = damping * torch.as_tensor(np.asarray(w), device=dev).to(dtype) / out[s]
    k = len(seeds)
    c = torch.zeros((n, k), dtype=dtype, device=dev)
    c[torch.as_tensor(np.asarray(seeds, np.int64), device=dev),
      torch.arange(k, device=dev)] = 1.0 - damping
    if round_tf32:
        coef = tf32(coef)
    x = c.clone()
    for _ in range(max_iters):
        xs = x[s]
        if round_tf32:
            xs = tf32(xs)
        x_new = c.index_add(0, t, xs * coef[:, None])
        moved = float((x_new - x).abs().max()) if x.numel() else 0.0
        x = x_new
        if moved <= tol:
            return x.cpu().numpy()
    if round_tf32:
        return x.cpu().numpy()
    raise RuntimeError(f"PPR did not reach {tol} in {max_iters} iterations")
