"""The check of personalized PageRank answers.

``ppr_max_abs_err``: the largest gap, over the sampled queries and every
vertex, between the program's score and the reference's float64 fixed
point (`gpubench.reference.ppr`). The program stops a query once no score
moved by more than its ``eps`` in a sweep, so a sound answer sits within a
few ``eps`` of the fixed point; rounding to TF32 (the control) moves the
large scores near the seed by about 2^-11 of their size.
"""
from __future__ import annotations

import numpy as np
import torch

from gpubench.reference.ppr import ppr

NAME = "ppr_max_abs_err"


def _reference(g, config, sources, device, control=False):
    damping = float(config["algorithms"]["ppr"]["damping"])
    if control:
        return ppr(g.n, g.src, g.dst, g.w, sources, damping, device=device,
                   dtype=torch.float32, round_tf32=True, tol=1e-7,
                   max_iters=2000)
    return ppr(g.n, g.src, g.dst, g.w, sources, damping, device=device)


def _gap(got: np.ndarray, ref: np.ndarray) -> float:
    return float(np.max(np.abs(got.astype(np.float64) - ref)))


def numbers(g, config, sources, got, device="cpu") -> dict:
    """The compared numbers for the program's answers ``got`` (n, k)."""
    ref = _reference(g, config, sources, device)
    return {NAME: _gap(got, ref)}


def control(g, config, sources, device="cpu") -> dict:
    """The same numbers with the reference in TF32 in the program's place."""
    ref = _reference(g, config, sources, device)
    low = _reference(g, config, sources, device, control=True)
    return {NAME: _gap(low, ref)}
