"""The check of single-source shortest-path answers.

``sssp_max_abs_err``: the largest gap, over the sampled queries and every
vertex, between the program's distance and the reference's
(`gpubench.reference.sssp`, float64). Weights are whole numbers and every
path sum the graphs hold is below 2^24, so float32 sums are exact and a
sound answer equals the reference: the limit is 0. A vertex one side
reaches and the other does not reads as an infinite gap. The program
writes an unreachable vertex as 3e38; anything at or above 1e38 reads as
unreachable.
"""
from __future__ import annotations

import numpy as np
import torch

from gpubench.reference.sssp import sssp

NAME = "sssp_max_abs_err"
UNREACHED = 1e38


def _reference(g, sources, device, control=False):
    if control:
        return sssp(g.n, g.src, g.dst, g.w, sources, device=device,
                    dtype=torch.float32, round_tf32=True)
    return sssp(g.n, g.src, g.dst, g.w, sources, device=device)


def _gap(got: np.ndarray, ref: np.ndarray) -> float:
    got = np.where(got >= UNREACHED, np.inf, got.astype(np.float64))
    ref = np.where(ref >= UNREACHED, np.inf, ref)
    both = np.isinf(got) & np.isinf(ref)
    diff = np.abs(np.where(both, 0.0, got - np.where(both, 0.0, ref)))
    return float(np.max(np.where(np.isnan(diff), np.inf, diff)))


def numbers(g, config, sources, got, device="cpu") -> dict:
    """The compared numbers for the program's answers ``got`` (n, k)."""
    return {NAME: _gap(got, _reference(g, sources, device))}


def control(g, config, sources, device="cpu") -> dict:
    """The same numbers with the reference in TF32 in the program's place."""
    ref = _reference(g, sources, device)
    return {NAME: _gap(_reference(g, sources, device, control=True), ref)}
