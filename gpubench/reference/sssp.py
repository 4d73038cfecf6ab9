"""Single-source shortest paths by Bellman–Ford relaxation to the fixed
point: every column starts at 0 on its source and +inf elsewhere, and each
step relaxes every edge at once until no distance falls. Unreachable
vertices stay +inf."""
from __future__ import annotations

import numpy as np
import torch

from gpubench.reference.precision import tf32


def sssp(n: int, src: np.ndarray, dst: np.ndarray, w: np.ndarray,
         sources: np.ndarray, *, device: str = "cpu",
         dtype: torch.dtype = torch.float64, round_tf32: bool = False,
         max_iters: int | None = None) -> np.ndarray:
    """``(n, len(sources))`` distances. ``round_tf32`` rounds every path
    sum to TF32 as it is formed (the control; use ``dtype=torch.float32``)."""
    dev = torch.device(device)
    s = torch.as_tensor(np.asarray(src, np.int64), device=dev)
    t = torch.as_tensor(np.asarray(dst, np.int64), device=dev)
    wt = torch.as_tensor(np.asarray(w), device=dev).to(dtype)[:, None]
    k = len(sources)
    x = torch.full((n, k), float("inf"), dtype=dtype, device=dev)
    x[torch.as_tensor(np.asarray(sources, np.int64), device=dev),
      torch.arange(k, device=dev)] = 0.0
    idx = t[:, None].expand(-1, k)
    for _ in range(max_iters if max_iters is not None else n):
        cand = x[s] + wt
        if round_tf32:
            cand = tf32(cand)
        x_new = x.scatter_reduce(0, idx, cand, reduce="amin", include_self=True)
        if torch.equal(x_new, x):
            return x.cpu().numpy()
        x = x_new
    raise RuntimeError("SSSP relaxation did not settle (negative cycle?)")
