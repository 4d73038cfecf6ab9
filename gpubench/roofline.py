"""What one pass of the sweep costs at the least, and the card's peaks.

A round of the engine is one pass over every edge (``RunResult``: "rounds
counts full passes over the edge set"), whatever implements it. At batch
width ``d`` a pass

* reads each edge's source index (int32) and weight (float32) once,
* reads each of the ``n`` state rows (``d`` float32) once and writes it once,
* does ``2 |E| d`` operations (one multiply-or-add and one reduce per edge
  and column).

The least time for a pass is the larger of its bytes over the memory's
rate and its operations over the float32 rate (no tensor cores: the
semirings are not matrix products). The work is counted from the graph,
never from the tiles the program stores, so it stays the same when a
later change stores the graph another way.
"""
from __future__ import annotations

# NVIDIA H100 SXM, data sheet, dense, at the full 700 W power limit
PEAKS = {
    "H100": {"hbm_bytes_per_s": 3.35e12, "f32_flops_per_s": 67e12},
}


def peaks_for(device_name: str) -> dict:
    """The peak table row for a card's name (``torch.cuda.get_device_name``)."""
    for key, row in PEAKS.items():
        if key in device_name:
            return row
    raise KeyError(f"no peaks for {device_name!r}; known: {sorted(PEAKS)}")


def pass_bytes(n_edges: int, n_rows: int, d: int) -> int:
    """Bytes one pass moves: 8 an edge, 2 x 4 d a state row."""
    return 8 * n_edges + 2 * 4 * d * n_rows


def pass_ops(n_edges: int, d: int) -> int:
    """Operations of one pass: 2 |E| d."""
    return 2 * n_edges * d


def pass_bound_s(n_edges: int, n_rows: int, d: int, peaks: dict) -> float:
    """The least seconds one pass can take on a card with ``peaks``."""
    return max(pass_bytes(n_edges, n_rows, d) / peaks["hbm_bytes_per_s"],
               pass_ops(n_edges, d) / peaks["f32_flops_per_s"])
