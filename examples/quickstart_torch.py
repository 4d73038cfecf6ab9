"""Quickstart on the PyTorch port: the paper in 60 seconds.

Builds a power-law graph, reorders it with GoGraph, and runs PageRank in the
three execution modes the paper compares — synchronous, asynchronous with the
default order, asynchronous with the GoGraph order — printing the metric
M(O_V) and the number of iteration rounds for each.

    PYTHONPATH=src python examples/quickstart_torch.py
    PYTHONPATH=src python examples/quickstart_torch.py --device cpu

The twin of ``examples/quickstart.py``: the same graph, orders, solves and
printed lines, through ``repro_torch`` on ``--device`` (default ``cuda``;
without a GPU pass ``--device cpu``).
"""
import argparse
import sys

sys.path.insert(0, "src")

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch import get_algorithm, solve  # noqa: E402
from repro_torch.core import baselines, metric  # noqa: E402
from repro_torch.core.gograph import gograph_order  # noqa: E402
from repro_torch.graphs import generators as gen  # noqa: E402

N = 8000


def check_device(device: str) -> None:
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda was asked for but no CUDA device is "
                           "available; pass --device cpu")


def run(n: int = N, device: str = "cuda", echo=print) -> dict:
    """The script on an ``n``-vertex graph; returns the numbers it prints."""
    check_device(device)
    echo("generating a scrambled power-law graph (the paper's web-graph regime)...")
    g = gen.scrambled(gen.powerlaw_cluster(n, 5, seed=1), seed=7)
    echo(f"  {g}")

    echo("\nreordering with GoGraph (divide-and-conquer, maximizing M)...")
    rank = gograph_order(g)
    m_default = metric.positive_edge_fraction(g, baselines.default_order(g))
    m_gograph = metric.positive_edge_fraction(g, rank)
    echo(f"  M/|E| default  = {m_default:.3f}")
    echo(f"  M/|E| GoGraph  = {m_gograph:.3f}   (Theorem 2 guarantees >= 0.5)")

    algo = get_algorithm("pagerank", g)
    algo_gg = algo.relabel(rank)

    # inner=2: one re-iteration per block makes the intra-block edges
    # GoGraph concentrates fresh too, as the reference's example runs it
    r_sync = solve(algo, engine="sync", device=device)
    r_async = solve(algo, engine="async_block", bs=64, inner=2, device=device)
    r_gg = solve(algo_gg, engine="async_block", bs=64, inner=2, device=device)

    echo("\nPageRank iteration rounds to 1e-6 convergence:")
    echo(f"  sync  + default order : {r_sync.rounds}")
    echo(f"  async + default order : {r_async.rounds}")
    echo(f"  async + GoGraph order : {r_gg.rounds}")
    speed = r_sync.rounds / max(1, r_gg.rounds)
    echo(f"  round speedup (async+GoGraph vs sync): {speed:.2f}x")

    err = float(np.max(np.abs(r_gg.x - algo_gg.exact())))
    echo(f"\nmax |x - exact| = {err:.2e}  (same fixpoint, fewer rounds)")
    return {"m_default": m_default, "m_gograph": m_gograph, "rounds_sync": r_sync.rounds,
            "rounds_async": r_async.rounds, "rounds_gograph": r_gg.rounds,
            "x_sync": r_sync.x, "x_async": r_async.x, "x_gograph": r_gg.x, "err": err}


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--device", default="cuda")
    run(device=p.parse_args().device)


if __name__ == "__main__":
    main()
