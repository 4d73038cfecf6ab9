"""Serving PageRank on an evolving graph, on the PyTorch port: converge once,
then absorb a stream of edge/vertex delta batches by iterating only on each
batch's residual (Maiter-style accumulative correction) instead of
recomputing from scratch.

    PYTHONPATH=src python examples/evolving_pagerank_torch.py [--n 20000] [--batches 5]
    PYTHONPATH=src python examples/evolving_pagerank_torch.py --device cpu

The twin of ``examples/evolving_pagerank.py``: the same flags, graph,
deltas and printed lines, through ``repro_torch`` on ``--device`` (default
``cuda``; without a GPU pass ``--device cpu``). Each step prints warm vs
cold rounds and the cumulative rounds saved. Newly arrived vertices are
placed into the existing GoGraph rank by ``core.gograph.extend_rank``, not
a full reorder; ``run_incremental`` applies the rank internally and returns
id-space states.
"""
import argparse
import sys
import time

sys.path.insert(0, "src")

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch import get_algorithm, remake, run_incremental, solve  # noqa: E402
from repro_torch.core.gograph import extend_rank, gograph_order  # noqa: E402
from repro_torch.core.metric import positive_edge_fraction  # noqa: E402
from repro_torch.graphs import generators as gen  # noqa: E402
from repro_torch.graphs.delta import random_delta  # noqa: E402


def check_device(device: str) -> None:
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda was asked for but no CUDA device is "
                           "available; pass --device cpu")


def run(n: int = 20_000, batches: int = 5, frac_add: float = 0.01, bs: int = 256,
        device: str = "cuda", echo=print) -> dict:
    """The script's run; returns each batch's warm and cold rounds, M/|E|
    and states."""
    check_device(device)
    g = gen.scrambled(gen.powerlaw_cluster(n, 5, seed=1), seed=7)
    echo(f"base graph: {g}")
    rank = gograph_order(g)
    algo = get_algorithm("pagerank", g)
    t0 = time.perf_counter()
    prior = solve(algo.relabel(rank), bs=bs, inner=2, device=device)
    x_served = prior.x[rank]  # back to id space: v's value sits at slot rank[v]
    echo(f"initial convergence: {prior.rounds} rounds "
         f"({(time.perf_counter() - t0)*1e3:.0f} ms)\n")

    out = {"initial_rounds": prior.rounds, "steps": []}
    total_warm = total_cold = 0
    for step in range(batches):
        delta = random_delta(g, frac_add=frac_add, n_add_vertices=n // 1000,
                             seed=100 + step)
        g_new = delta.apply(g)
        algo_new = remake(algo, g_new)
        rank = extend_rank(g_new, rank)

        t0 = time.perf_counter()
        warm = run_incremental(algo_new, algo, x_served, engine="async_block", bs=bs,
                               inner=2, rank=rank, device=device)
        t_warm = time.perf_counter() - t0
        t0 = time.perf_counter()
        cold = solve(algo_new.relabel(rank), bs=bs, inner=2, device=device)
        t_cold = time.perf_counter() - t0

        drift = float(np.abs(warm.x - cold.x[rank]).max())
        m = positive_edge_fraction(g_new, rank)
        total_warm += warm.rounds
        total_cold += cold.rounds
        echo(f"batch {step}: +{len(delta.add_src)} edges, "
             f"+{delta.n_add} vertices, M/|E|={m:.3f}"
             f" -> warm {warm.rounds} rounds ({t_warm*1e3:.0f} ms) "
             f"vs cold {cold.rounds} ({t_cold*1e3:.0f} ms), "
             f"|warm-cold|={drift:.1e}")
        out["steps"].append({"warm_rounds": warm.rounds, "cold_rounds": cold.rounds,
                             "m": m, "drift": drift, "warm_x": warm.x,
                             "cold_x": cold.x[rank], "rank": rank})
        g, algo, x_served = g_new, algo_new, warm.x

    echo(f"\ntotal rounds: warm {total_warm} vs cold {total_cold} "
         f"({total_warm / max(1, total_cold):.0%})")
    out.update(total_warm=total_warm, total_cold=total_cold)
    return out


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--n", type=int, default=20_000)
    p.add_argument("--batches", type=int, default=5)
    p.add_argument("--frac-add", type=float, default=0.01)
    p.add_argument("--bs", type=int, default=256)
    p.add_argument("--device", default="cuda")
    args = p.parse_args()
    run(args.n, args.batches, args.frac_add, args.bs, args.device)


if __name__ == "__main__":
    main()
