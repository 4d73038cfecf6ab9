"""Batched multi-query serving on the PyTorch port: many personalized-PageRank
seeds (and SSSP sources) answered by ONE engine run over an f32[n, d] state
matrix.

    PYTHONPATH=src python examples/multi_query_torch.py [--n 20000] [--d 32]
    PYTHONPATH=src python examples/multi_query_torch.py --device cpu --n 4000 --d 8

The twin of ``examples/multi_query.py``: the same flags, graph, seeds and
printed lines, through ``repro_torch`` on ``--device`` (default ``cuda``;
without a GPU pass ``--device cpu``). Prints per-query round counts (each
column converges on its own schedule and freezes) and the throughput of the
batched run vs running the scalar engine d times.
"""
import argparse
import sys
import time

sys.path.insert(0, "src")

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch import multi_source_sssp, personalized_pagerank, solve  # noqa: E402
from repro_torch.graphs import generators as gen  # noqa: E402


def check_device(device: str) -> None:
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda was asked for but no CUDA device is "
                           "available; pass --device cpu")


def run(n: int = 20_000, d: int = 32, bs: int = 256, device: str = "cuda",
        echo=print) -> dict:
    """The script's run; returns the numbers it prints and the states."""
    check_device(device)
    g = gen.scrambled(gen.powerlaw_cluster(n, 5, seed=1), seed=7)
    echo(f"graph: {g}")
    rng = np.random.default_rng(0)
    seeds = rng.choice(g.n, size=d, replace=False)

    algo = personalized_pagerank(g, seeds)
    solve(algo, bs=bs, device=device)  # warm up (kernel builds, allocator) before timing
    t0 = time.perf_counter()
    r = solve(algo, bs=bs, device=device)
    t_batched = time.perf_counter() - t0
    echo(f"\nPPR x{d} batched: {r.rounds} sweeps "
         f"({t_batched*1e3:.0f} ms, {d / t_batched:.1f} queries/s)")
    echo(f"  per-query rounds: min={int(r.col_rounds.min())} "
         f"median={int(np.median(r.col_rounds))} max={int(r.col_rounds.max())}")

    scalar = personalized_pagerank(g, [int(seeds[0])])
    solve(scalar, bs=bs, device=device)
    t0 = time.perf_counter()
    for s in seeds[: min(8, d)]:
        solve(personalized_pagerank(g, [int(s)]), bs=bs, device=device)
    t_serial = (time.perf_counter() - t0) / min(8, d) * d
    echo(f"serial x{d} (extrapolated): {t_serial*1e3:.0f} ms "
         f"-> batched speedup {t_serial / t_batched:.1f}x")

    gw = gen.with_random_weights(g, seed=2)
    sources = rng.choice(g.n, size=min(8, d), replace=False)
    rm = solve(multi_source_sssp(gw, sources), bs=bs, device=device)
    echo(f"\nmulti-source SSSP x{len(sources)}: {rm.rounds} sweeps, "
         f"converged={rm.converged}, x shape {rm.x.shape}")
    return {"ppr_rounds": r.rounds, "ppr_col_rounds": r.col_rounds, "ppr_x": r.x,
            "batched_s": t_batched, "serial_s": t_serial, "sssp_rounds": rm.rounds,
            "sssp_converged": rm.converged, "sssp_x": rm.x, "seeds": seeds, "sources": sources}


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--n", type=int, default=20_000)
    p.add_argument("--d", type=int, default=32)
    p.add_argument("--bs", type=int, default=256)
    p.add_argument("--device", default="cuda")
    args = p.parse_args()
    run(args.n, args.d, args.bs, args.device)


if __name__ == "__main__":
    main()
