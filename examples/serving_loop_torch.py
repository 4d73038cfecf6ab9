"""End-to-end continuous-batching serving demo on the PyTorch port.

Poisson arrivals of mixed personalized-PageRank / SSSP traffic hit a
:class:`repro_torch.serving.GraphServer` while the graph itself evolves (a
random edge-delta batch lands every few ticks). Each simulation tick submits
the tick's arrivals and runs one server step; finished columns are swapped
out and queued queries swapped in mid-run, repeat queries are served from
the graph-version result cache, and in-flight queries ride deltas warm.

    PYTHONPATH=src python examples/serving_loop_torch.py
    PYTHONPATH=src python examples/serving_loop_torch.py --device cpu

The twin of ``examples/serving_loop.py``: the same graph, traffic, deltas
and printed lines, through ``repro_torch`` on ``--device`` (default
``cuda``; without a GPU pass ``--device cpu``).
"""
import argparse
import sys

sys.path.insert(0, "src")

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch import GraphServer  # noqa: E402
from repro_torch.graphs import generators as gen  # noqa: E402
from repro_torch.graphs.delta import random_delta  # noqa: E402

N = 1200
TICKS = 60
ARRIVAL_RATE = 2.5      # Poisson mean queries/tick
DELTA_EVERY = 15        # ticks between graph mutations
SLOTS = 8


def check_device(device: str) -> None:
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda was asked for but no CUDA device is "
                           "available; pass --device cpu")


def run(n: int = N, ticks: int = TICKS, device: str = "cuda", echo=print) -> dict:
    """The script's run; returns the server's summary, its graph version
    and cache statistics, and every ticket."""
    check_device(device)
    rng = np.random.default_rng(0)
    g = gen.scrambled(gen.powerlaw_cluster(n, 5, p=0.4, seed=1), seed=9)
    # weights <= 1 keep the PageRank family contractive, so PPR and SSSP
    # traffic can share the one served graph
    gw = gen.with_random_weights(g, lo=0.1, hi=1.0, seed=2)

    srv = GraphServer(gw, slots=SLOTS, bs=64, rounds_per_batch=4,
                      policy="fifo", delta_mode="warm", device=device)
    # a small hot set makes the result cache visible in the output
    hot = [int(v) for v in rng.integers(0, n, size=12)]

    echo(f"serving {n}-vertex graph | {SLOTS} slots | "
         f"Poisson({ARRIVAL_RATE}) arrivals | delta every {DELTA_EVERY} ticks")
    tickets = []
    for tick in range(ticks):
        if tick and tick % DELTA_EVERY == 0:
            delta = random_delta(srv.g, frac_add=0.01, frac_del=0.002,
                                 frac_rew=0.002, seed=100 + tick)
            srv.apply_delta(delta)
            echo(f"tick {tick:3d}  DELTA v{srv.graph_version} "
                 f"({delta.size} edge updates) — cache "
                 f"{srv.cache.stats()['promoted']} promoted / "
                 f"{srv.cache.stats()['invalidated']} invalidated")
        for _ in range(rng.poisson(ARRIVAL_RATE)):
            v = int(rng.choice(hot)) if rng.random() < 0.4 \
                else int(rng.integers(0, n))
            if rng.random() < 0.5:
                tickets.append(srv.submit("ppr", {"seeds": [v]}))
            else:
                tickets.append(srv.submit("sssp", {"source": v}))
        srv.step()
        if tick % 10 == 9:
            s = srv.stats.summary()
            occ = srv.stats.occupancy_trace
            echo(f"tick {tick:3d}  submitted={s['submitted']:3d} "
                 f"resolved={s['resolved']:3d} "
                 f"cache_hits={s['cache_hits']:2d} "
                 f"occupancy={occ[-1] if occ else 0.0:.2f} "
                 f"queued={srv.scheduler.total_pending()}")

    srv.run()   # drain what's left
    s = srv.stats.summary()
    echo("-" * 64)
    echo(f"drained: {s['resolved']}/{s['submitted']} queries "
         f"({s['cache_hits']} from cache), {s['unconverged']} unconverged")
    echo(f"throughput      {s['throughput_qps']:8.1f} queries/sec")
    echo(f"latency p50/p99 {s['latency_p50_s'] * 1e3:8.1f} / "
         f"{s['latency_p99_s'] * 1e3:.1f} ms")
    echo(f"rounds p50/p99  {s['rounds_p50']:8.0f} / {s['rounds_p99']:.0f}")
    echo(f"occupancy mean  {s['occupancy_mean']:8.2f}")
    echo(f"graph version   {srv.graph_version:8d} "
         f"(cache: {srv.cache.stats()})")
    return {"summary": s, "graph_version": srv.graph_version,
            "cache": srv.cache.stats(), "tickets": tickets}


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--device", default="cuda")
    run(device=p.parse_args().device)


if __name__ == "__main__":
    main()
