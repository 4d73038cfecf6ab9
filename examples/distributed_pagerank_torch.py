"""Distributed graph engine demo on the PyTorch port: vertex-sharded
PageRank over the ranks of a ``torch.distributed`` mesh (sync across
shards, Gauss-Seidel within), with GoGraph keeping cross-shard edges scarce.

    PYTHONPATH=src python examples/distributed_pagerank_torch.py
    PYTHONPATH=src python examples/distributed_pagerank_torch.py --device cpu
    PYTHONPATH=src OMP_NUM_THREADS=1 torchrun --nproc-per-node 4 \\
        examples/distributed_pagerank_torch.py --device cpu

The twin of ``examples/distributed_pagerank.py``: the same graph, order,
solves and printed lines, through ``repro_torch`` on ``--device``
(default ``cuda``; without a GPU pass ``--device cpu``). Where the
reference forces eight host devices, the port's distributed engine runs
over the ranks of the process group: started by ``torchrun`` (gloo ranks
on the CPU, one NCCL rank per card), or else one rank of its own (NCCL on
the card, gloo on the CPU). The intra-shard fraction uses that rank count.
"""
import argparse
import datetime
import os
import sys
import tempfile

sys.path.insert(0, "src")

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

from repro_torch import get_algorithm, solve  # noqa: E402
from repro_torch.core.gograph import gograph_order  # noqa: E402
from repro_torch.graphs import generators as gen  # noqa: E402


def check_device(device: str) -> None:
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda was asked for but no CUDA device is "
                           "available; pass --device cpu")


def _init_group(device: str, tmp: str) -> None:
    """The process group: torchrun's (its environment), else one rank
    through a FileStore in ``tmp``; NCCL on the card, gloo on the CPU."""
    backend = "nccl" if torch.device(device).type == "cuda" else "gloo"
    if torch.device(device).type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)) % torch.cuda.device_count())
    timeout = datetime.timedelta(seconds=600)
    if "WORLD_SIZE" in os.environ:
        dist.init_process_group(backend, timeout=timeout)
    else:
        dist.init_process_group(backend, store=dist.FileStore(os.path.join(tmp, "store"), 1),
                                rank=0, world_size=1, timeout=timeout)


def run(n: int = 20_000, device: str = "cuda", echo=print) -> dict:
    """The script's run over the process group that is up (one of its own
    when none is, torn down after); returns the numbers rank 0 prints."""
    from torch.distributed.device_mesh import init_device_mesh

    check_device(device)
    own = not dist.is_initialized()
    with tempfile.TemporaryDirectory() as tmp:
        if own:
            _init_group(device, tmp)
        try:
            ranks = dist.get_world_size()
            if dist.get_rank() != 0:
                echo = lambda *a, **k: None  # noqa: E731  (rank 0 prints)
            mesh = init_device_mesh(torch.device(device).type, (ranks,),
                                    mesh_dim_names=("data",))
            echo(f"ranks: {ranks}")
            g = gen.scrambled(gen.powerlaw_cluster(n, 5, seed=1), seed=3)
            rank = gograph_order(g)
            algo = get_algorithm("pagerank", g).relabel(rank)

            # fraction of edges that stay within a shard (the GoGraph locality win)
            shard = (np.arange(g.n) * ranks) // g.n
            g2 = g.relabel(rank)
            intra = float(np.mean(shard[g2.src] == shard[g2.dst]))
            echo(f"intra-shard edge fraction after GoGraph: {intra:.2f}")

            r_single = solve(algo, engine="async_block", bs=64, device=device)
            r_dist = solve(algo, engine="distributed", bs=64, mesh=mesh, device=device)
            err = float(np.max(np.abs(r_dist.x - algo.exact())))
            echo(f"single-device async rounds: {r_single.rounds}")
            echo(f"{ranks}-rank hybrid rounds: {r_dist.rounds} (err {err:.1e})")
            echo("cross-shard staleness costs rounds; locality keeps it bounded "
                 "(DESIGN.md §3)")
        finally:
            if own:
                dist.destroy_process_group()
    return {"ranks": ranks, "intra": intra, "single_rounds": r_single.rounds,
            "single_x": r_single.x, "dist_rounds": r_dist.rounds, "dist_x": r_dist.x,
            "err": err}


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--device", default="cuda")
    run(device=p.parse_args().device)


if __name__ == "__main__":
    main()
