"""End-to-end run of the paper's workload kind on the PyTorch port:
large-graph iterative analytics with the full production stack — GoGraph
reordering, the block Gauss–Seidel engine, the hand-written sweep kernel,
checkpointing, and fault-tolerant execution.

    PYTHONPATH=src python examples/graph_end2end_torch.py [--n 50000] [--kernel]
    PYTHONPATH=src python examples/graph_end2end_torch.py --device cpu --n 3000 --inject-failure

The twin of ``examples/graph_end2end.py``: the same flags, graph, order,
macro-steps, checkpoints and printed lines, through ``repro_torch`` on
``--device`` (default ``cuda``; without a GPU pass ``--device cpu``).
``--kernel`` takes the place of ``--pallas``: each macro-step runs
``repro_torch.kernels.ops.run_async_block_kernel``, which launches the
``gs_multisweep`` kernel (``csrc/gs_sweep.cu``) on the card and runs its
plain version on the CPU.
"""
import argparse
import sys
import tempfile
import time

sys.path.insert(0, "src")

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.ckpt.manager import CheckpointManager  # noqa: E402
from repro_torch.core import metric  # noqa: E402
from repro_torch.core.gograph import gograph_order  # noqa: E402
from repro_torch.engine import get_algorithm, run_async_block  # noqa: E402
from repro_torch.graphs import generators as gen  # noqa: E402
from repro_torch.runtime.fault import FaultTolerantRunner, StragglerMonitor  # noqa: E402

ALGOS = ["pagerank", "sssp", "bfs", "php", "cc", "katz"]


def check_device(device: str) -> None:
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda was asked for but no CUDA device is "
                           "available; pass --device cpu")


def run(n: int = 50_000, algo_name: str = "pagerank", kernel: bool = False,
        inject_failure: bool = False, device: str = "cuda", echo=print) -> dict:
    """The script's run; returns the final state, its rounds, the fault
    log and the runner's failures."""
    check_device(device)
    t0 = time.perf_counter()
    g = gen.scrambled(gen.powerlaw_cluster(n, 5, seed=1), seed=3)
    echo(f"graph: {g}  ({time.perf_counter()-t0:.1f}s)")

    t0 = time.perf_counter()
    rank = gograph_order(g)
    m = metric.positive_edge_fraction(g, rank)
    echo(f"GoGraph reorder: M/E={m:.3f} ({time.perf_counter()-t0:.1f}s)")

    graph = gen.with_random_weights(g, seed=2) if algo_name == "sssp" else g
    algo = get_algorithm(algo_name, graph).relabel(rank)

    ckpt_dir = tempfile.mkdtemp(prefix="gograph_ckpt_")
    mgr = CheckpointManager(ckpt_dir, keep_last=2)
    injected = {"done": False}

    def step_fn(state, step):
        """One engine macro-step = up to 5 sweeps (checkpointable unit)."""
        if inject_failure and step == 1 and not injected["done"]:
            injected["done"] = True
            raise RuntimeError("injected failure (simulated node loss)")
        if kernel:
            from repro_torch.kernels.ops import run_async_block_kernel

            r = run_async_block_kernel(algo, bs=128, max_iters=5, x_init=state["x"],
                                       device=device)
        else:
            r = run_async_block(algo, bs=128, max_iters=5, x_init=state["x"], device=device)
        total = state["rounds"] + r.rounds
        return {"x": r.x, "rounds": total, "converged": bool(r.converged)}

    def save_fn(step, state):
        mgr.save(step, {"x": state["x"], "rounds": np.int64(state["rounds"])})

    def restore_fn():
        tree, man = mgr.restore()
        return ({"x": tree["['params']['x']"].numpy(),
                 "rounds": int(tree.get("['params']['rounds']", 0)),
                 "converged": False},
                man["step"])

    runner = FaultTolerantRunner(step_fn, save_fn, restore_fn, ckpt_every=1,
                                 max_failures=2,
                                 straggler=StragglerMonitor(threshold=3.0))
    t0 = time.perf_counter()
    state = {"x": algo.x0, "rounds": 0, "converged": False}
    for macro in range(20):
        state, _ = runner.run(state, steps=macro + 1, start_step=macro)
        if state["converged"]:
            break
    dt = time.perf_counter() - t0
    err = float(np.max(np.abs(state["x"] - algo.exact())))
    echo(f"{algo_name}: converged={state['converged']} rounds={state['rounds']} "
         f"({dt:.1f}s), max err vs exact = {err:.2e}")
    if runner.log:
        echo("fault log:", *runner.log, sep="\n  ")
    return {"m": m, "x": state["x"], "rounds": state["rounds"],
            "converged": state["converged"], "err": err, "wall_s": dt,
            "log": list(runner.log), "failures": runner.failures}


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--n", type=int, default=50_000)
    p.add_argument("--algo", default="pagerank", choices=ALGOS)
    p.add_argument("--kernel", action="store_true",
                   help="sweep through the hand-written gs_multisweep kernel")
    p.add_argument("--inject-failure", action="store_true")
    p.add_argument("--device", default="cuda")
    args = p.parse_args()
    run(args.n, args.algo, args.kernel, args.inject_failure, args.device)


if __name__ == "__main__":
    main()
