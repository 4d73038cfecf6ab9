"""The control of a cell's check: the reference computed in TF32 put in the
program's place, held to the same numbers as a run's answers.

    python gpubench/control.py --workload <cell> --seeds <n> [<n> ...]

For each seed it generates the cell's graph, takes as many queries as a run
compares (the mix's ``sample`` and one more) from the head of the seeded
query stream, and prints one JSON line: the control's numbers beside the
cell's limits. A sound limit lies below every control reading. It runs on
the card when there is one, else on the CPU; the benchmark's runs never
run it.

The control runs on the generated graph (version 0) alone, also for a mix
whose graph changes under the window: a few hundred links changed among
hundreds of thousands leave the reference's precision, which is what the
control reads, where it was.
"""
import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def control_numbers(cell, seed: int, device: str) -> dict:
    from gpubench import graphs, harness
    from gpubench.traffic import query_sources

    g = graphs.generate(cell.config["graph"])
    sources = query_sources(g.n, cell.mix, seed)[: cell.mix["sample"] + 1]
    check = harness.load_module("checks", cell.mix["check"], cell.base)
    return check.control(g, cell.config, sources, device=device)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch

    from gpubench import harness

    device = "cuda" if torch.cuda.is_available() else "cpu"
    cell = harness.find_cell(args.workload, False)
    for seed in args.seeds:
        t = time.perf_counter()
        numbers = control_numbers(cell, seed, device)
        print(json.dumps({
            "workload": args.workload, "seed": seed, "device": device,
            "control": numbers, "limits": cell.limits,
            "fails_a_limit": any(numbers[k] > v for k, v in cell.limits.items()),
            "seconds": time.perf_counter() - t,
        }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
