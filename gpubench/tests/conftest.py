"""Tests of the benchmark itself, on the CPU at small sizes; the few that
need a card ask for the ``card`` fixture and skip without one.

    python -m pytest gpubench/tests
"""
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)


@pytest.fixture(autouse=True, scope="session")
def _one_thread():
    """The CPU runs take the kernels' plain torch versions; with several
    test workers, torch's own threads would crowd the cores."""
    import torch

    torch.set_num_threads(1)


@pytest.fixture
def card():
    """The CUDA device, or a skip when the machine has none."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def shrink(cell):
    """A cell cut to a size the CPU runs in seconds: the same files, with
    small graphs, few slots and clients and a short profile."""
    g = cell.config["graph"]
    if "edges" in g:
        g.update(vertices=3000, edges=18000)
    else:
        g.update(vertices=1200, cols=35, arcs=2 * 1600)
    cell.config["deployment"]["d"] = 8
    cell.mix.update(clients=16, warmup_resolved=16, profile_seconds=0.3, sample=8,
                    **({"warmup_batches": 1} if "warmup_batches" in cell.mix else {}))
    return cell


@pytest.fixture
def small_cell():
    """``small_cell(name, trace=False)``: the named cell, shrunk."""
    from gpubench.harness import find_cell

    return lambda name, trace=False: shrink(find_cell(name, trace))
