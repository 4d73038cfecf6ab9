"""The control (the reference in TF32 in the program's place) fails each
cell's limits at a size the CPU holds; `gpubench/control.py` reads the
same numbers at the cells' own size on the card."""
import pytest

from gpubench.control import control_numbers
from gpubench.harness import HERE, load_json

CELLS = [w["name"] for w in load_json(HERE.parent / "BENCHMARK.json")["workloads"]]


@pytest.mark.parametrize("seed", [1, 2, 3])
@pytest.mark.parametrize("name", CELLS)
def test_control_fails_a_limit(small_cell, name, seed):
    cell = small_cell(name)
    numbers = control_numbers(cell, seed, "cpu")
    assert any(numbers[k] > lim for k, lim in cell.limits.items()), numbers
