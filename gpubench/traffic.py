"""The general traffic generator: a mix is a data file under
``gpubench/traffic/<mix>.json`` that names its driver (a module under
``gpubench/drivers/``) and its parameters. This module turns the
parameters and the run's seed into the queries a run submits.

``"sources": "permutation"`` draws every vertex once, in an order that the
seed decides: no query repeats within a run, so a result cache never
answers, and every seed sends the same set of queries in another order.
"""
from __future__ import annotations

import numpy as np


def query_sources(n: int, mix: dict, seed: int) -> np.ndarray:
    """The vertices the run's queries start from, in submission order."""
    kind = mix["sources"]
    rng = np.random.default_rng([int(seed), 0x71756572])
    if kind == "permutation":
        return rng.permutation(n)
    raise ValueError(f"unknown sources {kind!r}")


class Reservoir:
    """A uniform sample of ``size`` items from a stream, drawn from a seed
    (Algorithm R): which answers the check compares."""

    def __init__(self, size: int, seed: int) -> None:
        self.size = size
        self.items: list = []
        self.seen = 0
        self._rng = np.random.default_rng([int(seed), 0x73616d70])

    def offer(self, make) -> bool:
        """Keep the item ``make()`` builds with the right chance (``make``
        runs only then); True if it was kept (an item it replaced is gone)."""
        self.seen += 1
        if len(self.items) < self.size:
            self.items.append(make())
            return True
        j = int(self._rng.integers(self.seen))
        if j < self.size:
            self.items[j] = make()
            return True
        return False
