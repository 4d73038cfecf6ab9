"""The benchmark's own frozen graph generators.

Each generator builds one deployment's graph at the published vertex and
edge counts, as plain numpy arrays: the program under test and the
reference both read the same arrays. The graph is the deployment's data,
one graph as a real data set is one: it is drawn from the configuration's
own ``"seed"``, so every run of a cell serves the same graph, and a run's
``--seed`` draws only its queries (`gpubench.traffic`). Graphs drawn from
the run's seed would change the work itself (the tiles and the rounds)
from seed to seed, which no change to the program causes. A configuration file names its
generator under ``"graph": {"generator": <name>, ...}``: the module
``generators/<name>.py``, whose ``generate(spec, rng)`` takes that dict and
a ``numpy.random.Generator``.

Vertex ids are scrambled by a seeded permutation at the end, as a graph's
ids arrive in no useful order (the idea of ``scrambled`` in the program's
generators), so the processing order is the program's to find.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class EdgeList:
    """A directed graph: ``n`` vertices, edges ``src[i] -> dst[i]`` with
    float32 weights ``w[i]``; no self-loop and no repeated pair."""

    n: int
    src: np.ndarray  # int64[m]
    dst: np.ndarray  # int64[m]
    w: np.ndarray    # float32[m]

    @property
    def m(self) -> int:
        return int(self.src.shape[0])


def dedup(n: int, src: np.ndarray, dst: np.ndarray):
    keep = src != dst
    src, dst = src[keep], dst[keep]
    _, first = np.unique(src * n + dst, return_index=True)
    first.sort()
    return src[first], dst[first]


def scramble(n: int, src, dst, rng):
    perm = rng.permutation(n)
    return perm[src], perm[dst]


def generate(spec: dict) -> EdgeList:
    """The graph a configuration's ``"graph"`` entry describes, drawn from
    its ``"seed"``."""
    from gpubench.harness import load_module

    rng = np.random.default_rng([int(spec["seed"]), 0x67726170])
    return load_module("generators", spec["generator"]).generate(spec, rng)
