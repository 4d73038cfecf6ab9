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

A graph that changes under a run goes from one version to the next by
`apply_delta`, the benchmark's own: the reference is built on the edge
list of each version without the program's delta code.
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


def apply_delta(g: EdgeList, batch: dict) -> EdgeList:
    """The next version of ``g``: the pairs ``(del_src[i], del_dst[i])``
    removed, then ``(add_src[i], add_dst[i])`` appended with weights
    ``add_w[i]``. Raises ``ValueError`` on an id out of range, a self-loop,
    an inserted pair already in ``g`` (or twice in the batch) and a deleted
    pair not in ``g`` (or twice in the batch), so that every version is one
    simple graph and no batch can be read two ways."""
    n = g.n
    add_s, add_d, del_s, del_d = (np.asarray(batch[k], np.int64).reshape(-1) for k in
                                  ("add_src", "add_dst", "del_src", "del_dst"))
    add_w = np.asarray(batch["add_w"], np.float32).reshape(-1)
    if not len(add_s) == len(add_d) == len(add_w) or len(del_s) != len(del_d):
        raise ValueError("a batch's arrays differ in length")
    for a in (add_s, add_d, del_s, del_d):
        if len(a) and (a.min() < 0 or a.max() >= n):
            raise ValueError(f"a vertex id out of range for n={n}")
    if np.any(add_s == add_d) or np.any(del_s == del_d):
        raise ValueError("a self-loop in the batch")
    key = g.src * n + g.dst
    add_key, del_key = add_s * n + add_d, del_s * n + del_d
    if len(np.unique(add_key)) < len(add_key) or np.isin(add_key, key).any():
        raise ValueError("an inserted pair is already present")
    drop = np.isin(key, del_key)
    if len(np.unique(del_key)) < len(del_key) or int(drop.sum()) != len(del_key):
        raise ValueError("a deleted pair is absent")
    keep = ~drop
    return EdgeList(n, np.concatenate([g.src[keep], add_s]),
                    np.concatenate([g.dst[keep], add_d]),
                    np.concatenate([g.w[keep], add_w]))
