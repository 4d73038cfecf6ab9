import heapq

import numpy as np
import pytest
import torch

from gpubench.reference.ppr import ppr
from gpubench.reference.precision import tf32
from gpubench.reference.sssp import sssp


def _graph(n, m, seed, weights=False):
    rng = np.random.default_rng(seed)
    key = np.unique(rng.integers(0, n * n, size=m))
    src, dst = key // n, key % n
    keep = src != dst
    src, dst = src[keep], dst[keep]
    w = (rng.integers(1, 20, size=len(src)) if weights else np.ones(len(src))).astype(np.float32)
    return src, dst, w


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_ppr_against_a_dense_solve(seed):
    n = 60
    src, dst, w = _graph(n, 300, seed)
    seeds = np.array([0, 5, 17])
    a = 0.85
    out = np.maximum(np.bincount(src, minlength=n), 1)
    P = np.zeros((n, n))
    np.add.at(P, (dst, src), a * w.astype(np.float64) / out[src])
    C = np.zeros((n, len(seeds)))
    C[seeds, np.arange(len(seeds))] = 1 - a
    want = np.linalg.solve(np.eye(n) - P, C)
    got = ppr(n, src, dst, w, seeds, a)
    assert np.max(np.abs(got - want)) < 1e-12


def _dijkstra(n, src, dst, w, s):
    adj = [[] for _ in range(n)]
    for a, b, c in zip(src.tolist(), dst.tolist(), w.tolist()):
        adj[a].append((b, c))
    dist = [float("inf")] * n
    dist[s] = 0.0
    heap = [(0.0, s)]
    while heap:
        d, v = heapq.heappop(heap)
        if d > dist[v]:
            continue
        for u, c in adj[v]:
            if d + c < dist[u]:
                dist[u] = d + c
                heapq.heappush(heap, (d + c, u))
    return np.array(dist)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_sssp_against_dijkstra(seed):
    n = 80
    src, dst, w = _graph(n, 240, seed, weights=True)
    sources = np.array([0, 3, 40])
    got = sssp(n, src, dst, w, sources)
    want = np.stack([_dijkstra(n, src, dst, w, int(s)) for s in sources], axis=1)
    assert np.array_equal(np.isinf(got), np.isinf(want))
    fin = np.isfinite(want)
    assert np.array_equal(got[fin], want[fin])


def test_tf32_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0, 1.0 + 2**-10, 1.0 + 2**-11, 1.0 + 3 * 2**-12, -(1.0 + 2**-11),
                      float("inf"), 2049.0, 0.0])
    got = tf32(x).tolist()
    assert got[:3] == [1.0, 1.0 + 2**-10, 1.0 + 2**-10]  # a tie rounds away from zero
    assert got[3] == 1.0 + 2**-10
    assert got[4] == -(1.0 + 2**-10)
    assert got[5] == float("inf") and got[6] == 2050.0 and got[7] == 0.0
    y = torch.rand(1000) * 100
    assert torch.all((tf32(y) - y).abs() <= y.abs() * 2**-11)
