"""Graph I/O: SNAP-style edge lists and a fast binary cache (port of
``repro.graphs.io``; host numpy, no torch). Nothing is fetched: these read
edge lists already on disk."""
from __future__ import annotations

import os

import numpy as np

from repro_torch.graphs.graph import Graph


def load_edge_list(path: str, weighted: bool = False, comments: str = "#") -> Graph:
    """Parse a whitespace-separated edge list (`u v [w]` per line).

    Vertex ids are compacted to a dense [0, n) range (SNAP files are sparse in
    id space). Order of first appearance defines the *default* processing
    order, matching how the paper treats original ids.
    """
    srcs: list[int] = []
    dsts: list[int] = []
    ws: list[float] = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith(comments):
                continue
            parts = line.split()
            srcs.append(int(parts[0]))
            dsts.append(int(parts[1]))
            if weighted:
                ws.append(float(parts[2]) if len(parts) > 2 else 1.0)
    src = np.asarray(srcs, dtype=np.int64)
    dst = np.asarray(dsts, dtype=np.int64)
    # compact ids by first appearance
    interleaved = np.empty(2 * len(src), dtype=np.int64)
    interleaved[0::2] = src
    interleaved[1::2] = dst
    uniq, inv = np.unique(interleaved, return_inverse=True)
    first_pos = np.full(len(uniq), np.iinfo(np.int64).max)
    np.minimum.at(first_pos, inv, np.arange(len(inv)))
    appearance_rank = np.argsort(np.argsort(first_pos))
    compact = appearance_rank[inv]
    src_c = compact[0::2].astype(np.int32)
    dst_c = compact[1::2].astype(np.int32)
    w = np.asarray(ws, dtype=np.float32) if weighted else None
    return Graph(len(uniq), src_c, dst_c, w)


def save_npz(g: Graph, path: str) -> None:
    """Write ``g`` to ``path`` (compressed npz), atomically."""
    tmp = path + ".tmp"
    arrays = {"n": np.asarray(g.n), "src": g.src, "dst": g.dst}
    if g.w is not None:
        arrays["w"] = g.w
    np.savez_compressed(tmp, **arrays)
    os.replace(tmp + ".npz" if not tmp.endswith(".npz") else tmp, path)


def load_npz(path: str) -> Graph:
    data = np.load(path)
    w = data["w"] if "w" in data else None
    return Graph(int(data["n"]), data["src"], data["dst"], w)


def load_cached(path: str, weighted: bool = False) -> Graph:
    """Load an edge list, memoized as .npz next to the source file."""
    cache = path + ".npz"
    if os.path.exists(cache) and os.path.getmtime(cache) >= os.path.getmtime(path):
        return load_npz(cache)
    g = load_edge_list(path, weighted=weighted)
    save_npz(g, cache)
    return g
