"""Iterative graph algorithms as monotonic update-function specs (paper §II/III).

Every algorithm is normalized to the template

    x_v  <-  combine( c_v ,  REDUCE_{(u,v) in E}  edge_op(x_u, w'_uv) ,  x_v )

with a *monotonic* update function F (paper Eq. 3), which is what licenses the
asynchronous mode: consuming fresher in-neighbor states can only move a vertex
closer to its converged value (Lemma 1 / Theorem 1).

Instances carry their own edge arrays (CC symmetrizes; PageRank-style
algorithms bake d/|OUT(u)| into the edge weight), so engines only ever see an
:class:`AlgoInstance` and never touch the Graph again.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np

from repro_torch.graphs.graph import Graph

BIG = np.float32(3.0e38)  # stand-in for +inf that survives f32 arithmetic


@dataclasses.dataclass(frozen=True)
class Semiring:
    reduce: str   # "sum" | "min" | "max"
    edge_op: str  # "mul" | "add" | "min"

    @property
    def identity(self) -> float:
        return {"sum": 0.0, "min": float(BIG), "max": float(-BIG)}[self.reduce]


@dataclasses.dataclass
class AlgoInstance:
    """A concrete algorithm bound to a concrete graph.

    State is *batched*: ``x0``, ``c``, ``fixed`` are ``(n, d)`` where column j
    is an independent query (e.g. one personalized-PageRank seed or one SSSP
    source). Scalar constructors pass 1-D arrays and are normalized to
    ``d = 1`` here; every engine runs all columns in lockstep with per-column
    convergence, so ``d = 1`` reproduces the scalar behavior exactly.
    """

    name: str
    n: int
    src: np.ndarray        # int32[m]      edge sources
    dst: np.ndarray        # int32[m]      edge destinations
    w: np.ndarray          # float32[m]    transformed edge weights w'
    x0: np.ndarray         # float32[n, d] initial states
    c: np.ndarray          # float32[n, d] per-vertex constants
    fixed: np.ndarray      # bool[n, d]    vertices pinned at x0 (e.g. PHP target)
    semiring: Semiring
    combine: str           # "replace" (c + agg) | "min_old" | "max_old"
    residual: str          # "linf" | "l1" | "changed"
    eps: float
    monotone_dir: int      # +1 increasing toward fixpoint, -1 decreasing
    exact_fn: Optional[Callable[[], np.ndarray]] = None
    # constructor keyword args, recorded so `remake` can rebuild the same
    # algorithm on a mutated graph (incremental serving). Vertex-id-valued
    # params (source/seeds/target) are in the constructor's id space, so
    # `remake` is only valid before any `relabel`.
    params: Optional[dict] = None

    def __post_init__(self):
        for f in ("x0", "c", "fixed"):
            a = np.asarray(getattr(self, f))
            if a.ndim == 1:
                a = a.reshape(self.n, 1)
            setattr(self, f, a)
        if not (self.x0.shape == self.c.shape == self.fixed.shape):
            raise ValueError(
                f"x0/c/fixed shapes disagree: {self.x0.shape} "
                f"{self.c.shape} {self.fixed.shape}"
            )

    @property
    def m(self) -> int:
        return int(self.src.shape[0])

    @property
    def d(self) -> int:
        """Number of queries batched in the state columns."""
        return int(self.x0.shape[1])

    @property
    def c_pad_fill(self) -> float:
        """Padding fill for the constant vector `c`: additive 0.0 under
        "replace" combine, the reduce identity otherwise (0.0 is absorbing
        under min/max and would corrupt padding rows)."""
        return 0.0 if self.combine == "replace" else self.semiring.identity

    def exact(self) -> np.ndarray:
        assert self.exact_fn is not None
        return self.exact_fn()

    def relabel(self, rank: np.ndarray) -> "AlgoInstance":
        """Apply a processing order: vertex v becomes id rank[v]."""
        rank = np.asarray(rank)
        inv = np.empty_like(rank)
        inv[rank] = np.arange(len(rank))
        return dataclasses.replace(
            self,
            src=rank[self.src].astype(np.int32),
            dst=rank[self.dst].astype(np.int32),
            w=self.w.copy(),
            x0=self.x0[inv].copy(),
            c=self.c[inv].copy(),
            fixed=self.fixed[inv].copy(),
            exact_fn=(lambda: self.exact()[inv]) if self.exact_fn is not None else None,
            # id-valued params (source/seeds/target) are now stale; dropping
            # them makes `remake` on a relabeled instance fail loudly
            params=None,
        )


# --------------------------------------------------------------------------
# constructors
# --------------------------------------------------------------------------

def make_pagerank(g: Graph, damping: float = 0.85, eps: float = 1e-6) -> AlgoInstance:
    """x_v = (1-d) + d * sum_{u in IN(v)} x_u / |OUT(u)|  (unnormalized PR).

    Started from x0 = 0 the iterates increase monotonically toward the
    fixpoint, which is the monotone form the paper's theory needs.
    """
    outdeg = np.maximum(g.out_degrees(), 1).astype(np.float32)
    w = (damping * g.weights / outdeg[g.src]).astype(np.float32)
    return AlgoInstance(
        name="pagerank", n=g.n, src=g.src.copy(), dst=g.dst.copy(), w=w,
        x0=np.zeros(g.n, np.float32),
        c=np.full(g.n, 1.0 - damping, np.float32),
        fixed=np.zeros(g.n, bool),
        semiring=Semiring("sum", "mul"), combine="replace",
        residual="linf", eps=eps, monotone_dir=+1,
        exact_fn=lambda: _exact_linear_sum(g.n, g.src, g.dst, w,
                                           np.full(g.n, 1.0 - damping, np.float32)),
        params={"damping": damping, "eps": eps},
    )


def make_katz(g: Graph, alpha: float = 0.05, beta: float = 1.0, eps: float = 1e-6) -> AlgoInstance:
    w = np.full(g.m, alpha, np.float32) * g.weights
    return AlgoInstance(
        name="katz", n=g.n, src=g.src.copy(), dst=g.dst.copy(), w=w,
        x0=np.zeros(g.n, np.float32), c=np.full(g.n, beta, np.float32),
        fixed=np.zeros(g.n, bool),
        semiring=Semiring("sum", "mul"), combine="replace",
        residual="linf", eps=eps, monotone_dir=+1,
        exact_fn=lambda: _exact_linear_sum(g.n, g.src, g.dst, w,
                                           np.full(g.n, beta, np.float32)),
        params={"alpha": alpha, "beta": beta, "eps": eps},
    )


def make_php(g: Graph, target: int = 0, penalty: float = 0.8, eps: float = 1e-6) -> AlgoInstance:
    """Penalized hitting probability toward `target` (paper workload PHP):
    x_t = 1 pinned; x_v = p * sum_{u in IN(v)} x_u / |OUT(u)|."""
    outdeg = np.maximum(g.out_degrees(), 1).astype(np.float32)
    w = (penalty * g.weights / outdeg[g.src]).astype(np.float32)
    x0 = np.zeros(g.n, np.float32)
    x0[target] = 1.0
    fixed = np.zeros(g.n, bool)
    fixed[target] = True
    return AlgoInstance(
        name="php", n=g.n, src=g.src.copy(), dst=g.dst.copy(), w=w,
        x0=x0, c=np.zeros(g.n, np.float32), fixed=fixed,
        semiring=Semiring("sum", "mul"), combine="replace",
        residual="linf", eps=eps, monotone_dir=+1,
        exact_fn=lambda: _exact_linear_sum(g.n, g.src, g.dst, w,
                                           np.zeros(g.n, np.float32),
                                           fixed=fixed, x_fixed=x0),
        params={"target": target, "penalty": penalty, "eps": eps},
    )


def make_adsorption(
    g: Graph, seeds: Optional[np.ndarray] = None,
    p_inj: float = 0.25, p_cont: float = 0.75, eps: float = 1e-6,
) -> AlgoInstance:
    """Scalar-label Adsorption [18]: x_v = p_inj*I_v + p_cont * mean_in x_u."""
    indeg = np.maximum(g.in_degrees(), 1).astype(np.float32)
    w = (p_cont * g.weights / indeg[g.dst]).astype(np.float32)
    seeds = np.asarray(seeds if seeds is not None else [0])
    c = np.zeros(g.n, np.float32)
    c[seeds] = p_inj
    return AlgoInstance(
        name="adsorption", n=g.n, src=g.src.copy(), dst=g.dst.copy(), w=w,
        x0=np.zeros(g.n, np.float32), c=c, fixed=np.zeros(g.n, bool),
        semiring=Semiring("sum", "mul"), combine="replace",
        residual="linf", eps=eps, monotone_dir=+1,
        exact_fn=lambda: _exact_linear_sum(g.n, g.src, g.dst, w, c),
        params={"seeds": seeds, "p_inj": p_inj, "p_cont": p_cont, "eps": eps},
    )


def make_sssp(g: Graph, source: int = 0, eps: float = 0.5) -> AlgoInstance:
    """x_v = min(x_v, min_u x_u + w_uv); converged when nothing changes.

    ``eps`` thresholds the "changed" residual (#state entries that moved this
    round); the 0.5 default means "stop when nothing changes".
    """
    x0 = np.full(g.n, BIG, np.float32)
    x0[source] = 0.0
    return AlgoInstance(
        name="sssp", n=g.n, src=g.src.copy(), dst=g.dst.copy(),
        w=g.weights.copy(), x0=x0, c=np.full(g.n, BIG, np.float32),
        fixed=np.zeros(g.n, bool),
        semiring=Semiring("min", "add"), combine="min_old",
        residual="changed", eps=eps, monotone_dir=-1,
        exact_fn=lambda: _exact_dijkstra(g, source),
        params={"source": source, "eps": eps},
    )


def make_bfs(g: Graph, source: int = 0, eps: float = 0.5) -> AlgoInstance:
    """Hop counts = SSSP with unit weights."""
    inst = make_sssp(Graph(g.n, g.src.copy(), g.dst.copy(), None), source, eps=eps)
    return dataclasses.replace(
        inst, name="bfs", w=np.ones(g.m, np.float32),
        params={"source": source, "eps": eps},
    )


def make_cc(g: Graph) -> AlgoInstance:
    """Connected components by min-label propagation over symmetrized edges."""
    src = np.concatenate([g.src, g.dst])
    dst = np.concatenate([g.dst, g.src])
    x0 = np.arange(g.n, dtype=np.float32)

    def _exact() -> np.ndarray:
        parent = np.arange(g.n)

        def find(a: int) -> int:
            while parent[a] != a:
                parent[a] = parent[parent[a]]
                a = parent[a]
            return a

        for u, v in zip(g.src, g.dst, strict=True):
            ra, rb = find(int(u)), find(int(v))
            if ra != rb:
                parent[max(ra, rb)] = min(ra, rb)
        roots = np.array([find(v) for v in range(g.n)])
        # min label within each component
        out = np.full(g.n, np.inf)
        np.minimum.at(out, roots, np.arange(g.n, dtype=np.float64))
        return out[roots].astype(np.float32)

    return AlgoInstance(
        name="cc", n=g.n, src=src.astype(np.int32), dst=dst.astype(np.int32),
        w=np.zeros(len(src), np.float32), x0=x0, c=np.full(g.n, BIG, np.float32),
        fixed=np.zeros(g.n, bool),
        semiring=Semiring("min", "add"), combine="min_old",
        residual="changed", eps=0.5, monotone_dir=-1,
        exact_fn=_exact,
        params={},
    )


def make_sswp(g: Graph, source: int = 0) -> AlgoInstance:
    """Single-source widest path: x_v = max(x_v, max_u min(x_u, w_uv))."""
    if g.w is None:
        raise ValueError("SSWP needs edge weights")
    x0 = np.zeros(g.n, np.float32)
    x0[source] = BIG

    def _exact() -> np.ndarray:
        import heapq

        width = np.zeros(g.n, np.float32)
        width[source] = BIG
        indptr, nbrs, eid = g.csr()
        w = g.weights
        heap = [(-float(BIG), source)]
        done = np.zeros(g.n, bool)
        while heap:
            negw, v = heapq.heappop(heap)
            if done[v]:
                continue
            done[v] = True
            for j in range(indptr[v], indptr[v + 1]):
                u = nbrs[j]
                cand = min(-negw, float(w[eid[j]]))
                if cand > width[u]:
                    width[u] = cand
                    heapq.heappush(heap, (-cand, int(u)))
        return width

    return AlgoInstance(
        name="sswp", n=g.n, src=g.src.copy(), dst=g.dst.copy(),
        w=g.weights.copy(), x0=x0, c=np.full(g.n, -BIG, np.float32),
        fixed=np.zeros(g.n, bool),
        semiring=Semiring("max", "min"), combine="max_old",
        residual="changed", eps=0.5, monotone_dir=+1,
        exact_fn=_exact,
        params={"source": source},
    )


def make_reachability(g: Graph, source: int = 0) -> AlgoInstance:
    """0/1 reachability from ``source`` as a max-times fixpoint:
    x_v = max(x_v, max_{u in IN(v)} x_u * 1) with x_source = 1.

    The (max, mul) semiring is the second max-reduce pair the fused kernels
    implement (`max_times`); states stay in {0, 1}, so the nonnegative-state
    contract that semiring's 0-fill relies on holds by construction.
    """
    x0 = np.zeros(g.n, np.float32)
    x0[source] = 1.0

    def _exact() -> np.ndarray:
        reach = np.zeros(g.n, bool)
        reach[source] = True
        indptr, nbrs, _ = g.csr()
        frontier = [source]
        while frontier:
            v = frontier.pop()
            for j in range(indptr[v], indptr[v + 1]):
                u = int(nbrs[j])
                if not reach[u]:
                    reach[u] = True
                    frontier.append(u)
        return reach.astype(np.float32)

    return AlgoInstance(
        name="reachability", n=g.n, src=g.src.copy(), dst=g.dst.copy(),
        w=np.ones(g.m, np.float32), x0=x0,
        c=np.full(g.n, -BIG, np.float32), fixed=np.zeros(g.n, bool),
        semiring=Semiring("max", "mul"), combine="max_old",
        residual="changed", eps=0.5, monotone_dir=+1,
        exact_fn=_exact,
        params={"source": source},
    )


# --------------------------------------------------------------------------
# batched multi-query constructors
# --------------------------------------------------------------------------

def make_personalized_pagerank(
    g: Graph, seeds=None, damping: float = 0.85, eps: float = 1e-6,
) -> AlgoInstance:
    """Personalized PageRank from ``d = len(seeds)`` seeds at once.

    Column j solves  x_v = (1-damping)*1[v == seeds[j]] + damping * sum_in
    x_u / |OUT(u)| — the same linear system as :func:`make_pagerank` with a
    one-hot restart vector, so all columns share the edge arrays and one
    batched run answers every query.
    """
    seeds = np.asarray(seeds if seeds is not None else [0], dtype=np.int64)
    if len(seeds) == 0:
        raise ValueError("personalized_pagerank needs at least one seed")
    d = len(seeds)
    outdeg = np.maximum(g.out_degrees(), 1).astype(np.float32)
    w = (damping * g.weights / outdeg[g.src]).astype(np.float32)
    c = np.zeros((g.n, d), np.float32)
    c[seeds, np.arange(d)] = 1.0 - damping
    return AlgoInstance(
        name="ppr", n=g.n, src=g.src.copy(), dst=g.dst.copy(), w=w,
        x0=np.zeros((g.n, d), np.float32), c=c,
        fixed=np.zeros((g.n, d), bool),
        semiring=Semiring("sum", "mul"), combine="replace",
        residual="linf", eps=eps, monotone_dir=+1,
        exact_fn=lambda: _exact_linear_sum(g.n, g.src, g.dst, w, c),
        params={"seeds": seeds, "damping": damping, "eps": eps},
    )


def make_multi_source_sssp(g: Graph, sources=None, eps: float = 0.5) -> AlgoInstance:
    """Single-source shortest paths from ``d = len(sources)`` sources at once;
    column j is the distance field of source j."""
    sources = np.asarray(sources if sources is not None else [0], dtype=np.int64)
    if len(sources) == 0:
        raise ValueError("multi_source_sssp needs at least one source")
    d = len(sources)
    x0 = np.full((g.n, d), BIG, np.float32)
    x0[sources, np.arange(d)] = 0.0

    def _exact() -> np.ndarray:
        return np.stack([_exact_dijkstra(g, int(s)) for s in sources], axis=1)

    return AlgoInstance(
        name="ms_sssp", n=g.n, src=g.src.copy(), dst=g.dst.copy(),
        w=g.weights.copy(), x0=x0, c=np.full((g.n, d), BIG, np.float32),
        fixed=np.zeros((g.n, d), bool),
        semiring=Semiring("min", "add"), combine="min_old",
        residual="changed", eps=eps, monotone_dir=-1,
        exact_fn=_exact,
        params={"sources": sources, "eps": eps},
    )


# short aliases matching the README / benchmark vocabulary
personalized_pagerank = make_personalized_pagerank
multi_source_sssp = make_multi_source_sssp


# --------------------------------------------------------------------------
# exact references
# --------------------------------------------------------------------------

def _exact_linear_sum(
    n: int, src: np.ndarray, dst: np.ndarray, w: np.ndarray, c: np.ndarray,
    fixed: Optional[np.ndarray] = None, x_fixed: Optional[np.ndarray] = None,
    iters: int = 10_000, tol: float = 1e-12,
) -> np.ndarray:
    """Jacobi to machine precision in float64 (reference for sum semirings).

    ``c`` may be (n,) or (n, d); the result matches its shape (columns are
    independent restart vectors).
    """
    c64 = np.asarray(c, np.float64)
    x = np.zeros_like(c64)
    if fixed is not None:
        x = np.where(fixed, np.asarray(x_fixed, np.float64), x)
    w64 = w.astype(np.float64)
    wv = w64 if c64.ndim == 1 else w64[:, None]
    for _ in range(iters):
        agg = np.zeros_like(x)
        np.add.at(agg, dst, x[src] * wv)
        x_new = c64 + agg
        if fixed is not None:
            x_new = np.where(fixed, np.asarray(x_fixed, np.float64), x_new)
        if np.max(np.abs(x_new - x)) < tol:
            x = x_new
            break
        x = x_new
    return x.astype(np.float32)


def _exact_dijkstra(g: Graph, source: int) -> np.ndarray:
    import heapq

    dist = np.full(g.n, np.float64(BIG))
    dist[source] = 0.0
    indptr, nbrs, eid = g.csr()
    w = g.weights
    heap = [(0.0, source)]
    done = np.zeros(g.n, bool)
    while heap:
        d, v = heapq.heappop(heap)
        if done[v]:
            continue
        done[v] = True
        for j in range(indptr[v], indptr[v + 1]):
            u = nbrs[j]
            nd = d + float(w[eid[j]])
            if nd < dist[u]:
                dist[u] = nd
                heapq.heappush(heap, (nd, int(u)))
    return dist.astype(np.float32)


ALGORITHMS: dict[str, Callable[..., AlgoInstance]] = {
    "pagerank": make_pagerank,
    "katz": make_katz,
    "php": make_php,
    "adsorption": make_adsorption,
    "sssp": make_sssp,
    "bfs": make_bfs,
    "cc": make_cc,
    "sswp": make_sswp,
    "reachability": make_reachability,
    "ppr": make_personalized_pagerank,
    "ms_sssp": make_multi_source_sssp,
}


def get_algorithm(name: str, g: Graph, **kw) -> AlgoInstance:
    return ALGORITHMS[name](g, **kw)


def remake(algo: AlgoInstance, g: Graph) -> AlgoInstance:
    """Rebuild ``algo`` (same constructor, same parameters) on a mutated
    graph — the delta constructor of the incremental serving engine.

    This re-runs the weight transform (e.g. PageRank's d/|OUT(u)| scaling),
    so edges whose weight changed only *implicitly* — an insertion into u's
    out-set rescales every existing u-edge — are picked up. ``algo`` must be
    in its original (pre-`relabel`) id space and ``g`` must keep the old
    vertex ids (new vertices appended at the end).
    """
    if algo.params is None:
        raise ValueError(
            f"algorithm {algo.name!r} has no recorded constructor params; "
            "build it via the make_* constructors / get_algorithm"
        )
    if g.n < algo.n:
        raise ValueError(
            f"mutated graph has {g.n} vertices < instance's {algo.n}; "
            "vertex removal is not supported (mask edges instead)"
        )
    return ALGORITHMS[algo.name](g, **algo.params)
