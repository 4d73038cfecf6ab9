"""GoGraph — the paper's divide-and-conquer vertex reordering (Algorithm 1).

Pipeline (paper §IV-A, Fig. 3):
  1. extract high-degree vertices (top ``hd_fraction``, default 0.2%) and the
     vertices their removal isolates;
  2. partition the remaining core into locality-preserving subgraphs;
  3. order vertices inside each subgraph by BFS-driven insertion, placing each
     candidate at the position maximizing the metric M(.) via the incremental
     ``GetOptVal`` scan over its already-placed neighbors;
  4. order the subgraphs themselves the same way, treating each as a
     super-vertex with weighted edges (weight = #edges between subgraphs);
  5. re-insert high-degree vertices, then isolated vertices, again via
     ``GetOptVal`` against the assembled order.

Ordinal numbers are represented by floating ``val``s exactly as in the paper's
implementation section (§IV-C): inserting between two placed vertices assigns
the mean of their vals, so no reindexing is needed; the final processing order
is the stable argsort of vals. A renormalization guard keeps midpoint
bisection away from float-precision exhaustion.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.graphs.graph import Graph, order_to_rank, rank_to_order
from repro_torch.core import partition as part_mod


@dataclasses.dataclass
class GoGraphConfig:
    hd_fraction: float = 0.002      # paper: "top 0.2% vertices with highest degree"
    min_n_for_hd: int = 64          # tiny graphs skip the HD phase
    partition_method: str = "labelprop"  # labelprop | louvain | fennel | bfs
    max_subgraph: int = 4096
    seed: int = 0


def _scan_best_gap(pe_head: float, delta_per: np.ndarray) -> int:
    """The ``GetOptVal`` gap scan, vectorized: the paper's per-gap loop
    walks the candidate's placed neighbors in val order, accumulating the
    positive-edge count ``pe`` (+w past an in-neighbor, -w past an
    out-neighbor) and keeping the first gap that *strictly* improves on the
    head position (paper line 18). The running ``pe`` after each neighbor is
    a sequential prefix sum seeded with ``pe_head`` — ``np.cumsum`` performs
    the identical left-to-right f64 additions, so seeding the cumsum with
    ``pe_head`` reproduces the loop's rounding bitwise — and "first strict
    improvement over everything before it" is ``argmax`` (first occurrence
    of the max) guarded by ``max > pe_head``. Returns the best gap index, or
    -1 for the head position."""
    cum = np.cumsum(np.concatenate(([pe_head], delta_per)))[1:]
    best = cum.max()
    return int(np.argmax(cum)) if best > pe_head else -1


class _Inserter:
    """Incremental M-maximizing insertion (the paper's ``GetOptVal``).

    Maintains float vals for placed vertices of an id universe of size n.
    ``insert`` scans the candidate's placed neighbors in ascending val order,
    updating the positive-edge count pe incrementally (+w when passing an
    in-neighbor, -w when passing an out-neighbor), and assigns the candidate
    the val of the best gap. Head/tail positions use global min-1 / max+1.
    The scan itself is the vectorized `_scan_best_gap` prefix sum
    (bitwise-identical to the sequential loop it replaced), so insertion
    cost is sort-dominated O(deg log deg) numpy work, not a Python loop
    per gap.
    """

    def __init__(self, n: int) -> None:
        self.val = np.full(n, np.nan, dtype=np.float64)
        self.placed: list[int] = []
        self._min = 0.0
        self._max = 0.0

    def grow(self, n_new: int) -> None:
        """Extend the id universe (appended vertices arrive unplaced)."""
        if n_new < len(self.val):
            raise ValueError(f"cannot shrink inserter from {len(self.val)} to {n_new}")
        pad = np.full(n_new - len(self.val), np.nan, dtype=np.float64)
        self.val = np.concatenate([self.val, pad])

    # -- helpers ---------------------------------------------------------
    def seed_sequence(self, ids: np.ndarray) -> None:
        """Pre-place `ids` at consecutive integer vals (assembled core order)."""
        ids = np.asarray(ids, dtype=np.int64)
        self.val[ids] = np.arange(len(ids), dtype=np.float64)
        self.placed = [int(i) for i in ids]
        if len(ids):
            self._min, self._max = 0.0, float(len(ids) - 1)

    def _renormalize(self) -> None:
        ids = np.asarray(self.placed, dtype=np.int64)
        order = ids[np.argsort(self.val[ids], kind="stable")]
        self.val[order] = np.arange(len(order), dtype=np.float64)
        self._min, self._max = 0.0, float(max(0, len(order) - 1))

    def is_placed(self, v: int) -> bool:
        return not np.isnan(self.val[v])

    # -- the core routine --------------------------------------------------
    def insert(
        self,
        v: int,
        in_nbrs: np.ndarray,
        in_w: np.ndarray,
        out_nbrs: np.ndarray,
        out_w: np.ndarray,
    ) -> float:
        """Place v optimally w.r.t. its placed neighbors; returns the val."""
        if not self.placed:
            self.val[v] = 0.0
            self._min = self._max = 0.0
            self.placed.append(int(v))
            return 0.0

        in_nbrs = np.asarray(in_nbrs, dtype=np.int64)
        out_nbrs = np.asarray(out_nbrs, dtype=np.int64)
        in_w = np.asarray(in_w, dtype=np.float64)
        out_w = np.asarray(out_w, dtype=np.float64)
        pin = in_nbrs[~np.isnan(self.val[in_nbrs])] if len(in_nbrs) else in_nbrs
        win = in_w[~np.isnan(self.val[in_nbrs])] if len(in_nbrs) else in_w
        pout = out_nbrs[~np.isnan(self.val[out_nbrs])] if len(out_nbrs) else out_nbrs
        wout = out_w[~np.isnan(self.val[out_nbrs])] if len(out_nbrs) else out_w

        if len(pin) == 0 and len(pout) == 0:
            # no placed neighbors: append at tail (keeps BFS locality)
            self._max += 1.0
            self.val[v] = self._max
            self.placed.append(int(v))
            return self.val[v]

        # net pe change when the candidate moves past each distinct neighbor:
        # passing an in-neighbor u (edge u->v) makes it positive (+w);
        # passing an out-neighbor w_ (edge v->w_) makes it negative (-w).
        nbrs = np.concatenate([pin, pout])
        deltas = np.concatenate([win, -wout])
        uniq, inv = np.unique(nbrs, return_inverse=True)
        delta_per = np.zeros(len(uniq), dtype=np.float64)
        np.add.at(delta_per, inv, deltas)
        order = np.argsort(self.val[uniq], kind="stable")
        uniq = uniq[order]
        delta_per = delta_per[order]

        pe = float(wout.sum())  # head position: all out-edges positive
        best_idx = _scan_best_gap(pe, delta_per)  # -1 = before first neighbor

        if best_idx == -1:
            self._min -= 1.0
            new_val = self._min
        elif best_idx == len(uniq) - 1:
            self._max += 1.0
            new_val = self._max
        else:
            lo = self.val[uniq[best_idx]]
            hi = self.val[uniq[best_idx + 1]]
            new_val = 0.5 * (lo + hi)
            if not (lo < new_val < hi):  # float bisection exhausted
                self._renormalize()
                lo = self.val[uniq[best_idx]]
                hi = self.val[uniq[best_idx + 1]]
                new_val = 0.5 * (lo + hi)

        self.val[v] = new_val
        self._min = min(self._min, new_val)
        self._max = max(self._max, new_val)
        self.placed.append(int(v))
        return new_val


def _insert_all(
    ins: _Inserter, g: Graph, ids: np.ndarray, *, by_degree: bool = True
) -> None:
    """Insert ``ids`` into ``ins`` against ``g``'s full (unit-weight)
    neighborhoods — THE shared insertion loop behind phase 5, `extend_rank`,
    and `regional_rerank` (previously re-spelled at each site).

    ``by_degree=True`` inserts hubs first (descending degree, stable by id —
    the HD-phase convention, so later arrivals can position against them);
    ``by_degree=False`` preserves the given order (BFS-candidate sequences).
    """
    ids = np.asarray(ids, dtype=np.int64)
    if not len(ids):
        return
    if by_degree:
        deg = g.degrees()
        ids = ids[np.argsort(-deg[ids], kind="stable")]
    csc_indptr, csc_src, _ = g.csc()
    csr_indptr, csr_dst, _ = g.csr()
    for v in ids:
        inn = csc_src[csc_indptr[v]:csc_indptr[v + 1]]
        outn = csr_dst[csr_indptr[v]:csr_indptr[v + 1]]
        ins.insert(int(v), inn, np.ones(len(inn)), outn, np.ones(len(outn)))


def _community_bfs_order(
    members: np.ndarray,
    indptr: np.ndarray,
    nbrs: np.ndarray,
    in_deg: np.ndarray,
) -> np.ndarray:
    """BFS over the community's internal (undirected) edges, seeded at the
    min in-degree member (paper: "the initial vertex always has the smallest
    in-degree"), restarting for disconnected pieces."""
    from collections import deque

    member_set = np.zeros(int(indptr.shape[0] - 1), dtype=bool)
    member_set[members] = True
    visited = np.zeros_like(member_set)
    by_indeg = members[np.argsort(in_deg[members], kind="stable")]
    order = np.empty(len(members), dtype=np.int64)
    pos = 0
    ptr = 0
    q: deque[int] = deque()
    while pos < len(members):
        if not q:
            while ptr < len(by_indeg) and visited[by_indeg[ptr]]:
                ptr += 1
            if ptr >= len(by_indeg):
                break
            s = int(by_indeg[ptr])
            visited[s] = True
            q.append(s)
        u = q.popleft()
        order[pos] = u
        pos += 1
        for w in nbrs[indptr[u]:indptr[u + 1]]:
            if member_set[w] and not visited[w]:
                visited[w] = True
                q.append(int(w))
    return order[:pos]


def gograph_order(
    g: Graph,
    config: GoGraphConfig | None = None,
    return_info: bool = False,
) -> np.ndarray | tuple[np.ndarray, dict]:
    """Run GoGraph; returns rank (rank[v] = ordinal p(v)).

    With ``return_info=True`` also returns a dict of phase artifacts used by
    tests and benchmarks (hd set, isolated set, community labels, vals).
    """
    cfg = config or GoGraphConfig()
    n = g.n
    if n == 0:
        rank = np.empty(0, dtype=np.int64)
        return (rank, {}) if return_info else rank

    ones = np.ones(g.m, dtype=np.float64)

    # ---- phase 1: extract high-degree vertices -------------------------
    deg = g.degrees()
    n_hd = int(round(n * cfg.hd_fraction)) if n >= cfg.min_n_for_hd else 0
    if n_hd > 0:
        # deterministic top-k by (degree desc, id asc)
        order_by_deg = np.lexsort((np.arange(n), -deg))
        hd = order_by_deg[:n_hd]
    else:
        hd = np.empty(0, dtype=np.int64)
    is_hd = np.zeros(n, dtype=bool)
    is_hd[hd] = True

    # ---- isolated after HD removal (incl. genuinely isolated vertices) --
    keep_edge = ~(is_hd[g.src] | is_hd[g.dst])
    deg_rest = np.bincount(g.src[keep_edge], minlength=n) + np.bincount(
        g.dst[keep_edge], minlength=n
    )
    is_iso = (~is_hd) & (deg_rest == 0)
    core_ids = np.where(~is_hd & ~is_iso)[0].astype(np.int32)

    info: dict = {"hd": hd, "iso": np.where(is_iso)[0], "core": core_ids}

    # ---- phase 2: partition the core ------------------------------------
    core_order_global: np.ndarray
    if len(core_ids):
        g_core, old_ids = g.subgraph(core_ids)
        labels = part_mod.partition(
            g_core, method=cfg.partition_method, max_size=cfg.max_subgraph, seed=cfg.seed
        )
        info["labels"] = labels
        k = int(labels.max()) + 1 if len(labels) else 0

        sym_indptr, sym_nbrs = part_mod._sym_csr(g_core)
        in_deg_core = g_core.in_degrees()
        csc_indptr, csc_src, csc_eid = g_core.csc()
        csr_indptr, csr_dst, csr_eid = g_core.csr()

        # ---- phase 3: order vertices within each subgraph ---------------
        local_pos = np.empty(g_core.n, dtype=np.int64)  # position inside community
        comm_members: list[np.ndarray] = []
        for c in range(k):
            members = np.where(labels == c)[0]
            comm_members.append(members)
            cand = _community_bfs_order(members, sym_indptr, sym_nbrs, in_deg_core)
            ins = _Inserter(g_core.n)
            lab_c = labels
            for v in cand:
                inn = csc_src[csc_indptr[v]:csc_indptr[v + 1]]
                inn = inn[lab_c[inn] == c]
                outn = csr_dst[csr_indptr[v]:csr_indptr[v + 1]]
                outn = outn[lab_c[outn] == c]
                ins.insert(int(v), inn, np.ones(len(inn)), outn, np.ones(len(outn)))
            mvals = ins.val[members]
            local_pos[members] = np.argsort(np.argsort(mvals, kind="stable"), kind="stable")

        # ---- phase 4: order the subgraphs (super-vertices) --------------
        cs, cd = labels[g_core.src], labels[g_core.dst]
        inter = cs != cd
        if k > 1 and inter.any():
            key = cs[inter].astype(np.int64) * k + cd[inter]
            uniq, cnt = np.unique(key, return_counts=True)
            s_src = (uniq // k).astype(np.int32)
            s_dst = (uniq % k).astype(np.int32)
            g_sup = Graph(k, s_src, s_dst, cnt.astype(np.float32))
        else:
            g_sup = Graph(k, np.empty(0, np.int32), np.empty(0, np.int32))
        sup_sym_indptr, sup_sym_nbrs = part_mod._sym_csr(g_sup)
        sup_in_deg = g_sup.in_degrees()
        s_csc_indptr, s_csc_src, s_csc_eid = g_sup.csc()
        s_csr_indptr, s_csr_dst, s_csr_eid = g_sup.csr()
        sup_cand = _community_bfs_order(
            np.arange(k, dtype=np.int64), sup_sym_indptr, sup_sym_nbrs, sup_in_deg
        )
        sup_ins = _Inserter(k)
        sup_w = g_sup.weights
        for svx in sup_cand:
            inn = s_csc_src[s_csc_indptr[svx]:s_csc_indptr[svx + 1]]
            win = sup_w[s_csc_eid[s_csc_indptr[svx]:s_csc_indptr[svx + 1]]]
            outn = s_csr_dst[s_csr_indptr[svx]:s_csr_indptr[svx + 1]]
            wout = sup_w[s_csr_eid[s_csr_indptr[svx]:s_csr_indptr[svx + 1]]]
            sup_ins.insert(int(svx), inn, win, outn, wout)
        sup_rank = np.argsort(np.argsort(sup_ins.val[:k], kind="stable"), kind="stable")
        info["sup_rank"] = sup_rank

        # ---- decompress: global core order ------------------------------
        comm_sizes = np.array([len(m) for m in comm_members], dtype=np.int64)
        comm_by_pos = np.argsort(sup_rank, kind="stable")  # community at each slot
        offsets = np.zeros(k, dtype=np.int64)
        running = 0
        for cpos in comm_by_pos:
            offsets[cpos] = running
            running += comm_sizes[cpos]
        core_pos = offsets[labels] + local_pos  # position of each core vertex
        core_order_local = np.argsort(core_pos, kind="stable")
        core_order_global = old_ids[core_order_local]
    else:
        core_order_global = np.empty(0, dtype=np.int64)

    # ---- phase 5: insert high-degree then isolated vertices -------------
    glob = _Inserter(n)
    glob.seed_sequence(core_order_global)
    _insert_all(glob, g, hd, by_degree=True)
    _insert_all(glob, g, np.where(is_iso)[0], by_degree=False)

    order = np.argsort(glob.val, kind="stable")
    rank = order_to_rank(order)
    info["val"] = glob.val
    return (rank, info) if return_info else rank


class RankMaintainer:
    """Persistent incremental order maintenance for evolving graphs.

    Wraps one `_Inserter` whose float vals survive across delta batches:
    ``extend_rank`` used to re-seed (an O(n) renormalization) on *every*
    batch, so a tenant absorbing a delta stream paid O(n) per batch even
    when only a handful of vertices arrived. The maintainer seeds once and
    only renormalizes when midpoint bisection exhausts float precision
    (the `_Inserter` guard), making steady-state extension O(|new| · deg).

    Placed vertices keep their relative order exactly (their vals are only
    bisected between), so already-packed blocks and served warm states stay
    aligned. After an arbitrary reorder (e.g. `regional_rerank`) build a
    fresh maintainer from the new rank.
    """

    def __init__(self, rank: np.ndarray) -> None:
        rank = np.asarray(rank)
        self.n = len(rank)
        self._ins = _Inserter(self.n)
        self._ins.seed_sequence(rank_to_order(rank))

    def extend(self, g: Graph) -> np.ndarray:
        """Place ``g``'s appended vertices (ids >= current n) and return the
        extended rank over all ``g.n`` vertices. New vertices insert in
        descending degree order (hubs first, the HD-phase convention)."""
        if self.n > g.n:
            raise ValueError(f"maintained rank covers {self.n} vertices, graph has {g.n}")
        if g.n > self.n:
            self._ins.grow(g.n)
            _insert_all(self._ins, g, np.arange(self.n, g.n, dtype=np.int64),
                        by_degree=True)
            self.n = g.n
        return self.rank()

    def rank(self) -> np.ndarray:
        return order_to_rank(np.argsort(self._ins.val[:self.n], kind="stable"))


def extend_rank(g: Graph, rank_old: np.ndarray) -> np.ndarray:
    """Incremental order maintenance for evolving graphs.

    ``g`` is a mutated graph whose first ``len(rank_old)`` vertices keep
    their ids; the rest are newly appended. Instead of re-running the full
    divide-and-conquer pipeline, each new vertex is placed into the existing
    order at its M-maximizing position via the same ``GetOptVal`` scan
    (`_Inserter.insert`) that phase 5 uses for high-degree vertices —
    O(deg(v) log deg(v)) per arrival, no global reorder.

    One-shot convenience over :class:`RankMaintainer` — callers extending
    repeatedly (the serving loop) should hold a maintainer instead, which
    amortizes the O(n) seeding this wrapper pays per call.
    """
    return RankMaintainer(rank_old).extend(g)


def regional_rerank(g: Graph, rank: np.ndarray, members: np.ndarray) -> np.ndarray:
    """Re-run the divide-and-conquer insertion over ``members`` only and
    splice the result into the global rank.

    Non-members keep their relative order exactly; members are removed and
    re-inserted at their M-maximizing positions via the same ``GetOptVal``
    machinery as phase 3 (BFS candidate order over the members' internal
    undirected edges, seeded at the min in-degree member) with the
    vectorized `_scan_best_gap` prefix scan. Cross-region edges participate
    through each member's full neighborhood, so a member can land anywhere
    in the global order, not just inside its old span.

    This is the online-reordering repair step: when a region's M fraction
    decays (tracked by `MetricTracker`), re-ranking just that region
    recovers most of the lost metric at O(|region| · deg) cost instead of
    the full O(n) pipeline. Returns the new rank over all vertices.
    """
    rank = np.asarray(rank, dtype=np.int64)
    if rank.shape != (g.n,):
        raise ValueError(f"rank must have shape ({g.n},), got {rank.shape}")
    members = np.asarray(members, dtype=np.int64)
    if not len(members):
        return rank.copy()
    is_member = np.zeros(g.n, dtype=bool)
    is_member[members] = True
    rest = rank_to_order(rank)
    rest = rest[~is_member[rest]]  # non-members, in current order
    ins = _Inserter(g.n)
    ins.seed_sequence(rest)
    sym_indptr, sym_nbrs = part_mod._sym_csr(g)
    # Seed each BFS component at a *boundary* member (one with a non-member
    # neighbor), min in-degree among those. Phase 3's plain min-in-degree
    # seed is right when nothing is placed yet, but here the non-members
    # are already placed: an interior seed has no placed neighbor, so its
    # GetOptVal scan degenerates to the tail-append fallback and drags the
    # whole spliced component away from its cross-region anchors.
    csum = np.concatenate([[0], np.cumsum(~is_member[sym_nbrs])])
    ext_nbrs = csum[sym_indptr[1:]] - csum[sym_indptr[:-1]]
    deg = g.in_degrees().astype(np.int64)
    prio = deg + (int(deg.max(initial=0)) + 1) * (ext_nbrs == 0)
    cand = _community_bfs_order(members, sym_indptr, sym_nbrs, prio)
    _insert_all(ins, g, cand, by_degree=False)
    # BFS can only miss members with no internal edges; place them by degree
    missed = members[np.isnan(ins.val[members])]
    _insert_all(ins, g, missed, by_degree=True)
    return order_to_rank(np.argsort(ins.val, kind="stable"))
