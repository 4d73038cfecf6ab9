"""Priority-scheduled block engine, Priter adapted to blocks (port of
``repro.engine.priority``).

Per scheduling round, select the top-k blocks by accumulated priority and
update only those, one after another in selection order (Gauss–Seidel
inside the round: a later selected block reads the states an earlier one
just wrote). When block i's state moves by |delta_i|, every dependent block
j (one with edges i -> j) inherits priority mass |delta_i|, through one
scatter-add over the O(nnz_blocks) dependency pairs of
`graphs.blocked.block_dependency_structure`.

States are batched ``f32[n, d]``; a block's priority is its state motion
summed over all d columns. Work is measured in *block updates*: ``rounds``
is total block updates / nb, the equivalent full sweeps.

Selection: every block starts at priority 1e30, so the first selections are
all ties. The reference's ``jax.lax.top_k`` breaks ties by the lower index;
``torch.topk`` promises no order, so the selection here is a stable
descending sort, which keeps the lower index first. Each round reads the
device once: the stopping test and the round's selection in one transfer.
A block's in-edges are grouped by destination once and reduced in that
order (`torch_ops.segment_reduce_sorted`), so the sums, and with them the
priorities and the stopping test, are the same on every run, on the card
too.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.engine.algorithms import AlgoInstance
from repro_torch.engine.convergence import RunResult
from repro_torch.engine import harness
from repro_torch.engine import torch_ops as T


def _block_dependency(
    algo: AlgoInstance, bs: int
) -> tuple[np.ndarray, np.ndarray]:
    """Unique (dst block, src block) dependency pairs: ``dep_dst[t]``
    depends on ``dep_src[t]`` (an edge runs src-block -> dst-block)."""
    from repro_torch.graphs.blocked import block_dependency_structure

    _, dep_dst, dep_src = block_dependency_structure(algo.src, algo.dst, algo.n, bs)
    return dep_dst, dep_src


def _finite(a: torch.Tensor) -> torch.Tensor:
    return torch.where(torch.abs(a) < 1e30, a, 0.0)


def _run(
    rows, x0, c, fixed, dep_dst, dep_src, *,
    bs: int, nb: int, k_sel: int,
    sem_reduce: str, sem_edge: str, comb: str,
    eps: float, max_rounds: int, identity: float,
):
    """Block i's in-edges are ``rows[i] = (src, lengths, w)``, grouped by
    destination with ``lengths[v]`` edges into the block's vertex v.
    Returns ``(x, k, res, total block updates)``."""
    d = x0.shape[1]
    dev = x0.device
    c_blk = c.view(nb, bs, d)
    fixed_blk = fixed.view(nb, bs, d)
    x0_blk = x0.view(nb, bs, d)
    x = x0.clone()
    prio = torch.full((nb,), 1e30, dtype=torch.float32, device=dev)
    res = torch.tensor(float("inf"), dtype=torch.float32, device=dev)
    k = tot = 0
    while k < max_rounds:
        sel = torch.sort(prio, descending=True, stable=True).indices[:k_sel]
        with harness.audited_sync():  # the round's one readout
            head = torch.cat([(res > eps).to(torch.int64).view(1), sel]).cpu().tolist()
        if not head[0]:
            break
        deltas = []
        for i in head[1:]:
            src, lengths, w = rows[i]
            sl = slice(i * bs, (i + 1) * bs)
            msgs = T.edge_op(sem_edge, x[src], w)
            agg = T.segment_reduce_sorted(sem_reduce, msgs, lengths, identity)
            old = x[sl]
            new = T.combine(comb, agg, c_blk[i], old, fixed_blk[i], x0_blk[i])
            deltas.append(torch.sum(torch.abs(_finite(new) - _finite(old))))
            x[sl] = new
        # processed blocks hand their priority to dependents (delta_vec is
        # nonzero only at the selected blocks, so untouched pairs add 0)
        delta_vec = torch.zeros((nb,), dtype=torch.float32, device=dev)
        delta_vec[sel] = torch.stack(deltas)
        prio[sel] = 0.0
        prio.index_add_(0, dep_dst, delta_vec[dep_src])
        # stop only when this round moved nothing AND no pending priority
        # remains anywhere (selected-quiet != converged)
        res = torch.maximum(torch.sum(delta_vec), torch.max(prio))
        k += 1
        tot += k_sel
    return x, k, res, tot


def run_priority_block(
    algo: AlgoInstance, bs: int = 128, select_frac: float = 0.25,
    max_rounds: int = 20000, device: str = "cuda",
) -> RunResult:
    """Returns a RunResult whose ``rounds`` is *equivalent full sweeps*
    (total block updates / nb), comparable to the other engines' round
    counts in work terms. The scheduler stops on the total priority mass
    over all d columns, which bounds every column's mass, so
    ``col_converged`` is filled with the one verdict; ``col_rounds`` stays
    None. ``device`` is where the run happens (``"cuda"`` unless asked)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={device!r} was asked for but no CUDA device is available; "
            "pass device='cpu' to run on the CPU"
        )
    be, x0, c, fixed, npad = harness.pack(algo, bs)
    nb = be.nb
    k_sel = max(1, int(round(nb * select_frac)))
    dep_dst, dep_src = _block_dependency(algo, bs)
    # priority scheduling needs an accumulated-change signal; for "changed"
    # algorithms (SSSP/BFS/CC) the L1 delta works identically. The threshold
    # is NOT scaled by d: total mass <= eps bounds every column's mass.
    eps = algo.eps if algo.residual != "linf" else algo.eps * max(1, algo.n) * 0.01

    def to_dev(a):
        return harness.to_device(a, dev)

    x, k, res, tot = _run(
        harness.block_segments(be, dev), to_dev(x0), to_dev(c), to_dev(fixed),
        to_dev(dep_dst.astype(np.int64)), to_dev(dep_src.astype(np.int64)),
        bs=bs, nb=nb, k_sel=k_sel,
        sem_reduce=algo.semiring.reduce, sem_edge=algo.semiring.edge_op,
        comb=algo.combine, eps=float(eps), max_rounds=max_rounds,
        identity=algo.semiring.identity,
    )
    with harness.audited_sync():
        xr = x.cpu().numpy()[: algo.n]
        converged = bool(res <= eps)  # in f32, as the reference compares
        res = float(res)
    if algo.d == 1:
        xr = xr[:, 0]
    finite = xr[np.abs(xr) < 1e30]
    return RunResult(
        x=xr,
        rounds=float(tot) / nb,
        converged=converged,
        residuals=np.asarray([res]),
        state_sums=np.asarray([float(finite.sum()) if len(finite) else 0.0]),
        col_converged=np.full((algo.d,), converged),
    )
