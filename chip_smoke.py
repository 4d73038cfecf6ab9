"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``).

Run from the root of a checkout on a machine with one NVIDIA H100:

    python3 chip_smoke.py

It builds the CUDA kernel from ``src/repro_torch/csrc`` (into
``build/repro_torch/``), holds the kernel against its plain PyTorch version
on small cases, drives the port's main path — GoGraph order, then
``solve(engine="async_block", backend="kernel")`` on a batch of 64
personalized-PageRank queries and 64 SSSP queries over a 100,000-vertex
graph — checks the PPR solve against the same path run through the
kernel's plain version, both solves against the torch-ops backend, and the
paper's result (fewer rounds for PageRank under GoGraph than under the
default order), and at the main path's shape holds one sweep of the kernel
against its plain version, checks that it repeats bit for bit, and times it
beside its plain version and its bound.

Any failure raises and exits non-zero. The second-to-last line of standard
output is the kernels' JSON record, the last line the device JSON. Detailed
per-case results go to ``chiprun_out/chip_smoke.json``. With no CUDA device
it exits non-zero before printing any result. ``--only-kernels`` stops after
the kernel-vs-plain phase.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import repro_torch  # noqa: E402,F401  (fails here when run outside a checkout)

# published peaks of one H100 SXM (NVIDIA data sheet) used for the bounds.
# The f32 rate counts an FMA as two operations; an add, multiply, min or max
# is one instruction of its own, so the lattice pairs (edge op, then reduce:
# two instructions per element) run at half that many operations per second.
HBM_BYTES_PER_S = 3.35e12
F32_FMA_OPS_PER_S = 67e12
F32_NON_FMA_OPS_PER_S = F32_FMA_OPS_PER_S / 2

PAIRS = [
    ("plus_times", "replace"),
    ("min_plus", "min_old"),
    ("max_min", "max_old"),
    ("max_times", "max_old"),
]
RECORD: dict = {"cases": [], "phases": {}}


def log(*a) -> None:
    print(*a, flush=True)


def phase_env() -> tuple[str, str]:
    log(f"[env] python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    log(smi)
    kind = torch.cuda.get_device_name(0)
    log(f"[env] device {kind} x{torch.cuda.device_count()}")
    # plus_times holds f32 products: no TF32 anywhere, kernel or plain
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    RECORD["nvidia_smi"] = smi
    return smi, kind


def phase_build() -> None:
    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    _build.load("gs_sweep")
    info = _build.BUILD_INFO["gs_sweep"]
    log(f"[build] gs_sweep.cu for sm_90a: {info['seconds']:.1f} s nvcc, "
        f"{time.perf_counter() - t0:.1f} s total -> {info['path']}")
    for line in sorted({ln.strip() for ln in info["ptxas"].splitlines()
                        if "registers" in ln or "spill" in ln}):
        log(f"[build] {line}")
    RECORD["build"] = {k: info[k] for k in ("seconds", "path", "ptxas")}


# ---------------------------------------------------------------------------
# kernel vs plain
# ---------------------------------------------------------------------------

def _case_operands(pair: str, n: int, bs: int, d: int, seed: int):
    """Kernel operands for one semiring pair: a graph of n vertices and d
    query columns with per-column sources or seeds."""
    from repro_torch.engine import algorithms as A
    from repro_torch.graphs import generators as gen
    from repro_torch.kernels.ops import pack_algorithm

    g = gen.with_random_weights(
        gen.scrambled(gen.powerlaw_cluster(n, 4, p=0.5, seed=seed), seed=seed + 1),
        lo=0.1, hi=1.0, seed=seed + 2,
    )
    rng = np.random.default_rng(seed)
    srcs = rng.choice(n, size=d, replace=False)
    if pair == "plus_times":
        algo = A.make_personalized_pagerank(g, seeds=srcs)
    elif pair == "min_plus":
        algo = A.make_multi_source_sssp(g, sources=srcs)
    else:
        make = A.make_sswp if pair == "max_min" else A.make_reachability
        cols = [make(g, source=int(s)) for s in srcs]
        algo = cols[0]
        algo.x0 = np.concatenate([a.x0 for a in cols], axis=1)
        algo.c = np.repeat(algo.c, d, axis=1)
        algo.fixed = np.repeat(algo.fixed, d, axis=1)
    ops = pack_algorithm(algo, bs, device="cuda")
    return algo, ops, srcs


def _run_pair(fn, algo, ops, bs, sweeps, dirty):
    x = ops["x0"].clone()
    out = fn(
        ops["rowptr"], ops["tilecols"], ops["revptr"], ops["revrows"],
        dirty.clone(), ops["tiles"], ops["c"], ops["x0"], ops["fixed"], x,
        semiring=ops["semiring"], combine=ops["combine"], res_kind=algo.residual,
        bs=bs, sweeps=sweeps, eps=float(algo.eps),
    )
    torch.cuda.synchronize()
    return out


def _compare(pair: str, k_out, p_out) -> tuple[bool, float]:
    xk, dk, ak, rk = k_out
    xp, dp, ap, rp = p_out
    err = float((xk - xp).abs().max())
    same_int = torch.equal(ak, ap) and torch.equal(rk, rp)
    if pair == "plus_times":
        ok = (torch.allclose(xk, xp, atol=1e-5, rtol=1e-4)
              and torch.allclose(dk, dp, atol=1e-5, rtol=1e-4) and same_int)
    else:
        ok = torch.equal(xk, xp) and torch.equal(dk, dp) and same_int
    return ok, err


def phase_kernels() -> dict:
    from repro_torch.graphs.blocked import frontier_blocks
    from repro_torch.kernels import gs_sweep as K

    n_cases = 0
    failures = []
    t0 = time.perf_counter()
    plan = [(pair, 311, 64, d, sw, fr)
            for pair, _ in PAIRS for d in (1, 3, 64) for sw in (1, 4, 16)
            for fr in ("all", "seeded")]
    plan += [(pair, 311, bs, d, 4, "seeded")
             for pair in ("plus_times", "min_plus") for bs in (16, 32, 128, 256)
             for d in (3, 64)]
    cache: dict = {}
    for pair, n, bs, d, sweeps, fr in plan:
        key = (pair, n, bs, d)
        if key not in cache:
            cache = {key: _case_operands(pair, n, bs, d, seed=5)}
        algo, ops, srcs = cache[key]
        nb = ops["rowptr"].shape[0] - 1
        if fr == "all":
            dirty = torch.ones(nb, dtype=torch.int32, device="cuda")
        else:
            mask = np.zeros(n, bool)
            mask[srcs] = True
            dirty = torch.as_tensor(frontier_blocks(mask, n, bs)).cuda()
        k_out = _run_pair(K.gs_multisweep, algo, ops, bs, sweeps, dirty)
        p_out = _run_pair(K.gs_multisweep_plain, algo, ops, bs, sweeps, dirty)
        ok, err = _compare(pair, k_out, p_out)
        n_cases += 1
        case = {"pair": pair, "n": n, "bs": bs, "d": d, "sweeps": sweeps,
                "frontier": fr, "ok": ok, "max_abs_err": err,
                "active_kernel": k_out[2][:, 0].tolist()}
        RECORD["cases"].append(case)
        if not ok:
            failures.append(case)
            log(f"[kernels] MISMATCH {case}")
    # run-to-run determinism of the plus_times fold order
    algo, ops, _ = _case_operands("plus_times", 311, 64, 64, seed=5)
    nb = ops["rowptr"].shape[0] - 1
    ones = torch.ones(nb, dtype=torch.int32, device="cuda")
    a = _run_pair(K.gs_multisweep, algo, ops, 64, 16, ones)
    b = _run_pair(K.gs_multisweep, algo, ops, 64, 16, ones)
    determ = all(torch.equal(u, v) for u, v in zip(a, b))
    line = {"kernels": [{"name": "gs_multisweep", "cases": n_cases,
                         "ok": not failures and determ,
                         "deterministic": determ}]}
    log(f"[kernels] {json.dumps(line)} ({time.perf_counter() - t0:.1f} s)")
    if failures or not determ:
        raise AssertionError(f"kernel disagrees with its plain version: "
                             f"{len(failures)} case(s), deterministic={determ}")
    return line


# ---------------------------------------------------------------------------
# main path at full size
# ---------------------------------------------------------------------------

N_FULL = 100_000
BS = 64
D = 64
SWEEPS_PER_CALL = 8


def _solve_timed(algo, rank, backend: str, label: str) -> dict:
    from repro_torch import solve
    from repro_torch.kernels import gs_sweep as K

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    K.reset_launches()
    t0 = time.perf_counter()
    res = solve(algo, engine="async_block", backend=backend, bs=BS, rank=rank,
                sweeps_per_call=SWEEPS_PER_CALL if backend == "kernel" else 1,
                max_iters=2000, device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    row = {
        "label": label, "backend": backend, "rounds": int(res.rounds),
        "converged": bool(res.converged), "wall_s": wall,
        "ms_per_sweep": 1e3 * wall / max(1, res.rounds),
        "launches": K.launches,
        "max_memory_allocated": int(torch.cuda.max_memory_allocated()),
    }
    log(f"[main] {json.dumps(row)}")
    if not np.isfinite(res.x).all() and algo.semiring.reduce == "sum":
        raise AssertionError(f"{label}: non-finite state")
    if backend == "kernel" and K.launches <= 0:
        raise AssertionError(f"{label}: the kernel path launched no kernel")
    if not res.converged:
        raise AssertionError(f"{label}: did not converge in {res.rounds} rounds")
    RECORD["phases"][label] = row
    return {"res": res, "row": row}


def _tile_count(g, rank, bs: int) -> int:
    nb = (g.n + bs - 1) // bs
    key = (rank[g.dst].astype(np.int64) // bs) * nb + rank[g.src] // bs
    return int(np.unique(key).size)


def _time_cuda(fn, reps: int) -> float:
    fn()  # warm-up
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _kernel_entry(algo, bs: int) -> dict:
    """Time one all-dirty sweep of the kernel and of its plain version at the
    main path's shape and hold the two against each other (bitwise for the
    lattice pairs; plus_times within rtol 1e-4 and an atol of 1e-7 of the
    largest value); check that the kernel gives the same bits twice; bound
    it from this shape's bytes and operations."""
    from repro_torch.kernels import gs_sweep as K
    from repro_torch.kernels.ops import pack_algorithm

    ops = pack_algorithm(algo, bs, device="cuda")
    nb = ops["rowptr"].shape[0] - 1
    nnz = int(ops["tiles"].shape[0])
    npad, d = ops["x0"].shape
    ones = torch.ones(nb, dtype=torch.int32, device="cuda")
    x = ops["x0"].clone()

    def kern():
        x.copy_(ops["x0"])
        return K.gs_multisweep(
            ops["rowptr"], ops["tilecols"], ops["revptr"], ops["revrows"], ones,
            ops["tiles"], ops["c"], ops["x0"], ops["fixed"], x,
            semiring=ops["semiring"], combine=ops["combine"],
            res_kind=algo.residual, bs=bs, sweeps=1, eps=-1.0,
        )

    ms = _time_cuda(kern, reps=3)
    k_out = [t.clone() for t in kern()]
    determ = all(torch.equal(u, v) for u, v in zip(k_out, kern()))
    xp = ops["x0"].clone()

    def plain():
        xp.copy_(ops["x0"])
        return K.gs_multisweep_plain(
            ops["rowptr"], ops["tilecols"], ops["revptr"], ops["revrows"], ones,
            ops["tiles"], ops["c"], ops["x0"], ops["fixed"], xp,
            semiring=ops["semiring"], combine=ops["combine"],
            res_kind=algo.residual, bs=bs, sweeps=1, eps=-1.0,
        )

    plain_ms = _time_cuda(plain, reps=1)
    p_out = plain()
    torch.cuda.synchronize()
    xk, dk, ak, rk = k_out
    xp, dp, ap, rp = p_out
    err = float((xk - xp).abs().max())
    if ops["semiring"] == "plus_times":
        agree = (torch.allclose(xk, xp, atol=1e-7 * float(xp.abs().max()), rtol=1e-4)
                 and torch.allclose(dk, dp, atol=1e-7 * float(dp.abs().max()), rtol=1e-4))
    else:
        agree = torch.equal(xk, xp) and torch.equal(dk, dp)
    agree = agree and torch.equal(ak, ap) and torch.equal(rk, rp)
    # each input read once, each output written once
    nbytes = (nnz * bs * bs * 4 + 5 * npad * d * 4
              + (2 * (nb + 1) + 2 * nnz + 2 * nb) * 4 + d * 4 + 4)
    nops = 2 * nnz * bs * bs * d
    t_bytes = 1e3 * nbytes / HBM_BYTES_PER_S
    rate = F32_FMA_OPS_PER_S if ops["semiring"] == "plus_times" else F32_NON_FMA_OPS_PER_S
    t_ops = 1e3 * nops / rate
    # every tile's gathered source block counted as its own read
    gather_bytes = nnz * bs * d * 4
    entry = {
        "name": f"gs_multisweep[{ops['semiring']}]",
        "route": "cuda",
        "source": "src/repro_torch/csrc/gs_sweep.cu",
        "replaces": "src/repro/kernels/gs_sweep.py:304",
        "launches": 0,
        "max_abs_err": err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": None,
    }
    tag = f"time_{ops['semiring']}"
    RECORD["phases"][tag] = {
        **entry, "nnz": nnz, "nb": nb, "d": d, "bytes": nbytes, "ops": nops,
        "ops_per_s": rate, "agrees_with_plain": agree, "deterministic": determ,
        "bytes_with_gathers": nbytes + gather_bytes,
        "bound_ms_with_gathers": max(1e3 * (nbytes + gather_bytes) / HBM_BYTES_PER_S, t_ops),
    }
    log(f"[time] {json.dumps(RECORD['phases'][tag])}")
    if not (agree and determ):
        raise AssertionError(f"{entry['name']} at the main path's shape: agrees with "
                             f"its plain version {agree}, deterministic {determ}, "
                             f"max abs err {err}")
    del ops, x, xp, xk, k_out, p_out
    torch.cuda.empty_cache()
    return entry


def phase_main() -> list[dict]:
    from repro_torch.core.gograph import gograph_order
    from repro_torch.core.metric import block_fresh_fraction, positive_edge_fraction
    from repro_torch.engine import algorithms as A
    from repro_torch.graphs import generators as gen

    t0 = time.perf_counter()
    g = gen.scrambled(gen.powerlaw_cluster(N_FULL, 6, p=0.5, seed=1), seed=11)
    t_gen = time.perf_counter() - t0
    t0 = time.perf_counter()
    rank = gograph_order(g)
    t_order = time.perf_counter() - t0
    ident = np.arange(g.n)
    nnz_go = _tile_count(g, rank, BS)
    nnz_id = _tile_count(g, ident, BS)
    graph = {"n": g.n, "edges": g.m, "bs": BS, "nnz_tiles_gograph": nnz_go,
             "tile_gb_gograph": nnz_go * BS * BS * 4 / 1e9,
             "nnz_tiles_identity": nnz_id,
             "tile_gb_identity": nnz_id * BS * BS * 4 / 1e9,
             "generate_s": t_gen, "gograph_s": t_order,
             "m_over_e_gograph": positive_edge_fraction(g, rank),
             "m_over_e_identity": positive_edge_fraction(g, ident),
             "block_fresh_gograph": block_fresh_fraction(g, rank, BS)["fresh"],
             "block_fresh_identity": block_fresh_fraction(g, ident, BS)["fresh"]}
    log(f"[main] graph {json.dumps(graph)}")
    RECORD["phases"]["graph"] = graph

    rng = np.random.default_rng(0)
    seeds = rng.choice(g.n, size=D, replace=False)
    sources = rng.choice(g.n, size=D, replace=False)
    gw = gen.with_random_weights(g, lo=0.1, hi=1.0)
    ppr = A.personalized_pagerank(g, seeds=seeds)
    sssp = A.multi_source_sssp(gw, sources=sources)

    # the main path through the kernel; counts read right after each run
    k_ppr = _solve_timed(ppr, rank, "kernel", "ppr_gograph_kernel")
    k_sssp = _solve_timed(sssp, rank, "kernel", "sssp_gograph_kernel")
    launches = {"plus_times": k_ppr["row"]["launches"],
                "min_plus": k_sssp["row"]["launches"]}

    # correctness at full size: the same path with the plain version in the
    # kernel's place, held to the kernel's tolerance ...
    p_ppr = _solve_plain_path(ppr, rank)
    a, b = k_ppr["res"], p_ppr
    atol = 1e-7 * float(np.abs(b.x).max())
    nonzero = np.abs(b.x[b.x != 0])
    plain_check = {
        "rounds": [int(a.rounds), int(b.rounds)],
        "col_rounds_equal": bool(np.array_equal(a.col_rounds, b.col_rounds)),
        "max_abs_err": float(np.abs(a.x - b.x).max()),
        "max_rel_err": float((np.abs(a.x - b.x) / np.maximum(np.abs(b.x), atol)).max()),
        "atol": atol, "median_nonzero": float(np.median(nonzero)),
        "min_nonzero": float(nonzero.min()),
    }
    plain_check["ok"] = bool(
        a.rounds == b.rounds and plain_check["col_rounds_equal"]
        and np.allclose(a.x, b.x, rtol=1e-4, atol=atol))
    log(f"[main] ppr kernel vs plain version on the same path {json.dumps(plain_check)}")
    RECORD["phases"]["ppr_plain_path"] = plain_check
    if not plain_check["ok"]:
        raise AssertionError(f"PPR through the kernel and through its plain version "
                             f"disagree: {plain_check}")
    del p_ppr

    # ... and the torch-ops backend on the card, an independent code path
    # that freezes columns after every sweep where the kernel path runs
    # batches of 8: the two agree to the solve's own precision (eps 1e-6)
    t_ppr = _solve_timed(ppr, rank, "torch", "ppr_gograph_torch")
    t_sssp = _solve_timed(sssp, rank, "torch", "sssp_gograph_torch")
    a, b = k_sssp["res"], t_sssp["res"]
    sssp_same = (np.array_equal(a.x, b.x) and a.rounds == b.rounds
                 and np.array_equal(a.col_rounds, b.col_rounds))
    a, b = k_ppr["res"], t_ppr["res"]
    ppr_err = float(np.abs(a.x - b.x).max())
    ppr_ok = ppr_err <= 1e-5 and abs(a.rounds - b.rounds) <= 1
    check = {"sssp_bitwise": sssp_same, "ppr_max_abs_err": ppr_err,
             "ppr_rounds": [k_ppr["row"]["rounds"], t_ppr["row"]["rounds"]],
             "ppr_ok": ppr_ok}
    log(f"[main] kernel vs torch backend {json.dumps(check)}")
    RECORD["phases"]["agreement"] = check
    if not (sssp_same and ppr_ok):
        raise AssertionError(f"kernel and torch backends disagree: {check}")
    del t_ppr, t_sssp

    # the paper's result on the port: rounds under GoGraph's order against
    # the default (scrambled) order. The batch of 64 PPR queries is printed;
    # the asserted comparison is the paper's own workload, global PageRank.
    k_id = _solve_timed(ppr, None, "kernel", "ppr_identity_kernel")
    s_id = _solve_timed(sssp, None, "kernel", "sssp_identity_kernel")
    pr = A.make_pagerank(g)
    pr_go = _solve_timed(pr, rank, "kernel", "pagerank_gograph_kernel")
    pr_id = _solve_timed(pr, None, "kernel", "pagerank_identity_kernel")
    paper = {"ppr64_rounds_gograph": k_ppr["row"]["rounds"],
             "ppr64_rounds_identity": k_id["row"]["rounds"],
             "sssp64_rounds_gograph": k_sssp["row"]["rounds"],
             "sssp64_rounds_identity": s_id["row"]["rounds"],
             "pagerank_rounds_gograph": pr_go["row"]["rounds"],
             "pagerank_rounds_identity": pr_id["row"]["rounds"]}
    log(f"[main] paper's result {json.dumps(paper)}")
    RECORD["phases"]["paper"] = paper
    if not paper["pagerank_rounds_gograph"] < paper["pagerank_rounds_identity"]:
        raise AssertionError(f"GoGraph did not cut PageRank's rounds: {paper}")
    del k_ppr, k_id, k_sssp, s_id, pr_go, pr_id

    # the kernel's time at the main path's shape, beside plain and bound
    entries = []
    for algo, sem in ((ppr.relabel(rank), "plus_times"), (sssp.relabel(rank), "min_plus")):
        e = _kernel_entry(algo, BS)
        e["launches"] = launches[sem]
        entries.append(e)
    _fixed_cost(g.n, seeds)
    return entries


def _solve_plain_path(algo, rank):
    """The main path (`solve`, backend "kernel") with the kernel's plain
    version in the kernel's place: the same operands on the card, frontier,
    early-out and batches of sweeps, so only the f32 summation order
    differs."""
    from repro_torch import solve
    from repro_torch.kernels import gs_sweep as K

    kernel = K.gs_multisweep
    K.gs_multisweep = K.gs_multisweep_plain
    try:
        t0 = time.perf_counter()
        res = solve(algo, engine="async_block", backend="kernel", bs=BS, rank=rank,
                    sweeps_per_call=SWEEPS_PER_CALL, max_iters=2000, device="cuda")
        torch.cuda.synchronize()
    finally:
        K.gs_multisweep = kernel
    log(f"[main] ppr through the plain version: {res.rounds} rounds, "
        f"{time.perf_counter() - t0:.1f} s")
    return res


def _fixed_cost(n: int, seeds) -> None:
    """The kernel's cost per updated block that does not depend on tiles:
    one all-dirty sweep over a graph with no edges at the main path's n, bs
    and d (grid barriers, the partial fold and the bookkeeping only)."""
    from repro_torch.engine import algorithms as A
    from repro_torch.graphs.graph import Graph
    from repro_torch.kernels import gs_sweep as K
    from repro_torch.kernels.ops import pack_algorithm

    empty = Graph(n, np.zeros(0, np.int32), np.zeros(0, np.int32))
    ops = pack_algorithm(A.personalized_pagerank(empty, seeds=seeds), BS, device="cuda")
    nb = ops["rowptr"].shape[0] - 1
    ones = torch.ones(nb, dtype=torch.int32, device="cuda")
    x = ops["x0"].clone()
    ms = _time_cuda(lambda: K.gs_multisweep(
        ops["rowptr"], ops["tilecols"], ops["revptr"], ops["revrows"], ones,
        ops["tiles"], ops["c"], ops["x0"], ops["fixed"], x,
        semiring="plus_times", combine="replace", bs=BS, sweeps=1, eps=-1.0), reps=3)
    row = {"nb": nb, "ms_per_sweep": ms, "us_per_block": 1e3 * ms / nb}
    log(f"[time] no-tile sweep {json.dumps(row)}")
    RECORD["phases"]["time_no_tiles"] = row


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    t0 = time.perf_counter()
    _, kind = phase_env()
    phase_build()
    phase_kernels()
    if "--only-kernels" in sys.argv[1:]:
        return 0
    entries = phase_main()
    out_dir = os.path.join(ROOT, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    RECORD["seconds"] = time.perf_counter() - t0
    with open(os.path.join(out_dir, "chip_smoke.json"), "w") as f:
        json.dump(RECORD, f, indent=1)
    log(f"[done] {RECORD['seconds']:.1f} s")
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
