"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``).

Run from the root of a checkout on a machine with one NVIDIA H100:

    python3 chip_smoke.py

It builds the three CUDA kernels from ``src/repro_torch/csrc`` (one ``nvcc``
each, all at once, into ``build/repro_torch/``), holds every instantiation's
ptxas report to its declared Hopper budget (``repro_torch.kernels.budgets``:
registers, static shared bytes, no spills; a missing report fails) and
holds each kernel against its plain PyTorch version on small cases, each kernel run twice for the same
bits; the push kernel also on rounds built to stress its wave schedule (a
star hub, self-loops, parallel edges, one slot, waves at the slot cap,
vertices pushed twice), the BSR product's tensor-core path also at bs and
d of 64 and 128 with every column chunk giving the same bits, an empty
row-block, a row of more tiles than its ring has stages and states spread
over 1e-4 .. 1e4. Then it drives the port's paths over a 100,000-vertex
graph:

* the main path — GoGraph order, then ``solve(engine="async_block",
  backend="kernel")`` on a batch of 64 personalized-PageRank queries and 64
  SSSP queries — checked against the same path through the sweep kernel's
  plain version, against the torch-ops backend, and for the paper's result
  (fewer PageRank rounds under GoGraph than under the default order); at
  its shape one sweep of the kernel is held against its plain version,
  repeated bit for bit and timed beside its plain version and its bound;
* the serving path — ``GraphServer(backend="kernel", sweeps_per_call=8,
  transfer_guard="disallow")`` on the weighted graph under GoGraph, 128
  one-seed PPR and 64 one-source SSSP tickets arriving in three waves, a
  10-edge reweighting delta landing warm mid-run and absorbed by push on
  both families; tickets resolved before the delta held against solo runs,
  tickets across it against cold solves on the new graph, one resubmitted
  query against the cache's rule; then the priority engine and the push
  engine's torch round, each run twice for the same bits;
* the distributed engine — ``solve(engine="distributed")`` at bs 256 on one
  NCCL rank (a 1-D "cuda" ``DeviceMesh``), the d = 64 PPR and SSSP batches
  bitwise equal to the torch-ops ``async_block`` backend, global PageRank
  under both orders and three supersteps under ``torch.profiler``; the same
  cases on four gloo rank processes sharing the card (this script, started
  as ``--dist-rank k DIR``), held to the one-rank states and to each other;
  and the serving run above on ``GraphServer(backend="distributed")``;
* the push path — ``solve(engine="auto")`` routing the d = 64 PPR batch and
  a one-seed PPR query to the push engine and global PageRank to the sweep
  kernel; ``run_incremental`` absorbing two graph deltas into the converged
  d = 64 SSSP state, by push, by the warm sweep path and cold, all bitwise
  equal; the push and sweep paths once more under
  ``transfer_guard="disallow"``; one push round of the PPR solve, captured
  at full size, and the first round of the reweight-10 absorption, held
  against the push kernel's plain version and timed, with their waves and
  the time of their schedule;
* the BSR product's entry point ``repro_torch.kernels.bsr_spmm`` on the PPR
  (plus_times) and SSSP (min_plus) operands at full size, held against its
  plain version and timed beside ``torch.sparse.mm`` on the same BSR tiles
  and on the same matrix in CSR form;
* the paper's experiments: Fig. 8 (the sync engine, torch ops, default
  order, against the sweep kernel under the default order and GoGraph, on
  global PageRank and the d = 64 PPR and SSSP batches; the sync states held
  to the kernel's), Fig. 5/6 (global PageRank through the kernel under each
  of the eight orders of ``core.baselines.all_reorderers``) and the
  priority-scheduled block engine on global PageRank and the SSSP batch;
* the LM serving paths (``phase_lm``; no kernel of their own: the
  reference computes them in ``jnp``) — the reduced configurations of every
  family (dense, MoE, recurrent, encoder-decoder) in f32 held to the CPU, a
  full-width cut of each (gemma3-4b 6 layers, qwen2-moe 1, recurrentgemma
  3, xlstm 2, whisper-tiny whole) in f32 held to the CPU, then gemma3-4b,
  qwen2-moe-a2.7b, recurrentgemma-2b and xlstm-350m at full width and
  depth in bf16 and whisper-tiny whole, serving batches of 4 prompts and
  32 greedy decode steps through ``build_model``, ``prefill`` and
  ``decode_step``, each step held to ``forward`` (the MoE's on a run at
  capacity 16, where nothing drops), bf16 held to f32 weights, with
  ``[lm]`` lines of prefill seconds, decode ms a step, tokens/s, peak
  memory, the MoE's dropped share and their bounds.

Any failure raises and exits non-zero. The second-to-last line of standard
output is the kernels' JSON record, the last line the device JSON. Detailed
per-case results go to ``chiprun_out/chip_smoke.json``. With no CUDA device
it exits non-zero before printing any result. ``--only-kernels`` stops after
the kernel-vs-plain phase; ``--only-lm`` runs the environment phase and the
LM phase only.
"""
from __future__ import annotations

import dataclasses
import gc
import importlib
import itertools
import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

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
TF32_OPS_PER_S = 495e12  # tensor cores, dense

# where every tensor of the run lives (the card; a rehearsal on the CPU may
# point it elsewhere)
DEVICE = "cuda"

PAIRS = [
    ("plus_times", "replace"),
    ("min_plus", "min_old"),
    ("max_min", "max_old"),
    ("max_times", "max_old"),
]
RECORD: dict = {"cases": [], "phases": {}}
KERNELS = ("gs_sweep", "push_scatter", "bsr_spmm")


def log(*a) -> None:
    print(*a, flush=True)


def kmod(name: str):
    """A kernel module of the port (``repro_torch.kernels`` exports the
    entry points ``bsr_spmm`` and ``gs_sweep`` under the modules' names)."""
    return importlib.import_module(f"repro_torch.kernels.{name}")


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
    """One nvcc per kernel source, all started together; each source's
    ptxas report held to `repro_torch.kernels.budgets` (a missing report
    fails)."""
    from repro_torch.kernels import _build, budgets

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(KERNELS)) as pool:
        list(pool.map(_build.load, KERNELS))
    RECORD["build"] = {}
    problems = []
    for name in KERNELS:
        info = _build.BUILD_INFO[name]
        log(f"[build] {name}.cu for sm_90a: {info['seconds']:.1f} s nvcc -> {info['path']}")
        for line in sorted({ln.strip() for ln in info["ptxas"].splitlines()
                            if "registers" in ln or "spill" in ln}):
            log(f"[build] {line}")
        RECORD["build"][name] = {k: info[k] for k in ("seconds", "path", "ptxas")}
        problems += budgets.check_ptxas(info["ptxas"], f"{name}.cu")
    log(f"[build] {time.perf_counter() - t0:.1f} s for all kernels")
    # every instantiation against its kernel's declared Hopper budget
    used: dict[str, dict] = {}
    for name in KERNELS:
        for e in budgets.parse_ptxas(_build.BUILD_INFO[name]["ptxas"]):
            u = used.setdefault(e.kernel, {"instantiations": 0, "registers": 0, "smem": 0,
                                           "spill_bytes": 0})
            u["instantiations"] += 1
            u["registers"] = max(u["registers"], e.registers)
            u["smem"] = max(u["smem"], e.smem)
            u["spill_bytes"] = max(u["spill_bytes"], e.spill_stores + e.spill_loads)
    for kernel, b in budgets.KERNEL_BUDGETS.items():
        u = used.get(kernel, {})
        u["budget"] = {"registers": b.registers, "static_smem": b.static_smem,
                       "dynamic_smem": dict(zip((f"bs{p['bs']}_d{p['d']}" for p in budgets.POINTS),
                                                b.dynamic_smem))}
        used[kernel] = u
        log(f"[budget] {kernel} {json.dumps(u)}")
    RECORD["budgets"] = {"kernels": used, "problems": problems}
    if problems:
        raise AssertionError(f"ptxas reports over their Hopper budgets: {problems}")


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
    ops = pack_algorithm(algo, bs, device=DEVICE)
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


def phase_kernels() -> None:
    from repro_torch.graphs.blocked import frontier_blocks

    K = kmod("gs_sweep")
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
            dirty = torch.ones(nb, dtype=torch.int32, device=DEVICE)
        else:
            mask = np.zeros(n, bool)
            mask[srcs] = True
            dirty = torch.as_tensor(frontier_blocks(mask, n, bs)).to(DEVICE)
        k_out = _run_pair(K.gs_multisweep, algo, ops, bs, sweeps, dirty)
        again = _run_pair(K.gs_multisweep, algo, ops, bs, sweeps, dirty)
        p_out = _run_pair(K.gs_multisweep_plain, algo, ops, bs, sweeps, dirty)
        ok, err = _compare(pair, k_out, p_out)
        repeats = all(torch.equal(u, v) for u, v in zip(k_out, again))
        ok = ok and repeats
        n_cases += 1
        case = {"pair": pair, "n": n, "bs": bs, "d": d, "sweeps": sweeps,
                "frontier": fr, "ok": ok, "deterministic": repeats, "max_abs_err": err,
                "active_kernel": k_out[2][:, 0].tolist()}
        RECORD["cases"].append(case)
        if not ok:
            failures.append(case)
            log(f"[kernels] MISMATCH {case}")
    # run-to-run determinism of the plus_times fold order
    algo, ops, _ = _case_operands("plus_times", 311, 64, 64, seed=5)
    nb = ops["rowptr"].shape[0] - 1
    ones = torch.ones(nb, dtype=torch.int32, device=DEVICE)
    a = _run_pair(K.gs_multisweep, algo, ops, 64, 16, ones)
    b = _run_pair(K.gs_multisweep, algo, ops, 64, 16, ones)
    determ = all(torch.equal(u, v) for u, v in zip(a, b))
    line = {"name": "gs_multisweep", "cases": n_cases,
            "ok": not failures and determ, "deterministic": determ}
    log(f"[kernels] {json.dumps(line)} ({time.perf_counter() - t0:.1f} s)")
    if failures or not determ:
        raise AssertionError(f"kernel disagrees with its plain version: "
                             f"{len(failures)} case(s), deterministic={determ}")
    _push_cases()
    _spmm_cases()


PUSH_HUB, PUSH_LOOP, PUSH_DUP = 0, 5, 7


def _push_case(pair: str, n: int, d: int, buckets: int, seed: int) -> dict:
    """Operands of one push round on the card: a graph of n vertices with a
    self-loop, a hub of degree 150 and a duplicated edge; a slot list of
    120 vertices (those three among them) with -1 pads inside and after."""
    from repro_torch.engine.algorithms import BIG
    from repro_torch.graphs import generators as gen
    from repro_torch.graphs.graph import Graph

    g = gen.scrambled(gen.powerlaw_cluster(n, 3, p=0.5, seed=seed), seed=seed + 1)
    rng = np.random.default_rng(seed + 2)
    hub_dst = rng.choice(np.arange(1, n), size=150, replace=False)
    src = np.concatenate([g.src, np.full(150, PUSH_HUB), [PUSH_LOOP, PUSH_DUP, PUSH_DUP]])
    dst = np.concatenate([g.dst, hub_dst, [PUSH_LOOP, 8, 8]])
    w = rng.uniform(0.1, 1.0, size=len(src)).astype(np.float32)
    indptr, nbrs, eid = Graph(n, src.astype(np.int32), dst.astype(np.int32), w).csr()
    fill = {"plus_times": None, "min_plus": BIG}.get(pair, -BIG)
    lo, hi = (0.0, 1.0) if pair != "min_plus" else (0.0, 5.0)
    p = rng.uniform(lo, hi, (n, d))
    r = rng.uniform(-0.1, 0.2, (n, d)) if pair == "plus_times" else rng.uniform(lo, hi, (n, d))
    if fill is not None:
        p[rng.random((n, d)) < 0.3] = fill
        r[rng.random((n, d)) < 0.3] = fill
    ids = rng.choice(np.arange(n), size=120, replace=False)
    ids = np.concatenate([[PUSH_HUB, PUSH_LOOP, PUSH_DUP],
                          ids[~np.isin(ids, [PUSH_HUB, PUSH_LOOP, PUSH_DUP])]])
    rng.shuffle(ids)
    vid = ids.astype(np.int64)
    for pos in rng.choice(len(vid), size=9, replace=False):
        vid = np.insert(vid, pos, -1)
    cap = -(-len(vid) // buckets)
    slots = np.full(buckets * cap, -1, np.int64)
    slots[: len(vid)] = vid
    safe = np.maximum(slots, 0)
    seg_s = np.where(slots >= 0, indptr[safe], 0)
    seg_l = np.where(slots >= 0, indptr[safe + 1] - indptr[safe], 0)

    def i32(a):
        return torch.as_tensor(np.asarray(a, np.int32), device=DEVICE)

    def f32(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=DEVICE)

    return {"vid": i32(slots), "seg_start": i32(seg_s), "seg_len": i32(seg_l),
            "nbrs": i32(nbrs), "ew": f32(w[eid]), "p": f32(p), "r": f32(r),
            "semiring": pair, "buckets": buckets, "cap": cap}


def _push_run(fn, o: dict):
    out = fn(o["vid"], o["seg_start"], o["seg_len"], o["nbrs"], o["ew"],
             o["p"].clone(), o["r"].clone(), semiring=o["semiring"],
             buckets=o["buckets"], cap=o["cap"])
    torch.cuda.synchronize()
    return out


def _push_cases() -> None:
    """push_scatter against its plain version: all four semirings, d in
    {1, 3, 64}, 1 or 4 buckets; p, r, pushed and edges equal, and the
    kernel repeats bit for bit."""
    P = kmod("push_scatter")
    t0 = time.perf_counter()
    failures = []
    n_cases = 0
    for (pair, _), d, buckets in itertools.product(PAIRS, (1, 3, 64), (1, 4)):
        o = _push_case(pair, 311, d, buckets, seed=71)
        k_out = _push_run(P.push_scatter, o)
        again = _push_run(P.push_scatter, o)
        p_out = _push_run(P.push_scatter_plain, o)
        same = all(torch.equal(a, b) for a, b in zip(k_out, p_out))
        determ = all(torch.equal(a, b) for a, b in zip(k_out, again))
        err = max(float((a - b).abs().max()) for a, b in zip(k_out[:2], p_out[:2]))
        case = {"kernel": "push_scatter", "pair": pair, "d": d, "buckets": buckets,
                "ok": same and determ, "deterministic": determ, "max_abs_err": err,
                "pushed": k_out[2][:, 0].tolist(), "edges": k_out[3][:, 0].tolist()}
        RECORD["cases"].append(case)
        n_cases += 1
        if not case["ok"]:
            failures.append(case)
            log(f"[kernels] MISMATCH {case}")
    for (name, o), (pair, _), d in itertools.product(_push_adversarial(), PAIRS, (1, 20, 64)):
        o = {**o, **_push_state(pair, o["n"], d, seed=91), "semiring": pair}
        k_out = _push_run(P.push_scatter, o)
        again = _push_run(P.push_scatter, o)
        p_out = _push_run(P.push_scatter_plain, o)
        same = all(torch.equal(a, b) for a, b in zip(k_out, p_out))
        determ = all(torch.equal(a, b) for a, b in zip(k_out, again))
        nw = int(P.push_waves(o["vid"], o["seg_start"], o["seg_len"], o["nbrs"], o["ew"])[2][0])
        case = {"kernel": "push_scatter", "case": name, "pair": pair, "d": d,
                "ok": same and determ, "deterministic": determ, "waves": nw,
                "max_abs_err": max(float((a - b).abs().max()) for a, b in zip(k_out[:2], p_out[:2]))}
        RECORD["cases"].append(case)
        n_cases += 1
        if not case["ok"]:
            failures.append(case)
            log(f"[kernels] MISMATCH {case}")
    line = {"name": "push_scatter", "cases": n_cases, "ok": not failures}
    log(f"[kernels] {json.dumps(line)} ({time.perf_counter() - t0:.1f} s)")
    if failures:
        raise AssertionError(f"push_scatter disagrees with its plain version or does "
                             f"not repeat: {len(failures)} case(s)")


def _push_state(pair: str, n: int, d: int, seed: int) -> dict:
    """p and r for one round: values in [0, 1] (the sum's residual in
    [-0.1, 0.2]) with 30% of entries at the lattice identity."""
    from repro_torch.engine.algorithms import BIG

    rng = np.random.default_rng(seed)
    p = rng.uniform(0.0, 1.0, (n, d))
    r = rng.uniform(-0.1, 0.2, (n, d)) if pair == "plus_times" else rng.uniform(0.0, 1.0, (n, d))
    if pair != "plus_times":
        fill = BIG if pair == "min_plus" else -BIG
        p[rng.random((n, d)) < 0.3] = fill
        r[rng.random((n, d)) < 0.3] = fill
    return {"p": torch.as_tensor(p.astype(np.float32), device=DEVICE),
            "r": torch.as_tensor(r.astype(np.float32), device=DEVICE)}


def _push_adversarial() -> list[tuple[str, dict]]:
    """Slot lists that stress the wave cut: a star hub whose closed set
    meets every other slot's (and whose 1,999 edges overflow one wave's
    shared-memory stage); self-loops on every vertex; every edge three
    times over; a one-slot round; 1,000 isolated vertices (waves cut at the
    kernel's slot cap); vertices pushed twice in one round; and the hub
    pushed five times, whose segments hold more edges than the graph (every
    slot its own wave, walked in order)."""
    from repro_torch.graphs import generators as gen
    from repro_torch.graphs.graph import Graph

    n = 2000
    rng = np.random.default_rng(81)
    base = gen.scrambled(gen.powerlaw_cluster(n, 3, p=0.5, seed=82), seed=83)

    def build(src, dst, ids, buckets=1):
        w = rng.uniform(0.1, 1.0, size=len(src)).astype(np.float32)
        indptr, nbrs, eid = Graph(n, np.asarray(src, np.int32), np.asarray(dst, np.int32),
                                  w).csr()
        ids = np.asarray(ids, np.int64)
        cap = -(-len(ids) // buckets)
        slots = np.full(buckets * cap, -1, np.int64)
        slots[: len(ids)] = ids
        safe = np.maximum(slots, 0)
        i32 = lambda a: torch.as_tensor(np.asarray(a, np.int32), device=DEVICE)  # noqa: E731
        return {"n": n, "vid": i32(slots), "buckets": buckets, "cap": cap,
                "seg_start": i32(np.where(slots >= 0, indptr[safe], 0)),
                "seg_len": i32(np.where(slots >= 0, indptr[safe + 1] - indptr[safe], 0)),
                "nbrs": i32(nbrs), "ew": torch.as_tensor(w[eid], device=DEVICE)}

    some = rng.choice(np.arange(1, n), size=600, replace=False)
    star_ids = np.insert(some, 300, 0)
    star = build(np.concatenate([base.src, np.zeros(n - 1, np.int32)]),
                 np.concatenate([base.dst, np.arange(1, n)]), star_ids, buckets=4)
    loops = build(np.concatenate([base.src, np.arange(n)]),
                  np.concatenate([base.dst, np.arange(n)]), some)
    para = build(np.tile(base.src, 3), np.tile(base.dst, 3), some)
    one = build(base.src, base.dst, [int(some[0])])
    keep = base.src < 1000  # vertices 1000.. have no out-edges
    isolated = build(base.src[keep], base.dst[keep], np.arange(1000, 2000))
    twice = build(base.src, base.dst, np.concatenate([some[:50], some[:50]]))
    hub5 = build(np.concatenate([base.src, np.zeros(n - 1, np.int32)]),
                 np.concatenate([base.dst, np.arange(1, n)]),
                 np.concatenate([[0] * 5, some[:100]]))
    return [("star_hub", star), ("self_loops", loops), ("parallel_edges", para),
            ("one_slot", one), ("isolated_capped", isolated), ("pushed_twice", twice),
            ("hub_pushed_5x", hub5)]


def _spmm_close(pair: str, got, want) -> bool:
    if pair == "plus_times":
        return torch.allclose(got, want, rtol=1e-5, atol=1e-7 * float(want.abs().max()))
    return torch.equal(got, want)


def _spmm_cases() -> None:
    """bsr_spmm against its plain version: all four semirings, bs in
    {16, 64, 128}, d in {1, 3, 64}, n = 311 with an empty row-block; the
    lattice pairs equal, plus_times within rtol 1e-5 and an atol of 1e-7
    of the largest value; the kernel repeats bit for bit and gives the same
    bits through the entry point's narrowed column chunk."""
    from repro_torch.engine.algorithms import BIG
    from repro_torch.graphs import generators as gen
    from repro_torch.graphs.blocked import pack_bsr_flat
    from repro_torch.graphs.graph import Graph
    from repro_torch.kernels import bsr_spmm as entry
    from repro_torch.kernels.semirings import TILE_FILL

    B = kmod("bsr_spmm")
    t0 = time.perf_counter()
    failures = []
    n_cases = 0
    base = gen.with_random_weights(
        gen.scrambled(gen.powerlaw_cluster(311, 4, p=0.5, seed=51), seed=52),
        lo=0.1, hi=1.0, seed=53)
    for (pair, _), bs, d in itertools.product(PAIRS, (16, 64, 128), (1, 3, 64)):
        keep = (base.dst // bs) != 1  # row-block 1 has no tiles
        g = Graph(base.n, base.src[keep], base.dst[keep], base.w[keep])
        bsr = pack_bsr_flat(g, bs, fill=TILE_FILL[pair], device=DEVICE)
        rng = np.random.default_rng(61 + d)
        x = rng.uniform(0.0, 5.0, (bsr.nb * bs, d))
        if pair in ("min_plus", "max_min"):
            x[rng.random(x.shape) < 0.3] = BIG if pair == "min_plus" else -BIG
        x = torch.as_tensor(x.astype(np.float32), device=DEVICE)
        args = [torch.as_tensor(a, device=DEVICE) for a in (bsr.rowptr, bsr.tilerows, bsr.tilecols)]
        args += [bsr.tiles, x]
        yk = B.bsr_spmm(*args, semiring=pair, bs=bs, dj=d)
        again = B.bsr_spmm(*args, semiring=pair, bs=bs, dj=d)
        narrowed = entry(*args, semiring=pair)
        yp = B.bsr_spmm_plain(*args, semiring=pair, bs=bs, dj=d)
        torch.cuda.synchronize()
        ok = _spmm_close(pair, yk, yp) and torch.equal(yk, again) and torch.equal(yk, narrowed)
        case = {"kernel": "bsr_spmm", "pair": pair, "bs": bs, "d": d, "ok": ok,
                "max_abs_err": float((yk - yp).abs().max())}
        RECORD["cases"].append(case)
        n_cases += 1
        if not ok:
            failures.append(case)
            log(f"[kernels] MISMATCH {case}")
    n_cases += _spmm_tc_cases(failures)
    line = {"name": "bsr_spmm", "cases": n_cases, "ok": not failures}
    log(f"[kernels] {json.dumps(line)} ({time.perf_counter() - t0:.1f} s)")
    if failures:
        raise AssertionError(f"bsr_spmm disagrees with its plain version: "
                             f"{len(failures)} case(s)")


def _spmm_tc_cases(failures: list) -> int:
    """The tensor-core plus_times path (bs and d multiples of 64) against
    the plain version: bs in {64, 128}, d in {64, 128}, every column chunk
    dj in {64, d} giving the same bits, on a graph of 4,000 vertices whose
    row-block 0 holds a tile from every row-block (more tiles than the
    ring has stages, and more than one warp's worth of tile columns) and
    whose row-block 2 holds none, with states spread over 1e-4 .. 1e4 (where
    the 3xTF32 split is weakest) and, once, uniform in [0, 5]."""
    from repro_torch.graphs import generators as gen
    from repro_torch.graphs.blocked import pack_bsr_flat
    from repro_torch.graphs.graph import Graph

    B = kmod("bsr_spmm")
    n = 4000
    base = gen.scrambled(gen.powerlaw_cluster(n, 4, p=0.5, seed=54), seed=55)
    rng = np.random.default_rng(56)
    n_cases = 0
    for bs, d, spread in [(64, 64, True), (64, 128, True), (128, 64, True),
                          (128, 128, True), (64, 64, False)]:
        # one edge into vertex 3 from every row-block; row-block 2 emptied
        hub_src = np.arange(0, n, bs, dtype=np.int32) + 1
        src = np.concatenate([base.src, hub_src])
        dst = np.concatenate([base.dst, np.full(len(hub_src), 3, np.int32)])
        keep = (dst // bs) != 2
        pairs = np.unique(np.stack([src[keep], dst[keep]]), axis=1)
        w = rng.uniform(0.1, 1.0, pairs.shape[1]).astype(np.float32)
        g = Graph(n, pairs[0].astype(np.int32), pairs[1].astype(np.int32), w)
        bsr = pack_bsr_flat(g, bs, fill=0.0, device=DEVICE)
        npad = bsr.nb * bs
        x = (10.0 ** rng.uniform(-4.0, 4.0, (npad, d)) if spread
             else rng.uniform(0.0, 5.0, (npad, d)))
        x = torch.as_tensor(x.astype(np.float32), device=DEVICE)
        args = [torch.as_tensor(a, device=DEVICE) for a in (bsr.rowptr, bsr.tilerows, bsr.tilecols)]
        args += [bsr.tiles, x]
        outs = {dj: B.bsr_spmm(*args, semiring="plus_times", bs=bs, dj=dj)
                for dj in sorted({64, d})}
        again = B.bsr_spmm(*args, semiring="plus_times", bs=bs, dj=64)
        yp = B.bsr_spmm_plain(*args, semiring="plus_times", bs=bs, dj=64)
        torch.cuda.synchronize()
        yk = outs[64]
        row_tiles = np.diff(bsr.rowptr)
        ok = (_spmm_close("plus_times", yk, yp) and torch.equal(yk, again)
              and all(torch.equal(yk, o) for o in outs.values())
              and bool((yk[2 * bs:3 * bs] == 0).all()))
        case = {"kernel": "bsr_spmm", "path": "tensor_core", "pair": "plus_times",
                "bs": bs, "d": d, "dj": sorted(outs), "spread": spread,
                "max_row_tiles": int(row_tiles.max()), "empty_rows": int((row_tiles == 0).sum()),
                "ok": ok, "max_abs_err": float((yk - yp).abs().max()),
                "max_rel_err": float(((yk - yp).abs() / yp.abs().clamp_min(1e-30)).max())}
        RECORD["cases"].append(case)
        log(f"[kernels] {json.dumps(case)}")
        n_cases += 1
        if not ok:
            failures.append(case)
    return n_cases


# ---------------------------------------------------------------------------
# main path at full size
# ---------------------------------------------------------------------------

N_FULL = 100_000
BS = 64
D = 64
SWEEPS_PER_CALL = 8


def _solve_timed(algo, rank, backend: str, label: str) -> dict:
    from repro_torch import solve

    K = kmod("gs_sweep")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    K.reset_launches()
    t0 = time.perf_counter()
    res = solve(algo, engine="async_block", backend=backend, bs=BS, rank=rank,
                sweeps_per_call=SWEEPS_PER_CALL if backend == "kernel" else 1,
                max_iters=2000, device=DEVICE)
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


def _time_cuda(fn, reps: int, reset=None) -> float:
    """Mean ms of ``fn`` on the card after one warm-up call. With ``reset``
    (restores in-place inputs) each call is timed alone, the reset outside
    the events."""
    if reset is not None:
        reset()
    fn()  # warm-up
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    if reset is None:
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / reps
    total = 0.0
    for _ in range(reps):
        reset()
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        total += start.elapsed_time(end)
    return total / reps


def _kernel_entry(algo, bs: int) -> dict:
    """Time one all-dirty sweep of the kernel and of its plain version at the
    main path's shape and hold the two against each other (bitwise for the
    lattice pairs; plus_times within rtol 1e-4 and an atol of 1e-7 of the
    largest value); check that the kernel gives the same bits twice; bound
    it from this shape's bytes and operations."""
    from repro_torch.kernels.ops import pack_algorithm

    K = kmod("gs_sweep")
    ops = pack_algorithm(algo, bs, device=DEVICE)
    nb = ops["rowptr"].shape[0] - 1
    nnz = int(ops["tiles"].shape[0])
    npad, d = ops["x0"].shape
    ones = torch.ones(nb, dtype=torch.int32, device=DEVICE)
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


def phase_main() -> tuple[list[dict], dict]:
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
    ppr_x, sssp_x = k_ppr["res"].x, k_sssp["res"].x  # the push path's references
    pr_x = pr_go["res"].x
    del k_ppr, k_id, k_sssp, s_id, pr_go, pr_id

    # the kernel's time at the main path's shape, beside plain and bound
    entries = []
    for algo, sem in ((ppr.relabel(rank), "plus_times"), (sssp.relabel(rank), "min_plus")):
        e = _kernel_entry(algo, BS)
        e["launches"] = launches[sem]
        entries.append(e)
    _fixed_cost(g.n, seeds)
    ctx = {"g": g, "gw": gw, "rank": rank, "ppr": ppr, "sssp": sssp, "pr": pr,
           "ppr_x": ppr_x, "sssp_x": sssp_x, "pr_x": pr_x, "gograph_s": t_order}
    return entries, ctx


def _solve_plain_path(algo, rank):
    """The main path (`solve`, backend "kernel") with the kernel's plain
    version in the kernel's place: the same operands on the card, frontier,
    early-out and batches of sweeps, so only the f32 summation order
    differs."""
    from repro_torch import solve

    K = kmod("gs_sweep")
    kernel = K.gs_multisweep
    K.gs_multisweep = K.gs_multisweep_plain
    try:
        t0 = time.perf_counter()
        res = solve(algo, engine="async_block", backend="kernel", bs=BS, rank=rank,
                    sweeps_per_call=SWEEPS_PER_CALL, max_iters=2000, device=DEVICE)
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
    from repro_torch.kernels.ops import pack_algorithm

    K = kmod("gs_sweep")
    empty = Graph(n, np.zeros(0, np.int32), np.zeros(0, np.int32))
    ops = pack_algorithm(A.personalized_pagerank(empty, seeds=seeds), BS, device=DEVICE)
    nb = ops["rowptr"].shape[0] - 1
    ones = torch.ones(nb, dtype=torch.int32, device=DEVICE)
    x = ops["x0"].clone()
    ms = _time_cuda(lambda: K.gs_multisweep(
        ops["rowptr"], ops["tilecols"], ops["revptr"], ops["revrows"], ones,
        ops["tiles"], ops["c"], ops["x0"], ops["fixed"], x,
        semiring="plus_times", combine="replace", bs=BS, sweeps=1, eps=-1.0), reps=3)
    row = {"nb": nb, "ms_per_sweep": ms, "us_per_block": 1e3 * ms / nb}
    log(f"[time] no-tile sweep {json.dumps(row)}")
    RECORD["phases"]["time_no_tiles"] = row


# ---------------------------------------------------------------------------
# the serving path: GraphServer over the sweep kernel
# ---------------------------------------------------------------------------

SERVE_PPR = 128
SERVE_SSSP = 64
# arrival waves: tick -> (PPR tickets, SSSP tickets); the PPR tickets
# beyond the family's 64 slots queue and are swapped in as columns resolve
SERVE_WAVES = {0: (64, 24), 1: (32, 20), 2: (32, 20)}
SERVE_PPR_SOLO = 8
SERVE_SSSP_SOLO = 4
# the PPR tickets' eps: at the default 1e-6 every one-seed PPR query on the
# weighted graph converges inside its first batch of 8 rounds, so no PPR
# column is ever in flight between batches, where a delta lands; at 1e-7
# (7 ulps of the largest state, 0.15) they need a few rounds more
SERVE_PPR_EPS = 1e-7


def _reweight10(gw):
    """PERF.md's reweight-10 delta: 10 edges of ``gw`` scaled by 0.9."""
    from repro_torch import GraphDelta

    pick = np.random.default_rng(7).choice(gw.m, 10, replace=False)
    return GraphDelta(rew_src=gw.src[pick], rew_dst=gw.dst[pick],
                      rew_w=(gw.weights[pick] * 0.9).astype(np.float32))


def _kernel_solve(algo, rank):
    """The main path's solve; ``x`` always (n, d)."""
    from repro_torch import solve

    res = solve(algo, engine="async_block", backend="kernel", bs=BS, rank=rank,
                sweeps_per_call=SWEEPS_PER_CALL, max_iters=2000, device=DEVICE)
    res.x = np.asarray(res.x).reshape(algo.n, -1)
    return res


def _serve(gw, rank, delta, *, backend: str, bs: int, sweeps: int):
    """Drive a GraphServer on ``backend`` through the waves, landing
    ``delta`` (warm) once enough SSSP and PPR tickets have resolved for the
    solo checks while both families still hold tickets. Returns the server,
    the tickets, the ids resolved before the delta and the run's timings."""
    from repro_torch.engine import api
    from repro_torch.obs.trace import Tracer
    from repro_torch.serving import GraphServer

    rng = np.random.default_rng(0)
    seeds = rng.choice(gw.n, size=SERVE_PPR, replace=False)
    sources = rng.choice(gw.n, size=SERVE_SSSP, replace=False)
    tracer = Tracer(ring=100_000)
    srv = GraphServer(gw, rank=rank, slots=D, bs=bs, backend=backend,
                      sweeps_per_call=sweeps, rounds_per_batch=8,
                      push_threshold=0.05, transfer_guard="disallow",
                      device=DEVICE, trace=tracer)
    absorb = {"calls": 0, "s": 0.0}
    solve = api.solve

    def timed_solve(*a, **kw):  # the push absorptions inside apply_delta
        t0 = time.perf_counter()
        try:
            return solve(*a, **kw)
        finally:
            absorb["calls"] += 1
            absorb["s"] += time.perf_counter() - t0

    tickets, before, ticks = [], set(), []
    delta_s, delta_tick = None, None
    queue_p, queue_s = list(seeds), list(sources)
    tick = 0
    t0 = time.perf_counter()
    while tick <= max(SERVE_WAVES) or srv.scheduler.total_pending() or srv._busy():
        n_p, n_s = SERVE_WAVES.get(tick, (0, 0))
        for s in queue_p[:n_p]:
            tickets.append(srv.submit("ppr", {"seeds": [int(s)], "eps": SERVE_PPR_EPS}))
        for s in queue_s[:n_s]:
            tickets.append(srv.submit("sssp", {"source": int(s)}))
        queue_p, queue_s = queue_p[n_p:], queue_s[n_s:]
        srv.step()
        tick += 1
        done = {a: sum(t.done and t.algo == a for t in tickets) for a in ("ppr", "sssp")}
        busy = {f.probe.name: len(f.occupied()) for f in srv._families.values()}
        ticks.append({"tick": tick, "resolved": done, "occupied": busy,
                      "queued": srv.scheduler.total_pending()})
        if delta_s is None:
            if (done["sssp"] >= SERVE_SSSP_SOLO and done["ppr"] >= SERVE_PPR_SOLO
                    and min(busy.get("ppr", 0), busy.get("sssp", 0)) > 0):
                before = {t.id for t in tickets if t.done}
                api.solve = timed_solve
                try:
                    t1 = time.perf_counter()
                    srv.apply_delta(delta)
                    torch.cuda.synchronize()
                    delta_s = time.perf_counter() - t1
                finally:
                    api.solve = solve
                delta_tick = tick
        if tick > 200:
            raise AssertionError("the server did not drain in 200 ticks")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if delta_s is None:
        raise AssertionError(f"the delta never found both families in flight: {ticks}")
    timing = {"wall_s": wall, "ticks": tick, "delta_tick": delta_tick,
              "apply_delta_s": delta_s, "push_absorptions": absorb["calls"],
              "push_absorption_s": absorb["s"], "per_tick": ticks, "tracer": tracer}
    return srv, tickets, before, timing


def _serving_checks(ctx: dict, tag: str, solve_one, *, backend: str, bs: int,
                    sweeps: int) -> dict:
    """One serving run on ``backend`` and its checks: ``GraphServer`` on the
    full-size weighted graph under GoGraph, 128 one-seed PPR and 64
    one-source SSSP tickets in three waves, the reweight-10 delta landing
    warm mid-run (push absorption on both families: the PPR tickets carry
    eps 1e-7, see ``SERVE_PPR_EPS``), all under
    ``transfer_guard="disallow"``. Tickets resolved before the delta are
    held against solo runs of ``solve_one`` (SSSP bitwise with equal rounds;
    PPR within atol 1e-5 and a round), tickets in flight across it against
    cold solves on the new graph (SSSP bitwise; PPR within atol 1e-4, rtol
    1e-3), one resubmitted query against the cache's rule. Lines and
    records are tagged ``tag``; returns the run's row."""
    from repro_torch.engine import algorithms as A
    from repro_torch.engine.harness import column_support

    key = tag.replace("-", "_")
    gw, rank = ctx["gw"], ctx["rank"]
    delta = _reweight10(gw)
    gw_new = delta.apply(gw)
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for name in KERNELS:
        kmod(name).reset_launches()
    srv, tickets, before, timing = _serve(gw, rank, delta, backend=backend, bs=bs,
                                          sweeps=sweeps)
    counts = {name: kmod(name).launches for name in KERNELS}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    tracer = timing.pop("tracer")
    summ = srv.stats.summary()
    batches = [sp.duration_s for sp in tracer.find("batch")]
    packs = [sp.duration_s for sp in tracer.find("pack")]
    row = {
        "card": RECORD.get("nvidia_smi"), "tickets": len(tickets),
        "resolved": summ["resolved"], "qps": len(tickets) / timing["wall_s"],
        **timing, "batches": len(batches),
        "ms_per_family_batch": 1e3 * float(np.mean(batches)),
        "rounds_p50": summ["rounds_p50"], "rounds_p99": summ["rounds_p99"],
        "per_family": summ["per_family"],
        "occupancy_mean": summ["occupancy_mean"], "family_builds": len(packs),
        "family_build_s": packs,
        "push_absorption_share": timing["push_absorption_s"] / timing["apply_delta_s"],
        "peak_gb": peak_gb, "launches": counts,
        "resolved_before_delta": len(before), "backend": backend, "bs": bs,
        "sweeps_per_call": sweeps,
    }
    log(f"[{tag}] {json.dumps(row)}")
    RECORD["phases"][key] = row
    bad = [t for t in tickets if t.status != "done" or not t.converged]
    # the kernel backend sweeps through gs_sweep; the others launch no kernel
    kernel_ok = counts["gs_sweep"] > 0 if backend == "kernel" else not any(counts.values())
    if bad or not kernel_ok or timing["push_absorptions"] <= 0:
        raise AssertionError(f"{tag}: {len(bad)} tickets unresolved or unconverged "
                             f"(first {bad[:1]}), launches {counts}, push absorptions "
                             f"{timing['push_absorptions']}")

    # 1. tickets resolved before the delta against solo runs on the old graph
    sssp_pre = [t for t in tickets if t.algo == "sssp" and t.id in before]
    ppr_pre = [t for t in tickets if t.algo == "ppr" and t.id in before]
    sources = [t.params["source"] for t in sssp_pre]
    batch = solve_one(A.multi_source_sssp(gw, sources=sources), rank)
    sssp_ok = all(np.array_equal(t.result, batch.x[:, j]) and t.rounds == batch.col_rounds[j]
                  for j, t in enumerate(sssp_pre))
    solo_rows = []
    for t in sssp_pre[:SERVE_SSSP_SOLO]:
        solo = solve_one(A.make_sssp(gw, source=t.params["source"]), rank)
        solo_rows.append({"algo": "sssp", "rounds": [t.rounds, int(solo.rounds)],
                          "ok": bool(np.array_equal(t.result, solo.x[:, 0])
                                     and t.rounds == solo.rounds)})
    for t in ppr_pre[:SERVE_PPR_SOLO]:
        solo = solve_one(A.personalized_pagerank(gw, **t.params), rank)
        err = float(np.abs(t.result - solo.x[:, 0]).max())
        solo_rows.append({"algo": "ppr", "rounds": [t.rounds, int(solo.rounds)],
                          "max_abs_err": err,
                          "ok": bool(err <= 1e-5 and abs(t.rounds - solo.rounds) <= 1)})
    pre = {"sssp_tickets": len(sssp_pre), "sssp_vs_batch_bitwise": bool(sssp_ok),
           "ppr_tickets": len(ppr_pre), "solo": solo_rows}
    log(f"[{tag}] resolved before the delta, against solo runs {json.dumps(pre)}")
    RECORD["phases"][f"{key}_before_delta"] = pre
    if not (sssp_ok and len(ppr_pre) >= SERVE_PPR_SOLO and len(sssp_pre) >= SERVE_SSSP_SOLO
            and all(r["ok"] for r in solo_rows)):
        raise AssertionError(f"{tag}: tickets resolved before the delta differ from "
                             f"solo runs: {pre}")
    del batch

    # 2. tickets in flight across the delta (or arriving after it) against
    # cold solves on the new graph
    sssp_post = [t for t in tickets if t.algo == "sssp" and t.id not in before]
    ppr_post = [t for t in tickets if t.algo == "ppr" and t.id not in before]
    cold = solve_one(A.multi_source_sssp(
        gw_new, sources=[t.params["source"] for t in sssp_post]), rank)
    sssp_new_ok = all(np.array_equal(t.result, cold.x[:, j]) for j, t in enumerate(sssp_post))
    ppr_err, ppr_new_ok = 0.0, True
    for lo in range(0, len(ppr_post), D):
        part = ppr_post[lo:lo + D]
        cold_p = solve_one(A.personalized_pagerank(
            gw_new, seeds=[t.params["seeds"][0] for t in part], eps=SERVE_PPR_EPS), rank)
        for j, t in enumerate(part):
            ppr_err = max(ppr_err, float(np.abs(t.result - cold_p.x[:, j]).max()))
            ppr_new_ok &= bool(np.allclose(t.result, cold_p.x[:, j], atol=1e-4, rtol=1e-3))
    post = {"sssp_tickets": len(sssp_post), "sssp_bitwise": bool(sssp_new_ok),
            "ppr_tickets": len(ppr_post), "ppr_max_abs_err": ppr_err,
            "ppr_ok": ppr_new_ok}
    log(f"[{tag}] in flight across the delta, against cold solves {json.dumps(post)}")
    RECORD["phases"][f"{key}_after_delta"] = post
    if not (sssp_new_ok and ppr_new_ok and sssp_post and ppr_post):
        raise AssertionError(f"{tag}: tickets across the delta differ from cold "
                             f"solves: {post}")

    # the cache after the delta: an SSSP query resolved before it is a miss
    # if its support meets the delta's blocks, else a hit
    t0 = sssp_pre[0]
    q0 = A.make_sssp(gw, source=t0.params["source"])
    support = column_support(q0.x0[:, 0], q0.c[:, 0], q0.fixed[:, 0], reduce="min",
                             c_fill=q0.c_pad_fill, x=t0.result)
    meets = bool(set(np.nonzero(support)[0] // bs) & set(delta.touched_vertices() // bs))
    again = srv.submit("sssp", dict(t0.params))
    hit = again.status == "cached"
    srv.run()
    resub = {"source": int(t0.params["source"]), "support_meets_delta": meets,
             "cache": "hit" if hit else "miss",
             "equals_cold": bool(np.array_equal(again.result, solve_one(
                 A.make_sssp(gw_new, source=t0.params["source"]), rank).x[:, 0]))}
    log(f"[{tag}] resubmitted SSSP query after the delta: cache {resub['cache']} "
        f"{json.dumps(resub)}")
    RECORD["phases"][f"{key}_resubmit"] = resub
    if hit == meets or not resub["equals_cold"]:
        raise AssertionError(f"{tag}: the resubmitted query {resub}")
    del srv, tickets, cold
    torch.cuda.empty_cache()
    return row


def phase_serving(ctx: dict) -> None:
    """The serving path over the sweep kernel: ``GraphServer(backend=
    "kernel", sweeps_per_call=8)`` through `_serving_checks`. Then the two
    engines whose sums were moved off atomics run twice each for the same
    bits: the priority engine on the SSSP batch (eps 0) and the push
    engine's torch round on the PPR batch."""
    import dataclasses

    from repro_torch import solve
    from repro_torch.engine.incremental import dense_residual
    from repro_torch.engine.priority import run_priority_block

    t_phase = time.perf_counter()
    _serving_checks(ctx, "serving", _kernel_solve, backend="kernel", bs=BS,
                    sweeps=SWEEPS_PER_CALL)

    # the priority engine's sums on the card: two runs, the same bits
    sssp0 = dataclasses.replace(ctx["sssp"], eps=0.0)
    runs = [run_priority_block(sssp0, bs=PRIORITY_BS, select_frac=PRIORITY_FRAC,
                               device=DEVICE) for _ in range(2)]
    prio = {"equivalent_sweeps": [r.rounds for r in runs],
            "bitwise": bool(runs[0].rounds == runs[1].rounds
                            and runs[0].x.tobytes() == runs[1].x.tobytes()),
            "equals_kernel": bool(np.array_equal(runs[0].x, ctx["sssp_x"]))}
    # the push engine's torch round on the card: two runs, the same bits
    ppr = ctx["ppr"]
    pushes, push_s = [], []
    for _ in range(2):
        res, wall, c = _counted(lambda: solve(ppr, engine="push", backend="torch",
                                              max_iters=2000, device=DEVICE))
        pushes.append(res)
        push_s.append(wall)
    resid = [float(np.abs(dense_residual(ppr, r.x)).max()) for r in pushes]
    push = {"rounds": [int(r.rounds) for r in pushes], "wall_s": push_s,
            "bitwise": bool(pushes[0].rounds == pushes[1].rounds
                            and pushes[0].x.tobytes() == pushes[1].x.tobytes()),
            "max_residual": resid, "residual_bound": 2 * ppr.eps, "launches": c}
    repeat = {"priority_sssp64_eps0": prio, "push_torch_ppr64": push}
    log(f"[serving] repeated runs on the card {json.dumps(repeat)}")
    RECORD["phases"]["repeat_bitwise"] = repeat
    if not (prio["bitwise"] and prio["equals_kernel"] and push["bitwise"]
            and max(resid) <= 2 * ppr.eps and all(r.converged for r in pushes)):
        raise AssertionError(f"repeated runs differ or miss their bound: {repeat}")
    RECORD["phases"]["serving"]["phase_s"] = time.perf_counter() - t_phase
    log(f"[serving] phase {RECORD['phases']['serving']['phase_s']:.1f} s")


# ---------------------------------------------------------------------------
# the distributed engine: one NCCL rank, four gloo ranks on the one card,
# and the serving path over it
# ---------------------------------------------------------------------------

DIST_BS = 256      # run_distributed's default block size
DIST_RANKS = 4
DIST_TIMEOUT_S = 120   # a rank that leaves the loop early fails the run
DIST_CASES = ("sssp64", "ppr64", "pagerank_gograph", "pagerank_identity")


def _scratch() -> str:
    """``build/`` of the checkout, for the rank processes' stores and
    instances (the checkout is the only place the script writes)."""
    path = os.path.join(ROOT, "build")
    os.makedirs(path, exist_ok=True)
    return path


def _save_instance(path: str, algo) -> None:
    """An instance's arrays and scalars in one npz, for a rank process."""
    from repro_torch.interop import algo_fields

    f = algo_fields(algo)
    meta = {k: f[k] for k in ("name", "n", "combine", "residual", "eps",
                              "monotone_dir", "semiring")}
    np.savez(path, **{k: f[k] for k in ("src", "dst", "w", "x0", "c", "fixed")},
             meta=json.dumps(meta))


def _load_instance(path: str):
    from repro_torch.interop import algo_from_arrays

    z = np.load(path)
    fields = {k: z[k] for k in ("src", "dst", "w", "x0", "c", "fixed")}
    return algo_from_arrays({**fields, **json.loads(str(z["meta"]))})


def _dist_solve(algo, rank, mesh=None):
    """One solve through the distributed engine at run_distributed's block
    size, ``x`` always (n, d); ``mesh=None`` runs on the default process
    group's world."""
    from repro_torch import solve

    res = solve(algo, engine="distributed", mesh=mesh, bs=DIST_BS, rank=rank,
                max_iters=2000, device=DEVICE)
    res.x = np.asarray(res.x).reshape(algo.n, -1)
    return res


def _timed(fn) -> tuple:
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res = fn()
    torch.cuda.synchronize()
    return res, time.perf_counter() - t0, torch.cuda.max_memory_allocated() / 1e9


def _profile_supersteps(algo, label: str, steps: int = 3) -> dict:
    """Where a superstep's time goes: ``steps`` supersteps of ``algo`` (one
    rank of the default process group, `DistContext.run`) under
    ``torch.profiler`` after one warm-up superstep: wall ms per superstep,
    the device's busy ms (kernel time summed over ops) and idle share, and
    the ops that take the most host and device time."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.engine import harness
    from repro_torch.engine.distributed import DistContext

    dc = DistContext(algo, DIST_BS, device=DEVICE)
    ops = [harness.to_device(a, DEVICE) for a in (dc.x0, dc.c, dc.fixed)]
    dc.run(ops[0].clone(), *ops, max_iters=1)  # warm-up
    torch.cuda.synchronize()
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if DEVICE == "cuda" else [])
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        dc.run(ops[0].clone(), *ops, max_iters=steps)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    from torch.autograd import DeviceType

    rows = prof.key_averages()

    def dev_us(e):
        return getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0.0))

    # the device's own events (kernels, copies); a host op's device time
    # repeats its kernels' and is not summed again
    kernels = [e for e in rows if e.device_type == DeviceType.CUDA]
    host_ops = [e for e in rows if e.device_type == DeviceType.CPU]
    busy_ms = sum(dev_us(e) for e in kernels) / 1e3
    top = sorted(kernels, key=dev_us, reverse=True)[:6]
    host = sorted(host_ops, key=lambda e: e.self_cpu_time_total, reverse=True)[:6]
    out = {
        "label": label, "supersteps": steps, "blocks": dc.nb,
        "wall_ms_per_superstep": 1e3 * wall / steps,
        "device_busy_ms_per_superstep": busy_ms / steps,
        "device_idle_share": 1.0 - busy_ms / (1e3 * wall),
        "launches_per_superstep": sum(e.count for e in kernels) / steps,
        "top_device_ops": [{"op": e.key[:96], "calls": e.count,
                            "ms_per_superstep": dev_us(e) / 1e3 / steps} for e in top],
        "top_host_ops": [{"op": e.key, "calls": e.count,
                          "self_host_ms_per_superstep": e.self_cpu_time_total / 1e3 / steps}
                         for e in host],
    }
    log(f"[distributed] superstep profile {json.dumps(out)}")
    RECORD["phases"][f"profile_{label}"] = out
    return out


def dist_rank_main(rank: int, tmp: str) -> int:
    """One of DIST_RANKS rank processes on the one card over gloo: every
    instance of DIST_CASES (relabeled already) through
    ``solve(engine="distributed")`` on a 1-D mesh of "cuda" devices; the
    states, rounds and times into ``rank<k>.npz``."""
    import datetime

    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch import solve

    torch.cuda.set_device(0)  # every rank on the one card
    dist.init_process_group(
        "gloo", store=dist.FileStore(os.path.join(tmp, "store"), DIST_RANKS),
        rank=rank, world_size=DIST_RANKS,
        timeout=datetime.timedelta(seconds=DIST_TIMEOUT_S))
    try:
        mesh = init_device_mesh(DEVICE, (DIST_RANKS,), mesh_dim_names=("data",))
        out = {}
        for label in DIST_CASES:
            algo = _load_instance(os.path.join(tmp, f"{label}.npz"))
            dist.barrier()
            res, wall, peak = _timed(lambda: solve(
                algo, engine="distributed", mesh=mesh, bs=DIST_BS, max_iters=2000,
                device=DEVICE))
            out.update({f"{label}.x": np.asarray(res.x), f"{label}.rounds": res.rounds,
                        f"{label}.col_rounds": res.col_rounds,
                        f"{label}.converged": res.converged, f"{label}.wall_s": wall,
                        f"{label}.peak_gb": peak})
        np.savez(os.path.join(tmp, f"rank{rank}.npz"), **out)
    finally:
        dist.destroy_process_group()
    return 0


def _four_ranks(instances: dict) -> list[dict]:
    """Run DIST_CASES on DIST_RANKS gloo rank processes sharing the card;
    every rank's outputs."""
    import tempfile

    with tempfile.TemporaryDirectory(dir=_scratch()) as tmp:
        for label, algo in instances.items():
            _save_instance(os.path.join(tmp, f"{label}.npz"), algo)
        procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--dist-rank", str(k), tmp],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            for k in range(DIST_RANKS)]
        try:
            outs = [p.communicate(timeout=900) for p in procs]
        finally:
            for p in procs:
                p.kill()
                p.wait()
        for k, (p, (_, err)) in enumerate(zip(procs, outs)):
            if p.returncode != 0:
                raise AssertionError(f"gloo rank {k} exited {p.returncode}:\n{err[-4000:]}")
        return [dict(np.load(os.path.join(tmp, f"rank{k}.npz"))) for k in range(DIST_RANKS)]


def phase_distributed(ctx: dict) -> None:
    """The distributed engine on the main path's graph under GoGraph, d = 64,
    bs 256 (run_distributed's default).

    * One NCCL rank (``init_process_group("nccl", world_size=1)`` through a
      FileStore, a 1-D "cuda" mesh): the PPR and SSSP batches through
      ``solve(engine="distributed", mesh=...)``, each bitwise equal to
      ``solve(engine="async_block", backend="torch", bs=256)`` in state,
      rounds and per-column rounds; global PageRank under GoGraph and the
      default order; three supersteps of each batch under
      ``torch.profiler`` (`_profile_supersteps`).
    * Four gloo ranks on the one card (spawned processes; NCCL refuses two
      ranks on one device): SSSP bitwise equal to the one-rank state with
      rounds in [one-rank rounds, 3x + 5] (the reference's bound); PPR within
      atol 1e-4, rtol 1e-3 of the one-rank state (both stop within eps of
      the fixpoint, by other paths); every rank bitwise equal to rank 0;
      global PageRank's rounds under GoGraph and the default order, recorded.
    * Serving over the distributed backend on the one-rank world:
      `_serving_checks` with ``GraphServer(backend="distributed", bs=256,
      sweeps_per_call=1)``.
    """
    import datetime
    import tempfile

    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch import solve

    t_phase = time.perf_counter()
    rank = ctx["rank"]
    cases = {"sssp64": ctx["sssp"], "ppr64": ctx["ppr"]}
    for name in KERNELS:
        kmod(name).reset_launches()
    torch.cuda.empty_cache()
    torch.cuda.set_device(0)
    store_dir = tempfile.TemporaryDirectory(dir=_scratch())
    # NCCL on the card (a CPU rehearsal has only gloo)
    dist.init_process_group(
        "nccl" if DEVICE == "cuda" else "gloo",
        store=dist.FileStore(os.path.join(store_dir.name, "store"), 1), rank=0,
        world_size=1, timeout=datetime.timedelta(seconds=DIST_TIMEOUT_S))
    try:
        mesh = init_device_mesh(DEVICE, (1,), mesh_dim_names=("data",))
        one = {}
        for label, algo in cases.items():
            res, wall, peak = _timed(lambda: _dist_solve(algo, rank, mesh))
            ref, ref_wall, _ = _timed(lambda: solve(
                algo, engine="async_block", backend="torch", bs=DIST_BS, rank=rank,
                max_iters=2000, device=DEVICE))
            same = bool(np.array_equal(res.x, np.asarray(ref.x).reshape(res.x.shape))
                        and res.rounds == ref.rounds
                        and np.array_equal(res.col_rounds, ref.col_rounds))
            row = {"label": f"{label}_1rank_nccl", "rounds": int(res.rounds),
                   "converged": bool(res.converged), "wall_s": wall,
                   "ms_per_superstep": 1e3 * wall / max(1, res.rounds), "peak_gb": peak,
                   "async_block_torch": {"rounds": int(ref.rounds), "wall_s": ref_wall},
                   "bitwise_equal_async_block_torch": same}
            log(f"[distributed] {json.dumps(row)}")
            RECORD["phases"][row["label"]] = row
            if not (same and res.converged):
                raise AssertionError(f"one NCCL rank against the torch backend: {row}")
            one[label] = res
        pr_rows = {}
        for order, r in (("gograph", rank), ("identity", None)):
            res, wall, _ = _timed(lambda: _dist_solve(ctx["pr"], r, mesh))
            pr_rows[order] = {"rounds": int(res.rounds), "wall_s": wall,
                              "ms_per_superstep": 1e3 * wall / max(1, res.rounds)}
            if not res.converged:
                raise AssertionError(f"PageRank {order} on one rank did not converge")
        log(f"[distributed] pagerank, one NCCL rank {json.dumps(pr_rows)}")
        for label in ("ppr64", "sssp64"):
            _profile_supersteps(cases[label].relabel(rank), label)

        # four gloo ranks on the one card
        t0 = time.perf_counter()
        ranks = _four_ranks({"sssp64": ctx["sssp"].relabel(rank),
                             "ppr64": ctx["ppr"].relabel(rank),
                             "pagerank_gograph": ctx["pr"].relabel(rank),
                             "pagerank_identity": ctx["pr"]})
        four_s = time.perf_counter() - t0
        r0 = ranks[0]
        agree = all(sorted(rk) == sorted(r0) and all(np.array_equal(rk[k], r0[k]) for k in r0
                                                     if not k.endswith(("wall_s", "peak_gb")))
                    for rk in ranks[1:])
        sssp4 = r0["sssp64.x"].reshape(ctx["g"].n, -1)[rank]
        ppr4 = r0["ppr64.x"].reshape(ctx["g"].n, -1)[rank]
        r1 = {k: int(one[k].rounds) for k in one}
        r4 = {k: int(r0[f"{k}.rounds"]) for k in DIST_CASES}
        four = {
            "ranks": DIST_RANKS, "backend": "gloo", "seconds_with_spawn": four_s,
            "rounds": r4, "rounds_one_rank": {**r1, "pagerank_gograph": pr_rows["gograph"]["rounds"],
                                              "pagerank_identity": pr_rows["identity"]["rounds"]},
            "wall_s": {k: float(r0[f"{k}.wall_s"]) for k in DIST_CASES},
            "ms_per_superstep": {k: 1e3 * float(r0[f"{k}.wall_s"]) / max(1, r4[k])
                                 for k in DIST_CASES},
            "peak_gb_rank0": {k: float(r0[f"{k}.peak_gb"]) for k in DIST_CASES},
            "converged": {k: bool(r0[f"{k}.converged"]) for k in DIST_CASES},
            "every_rank_equals_rank0": agree,
            "sssp_bitwise_one_rank": bool(np.array_equal(sssp4, one["sssp64"].x)),
            "sssp_rounds_in_bound": r1["sssp64"] <= r4["sssp64"] <= 3 * r1["sssp64"] + 5,
            "ppr_max_abs_diff_one_rank": float(np.abs(ppr4 - one["ppr64"].x).max()),
            "ppr_close_one_rank": bool(np.allclose(ppr4, one["ppr64"].x, atol=1e-4,
                                                   rtol=1e-3)),
        }
        log(f"[distributed] four gloo ranks on one card {json.dumps(four)}")
        RECORD["phases"]["distributed_4rank_gloo"] = four
        RECORD["phases"]["distributed_pagerank_1rank"] = pr_rows
        if not (agree and all(four["converged"].values()) and four["sssp_bitwise_one_rank"]
                and four["sssp_rounds_in_bound"] and four["ppr_close_one_rank"]):
            raise AssertionError(f"four gloo ranks: {four}")
        counts = {name: kmod(name).launches for name in KERNELS}
        if any(counts.values()):
            raise AssertionError(f"the distributed engine launched a kernel: {counts}")
        del one, ranks
        torch.cuda.empty_cache()

        # the serving path over the distributed backend, one NCCL rank
        _serving_checks(ctx, "serving-dist", lambda algo, r: _dist_solve(algo, r),
                        backend="distributed", bs=DIST_BS, sweeps=1)
    finally:
        dist.destroy_process_group()
        store_dir.cleanup()
    RECORD["phases"]["distributed_phase_s"] = time.perf_counter() - t_phase
    log(f"[distributed] phase {RECORD['phases']['distributed_phase_s']:.1f} s")


# ---------------------------------------------------------------------------
# push path and the BSR product at full size
# ---------------------------------------------------------------------------

PUSH_CAPTURE_SLOTS = 10_000


def _counted(run):
    """Run ``run()`` with every kernel's launch count set to 0 just before;
    return its result, the wall seconds (ended by a synchronise) and the
    counts read just after."""
    for name in KERNELS:
        kmod(name).reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return res, wall, {name: kmod(name).launches for name in KERNELS}


def _push_row(label: str, res, wall: float, counts: dict, tracer=None, **extra) -> dict:
    """Print and record one run; with a tracer, also the seconds inside
    ``solve`` and inside its set-up (the "pack" span: operands, the push
    engine's initial residual, the kernel round's CSR)."""
    row = {"label": label, "rounds": int(res.rounds), "converged": bool(res.converged),
           "wall_s": wall, "launches": counts, **extra}
    if tracer is not None:
        for name in ("solve", "pack"):
            row[f"{name}_s"] = sum(sp.duration_s for sp in tracer.find(name))
    if res.push_stats is not None:
        row.update({k: res.push_stats[k] for k in ("pushed", "edges", "touched",
                                                    "touched_fraction")})
    log(f"[push] {json.dumps(row)}")
    RECORD["phases"][label] = row
    if not res.converged:
        raise AssertionError(f"{label}: did not converge in {res.rounds} rounds")
    return row


def phase_push(ctx: dict) -> list[dict]:
    from repro_torch import GraphDelta, estimate_frontier_fraction, run_incremental, solve
    from repro_torch.engine import algorithms as A
    from repro_torch.graphs.delta import random_delta
    from repro_torch.obs.trace import Tracer

    g, gw, rank = ctx["g"], ctx["gw"], ctx["rank"]
    ppr, sssp = ctx["ppr"], ctx["sssp"]
    P = kmod("push_scatter")

    # a. the router on the main graph: arms push / push / sweep
    probes = [("auto_ppr64", ppr, "push"),
              ("auto_ppr1", A.personalized_pagerank(g, seeds=[5]), "push"),
              ("auto_pagerank", A.make_pagerank(g), "sweep")]
    capture: dict = {}
    kernel = P.push_scatter

    def capturing(vid, seg_start, seg_len, nbrs, ew, p, r, **kw):
        # one round of the d = 64 PPR push solve with enough slots, taken
        # before the kernel updates p and r in place
        if not capture and int((vid >= 0).sum()) >= PUSH_CAPTURE_SLOTS:
            capture.update(vid=vid.clone(), seg_start=seg_start.clone(),
                           seg_len=seg_len.clone(), nbrs=nbrs, ew=ew,
                           p=p.clone(), r=r.clone(), **kw)
        return kernel(vid, seg_start, seg_len, nbrs, ew, p, r, **kw)

    results = {}
    push_launches = 0
    for label, algo, arm in probes:
        est = estimate_frontier_fraction(algo)
        P.push_scatter = capturing if label == "auto_ppr64" else kernel
        tr = Tracer()
        try:
            res, wall, counts = _counted(lambda: solve(
                algo, engine="auto", backend="kernel", bs=BS, rank=rank,
                sweeps_per_call=SWEEPS_PER_CALL, max_iters=2000, device=DEVICE,
                trace=tr))
        finally:
            P.push_scatter = kernel
        routed = "push" if res.push_stats is not None else "sweep"
        _push_row(label, res, wall, counts, tr, estimate=est, routed=routed, expected=arm)
        ran = counts["push_scatter"] if arm == "push" else counts["gs_sweep"]
        if routed != arm or ran <= 0:
            raise AssertionError(f"{label}: routed to {routed} with launches {counts}, "
                                 f"expected the {arm} arm to launch its kernel")
        if label == "auto_ppr64":
            push_launches = counts["push_scatter"]
        results[label] = res
    # the push engine's contract for a sum semiring: its state solves the
    # fixpoint equation to eps (residual c + W x - x in f64 on the host; 2 eps
    # leaves room for the f32 drift of the incrementally kept residual). Its
    # distance to the sweep's state is printed beside the reference's test
    # tolerance (20 eps, rtol 1e-5), which the reference's own push engine
    # exceeds on graphs of this kind (tests/test_torch_push.py).
    from repro_torch.engine.incremental import dense_residual

    a, b = results["auto_ppr64"].x, ctx["ppr_x"]
    agree = {"max_residual": float(np.abs(dense_residual(ppr, a)).max()),
             "residual_bound": 2 * ppr.eps,
             "max_abs_diff_vs_sweep": float(np.abs(a - b).max()),
             "within_20eps_rtol_1e-5_of_sweep": bool(
                 np.allclose(a, b, atol=20 * ppr.eps, rtol=1e-5))}
    agree["ok"] = agree["max_residual"] <= agree["residual_bound"]
    log(f"[push] ppr64 push residual and distance to async_block kernel {json.dumps(agree)}")
    RECORD["phases"]["push_vs_sweep_ppr64"] = agree
    if not agree["ok"]:
        raise AssertionError(f"the push solve of the PPR batch is no fixpoint: {agree}")

    # the push path under the transfer guard: the same bits
    guarded, wall, counts = _counted(lambda: solve(
        probes[1][1], engine="auto", backend="kernel", bs=BS, rank=rank,
        sweeps_per_call=SWEEPS_PER_CALL, device=DEVICE, transfer_guard="disallow"))
    _push_row("auto_ppr1_guarded", guarded, wall, counts)
    if guarded.x.tobytes() != results["auto_ppr1"].x.tobytes():
        raise AssertionError("transfer_guard='disallow' changed the push result")

    # b. delta absorption into the converged d = 64 SSSP state
    rng = np.random.default_rng(7)
    pick = rng.choice(gw.m, 10, replace=False)
    rew = GraphDelta(rew_src=gw.src[pick], rew_dst=gw.dst[pick],
                     rew_w=(gw.weights[pick] * 0.9).astype(np.float32))
    # 1,000 inserted edges, w ~ U[0.1, 1]; random_delta re-rolls self-loops
    # and existing pairs: the flat-BSR tiles keep one weight per (src, dst)
    # pair, so a parallel edge would part the sweep path from the push path
    ins = random_delta(gw, frac_add=1000 / gw.m, w_lo=0.1, w_hi=1.0, seed=8)
    assert len(ins.add_src) == 1000
    prior = ctx["sssp_x"]
    delta_round: dict = {}

    def capture_first(into):
        def run(vid, seg_start, seg_len, nbrs, ew, p, r, **kw):
            if not into:
                into.update(vid=vid.clone(), seg_start=seg_start.clone(),
                            seg_len=seg_len.clone(), nbrs=nbrs, ew=ew,
                            p=p.clone(), r=r.clone(), **kw)
            return kernel(vid, seg_start, seg_len, nbrs, ew, p, r, **kw)
        return run

    for label, delta in (("delta_reweight10", rew), ("delta_insert1000", ins)):
        new = A.remake(sssp, delta.apply(gw))
        trs = [Tracer() for _ in range(3)]
        if label == "delta_reweight10":
            P.push_scatter = capture_first(delta_round)
        try:
            rp, wp, cp = _counted(lambda: run_incremental(
                new, sssp, prior, engine="push", backend="kernel", device=DEVICE,
                trace=trs[0]))
        finally:
            P.push_scatter = kernel
        _push_row(f"{label}_push", rp, wp, cp, trs[0])
        rw, ww, cw = _counted(lambda: run_incremental(
            new, sssp, prior, engine="async_block", backend="kernel", bs=BS,
            sweeps_per_call=SWEEPS_PER_CALL, rank=rank, device=DEVICE, trace=trs[1]))
        _push_row(f"{label}_warm_block", rw, ww, cw, trs[1])
        rc, wc, cc = _counted(lambda: solve(
            new, engine="async_block", backend="kernel", bs=BS, rank=rank,
            sweeps_per_call=SWEEPS_PER_CALL, device=DEVICE, transfer_guard="disallow",
            trace=trs[2]))
        _push_row(f"{label}_cold_guarded", rc, wc, cc, trs[2])
        if label == "delta_reweight10":
            cp_reweight = cp["push_scatter"]
        same = (rp.x.tobytes() == rc.x.tobytes() and rw.x.tobytes() == rc.x.tobytes())
        if not same or cp["push_scatter"] <= 0 or cw["gs_sweep"] <= 0:
            raise AssertionError(f"{label}: push, warm block and cold differ "
                                 f"(bitwise {same}) or a kernel did not launch")
    del results, guarded

    # c. one captured push round at full size, and the reweight-10 delta's
    # first round, against the plain version
    entries = [_push_entry(capture, push_launches)]
    _push_entry(delta_round, cp_reweight, tag="time_push_scatter_delta_reweight10")
    # d. the BSR product's entry point at full size
    ppr_rel = ppr.relabel(rank)
    sssp_rel = sssp.relabel(rank)
    from repro_torch.engine.harness import permute_state

    entries.append(_spmm_entry(ppr_rel, permute_state(ctx["ppr_x"], rank)))
    entries.append(_spmm_entry(sssp_rel, permute_state(ctx["sssp_x"], rank)))
    return entries


def _push_entry(capture: dict, launches: int, tag: str = "time_push_scatter") -> dict:
    """The captured round: kernel against plain version (p, r, pushed and
    edges equal), the kernel twice bit for bit, times and bound, and the
    round's waves and the time of its schedule (`push_waves`: the torch ops
    and the wave cut, included in the round's time)."""
    if not capture:
        raise AssertionError(f"{tag}: no push round was captured")
    P = kmod("push_scatter")
    o = capture
    p, r = o["p"].clone(), o["r"].clone()

    def reset():
        p.copy_(o["p"])
        r.copy_(o["r"])

    def call(fn):
        return fn(o["vid"], o["seg_start"], o["seg_len"], o["nbrs"], o["ew"], p, r,
                  semiring=o["semiring"], buckets=o["buckets"], cap=o["cap"])

    reset()
    k_out = [t.clone() for t in call(P.push_scatter)]
    reset()
    again = [t.clone() for t in call(P.push_scatter)]
    reset()
    t0 = time.perf_counter()
    p_out = [t.clone() for t in call(P.push_scatter_plain)]
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    same = all(torch.equal(a, b) for a, b in zip(k_out, p_out))
    determ = all(torch.equal(a, b) for a, b in zip(k_out, again))
    err = max(float((a - b).abs().max()) for a, b in zip(k_out[:2], p_out[:2]))
    ms = _time_cuda(lambda: call(P.push_scatter), reps=5, reset=reset)
    sched_args = (o["vid"], o["seg_start"], o["seg_len"], o["nbrs"], o["ew"])
    waves = int(P.push_waves(*sched_args)[2][0])
    schedule_ms = _time_cuda(lambda: P.push_waves(*sched_args), reps=5)
    plain_ms = _time_cuda(lambda: call(P.push_scatter_plain), reps=1, reset=reset)
    n, d = p.shape
    slots = int((o["vid"] >= 0).sum())
    edges = int(o["seg_len"].sum())
    nbytes = slots * 4 * d * 4 + edges * (8 + 2 * d * 4)
    nops = (2 * edges + slots) * d
    t_bytes = 1e3 * nbytes / HBM_BYTES_PER_S
    t_ops = 1e3 * nops / F32_NON_FMA_OPS_PER_S
    entry = {
        "name": "push_scatter", "route": "cuda",
        "source": "src/repro_torch/csrc/push_scatter.cu",
        "replaces": "src/repro/kernels/push_scatter.py:180",
        "launches": launches, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": None,
    }
    RECORD["phases"][tag] = {
        **entry, "slots": slots, "buckets": o["buckets"], "cap": o["cap"], "edges": edges,
        "n": n, "d": d, "bytes": nbytes, "ops": nops, "agrees_with_plain": same,
        "deterministic": determ, "plain_first_call_s": plain_s,
        "waves": waves, "mean_slots_per_wave": slots / max(1, waves),
        "schedule_ms": schedule_ms,
    }
    log(f"[push] {tag}: {waves} waves per round, {slots / max(1, waves):.2f} slots "
        f"per wave, schedule {schedule_ms:.4f} ms of the round's {ms:.4f} ms")
    log(f"[time] {json.dumps(RECORD['phases'][tag])}")
    if not (same and determ):
        raise AssertionError(f"{tag}: equal to its plain version "
                             f"{same}, deterministic {determ}, max abs err {err}")
    return entry


def _spmm_entry(algo, x_rel: np.ndarray) -> dict:
    """One synchronous round through ``repro_torch.kernels.bsr_spmm`` at the
    main path's shape (bs 64, the converged state as input): launched once
    through the entry point with the counts at 0, then held against the
    plain version, repeated bit for bit, timed beside its plain version, its
    bound and, for plus_times, ``torch.sparse.mm`` on the same BSR tiles and
    on the same matrix in CSR form (``library_ms`` is the faster of the
    two)."""
    from repro_torch.graphs.blocked import pad_state
    from repro_torch.kernels import bsr_spmm as entry_point
    from repro_torch.kernels.ops import pack_algorithm

    B = kmod("bsr_spmm")
    ops = pack_algorithm(algo, BS, device=DEVICE)
    sem = ops["semiring"]
    x = torch.as_tensor(pad_state(np.asarray(x_rel, np.float32), BS,
                                  fill=algo.semiring.identity), device=DEVICE)
    args = (ops["rowptr"], ops["tilerows"], ops["tilecols"], ops["tiles"], x)
    y, _, counts = _counted(lambda: entry_point(*args, semiring=sem))
    launches = counts["bsr_spmm"]
    npad, d = x.shape
    dj = min(d, 64)
    yk = B.bsr_spmm(*args, semiring=sem, bs=BS, dj=dj)
    again = B.bsr_spmm(*args, semiring=sem, bs=BS, dj=dj)
    yp = B.bsr_spmm_plain(*args, semiring=sem, bs=BS, dj=dj)
    torch.cuda.synchronize()
    agree = _spmm_close(sem, yk, yp)
    determ = torch.equal(yk, again) and torch.equal(yk, y)
    err = float((yk - yp).abs().max())
    ms = _time_cuda(lambda: B.bsr_spmm(*args, semiring=sem, bs=BS, dj=dj), reps=3)
    plain_ms = _time_cuda(lambda: B.bsr_spmm_plain(*args, semiring=sem, bs=BS, dj=dj), reps=1)
    library_ms, library = None, {}
    if sem == "plus_times":
        # the same product as one library call, on the BSR tiles and on the
        # matrix in CSR form (one entry per edge: y[dst] += w * x[src]),
        # each built once outside the timing
        a = torch.sparse_bsr_tensor(ops["rowptr"], ops["tilecols"], ops["tiles"],
                                    size=(npad, npad), check_invariants=False)
        csr = torch.sparse_coo_tensor(
            torch.as_tensor(np.stack([algo.dst, algo.src]).astype(np.int64), device=DEVICE),
            torch.as_tensor(np.asarray(algo.w, np.float32), device=DEVICE),
            size=(npad, npad)).coalesce().to_sparse_csr()
        for fmt, mat in (("bsr", a), ("csr", csr)):
            library[f"library_{fmt}_ms"] = _time_cuda(
                lambda m=mat: torch.sparse.mm(m, x), reps=3)
            library[f"library_{fmt}_max_abs_err"] = float(
                (torch.sparse.mm(mat, x) - yk).abs().max())
        library["library_csr_nnz"] = int(csr.values().numel())
        library_ms = min(library["library_bsr_ms"], library["library_csr_ms"])
        del a, csr
    nb = ops["rowptr"].shape[0] - 1
    nnz = int(ops["tiles"].shape[0])
    nbytes = nnz * BS * BS * 4 + 2 * npad * d * 4 + (nb + 1 + nnz) * 4
    nops = 2 * nnz * BS * BS * d
    t_bytes = 1e3 * nbytes / HBM_BYTES_PER_S
    # plus_times runs in 3xTF32 on the tensor cores: three products each;
    # the lattice pairs run two non-FMA instructions per element
    if sem == "plus_times":
        run_ops, rate = 3 * nops, TF32_OPS_PER_S
    else:
        run_ops, rate = nops, F32_NON_FMA_OPS_PER_S
    t_ops = 1e3 * run_ops / rate
    entry = {
        "name": f"bsr_spmm[{sem}]", "route": "cuda",
        "source": "src/repro_torch/csrc/bsr_spmm.cu",
        "replaces": "src/repro/kernels/bsr_spmm.py:77",
        "launches": launches, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": library_ms,
    }
    tag = f"time_bsr_spmm_{sem}"
    RECORD["phases"][tag] = {**entry, "nnz": nnz, "nb": nb, "d": d, "bytes": nbytes,
                             "ops": nops, "ops_run": run_ops, "ops_per_s": rate,
                             "bound_bytes_ms": t_bytes, "bound_ops_ms": t_ops,
                             "bound_ffma_ms": 1e3 * nops / F32_FMA_OPS_PER_S,
                             "agrees_with_plain": agree,
                             "deterministic": determ, **library}
    log(f"[time] {json.dumps(RECORD['phases'][tag])}")
    if not (agree and determ and launches == 1):
        raise AssertionError(f"{entry['name']} at full size: agrees with its plain "
                             f"version {agree}, deterministic {determ}, entry-point "
                             f"launches {launches}, max abs err {err}")
    del ops, x, y, yk, again, yp
    torch.cuda.empty_cache()
    return entry


# ---------------------------------------------------------------------------
# the paper's experiments on the card: Fig. 8 (sync against async), Fig. 5/6
# (the competitor orders) and the priority engine
# ---------------------------------------------------------------------------

# the priority engine's block size and selected fraction: its own default
# fraction, on blocks of 256 because each block update is a dozen torch
# launches and the run is bound by their number; the one run at
# benchmarks/priority_sched.py's settings (64, 0.125) shows the stop rule
PRIORITY_BS = 256
PRIORITY_FRAC = 0.25


def _paper_row(tag: str, label: str, run, **extra):
    """Run ``run()`` with the launch counts at 0, print and record its row
    (rounds, wall time, ms per round, launches) and require convergence."""
    res, wall, counts = _counted(run)
    rounds = float(res.rounds)
    row = {"label": label, "rounds": rounds, "converged": bool(res.converged),
           "wall_s": wall, "ms_per_round": 1e3 * wall / max(rounds, 1.0),
           "launches": counts, **extra}
    log(f"[{tag}] {json.dumps(row)}")
    RECORD["phases"][label] = row
    if not res.converged:
        raise AssertionError(f"{label}: did not converge ({rounds} rounds)")
    return res, row


def _agree(name: str, got, want) -> dict:
    """Lattice states equal; PageRank-family states within the reference's
    sync-against-async tolerance (atol 1e-4, rtol 1e-3)."""
    got, want = np.asarray(got), np.asarray(want)
    if name.startswith("sssp"):
        ok = bool(np.array_equal(got, want))
    else:
        ok = bool(np.allclose(got, want, atol=1e-4, rtol=1e-3))
    return {"ok": ok, "max_abs_diff": float(np.abs(got - want).max())}


def phase_fig8(ctx: dict) -> None:
    """Paper Fig. 8 on the card: Sync + Default (the sync engine on torch
    ops) against Async + Default and Async + GoGraph (the sweep kernel; the
    main path's runs of the same instances) for global PageRank, the d = 64
    PPR batch and the d = 64 SSSP batch."""
    from repro_torch import solve

    cases = (("pagerank", ctx["pr"], ctx["pr_x"]), ("ppr64", ctx["ppr"], ctx["ppr_x"]),
             ("sssp64", ctx["sssp"], ctx["sssp_x"]))
    summary = {}
    for name, algo, x_async in cases:
        res, row = _paper_row("fig8", f"fig8_{name}_sync_default", lambda: solve(
            algo, engine="sync", max_iters=5000, device=DEVICE))
        if any(row["launches"].values()):
            raise AssertionError(f"the sync engine launched a kernel: {row['launches']}")
        agree = _agree(name, res.x, x_async)
        key = "ppr" if name == "ppr64" else "sssp" if name == "sssp64" else "pagerank"
        a_def = RECORD["phases"][f"{key}_identity_kernel"]
        a_go = RECORD["phases"][f"{key}_gograph_kernel"]
        summary[name] = {
            "sync_default": {"rounds": row["rounds"], "wall_s": row["wall_s"],
                             "ms_per_round": row["ms_per_round"]},
            "async_default": {k: a_def[k] for k in ("rounds", "wall_s", "ms_per_sweep")},
            "async_gograph": {k: a_go[k] for k in ("rounds", "wall_s", "ms_per_sweep")},
            "sync_vs_async_gograph": agree,
        }
        del res
        if not agree["ok"]:
            raise AssertionError(f"fig8 {name}: the sync state disagrees with the "
                                 f"kernel's: {agree}")
    log(f"[fig8] {json.dumps(summary)}")
    RECORD["phases"]["fig8"] = summary


def phase_orders(ctx: dict) -> None:
    """Paper Fig. 5/6 on the card: global PageRank through the sweep kernel
    under each order of ``all_reorderers`` (one order packed at a time,
    freed after): seconds to order, M/|E|, tiles, rounds, ms per sweep."""
    from repro_torch import solve
    from repro_torch.core.baselines import all_reorderers
    from repro_torch.core.metric import positive_edge_fraction

    g, pr = ctx["g"], ctx["pr"]
    rows = {}
    for name, order_fn in all_reorderers(seed=0).items():
        if name == "GoGraph":  # ordered once already by the main path
            rank, order_s = ctx["rank"], ctx["gograph_s"]
        else:
            t0 = time.perf_counter()
            rank = order_fn(g)
            order_s = time.perf_counter() - t0
        extra = {"order": name, "order_s": order_s,
                 "positive_edge_fraction": positive_edge_fraction(g, rank),
                 "tiles": _tile_count(g, rank, BS)}
        res, row = _paper_row("fig5_6", f"fig5_6_pagerank_{name}", lambda: solve(
            pr, engine="async_block", backend="kernel", bs=BS, rank=rank,
            sweeps_per_call=SWEEPS_PER_CALL, max_iters=2000, device=DEVICE), **extra)
        agree = _agree("pagerank", res.x, ctx["pr_x"])
        row["vs_gograph_kernel"] = agree
        rows[name] = {k: row[k] for k in ("rounds", "ms_per_round", "wall_s", "order_s",
                                          "positive_edge_fraction", "tiles")}
        del res
        torch.cuda.empty_cache()
        if row["launches"]["gs_sweep"] <= 0 or not agree["ok"]:
            raise AssertionError(f"fig5_6 {name}: kernel launches {row['launches']}, "
                                 f"state against GoGraph's {agree}")
    log(f"[fig5_6] {json.dumps(rows)}")
    RECORD["phases"]["fig5_6"] = rows


def phase_priority(ctx: dict) -> None:
    """The priority-scheduled block engine on global PageRank and the d = 64
    SSSP batch, under the default order and under GoGraph: equivalent
    sweeps and wall time. PageRank's state lies within the reference's
    priority tolerance (atol 2e-4, rtol 1e-3) of the kernel's. The engine
    stops once a round's total L1 motion and every pending priority are
    <= eps, and SSSP's eps (0.5, a count of changed entries for the other
    engines) lets it stop short of the fixpoint, as the reference's does:
    that run (at benchmarks/priority_sched.py's bs 64, select_frac 0.125)
    is printed with its distance to the kernel's state, and the SSSP runs
    held to the kernel's state bit for bit use eps = 0."""
    import dataclasses

    from repro_torch.engine.priority import run_priority_block

    rank = ctx["rank"]
    sssp_exact = dataclasses.replace(ctx["sssp"], eps=0.0)
    std = (PRIORITY_BS, PRIORITY_FRAC)
    runs = [("pagerank", "default", ctx["pr"], ctx["pr_x"], std),
            ("pagerank", "gograph", ctx["pr"], ctx["pr_x"], std),
            ("sssp64_eps0.5", "default", ctx["sssp"], ctx["sssp_x"], (64, 0.125)),
            ("sssp64", "default", sssp_exact, ctx["sssp_x"], std),
            ("sssp64", "gograph", sssp_exact, ctx["sssp_x"], std)]
    for name, order, algo, x_ref, (bs, frac) in runs:
        inst = algo if order == "default" else algo.relabel(rank)
        res, row = _paper_row("priority", f"priority_{name}_{order}",
                              lambda: run_priority_block(
                                  inst, bs=bs, select_frac=frac, device=DEVICE),
                              bs=bs, select_frac=frac, eps=float(algo.eps))
        x = res.x if order == "default" else np.asarray(res.x)[rank]
        if name == "sssp64":
            ok = bool(np.array_equal(x, x_ref))
        elif name == "pagerank":
            ok = bool(np.allclose(x, x_ref, atol=2e-4, rtol=1e-3))
        else:  # printed, not held: the reference stops at the same state
            ok = True
        row["vs_kernel"] = {"ok": ok, "max_abs_diff": float(np.abs(x - x_ref).max())}
        log(f"[priority] {row['label']}: {row['rounds']:.3f} equivalent sweeps, "
            f"{row['wall_s']:.3f} s, against the kernel {json.dumps(row['vs_kernel'])}")
        del res
        if not ok:
            raise AssertionError(f"priority {name} {order}: state against the "
                                 f"kernel's {row['vs_kernel']}")


# ---------------------------------------------------------------------------
# the LM serving paths
# ---------------------------------------------------------------------------

BF16_DENSE_OPS_PER_S = 989e12  # tensor cores, dense (H100 SXM data sheet)
# reduced configurations held card against CPU: (arch, config overrides)
LM_REDUCED = (("olmo-1b", {}), ("deepseek-7b", {}),
              ("deepseek-7b", {"kv_cache_dtype": "int8"}), ("gemma-7b", {}),
              ("gemma3-4b", {}), ("internvl2-76b", {}), ("qwen2-moe-a2.7b", {}),
              ("granite-moe-1b-a400m", {}), ("recurrentgemma-2b", {}),
              ("xlstm-350m", {}), ("whisper-tiny", {}))
LM_REDUCED_PROMPT = 40    # > kv_chunk 32: attention_chunked; windows of 8 roll; MoE drops
LM_REDUCED_STEPS = 8
LM_REDUCED_FRAMES = 48    # whisper: 40 x 48 > 32^2, the chunked cross-attention
LM_F32_TOL = {"atol": 2e-4, "rtol": 2e-3}  # the tier-1 tests' tolerance
# an int8 cache: a value within float noise of a rounding boundary lands one
# step over on one device (1/127 of its row's largest |K| or |V|), which
# moves the logits by ~1e-3; such steps must stay rare (LM_INT8_STEPS_OFF)
LM_INT8_TOL = {"atol": 1e-2, "rtol": 1e-2}
LM_INT8_STEPS_OFF = 1e-3
LM_WIDE_TOL = {"atol": 1e-3, "rtol": 2e-3}  # full width (sums of 10,240 terms), f32
# (b) full width, f32, card against CPU: arch, layers (0: all), batch,
# prompt, decode steps, encoder frames, seed
LM_WIDE = (
    # past the window of 1,024 and the KV chunk: chunked, rolling caches
    ("gemma3-4b", 6, 2, 1040, 2, 0, 1),
    # two dispatch groups a row; tokens drop at capacity 1.25
    ("qwen2-moe-a2.7b", 1, 2, 2048, 2, 0, 2),
    # rglru, rglru, local; attention_chunked past the KV chunk
    ("recurrentgemma-2b", 3, 2, 1040, 2, 0, 3),
    # mlstm, slstm; 300 is not a multiple of the 256-token mLSTM chunk
    ("xlstm-350m", 2, 2, 300, 2, 0, 4),
    # whole (4 + 4 layers) over 1,500 frames (30 s of audio)
    ("whisper-tiny", 0, 2, 64, 2, 1500, 5),
)
LM_PROFILED_STEPS = 2     # gemma3's serving run's last decode steps, under torch.profiler
LM_MOE_F32 = (4, 512, 8)  # the MoE's f32 decode check: requests, prompt, decode steps
# (c) full width and depth, bf16, weights from a generator seeded 0 on the
# card: the serving run (requests, prompt, decode steps) and what else
# each model runs: a short run held to forward, the decode steps' profile,
# encoder frames and max_seq, and the bf16-against-f32 check's layers (0:
# a copy of the whole model; n: its first n layers)
LM_SERVED = {
    "gemma3-4b": dict(serve=(4, 4096, 32), short=(4, 512, 8), profiled=LM_PROFILED_STEPS),
    # 29.67 GB in bf16: no f32 copy of the whole; decode held to forward at
    # capacity 16 (no drops), as the reference's own decode test
    "qwen2-moe-a2.7b": dict(serve=(4, 4096, 32), short=(4, 512, 8), short_capacity=16.0,
                            hold_serve=False, f32_layers=4, f32_decode=True),
    # 4,128 positions roll the local caches past the window of 2,048
    "recurrentgemma-2b": dict(serve=(4, 4096, 32)),
    "xlstm-350m": dict(serve=(4, 1024, 32)),
    # 30 s of audio, a 448-token text context
    "whisper-tiny": dict(serve=(4, 64, 32), frames=1500, max_seq=448),
}
# bf16: a decode step against forward at its position, element by element
# |step - forward| <= LM_BF16_ATOL + LM_BF16_RTOL * |forward|, and per
# position in norm within LM_BF16_NORM; the prefill's last logits against
# the same weights in f32 within LM_BF16_VS_F32 in norm (the MoE's cut: its
# forward logits at each position both dtypes routed alike)
LM_BF16_ATOL = 0.5
LM_BF16_RTOL = 2.0 ** -6
LM_BF16_NORM = 0.05
LM_BF16_VS_F32 = 0.05
# a bf16 MoE routes a token on near ties: decode and forward, whose hidden
# states differ by bf16 rounding, pick different experts at some positions
# and layers (ties of bf16 router logits broken apart by an ulp), and such
# a position's state parts from there on. The bf16 check holds the
# positions routed alike in every layer to the tolerances above and
# reports the others; it fails if fewer than LM_MOE_ALIKE_MIN of the held
# positions routed alike (12 of 36 over qwen2-moe's 24 layers on the
# H100), or if a position parted where its swapped experts' router
# log-probabilities lay more than LM_MOE_FLIP_GAP apart on either path (a
# wider gap is no rounding tie). The MoE is held to forward at every
# position in f32 at full depth (LM_MOE_F32), whose router logits round
# 2^16 times finer.
LM_MOE_ALIKE_MIN = 0.25
LM_MOE_FLIP_GAP = 2.0 ** -3
# the MoE's bf16-against-f32 cut: the positions whose experts both dtypes
# chose and kept alike in every layer of the cut are held to
# LM_BF16_VS_F32, and they must be at least LM_MOE_CUT_ALIKE_MIN of all
LM_MOE_CUT_ALIKE_MIN = 0.5
# the reference's analytic n_params against the tensors, norm scales
# aside: it leaves out qwen2-moe's shared gates (24 x 2,048), the RG-LRU's
# conv and Lambda (18 x 5 x 2,560) and whisper's frontend_proj (384^2), and
# counts xlstm's sLSTM at a width of 1,365 (not 1,408) with a dense
# recurrence, less the mLSTM's w_if (12 x 2,048 x 8)
LM_ANALYTIC_GAP = {"gemma3-4b": 0, "qwen2-moe-a2.7b": 49_152, "recurrentgemma-2b": 230_400,
                   "xlstm-350m": -13_983_744, "whisper-tiny": 147_456}


def _lm_numpy_tree(cfg, seed: int) -> dict:
    """Weights in the reference's layout from ``default_rng(seed)``: for a
    decoder ``emb``, ``final_norm``, ``cycles[j]`` stacked over cycles and
    ``rem[i]``; for an encoder-decoder ``emb``, ``frontend_proj``,
    ``final_norm`` and ``enc``/``dec`` stacked over their layers. Fan-in
    scaled normals (an expert's or a head's matrix by its own input width),
    norm scales and biases ~ N(0, 0.1^2)."""
    from repro_torch.models.model import abstract_params
    from repro_torch.models.transformer import _layer_plan

    shapes, _ = abstract_params(cfg)
    rng = np.random.default_rng(seed)

    def draw(tree: dict, lead: tuple = (), parent: str = "") -> dict:
        out = {}
        for name, t in tree.items():
            if isinstance(t, dict):
                out[name] = draw(t, lead, name)
                continue
            shape = tuple(t.shape)
            if name in ("scale", "bias"):
                std = 0.1
            elif name == "emb":
                std = shape[1] ** -0.5
            elif name == "r_gates" or (len(shape) == 3 and parent == "moe"):
                std = shape[1] ** -0.5
            else:
                std = shape[0] ** -0.5
            out[name] = (rng.standard_normal(lead + shape) * std).astype(np.float32)
        return out

    top = {k: v for k, v in shapes.items() if not isinstance(v, list)}
    tree = draw(top)
    if cfg.arch_type == "encdec":
        tree["enc"] = draw(shapes["enc"][0], (cfg.enc_layers,))
        tree["dec"] = draw(shapes["dec"][0], (cfg.dec_layers,))
        return tree
    n_cycles, rem = _layer_plan(cfg)
    layers, c = shapes["layers"], len(cfg.pattern)
    tree["cycles"] = [draw(layers[j], (n_cycles,)) for j in range(c)]
    tree["rem"] = [draw(layers[n_cycles * c + i]) for i in range(len(rem))]
    return tree


def _host_copy(caches: list) -> list:
    return [{k: v.to("cpu", copy=True) for k, v in c.items()} for c in caches]


def _lm_run(model, toks: np.ndarray, prompt: int, steps: int, prefix=None, frames=None,
            forward: bool = True) -> dict:
    """``forward`` over the prompt and the next ``steps`` tokens (for an
    encoder-decoder, ``decoder_forward`` over the encoder's output of
    ``frames``), ``prefill`` of the prompt and ``steps`` decode steps fed
    those tokens; every output brought to the host."""
    dev = model.weights.emb.device
    t = torch.from_numpy(toks).to(dev)
    kw = {} if prefix is None else {"prefix_embeds": torch.from_numpy(prefix).to(dev)}
    p0 = prompt + (0 if prefix is None else prefix.shape[1])
    out: dict = {}
    with torch.inference_mode():
        if frames is None:
            logits, caches = model.prefill(t[:, :prompt], p0 + steps, **kw)
            args = ()
        else:
            logits, caches, enc = model.prefill(torch.from_numpy(frames).to(dev),
                                                t[:, :prompt], p0 + steps)
            out["encode"] = enc.cpu()
            args = (enc,)
        if forward:
            out["forward"] = model(t[:, :prompt + steps], *args, **kw)[0].cpu()
        out["prefill"] = logits.cpu()
        out["prefill_caches"] = _host_copy(caches)  # decode writes into caches
        out["decode"] = []
        for i in range(steps):
            pos = torch.full((toks.shape[0],), p0 + i, device=dev)
            lg, caches = model.decode_step(caches, *args, t[:, prompt + i:prompt + i + 1], pos)
            out["decode"].append(lg.cpu())
        out["caches"] = _host_copy(caches)
    return out


def _lm_hold(label: str, card: dict, cpu: dict, tol: dict) -> dict:
    """Every output of two `_lm_run`s: logits, the encoder's output and
    float cache and state entries within ``tol``, slot positions equal,
    int8 K/V within one step (a value on a rounding boundary)."""
    pairs = [("prefill", card["prefill"], cpu["prefill"])]
    pairs += [(f"decode{i}", a, b) for i, (a, b) in enumerate(zip(card["decode"], cpu["decode"]))]
    pairs += [(k, card[k], cpu[k]) for k in ("forward", "encode") if k in card]
    for key in ("prefill_caches", "caches"):
        for i, (ca, cb) in enumerate(zip(card[key], cpu[key])):
            pairs += [(f"{key}[{i}].{n}", ca[n], cb[n]) for n in ca]
    worst, bad, off, n_int8 = 0.0, [], 0, 0
    for what, a, b in pairs:
        if a.shape != b.shape or a.dtype != b.dtype:
            bad.append(what)
            continue
        if a.is_floating_point():
            worst = max(worst, (a.float() - b.float()).abs().max().item())
            ok = torch.allclose(a.float(), b.float(), **tol)
        elif what.endswith("slot_pos"):
            ok = torch.equal(a, b)
        else:
            diff = (a.int() - b.int()).abs()
            off += int((diff > 0).sum())
            n_int8 += diff.numel()
            ok = diff.max().item() <= 1
        if not ok:
            bad.append(what)
    if n_int8 and off > LM_INT8_STEPS_OFF * n_int8:
        bad.append(f"{off} of {n_int8} int8 entries one step over")
    row = {"label": label, "compared": len(pairs), "max_abs_diff": worst, "tol": tol,
           "int8_steps_off": off, "int8_entries": n_int8, "ok": not bad}
    log(f"[lm] card against CPU {json.dumps(row)}")
    if bad:
        raise AssertionError(f"lm {label}: card against CPU out of {tol}: {bad[:8]}")
    return row


def _lm_reduced() -> list:
    """(a) The reduced configurations in f32, card against CPU."""
    from repro_torch.configs import get_reduced
    from repro_torch.interop import lm_params_from_arrays

    rows = []
    for seed, (arch, over) in enumerate(LM_REDUCED):
        cfg = dataclasses.replace(get_reduced(arch), **over)
        tree = _lm_numpy_tree(cfg, seed)
        rng = np.random.default_rng(100 + seed)
        toks = rng.integers(0, cfg.vocab, size=(2, LM_REDUCED_PROMPT + LM_REDUCED_STEPS))
        prefix = (rng.standard_normal((2, cfg.prefix_len, cfg.d_model)).astype(np.float32)
                  if cfg.prefix_len else None)
        frames = (rng.standard_normal((2, LM_REDUCED_FRAMES, cfg.d_model)).astype(np.float32)
                  if cfg.arch_type == "encdec" else None)
        runs = [_lm_run(lm_params_from_arrays(cfg, tree, device=dev), toks,
                        LM_REDUCED_PROMPT, LM_REDUCED_STEPS, prefix, frames)
                for dev in (DEVICE, "cpu")]
        label = arch + ("-int8kv" if over else "")
        rows.append(_lm_hold(label, *runs, LM_INT8_TOL if "kv_cache_dtype" in over else LM_F32_TOL))
    return rows


def _lm_wide(arch: str, layers: int, batch: int, prompt: int, steps: int, frames: int,
             seed: int) -> dict:
    """(b) ``arch`` at full width, cut to ``layers`` layers (0: whole), f32:
    ``batch`` prompts and ``steps`` decode steps on the card and on the
    CPU, the same weights (drawn on the card)."""
    from repro_torch.configs import get_config
    from repro_torch.models.layers import tree_map
    from repro_torch.models.model import Model, build_model

    over = {"dtype": "float32"} | ({"n_layers": layers} if layers else {})
    cfg = dataclasses.replace(get_config(arch), **over)
    card = build_model(cfg, device=DEVICE, generator=torch.Generator(DEVICE).manual_seed(seed))
    host = Model(cfg, device="cpu", params=tree_map(lambda t: t.cpu(), card.params))
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (batch, prompt + steps))
    fr = rng.standard_normal((batch, frames, cfg.d_model)).astype(np.float32) if frames else None
    t0 = time.perf_counter()
    runs = [_lm_run(m, toks, prompt, steps, frames=fr, forward=False) for m in (card, host)]
    what = f"{layers} layers" if layers else "whole"
    row = _lm_hold(f"{arch} full width, {what}, {batch} x {prompt}, f32", *runs, LM_WIDE_TOL)
    row["seconds"] = time.perf_counter() - t0
    del card, host, runs
    torch.cuda.empty_cache()
    return row


def _greedy(step, caches, tok, pos, steps: int, fed: list, logits: list):
    """``steps`` greedy decode steps (``step(caches, tokens1, pos)``) from
    ``tok`` at positions ``pos``, ``pos + 1``, ...: the tokens fed and each
    step's logits appended."""
    for i in range(steps):
        fed.append(tok)
        lg, caches = step(caches, tok[:, None], pos + i)
        logits.append(lg[:, 0])
        tok = lg[:, 0].argmax(-1)
    return caches, tok


def _profiled(fn, steps: int) -> tuple:
    """``fn()`` (``steps`` decode steps) under ``torch.profiler``: wall ms a
    step, the device's busy ms (kernel time summed) and idle share, kernel
    launches a step and the ops that take the most device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if DEVICE == "cuda" else [])
    torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0

    def dev_us(e):
        return getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0.0))

    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy_ms = sum(dev_us(e) for e in kernels) / 1e3
    top = sorted(kernels, key=dev_us, reverse=True)[:5]
    return res, {
        "steps": steps, "wall_ms_per_step": 1e3 * wall / steps,
        "device_busy_ms_per_step": busy_ms / steps,
        "device_idle_share": 1.0 - busy_ms / (1e3 * wall),
        "launches_per_step": sum(e.count for e in kernels) / steps,
        "top_device_ops": [{"op": e.key[:80], "ms_per_step": dev_us(e) / 1e3 / steps}
                           for e in top],
    }


class _RouteLog:
    """While active, keeps each MoE routing's group size, ``keep`` and
    ``gate_idx`` in call order: the route's own tensors, no copy and no
    launch, so a timed window runs as without the log. ``gate_idx`` of a
    call of more than one token a group (a prefill, a forward) is kept only
    with ``tail``, which also copies each of the ``batch`` rows' last
    ``tail`` positions of the router's probabilities (one small copy a
    call; the held runs and the bf16-against-f32 cut)."""

    def __init__(self, batch: int, tail: int = 0):
        self.batch, self.tail = batch, tail

    def __enter__(self):
        from repro_torch.models import moe

        self.mod, self.route, self.calls = moe, moe.route, []

        def logged(cfg, params, x):
            r = self.route(cfg, params, x)
            s, probs = x.shape[1], r["probs"]
            self.calls.append({
                "s": s, "keep": r["keep"],
                "gate": r["gate_idx"] if s == 1 or self.tail else None,
                "probs": (probs.reshape(self.batch, -1, probs.shape[-1])[:, -self.tail:].clone()
                          if self.tail else None)})
            return r

        moe.route = logged
        return self

    def __exit__(self, *exc):
        self.mod.route = self.route

    def dropped_share(self, moe_layers: int) -> tuple:
        """Dropped (token, choice) pairs over all pairs of the calls of
        more than one token a group (prefills), and the same for each MoE
        layer."""
        kept = [(int(c["keep"].sum()), c["keep"].numel()) for c in self.calls if c["s"] > 1]

        def share(pairs):
            return 1.0 - sum(a for a, _ in pairs) / sum(n for _, n in pairs)

        return share(kept), [share(kept[i::moe_layers]) for i in range(moe_layers)]

    def picked_per_step(self, moe_layers: int) -> list:
        """Distinct experts each decode step's router picked, summed over
        its MoE layers."""
        picks = [int(torch.unique(c["gate"]).numel()) for c in self.calls if c["s"] == 1]
        return [sum(picks[i:i + moe_layers]) for i in range(0, len(picks), moe_layers)]

    def _rows(self, call) -> torch.Tensor:
        g = call["gate"]
        return g.reshape(self.batch, -1, g.shape[-1])

    def flips(self, layers: int, steps: int) -> tuple:
        """For a held serving run logged with ``tail = steps + 1`` (warm-up
        prefill, prefill, ``steps`` decode steps, forward; no profiled
        steps): the positions (batch, steps + 1) — the prefill's last and
        each decode step's — where some layer's top-k set differs from
        forward's at that position, and the largest log-probability gap
        between a swapped-in and a swapped-out expert on either path at
        each such position's first such layer (past it the position's
        states part, and so may its later routings)."""
        calls = self.calls
        pre, dec, fwd = calls[layers:2 * layers], calls[2 * layers:-layers], calls[-layers:]

        def at(call, pos):  # pos counts from the end of the call's positions
            return self._rows(call)[:, pos].tolist(), call["probs"][:, pos].log()

        flipped = torch.zeros((self.batch, steps + 1), dtype=torch.bool)
        worst = 0.0
        for j, li in itertools.product(range(steps + 1), range(layers)):
            mine = at(pre[li], -1) if j == 0 else at(dec[(j - 1) * layers + li], -1)
            theirs = at(fwd[li], j - steps - 1)
            for b in range(self.batch):
                a, f = set(mine[0][b]), set(theirs[0][b])
                if a == f or flipped[b, j]:
                    continue
                flipped[b, j] = True
                for lp in (mine[1][b], theirs[1][b]):
                    for ea, ef in itertools.product(a - f, f - a):
                        worst = max(worst, abs((lp[ea] - lp[ef]).item()))
        return flipped, worst

    def routed_alike(self, other: "_RouteLog") -> torch.Tensor:
        """(batch, positions): where every layer chose the same experts
        and kept the same of them in this log and ``other``, two forward
        runs over the same tokens logged with ``tail``."""
        def sig(call):
            g = self._rows(call)
            kept = torch.where(call["keep"].reshape(g.shape), g, -1)
            return torch.cat([g.sort(-1).values, kept.sort(-1).values], -1)

        same = None
        for a, b in zip(self.calls, other.calls, strict=True):
            eq = (sig(a) == sig(b)).all(-1)
            same = eq if same is None else same & eq
        return same


def _lm_serve(model, batch: int, prompt: int, steps: int, seed: int, profiled: int = 0,
              hold: bool = True, frames: int = 0, max_seq: int = 0) -> tuple:
    """``examples/serve_lm.py``'s loop: prefill ``batch`` prompts of
    ``prompt`` tokens from ``default_rng(seed)`` (with ``frames`` encoder
    frames for an encoder-decoder; timed after one warm-up prefill of the
    same shape), then ``steps`` greedy decode steps (the last ``profiled``
    under the profiler). With ``hold``, each step's logits, and the
    prefill's last, are held to ``forward`` (``decoder_forward``) over the
    prompt and the tokens fed, at that position, and the greedy tokens to
    forward's where its top-2 gap exceeds the tolerance (a MoE's positions
    that decode and forward routed apart are counted, not held, within
    LM_MOE_ALIKE_MIN and LM_MOE_FLIP_GAP); without, the logits must be
    finite. A MoE's routing is logged: the prefill's dropped share and the
    experts each decode step picked. Returns (row, prompts, frames, the
    prefill's last logits)."""
    cfg = model.cfg
    rng = np.random.default_rng(seed)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (batch, prompt))).to(DEVICE)
    fr = (torch.from_numpy(rng.standard_normal((batch, frames, cfg.d_model)).astype(np.float32))
          .to(DEVICE) if frames else None)
    max_seq = max_seq or prompt + steps
    row: dict = {"batch": batch, "prompt": prompt, "decode_steps": steps, "max_seq": max_seq,
                 "frames": frames}
    moe_layers = 0
    if cfg.arch_type != "encdec":
        from repro_torch.models.transformer import layer_kinds

        moe_layers = layer_kinds(cfg).count("attn+moe")

    def prefill():
        if fr is None:
            return model.prefill(toks, max_seq) + (None,)
        return model.prefill(fr, toks, max_seq)

    fed: list = []
    with torch.inference_mode(), _RouteLog(batch, steps + 1 if hold else 0) as routes:
        prefill()  # warm-up: this shape's first call
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        last, caches, enc = prefill()
        torch.cuda.synchronize()
        row["prefill_s"] = time.perf_counter() - t0
        args = () if enc is None else (enc,)

        def step(c, tok1, pos):
            return model.decode_step(c, *args, tok1, pos)

        logits = [last[:, -1]]
        tok = last[:, -1].argmax(-1)
        pos = torch.full((batch,), prompt, device=DEVICE)
        timed = steps - profiled
        t0 = time.perf_counter()
        caches, tok = _greedy(step, caches, tok, pos, timed, fed, logits)
        torch.cuda.synchronize()
        row["decode_ms_per_step"] = 1e3 * (time.perf_counter() - t0) / timed
        row["decode_tokens_per_s"] = batch * 1e3 / row["decode_ms_per_step"]
        row["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
        if profiled:
            (caches, tok), row["decode_profile"] = _profiled(
                lambda: _greedy(step, caches, tok, pos + timed, profiled, fed, logits),
                profiled)
        row["cache_gb"] = sum(t.numel() * t.element_size() for c in caches
                              for t in c.values()) / 1e9
        del caches
        got = torch.stack(logits, 1)                       # (b, steps + 1, V)
        if hold:
            full = model(torch.cat([toks, torch.stack(fed, 1)], 1), *args)[0]
            want = full[:, prompt - 1:].clone()
            del full
    flipped = torch.zeros(got.shape[:2], dtype=torch.bool)
    if moe_layers:
        picks = routes.picked_per_step(moe_layers)
        dropped, by_layer = routes.dropped_share(moe_layers)
        row["moe"] = {"prefill_dropped_share": dropped,
                      "prefill_dropped_share_by_layer": by_layer,
                      "decode_experts_picked_per_step": sum(picks) / len(picks),
                      "experts_per_step": moe_layers * (cfg.moe_pad_to or cfg.moe_experts),
                      "capacity_factor": cfg.moe_capacity}
        if hold:
            flipped, gap = routes.flips(moe_layers, steps)
            row["moe"].update(positions_routed_apart=int(flipped.sum()),
                              routed_apart_max_logprob_gap=gap)
        log(f"[lm] moe routing {cfg.name} {batch}x{prompt} {json.dumps(row['moe'])}")
    del routes
    if not hold:
        row["finite"] = bool(torch.isfinite(got).all())
        log(f"[lm] serve {json.dumps(row)}")
        if not row["finite"]:
            raise AssertionError(f"lm serve {cfg.name} {batch}x{prompt}: logits not finite")
        return row, toks, fr, last[:, -1]
    same = ~flipped.to(got.device)                         # positions routed alike
    diff = (got - want).abs()
    elem_ok = bool((diff <= LM_BF16_ATOL + LM_BF16_RTOL * want.abs())[same].all())
    norms = (got - want).norm(dim=-1) / want.norm(dim=-1)
    norm = norms[same].max().item()
    top = want.topk(2, dim=-1)
    decided = (top.values[..., 0] - top.values[..., 1]) > (
        LM_BF16_ATOL + LM_BF16_RTOL * top.values[..., 0].abs())
    agree = got.argmax(-1) == top.indices[..., 0]
    row["vs_forward"] = {
        "positions": int(got.shape[0] * got.shape[1]), "max_abs_diff": diff[same].max().item(),
        "mean_abs_diff": diff[same].mean().item(), "max_norm_rel": norm,
        "tokens_decided": int(decided[same].sum()), "tokens_agree": int(agree[same].sum()),
        "decided_disagree": int((decided & ~agree & same).sum()),
        "ok": elem_ok and norm <= LM_BF16_NORM and bool(agree[decided & same].all()),
    }
    if moe_layers:
        row["vs_forward"]["positions_routed_alike"] = int(same.sum())
        row["vs_forward"]["routed_apart_max_norm_rel"] = (norms[~same].max().item()
                                                          if (~same).any() else 0.0)
        row["vs_forward"]["ok"] &= (same.float().mean().item() >= LM_MOE_ALIKE_MIN
                                    and row["moe"]["routed_apart_max_logprob_gap"]
                                    <= LM_MOE_FLIP_GAP)
    log(f"[lm] serve {json.dumps(row)}")
    if not row["vs_forward"]["ok"]:
        raise AssertionError(f"lm serve {cfg.name} {batch}x{prompt}: decode against forward "
                             f"{row['vs_forward']}")
    return row, toks, fr, last[:, -1]


def _lm_f32_decode(cfg) -> dict:
    """``cfg`` at full width and depth in f32 and capacity 16 (nothing
    drops), weights from a generator seeded 0 on the card: LM_MOE_F32's
    prompts through ``forward``, ``prefill`` and decode steps fed the next
    tokens, each step and the prefill's last logits held to forward at
    their position within LM_WIDE_TOL, no position excused."""
    from repro_torch.models.model import build_model

    batch, prompt, steps = LM_MOE_F32
    cfg = dataclasses.replace(cfg, dtype="float32", moe_capacity=16.0)
    t0 = time.perf_counter()
    model = build_model(cfg, device=DEVICE, generator=torch.Generator(DEVICE).manual_seed(0))
    toks = np.random.default_rng(3).integers(0, cfg.vocab, (batch, prompt + steps))
    out = _lm_run(model, toks, prompt, steps)
    del model
    torch.cuda.empty_cache()
    fwd = out["forward"]
    pairs = [(out["prefill"][:, 0], fwd[:, prompt - 1])]
    pairs += [(lg[:, 0], fwd[:, prompt + i]) for i, lg in enumerate(out["decode"])]
    row = {"layers": cfg.n_layers, "dtype": "float32", "capacity_factor": 16.0,
           "tokens": [batch, prompt], "decode_steps": steps,
           "max_abs_diff": max((a - b).abs().max().item() for a, b in pairs),
           "tol": LM_WIDE_TOL, "seconds": time.perf_counter() - t0,
           "ok": all(torch.allclose(a, b, **LM_WIDE_TOL) for a, b in pairs)}
    log(f"[lm] f32 decode against forward {cfg.name} {json.dumps(row)}")
    if not row["ok"]:
        raise AssertionError(f"lm {cfg.name}: f32 decode against forward {row}")
    return row


def _lm_bounds(model, batch: int, prompt: int, steps: int, frames: int = 0,
               picked: float = 0.0) -> dict:
    """The least time the card could take. A decode step reads the weights
    it needs once (for a MoE only the experts its router picked, ``picked``
    summed over the layers; for an encoder-decoder the decoder's and the
    encoder output its cross K/V are projected from), the K/V of the slots
    its attention needs (the last step's) and the recurrent states (read
    and written). The prefill's operations are the matrix products of
    every token (a MoE's routed experts counted top-k a token; logits at
    the last position), the attention of the causal/window band (and the
    encoder's and the cross-attention's), and the mLSTM's chunk products."""
    from repro_torch.models.layers import tree_leaves

    cfg, params = model.cfg, model.params
    elt = cfg.torch_dtype.itemsize

    def nbytes(tree):
        return sum(t.numel() * t.element_size() for t in tree_leaves(tree))

    def mats(tree):  # parameters a token multiplies with (no norm scales, no Lambda)
        return sum(t.numel() for t in tree_leaves(tree) if t.dim() >= 2)

    weight_bytes = nbytes(params)
    kv_row = 2 * batch * cfg.n_kv * cfg.head_dim * elt         # k and v of one slot
    n = prompt + steps

    def band(q: int, window=None) -> int:  # causal (query, key) pairs of q positions
        return int(np.minimum(np.arange(1, q + 1), window or q).sum())

    def attn(pairs: int) -> int:           # score and PV products over those pairs
        return 4 * batch * pairs * cfg.n_heads * cfg.head_dim

    if cfg.arch_type == "encdec":
        step_bytes = (nbytes(params["dec"]) + nbytes(params["emb"])
                      + nbytes(params["final_norm"]) + batch * frames * cfg.d_model * elt
                      + cfg.dec_layers * n * kv_row)
        tokens_x_params = (frames * (mats(params["frontend_proj"])
                                     + sum(mats(p) for p in params["enc"]))
                           + prompt * sum(mats(p) for p in params["dec"]))
        attn_ops = (cfg.enc_layers * attn(frames * frames)
                    + cfg.dec_layers * (attn(band(prompt)) + attn(prompt * frames)))
    else:
        from repro_torch.models.blocks import _mlstm_cfg
        from repro_torch.models.transformer import layer_kinds

        states = model.init_caches(batch, 1)
        step_bytes, active, attn_ops, expert_bytes = weight_bytes, 0, 0, 0
        for i, (kind, p) in enumerate(zip(layer_kinds(cfg), params["layers"])):
            active += mats(p)
            if kind == "attn+moe":
                moe = p["moe"]
                per_expert = sum(moe[k][0].numel() for k in ("wi", "wg_up", "wo"))
                e = moe["wi"].shape[0]
                active -= (e - cfg.moe_top_k) * per_expert
                expert_bytes = per_expert * elt
                step_bytes -= e * expert_bytes
            if kind in ("rglru+mlp", "mlstm", "slstm"):
                step_bytes += 2 * nbytes(states[i])
            elif kind == "local+mlp":
                step_bytes += min(n, cfg.window) * kv_row
                attn_ops += attn(band(prompt, cfg.window))
            else:
                step_bytes += n * kv_row
                attn_ops += attn(band(prompt))
            if kind == "mlstm":
                mc = _mlstm_cfg(cfg)
                ck = min(mc.chunk, prompt)
                pairs = (prompt // ck) * ck * (ck + 1) // 2 + band(prompt % ck)
                attn_ops += 4 * batch * mc.n_heads * mc.head_dim * (pairs + prompt * mc.head_dim)
        step_bytes += picked * expert_bytes
        tokens_x_params = prompt * active
    prefill_ops = 2 * batch * tokens_x_params + 2 * batch * cfg.d_model * cfg.vocab + attn_ops
    prefill_ms = {"operations": 1e3 * prefill_ops / BF16_DENSE_OPS_PER_S,
                  "bytes": 1e3 * weight_bytes / HBM_BYTES_PER_S}
    by = max(prefill_ms, key=prefill_ms.get)
    return {
        "weight_gb": weight_bytes / 1e9, "decode_read_gb": step_bytes / 1e9,
        "decode_bound_ms": 1e3 * step_bytes / HBM_BYTES_PER_S, "decode_bound_by": "bytes",
        "prefill_ops": prefill_ops, "prefill_attention_ops": attn_ops,
        "prefill_bound_ms": prefill_ms[by], "prefill_bound_by": by,
    }


def _bf16_vs_f32(model, prompts, frames, last, layers: int) -> dict:
    """The model's bf16 logits against the same weights in f32: the
    prefill's last logits of the serving prompts in norm, or with
    ``layers`` a cut of the first ``layers`` layers, its forward logits at
    each position of ``prompts`` that both dtypes routed alike (a MoE's
    routing flips on near-ties between the two dtypes and moves such a
    position whole), at least LM_MOE_CUT_ALIKE_MIN of them."""
    from repro_torch.models.layers import tree_map
    from repro_torch.models.model import Model

    cfg, params = model.cfg, model.params
    if layers:
        cfg = dataclasses.replace(cfg, n_layers=layers)
        params = {**params, "layers": params["layers"][:layers]}
    m32 = Model(dataclasses.replace(cfg, dtype="float32"), device=DEVICE,
                params=tree_map(lambda t: t.float(), params))
    batch, n = prompts.shape
    with torch.inference_mode():
        if layers:
            with _RouteLog(batch, n) as r16:
                got = Model(cfg, device=DEVICE, params=params)(prompts)[0]
            with _RouteLog(batch, n) as r32:
                want = m32(prompts)[0]
            alike = (r16.routed_alike(r32) if r16.calls
                     else torch.ones((batch, n), dtype=torch.bool, device=DEVICE)).flatten()
            del r16, r32
        elif frames is None:
            got, want = last, m32.prefill(prompts, n)[0][:, -1]
        else:
            got, want = last, m32.prefill(frames, prompts, n)[0][:, -1]
        per = ((got - want).norm(dim=-1) / want.norm(dim=-1)).flatten()
        row = {"layers": layers or cfg.n_layers, "positions": int(per.numel()),
               "tokens": list(prompts.shape), "logits_norm_rel": ((got - want).norm()
                                                                  / want.norm()).item(),
               "median_position_norm_rel": per.median().item(),
               "max_position_norm_rel": per.max().item(),
               "positions_over_limit": int((per > LM_BF16_VS_F32).sum()),
               "limit": LM_BF16_VS_F32}
        rel = row["logits_norm_rel"]
        if layers:
            share = alike.float().mean().item()
            rel = per[alike].max().item() if share else float("inf")
            row.update(positions_routed_alike=int(alike.sum()), alike_min=LM_MOE_CUT_ALIKE_MIN,
                       routed_alike_max_norm_rel=rel,
                       routed_apart_max_norm_rel=(per[~alike].max().item()
                                                  if share < 1 else 0.0))
    del m32, got, want
    torch.cuda.empty_cache()
    log(f"[lm] bf16 against f32 weights {cfg.name} {json.dumps(row)}")
    if rel > LM_BF16_VS_F32:
        raise AssertionError(f"lm {cfg.name}: bf16 logits {rel:.4f} from f32 in norm")
    if layers and share < LM_MOE_CUT_ALIKE_MIN:
        raise AssertionError(f"lm {cfg.name}: {share:.3f} of the positions routed alike "
                             f"in bf16 and f32, under {LM_MOE_CUT_ALIKE_MIN}")
    return row


def _lm_full(arch: str, spec: dict) -> dict:
    """(c) and (d) for one model of LM_SERVED at full width and depth in
    bf16, weights from a generator seeded 0 on the card."""
    from repro_torch.configs import get_config
    from repro_torch.models.layers import count_params
    from repro_torch.models.model import Model, build_model

    cfg = get_config(arch)
    t0 = time.perf_counter()
    model = build_model(cfg, device=DEVICE, generator=torch.Generator(DEVICE).manual_seed(0))
    torch.cuda.synchronize()
    params = model.params
    elements = count_params(params)
    norms = sum(t.numel() for name, t in model.named_parameters() if "norm" in name)
    rec: dict = {"model": {
        "arch": arch, "dtype": cfg.dtype, "layers": cfg.n_layers, "n_params": cfg.n_params(),
        "tensor_elements": elements, "norm_elements": norms,
        "analytic_gap": LM_ANALYTIC_GAP[arch],
        "weight_gb": sum(t.numel() * t.element_size() for t in model.parameters()) / 1e9,
        "init_s": time.perf_counter() - t0}}
    log(f"[lm] model {json.dumps(rec['model'])}")
    if elements - norms != cfg.n_params() + LM_ANALYTIC_GAP[arch]:
        raise AssertionError(f"lm {arch}: {elements} parameters, {norms} of them norm "
                             f"scales, against n_params {cfg.n_params()} and the gap "
                             f"{LM_ANALYTIC_GAP[arch]}")
    frames = spec.get("frames", 0)
    kw = {"frames": frames, "max_seq": spec.get("max_seq", 0)}
    short_prompts = None
    if "short" in spec:
        short_cfg = dataclasses.replace(cfg, moe_capacity=spec.get("short_capacity",
                                                                    cfg.moe_capacity))
        short_model = Model(short_cfg, device=DEVICE, params=params)
        rec["short"], short_prompts, _, _ = _lm_serve(short_model, *spec["short"], seed=2, **kw)
        del short_model
    serve, prompts, fr, last = _lm_serve(model, *spec["serve"], seed=0,
                                         profiled=spec.get("profiled", 1),
                                         hold=spec.get("hold_serve", True), **kw)
    rec["serve"] = serve
    picked = serve.get("moe", {}).get("decode_experts_picked_per_step", 0.0)
    cut = spec.get("f32_layers", 0)
    rec["bf16_vs_f32"] = _bf16_vs_f32(model, short_prompts if cut else prompts, fr, last, cut)
    bounds = _lm_bounds(model, *spec["serve"], frames=frames, picked=picked)
    rec["bounds"] = bounds
    log(f"[lm] bounds {arch} {json.dumps(bounds)}")
    rec["summary"] = {
        "arch": arch, "prefill_s": serve["prefill_s"],
        "prefill_bound_s": bounds["prefill_bound_ms"] / 1e3,
        "decode_ms_per_step": serve["decode_ms_per_step"],
        "decode_bound_ms": bounds["decode_bound_ms"],
        "decode_tokens_per_s": serve["decode_tokens_per_s"], "peak_gb": serve["peak_gb"],
        "n_params": cfg.n_params(), "tensor_elements": elements,
        "decode_device_idle_share": serve.get("decode_profile", {}).get("device_idle_share"),
    }
    log(f"[lm] summary {json.dumps(rec['summary'])}")
    del model, params, prompts, fr, last, short_prompts
    gc.collect()
    torch.cuda.empty_cache()
    if spec.get("f32_decode"):  # once the bf16 weights are freed: 59.3 GB in f32
        rec["f32_decode"] = _lm_f32_decode(cfg)
    return rec


def phase_lm() -> None:
    """The LM serving paths of the port on the card, f32 with TF32 off,
    bf16 with f32 reductions.

    (a) The reduced configurations of every family in f32 (numpy weights
        in the reference's layout, carried across by
        ``lm_params_from_arrays``): forward, prefill (the encoder's output
        too) and LM_REDUCED_STEPS decode steps on the card against the same
        on the CPU (which the tier-1 tests hold to the reference) within
        LM_F32_TOL, caches and recurrent states included.
    (b) LM_WIDE: each family at full width, cut to one pattern cycle
        (whisper whole), f32, on the card against the CPU within
        LM_WIDE_TOL.
    (c) LM_SERVED: gemma3-4b, qwen2-moe-a2.7b, recurrentgemma-2b, xlstm-350m
        and whisper-tiny at full width and depth in bf16 through
        ``build_model``, ``prefill`` and ``decode_step``, 32 greedy decode
        steps, each held to forward (the MoE's on a 4 x 512 run at
        capacity 16, where nothing drops), and bf16 against f32 weights.
    (d) ``[lm]`` lines per model: prefill s, decode ms a step and tokens/s,
        peak memory, the parameter count, the bounds, one decode step's
        profile, and the MoE's dropped share and experts picked.
    """
    t_phase = time.perf_counter()
    # the reference accumulates bf16 products in f32: no reduced-precision
    # split-K reductions in cuBLAS either
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    rec: dict = {"reduced": _lm_reduced()}
    rec["wide"] = [_lm_wide(*w) for w in LM_WIDE]
    rec["models"] = {arch: _lm_full(arch, spec) for arch, spec in LM_SERVED.items()}
    rec["seconds"] = time.perf_counter() - t_phase
    log(f"[lm] phase {rec['seconds']:.1f} s")
    RECORD["phases"]["lm"] = rec


def _write_record(t0: float) -> None:
    out_dir = os.path.join(ROOT, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    RECORD["seconds"] = time.perf_counter() - t0
    with open(os.path.join(out_dir, "chip_smoke.json"), "w") as f:
        json.dump(RECORD, f, indent=1)
    log(f"[done] {RECORD['seconds']:.1f} s")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    if sys.argv[1:2] == ["--dist-rank"]:
        return dist_rank_main(int(sys.argv[2]), sys.argv[3])
    t0 = time.perf_counter()
    _, kind = phase_env()
    if "--only-lm" in sys.argv[1:]:
        phase_lm()
        _write_record(t0)
        return 0
    phase_build()
    phase_kernels()
    if "--only-kernels" in sys.argv[1:]:
        return 0
    entries, ctx = phase_main()
    phase_serving(ctx)
    phase_distributed(ctx)
    entries += phase_push(ctx)
    phase_fig8(ctx)
    phase_orders(ctx)
    phase_priority(ctx)
    del ctx  # the graph phases' device memory, before the LM's
    gc.collect()
    torch.cuda.empty_cache()
    phase_lm()
    _write_record(t0)
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
