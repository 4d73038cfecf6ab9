"""The multi-pod dry-run on fake ranks.

For every (architecture x input shape) cell, build the REAL train or serve
step (``launch.steps.build_cell``: the same builders the run loops use)
for rank 0 of the production mesh, run it once on fake tensors, and record
the roofline inputs as JSON under experiments/dryrun/. No card is needed
and no byte of tensor memory is allocated:

* a fake process group (``torch.distributed``'s "fake" backend: every
  collective returns at once) of 256 ranks, or 512 for the multi-pod mesh,
  carries a ``DeviceMesh`` of ``launch.mesh.make_production_mesh``'s shape;
* the cell runs on fake tensors under the counting dispatch mode of
  ``roofline.op_count``, which sums its FLOPs, HBM bytes and collective
  bytes and follows the live storages for a peak. The fake tensors are
  meta tensors: a CPU-only torch refuses Python indexing of a
  ``FakeTensorMode`` CUDA tensor (it takes a CUDA device guard), and a
  meta tensor runs the same ops with nothing allocated, at a fraction of
  ``FakeTensorMode``'s dispatch cost.

The record has the reference's file name and keys, with the memory held
against ``HW_H100["hbm_bytes"]`` (``fits_hbm``) and the roofline on
``HW_H100``::

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch olmo-1b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import time
import traceback

import torch
import torch.distributed as dist

from repro_torch.configs import ALL_ARCHS, get_config, get_train_overrides
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.shapes import SHAPES, cell_applicable
from repro_torch.launch.steps import build_cell
from repro_torch.models.layers import tree_leaves
from repro_torch.roofline.analysis import HW_H100, mfu_fraction, model_flops, roofline_terms
from repro_torch.roofline.op_count import analyze
from repro_torch.sharding.rules import default_rules
from repro_torch.train.loop import TrainConfig


def fake_mesh(multi_pod: bool):
    """A ``DeviceMesh`` of the production mesh's shape over a fake process
    group of as many ranks, this process rank 0 (the group is made anew
    when its size changes)."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore  # registers "fake"

    shape = make_production_mesh(multi_pod=multi_pod)
    world = math.prod(shape.sizes)
    if dist.is_initialized() and dist.get_world_size() != world:
        dist.destroy_process_group()
        _MESHES.clear()
    if not dist.is_initialized():
        dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world)
    if world not in _MESHES:
        # a "cpu" mesh: its tensors are meta tensors, and no card is set up
        _MESHES[world] = init_device_mesh("cpu", shape.sizes, mesh_dim_names=shape.axis_names)
    return _MESHES[world]


_MESHES: dict = {}


def _bytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree)
               if isinstance(t, torch.Tensor))


def run_cell(arch: str, shape_name: str, multi_pod: bool, out_dir: str,
             tcfg: TrainConfig | None = None, rules_opts: dict | None = None,
             tag: str = "", verbose: bool = True,
             cfg_overrides: dict | None = None) -> dict:
    mesh_name = "multipod_2x16x16" if multi_pod else "pod_16x16"
    cfg = get_config(arch)
    if cfg_overrides:
        cfg = dataclasses.replace(cfg, **cfg_overrides)
    ok, why = cell_applicable(cfg, shape_name)
    rec: dict = {
        "arch": arch, "shape": shape_name, "mesh": mesh_name,
        "applicable": ok, "skip_reason": why, "tag": tag,
    }
    os.makedirs(out_dir, exist_ok=True)
    fname = os.path.join(
        out_dir, f"{arch}__{shape_name}__{mesh_name}{('__' + tag) if tag else ''}.json"
    )
    if not ok:
        with open(fname, "w") as f:
            json.dump(rec, f, indent=1)
        if verbose:
            print(f"[skip] {arch} x {shape_name} ({why})")
        return rec

    if tcfg is None:
        tcfg = TrainConfig(**get_train_overrides(arch))
    rec["train_config"] = {
        "microbatches": tcfg.microbatches, "zero1": tcfg.zero1,
        "zero2_grads": tcfg.zero2_grads,
    }
    t0 = time.time()
    try:
        mesh = fake_mesh(multi_pod)
        rules = default_rules(mesh, **(rules_opts or {}))
        cell = build_cell(cfg, shape_name, mesh, rules, tcfg=tcfg)
        t_build = time.time() - t0
        scaled = analyze(cell.fn, *cell.args)
        t_run = time.time() - t0 - t_build
        n_chips = mesh.size()
        flops_dev = float(scaled["flops_scaled"])
        # the memory term is the fusion traffic model (matmul boundary +
        # state update + collective bytes); the all-op upper bound is kept
        # in the record for bracketing
        bytes_dev = float(scaled["traffic_dot_bytes_scaled"])
        coll_dev = float(scaled["collective_bytes"]["total"])
        terms = roofline_terms(flops_dev, bytes_dev, coll_dev, HW_H100)
        mf = model_flops(cfg, SHAPES[shape_name])
        mf_dev = mf / n_chips
        args_b = scaled["arg_bytes"]
        peak = max(scaled["peak_live_bytes"], args_b)
        rec.update({
            "n_chips": n_chips,
            "build_s": round(t_build, 2),
            "run_s": round(t_run, 2),
            "memory": {
                "argument_bytes": args_b,
                "output_bytes": _bytes(scaled["out"]),
                "temp_bytes": peak - args_b,
                "alias_bytes": sum(_bytes(cell.args[i]) for i in cell.donate),
                "peak_bytes": peak,
                "fits_hbm": peak < HW_H100["hbm_bytes"],
            },
            "cost": {
                "flops_scaled": flops_dev,
                "traffic_dot_bytes_scaled": bytes_dev,
                "traffic_allop_bytes_scaled": float(scaled["traffic_bytes_scaled"]),
            },
            "collectives": {
                "bytes": scaled["collective_bytes"],
                "counts": scaled["collective_counts"],
            },
            "roofline": terms.as_dict(),
            "model_flops_total": mf,
            "model_flops_per_device": mf_dev,
            "useful_flops_ratio": (mf_dev / flops_dev) if flops_dev else None,
            "roofline_fraction": mfu_fraction(terms, mf_dev, HW_H100),
            "sharding_fallbacks": cell.notes,
        })
        if verbose:
            print(
                f"[ok]  {arch:22s} {shape_name:12s} {mesh_name:16s} "
                f"run={t_run:6.1f}s mem={peak / 1e9:6.2f}G "
                f"dom={terms.dominant:10s} frac={rec['roofline_fraction']:.3f}"
            )
    except Exception as e:  # noqa: BLE001  (recorded in the JSON and the exit code)
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-4000:]
        if verbose:
            print(f"[FAIL] {arch} x {shape_name} x {mesh_name}: {rec['error'][:200]}")
    with open(fname, "w") as f:
        json.dump(rec, f, indent=1)
    return rec


def _parse_sets(items) -> dict:
    out = {}
    for it in items:
        k, v = it.split("=", 1)
        try:
            out[k] = int(v)
        except ValueError:
            try:
                out[k] = float(v)
            except ValueError:
                out[k] = {"true": True, "false": False}.get(v.lower(), v)
    return out


def main(argv=None) -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--arch", default=None)
    p.add_argument("--shape", default=None)
    p.add_argument("--mesh", default="single", choices=["single", "multi", "both"])
    p.add_argument("--all", action="store_true")
    p.add_argument("--out", default="experiments/dryrun")
    p.add_argument("--tag", default="")
    p.add_argument("--set", action="append", default=[],
                   help="ModelConfig override, e.g. --set q_chunk=2048")
    p.add_argument("--train-set", action="append", default=[],
                   help="TrainConfig override, e.g. --train-set microbatches=8")
    p.add_argument("--seq-shard", action="store_true",
                   help="sequence-parallel activation sharding rules")
    args = p.parse_args(argv)

    cfg_overrides = _parse_sets(args.set)
    tset = _parse_sets(args.train_set)
    rules_opts = {"seq_shard": True} if args.seq_shard else None

    archs = ALL_ARCHS if (args.all or args.arch is None) else [args.arch]
    shapes = list(SHAPES) if (args.all or args.shape is None) else [args.shape]
    meshes = {"single": [False], "multi": [True], "both": [False, True]}[args.mesh]

    t0 = time.time()
    results = []
    for mp in meshes:
        for a in archs:
            for s in shapes:
                tcfg = None
                if tset:
                    tcfg = TrainConfig(**{**get_train_overrides(a), **tset})
                results.append(run_cell(
                    a, s, mp, args.out, tcfg=tcfg, tag=args.tag,
                    cfg_overrides=cfg_overrides or None,
                    rules_opts=rules_opts,
                ))
    if dist.is_initialized():
        dist.destroy_process_group()
    n_ok = sum(1 for r in results if "error" not in r and r.get("applicable"))
    n_skip = sum(1 for r in results if not r.get("applicable"))
    n_fail = sum(1 for r in results if "error" in r)
    print(f"\n=== dry-run: {n_ok} ok, {n_skip} skipped (inapplicable), {n_fail} FAILED "
          f"in {time.time() - t0:.1f} s ===")
    if n_fail:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
