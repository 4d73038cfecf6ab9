"""The production dry-run of the port (``launch.shapes``, ``launch.steps``,
``launch.dryrun``, ``roofline.analysis``, ``roofline.op_count``) against
the reference's.

* ``SHAPES``, ``cell_applicable`` and ``all_cells`` equal the reference's;
* ``roofline_terms``, ``model_flops`` and ``mfu_fraction`` equal the
  reference's for every arch and shape under ``HW_V5E``;
* ``input_specs`` gives the reference's shapes and dtypes;
* ``cache_shardings`` gives the reference's specs on the production mesh
  (the reference's side in a 256-device jax subprocess that builds no
  program), apart from the recurrent states of its docstring's exceptions;
* the counter's ``flops_scaled`` is within ``FLOPS_RTOL`` of the
  reference's ``hlo_parse.analyze`` on reduced train, prefill and decode
  cells compiled on one host device (``FLOP_CELLS``; the largest gap, the
  mLSTM's decode step, is 2.2%);
* the counter's own arithmetic on a few ops;
* one dry-run cell end to end as the CLI, in a subprocess on no GPU.
"""
import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro import configs as RC  # noqa: E402
from repro.launch import shapes as RSH  # noqa: E402
from repro.roofline import analysis as RA  # noqa: E402
from repro_torch import configs as PC  # noqa: E402
from repro_torch.launch import shapes as PSH  # noqa: E402
from repro_torch.launch import steps as PS  # noqa: E402
from repro_torch.launch.mesh import make_production_mesh  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.roofline import analysis as PA  # noqa: E402
from repro_torch.roofline.op_count import analyze  # noqa: E402

from tests.util import run_with_devices  # noqa: E402

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
ROOT = os.path.join(os.path.dirname(__file__), "..")
ARCHS = tuple(PC.ALL_ARCHS)
FLOPS_RTOL = 0.05
# small cells on one host device: (kind, seq, global batch)
SMALL = {"t_train": ("train", 32, 4), "t_prefill": ("prefill", 32, 2),
         "t_decode": ("decode", 32, 2)}
FLOP_CELLS = ([(a, "t_prefill") for a in ARCHS] + [(a, "t_decode") for a in ARCHS]
              + [(a, "t_train") for a in ("olmo-1b", "qwen2-moe-a2.7b", "whisper-tiny")])


def test_shapes_equal_reference():
    assert PSH.SHAPES.keys() == RSH.SHAPES.keys()
    for name in RSH.SHAPES:
        assert dataclasses.asdict(PSH.SHAPES[name]) == dataclasses.asdict(RSH.SHAPES[name])
    assert PSH.WHISPER_ENC_FRAMES == RSH.WHISPER_ENC_FRAMES
    pcfgs = {a: PC.get_config(a) for a in ARCHS}
    rcfgs = {a: RC.get_config(a) for a in ARCHS}
    for a in ARCHS:
        for s in RSH.SHAPES:
            assert PSH.cell_applicable(pcfgs[a], s) == RSH.cell_applicable(rcfgs[a], s)
    assert PSH.all_cells(ARCHS, pcfgs) == RSH.all_cells(ARCHS, rcfgs)
    assert len(PSH.all_cells(ARCHS, pcfgs)) == 40


@pytest.mark.parametrize("arch", ARCHS)
def test_roofline_arithmetic_equals_reference(arch):
    pcfg, rcfg = PC.get_config(arch), RC.get_config(arch)
    for s in RSH.SHAPES:
        mf = PA.model_flops(pcfg, PSH.SHAPES[s])
        assert mf == RA.model_flops(rcfg, RSH.SHAPES[s])
        flops, byts, coll = mf / 256 * 1.7, mf / 256 * 0.3, mf / 256 * 0.01
        pt = PA.roofline_terms(flops, byts, coll, PA.HW_V5E)
        rt = RA.roofline_terms(flops, byts, coll, RA.HW_V5E)
        assert pt.as_dict() == rt.as_dict()
        assert pt.bound_time == rt.bound_time
        assert (PA.mfu_fraction(pt, mf / 256, PA.HW_V5E)
                == RA.mfu_fraction(rt, mf / 256, RA.HW_V5E))
    assert PA.HW_V5E == RA.HW_V5E
    # the port's default is the H100 table
    t = PA.roofline_terms(989e12, 3.35e12, 450e9)
    assert (t.t_compute, t.t_memory, t.t_collective) == (1.0, 1.0, 1.0)
    assert PA.HW_H100["hbm_bytes"] == 80e9


@pytest.mark.parametrize("arch", ARCHS)
def test_input_specs_equal_reference(arch):
    from repro.launch import steps as RS

    pcfg, rcfg = PC.get_config(arch), RC.get_config(arch)
    for s in RSH.SHAPES:
        got = PS.input_specs(pcfg, PSH.SHAPES[s])
        want = RS.input_specs(rcfg, RSH.SHAPES[s])
        assert got.keys() == want.keys()
        for k in want:
            assert tuple(got[k].shape) == tuple(want[k].shape), (s, k)
            assert str(got[k].dtype).removeprefix("torch.") == str(want[k].dtype), (s, k)
            assert got[k].is_meta


CACHE_REF = textwrap.dedent("""
    import json
    import jax
    from repro.configs import ALL_ARCHS, get_config
    from repro.launch import steps as RS
    from repro.launch.mesh import make_production_mesh
    from repro.launch.shapes import SHAPES, cell_applicable
    from repro.models.model import build_model
    mesh = make_production_mesh()
    out = {}
    for arch in ALL_ARCHS:
        cfg = get_config(arch)
        for s in ("decode_32k", "long_500k"):
            if not cell_applicable(cfg, s)[0]:
                continue
            shape = SHAPES[s]
            ba = RS._batch_axes(mesh, shape.global_batch)
            caches = jax.eval_shape(
                lambda: build_model(cfg).init_caches(shape.global_batch, shape.seq))
            sh = RS.cache_shardings(cfg, mesh, caches, ba if ba else None)
            out[arch + "/" + s] = jax.tree.map(
                lambda n: [list(e) if isinstance(e, tuple) else e for e in n.spec], sh)
    print(json.dumps(out))
""")


def _norm(e):
    """A spec entry with a one-axis tuple as its name."""
    if isinstance(e, (list, tuple)):
        return e[0] if len(e) == 1 else tuple(e)
    return e


def _pad(spec, nd):
    return tuple(_norm(e) for e in spec) + (None,) * (nd - len(spec))


@pytest.fixture(scope="module")
def ref_cache_specs():
    return json.loads(run_with_devices(CACHE_REF, n_devices=256, timeout=300).strip()
                      .splitlines()[-1])


@pytest.mark.parametrize("arch", ARCHS)
def test_cache_shardings_equal_reference(ref_cache_specs, arch):
    mesh = make_production_mesh()
    cfg = PC.get_config(arch)
    n_cycles = cfg.n_layers // len(cfg.pattern)
    checked = 0
    for s in ("decode_32k", "long_500k"):
        key = arch + "/" + s
        if key not in ref_cache_specs:
            continue
        shape = PSH.SHAPES[s]
        ba = PS._batch_axes(mesh, shape.global_batch)
        if cfg.arch_type == "encdec":
            from repro_torch.models import encdec as E
            whole = E.init_dec_caches(cfg, shape.global_batch, shape.seq, "meta")
            kinds = ["dec"] * len(whole)
        else:
            whole = T.init_caches(cfg, shape.global_batch, shape.seq, "meta")
            kinds = T.layer_kinds(cfg)
        got = PS.cache_shardings(cfg, mesh, whole, ba)
        ref = ref_cache_specs[key]
        for i, (kind, layer) in enumerate(zip(kinds, got)):
            for leaf, spec in layer.items():
                nd = whole[i][leaf].dim()
                if cfg.arch_type == "encdec":
                    want = _pad(ref[leaf], nd + 1)[1:]
                elif i < n_cycles * len(cfg.pattern):
                    want = _pad(ref["cycles"][i % len(cfg.pattern)][leaf], nd + 1)[1:]
                else:
                    want = _pad(ref["rem"][i - n_cycles * len(cfg.pattern)][leaf], nd)
                if leaf in ("k", "v", "k_scale", "v_scale", "slot_pos"):
                    assert spec == want, (s, i, leaf, spec, want)
                elif i < n_cycles * len(cfg.pattern):
                    # a recurrent state: the port's heads or channels over
                    # "model" are the listed exception
                    assert tuple(None if e == "model" else e for e in spec) == want, (
                        s, i, leaf, spec, want)
                checked += 1
    assert checked


@pytest.fixture(scope="module")
def flop_pairs():
    """The reference's ``hlo_parse`` FLOPs of ``FLOP_CELLS`` compiled on one
    host device, and the counter's on the port's cells of a one-rank mesh."""
    code = textwrap.dedent(f"""
        import json
        from repro.configs import get_reduced
        from repro.launch import steps as RS
        from repro.launch.shapes import ShapeCell
        from repro.roofline.hlo_parse import analyze
        from repro.runtime.jax_compat import make_mesh, set_mesh
        from repro.sharding.rules import default_rules
        from repro.train.loop import TrainConfig
        for n, (k, s, b) in {SMALL!r}.items():
            RS.SHAPES[n] = ShapeCell(n, k, s, b)
        mesh = make_mesh((1, 1), ("data", "model"))
        out = {{}}
        for arch, n in {FLOP_CELLS!r}:
            c = RS.build_cell(get_reduced(arch), n, mesh, default_rules(mesh), TrainConfig())
            with set_mesh(mesh):
                hlo = c.fn.lower(*c.args).compile().as_text()
            out[arch + "/" + n] = analyze(hlo)["flops_scaled"]
        print(json.dumps(out))
    """)
    ref = json.loads(run_with_devices(code, n_devices=1, timeout=300).strip().splitlines()[-1])
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from repro_torch.sharding.rules import default_rules
    from repro_torch.train.loop import TrainConfig

    added = [n for n in SMALL if n not in PSH.SHAPES]
    for n, (k, s, b) in SMALL.items():
        PSH.SHAPES[n] = PSH.ShapeCell(n, k, s, b)
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=1)
    try:
        mesh = init_device_mesh("cpu", (1, 1), mesh_dim_names=("data", "model"))
        got = {}
        for arch, n in FLOP_CELLS:
            cell = PS.build_cell(PC.get_reduced(arch), n, mesh, default_rules(mesh),
                                 TrainConfig())
            got[arch + "/" + n] = analyze(cell.fn, *cell.args)["flops_scaled"]
    finally:
        dist.destroy_process_group()
        for n in added:
            del PSH.SHAPES[n]
    return ref, got


@pytest.mark.parametrize("case", FLOP_CELLS, ids=lambda c: f"{c[0]}-{c[1]}")
def test_counter_flops_match_hlo_parse(flop_pairs, case):
    ref, got = flop_pairs
    key = case[0] + "/" + case[1]
    assert ref[key] > 0
    assert abs(got[key] / ref[key] - 1) <= FLOPS_RTOL, (got[key], ref[key])


def test_counter_arithmetic():
    """A product's FLOPs and bytes, a state write, a row gather, the views
    left out, and the live storages' peak."""
    w = torch.empty((64, 32), device="meta")
    cache = torch.zeros((4, 16, 32), device="meta")

    def fn(x, cache):
        y = x @ w                                  # (8, 32): 2*8*64*32 FLOPs
        cache[:, 3] = y[:4]                        # state writes of 4*32 f32:
        cache[torch.arange(4, device=x.device), 5] = y[4:]   # a copy_ and an index_put_
        rows = w[torch.zeros(5, dtype=torch.long, device=x.device)]   # a row gather
        return y.t(), rows

    r = analyze(fn, torch.empty((8, 64)), cache)
    assert r["flops_scaled"] == 2 * 8 * 64 * 32
    mm = (8 * 64 + 64 * 32 + 8 * 32) * 4
    assert r["traffic_by_opcode"]["mm"] == mm
    assert r["traffic_by_opcode"]["copy_"] == 2 * 4 * 32 * 4
    assert r["traffic_by_opcode"]["index_put_"] == 2 * 4 * 32 * 4
    assert r["traffic_by_opcode"]["index"] == 2 * 5 * 32 * 4
    assert r["traffic_dot_bytes_scaled"] == sum(r["traffic_by_opcode"].values())
    assert r["arg_bytes"] == (8 * 64 + 4 * 16 * 32) * 4     # w is no argument
    assert r["peak_live_bytes"] >= r["arg_bytes"] + 8 * 32 * 4 + 5 * 32 * 4
    assert r["out"][0].shape == (32, 8) and r["out"][0].is_meta
    assert r["collective_bytes"] == {"total": 0}


def test_dryrun_single_cell_subprocess():
    """``python -m repro_torch.launch.dryrun`` for olmo-1b decode_32k on
    pod_16x16, as the reference's test runs its own: on no GPU, 256 fake
    ranks."""
    out = tempfile.mkdtemp()
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", "olmo-1b",
         "--shape", "decode_32k", "--mesh", "single", "--out", out],
        capture_output=True, text=True, timeout=120,
        env={**os.environ, "PYTHONPATH": SRC + os.pathsep + os.environ.get("PYTHONPATH", ""),
             "CUDA_VISIBLE_DEVICES": ""},
        cwd=ROOT,
    )
    assert r.returncode == 0, r.stdout + r.stderr
    rec = json.load(open(f"{out}/olmo-1b__decode_32k__pod_16x16.json"))
    assert rec["n_chips"] == 256
    assert rec["roofline"]["dominant"] in ("compute", "memory", "collective")
    assert rec["memory"]["fits_hbm"]
    assert rec["collectives"]["counts"]["all-reduce"] > 0
    assert 0 < rec["roofline_fraction"] < 1
    assert np.isclose(rec["model_flops_per_device"], rec["model_flops_total"] / 256)


def test_uneven_train_cell_rows_build():
    """internvl2-76b train_4k on multipod_2x16x16, the cell whose
    microbatches' rows do not divide over the data ranks: its 16
    microbatches of the 256-row batch are 16 rows over the 32 (pod, data)
    ranks, so a shard is one row and ranks 0-15 hold one row of each
    microbatch, 16-31 none; each rank's inputs keep the reference's
    input_specs beyond the batch dimension (the shape arithmetic only)."""
    from repro_torch.train.loop import TrainConfig

    cfg = PC.get_config("internvl2-76b")
    shape = PSH.SHAPES["train_4k"]
    mesh = make_production_mesh(multi_pod=True)
    assert PS._batch_axes(mesh, shape.global_batch) == ("pod", "data")
    tcfg = TrainConfig(**PC.get_train_overrides("internvl2-76b"))
    nm = tcfg.row_microbatches
    assert nm == 16 and shape.global_batch == 256
    ins = PS.input_specs(cfg, shape)
    ref = RSH.SHAPES["train_4k"]
    assert {k: tuple(v.shape) for k, v in ins.items()} == {
        "tokens": (ref.global_batch, ref.seq - cfg.prefix_len),
        "labels": (ref.global_batch, ref.seq - cfg.prefix_len),
        "prefix_embeds": (ref.global_batch, cfg.prefix_len, cfg.d_model)}
    held = []
    for rank in range(32):
        batch = PS.train_rows(ins, nm, 32, rank)
        assert batch.microbatches == nm and batch.shard_rows == 1
        rows = {t.shape[0] for t in batch.values()}
        assert len(rows) == 1
        held.append(rows.pop())
        for k, t in batch.items():
            assert t.shape[1:] == ins[k].shape[1:] and t.dtype == ins[k].dtype and t.is_meta
    assert held == [nm] * 16 + [0] * 16
    with pytest.raises(ValueError, match="microbatches"):
        PS.train_rows(ins, 24, 32, 0)       # 256 rows do not split into 24
