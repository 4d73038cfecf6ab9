"""Serving with the weights split over "model": the port's prefill and decode
on this rank's shards against the reference's, on the CPU.

One module fixture starts four gloo rank processes beside the reference on
four forced host devices (``tests.util.run_with_devices``). For every
reduced config of ``ARCHS`` on each mesh of ``MESHES`` both build the
prefill and decode cells of ``launch.steps.build_cell`` on a small
``ShapeCell`` (``SERVE``, added to ``SHAPES`` inside the subprocesses), from
the same numpy weights, and serve ``B`` prompts of ``P`` tokens and
``STEPS`` greedy decode steps: the reference jits its cells with the
parameters' shardings on the mesh; each port rank runs its cells on its
shards and its rows (a sequence-sharded config's caches laid out by
``shard_caches``). The tests hold, in f32:

* every rank's logits within ``TOL`` of the reference's rows, relative to
  their largest magnitude, at the prefill and at each step;
* the greedy tokens equal;
* each cache after the last step, gathered over the mesh by the specs of
  ``cache_shardings`` to the whole layout, within ``TOL`` of the
  reference's (relative to the leaf's largest magnitude; ``slot_pos``
  exactly).

The same ranks run a tensor-parallel prefill and decode through
``blocks.block_apply`` (the refusal of a cache or a decode step under
``tp`` is gone) and check that int8 KV with the sequence-sharded decode
still raises.
"""
import concurrent.futures
import os
import pickle
import subprocess
import sys
import tempfile
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from repro import configs as RC  # noqa: E402
from repro_torch import configs as PC  # noqa: E402
from repro_torch.interop import lm_caches_from_arrays  # noqa: E402

from tests.test_torch_lm_model import ref_weights  # noqa: E402
from tests.util import run_with_devices  # noqa: E402

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
RANKS = 4
ARCHS = tuple(PC.ALL_ARCHS)
MESHES = ((2, 2), (1, 4))
B, P, MAX, STEPS, FRAMES = 4, 8, 16, 8, 12
# (name, kind, seq = the caches' slots, global batch)
SERVE = {"serve_prefill": ("prefill", MAX, B), "serve_decode": ("decode", MAX, B)}
TOL = 2e-5

COMMON = textwrap.dedent("""
    import pickle
    import numpy as np
    rng = np.random.default_rng(11)
    TOKENS = {a: rng.integers(0, 512, (B, P)).astype(np.int32) for a in ARCHS}
    FRAMES_IN = rng.standard_normal((B, FRAMES_N, 64)).astype(np.float32)
    PREFIX = rng.standard_normal((B, 64, 64)).astype(np.float32)   # the first prefix_len rows
""")

RANK_CODE = textwrap.dedent("""
    import dataclasses, datetime, os, sys
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    rank, world, tmp = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    dist.init_process_group(
        "gloo", store=dist.FileStore(os.path.join(tmp, "store"), world),
        rank=rank, world_size=world, timeout=datetime.timedelta(seconds=120))
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.configs import get_reduced
    from repro_torch.interop import lm_params_from_arrays
    from repro_torch.launch import steps as PS
    from repro_torch.launch.shapes import ShapeCell
    from repro_torch.models import blocks as BL, transformer as T
    from repro_torch.sharding.rules import default_rules
    from repro_torch.sharding.tp import shard_params
    for name, (kind, seq, gb) in SERVE.items():
        PS.SHAPES[name] = ShapeCell(name, kind, seq, gb)
    out = {}

    def whole(t, spec, mesh):
        # this rank's part of a cache leaf gathered over the axes of its spec
        for i, e in enumerate(spec):
            for ax in (() if e is None else (e,) if isinstance(e, str) else e):
                parts = [torch.empty_like(t) for _ in range(mesh.size(mesh.mesh_dim_names.index(ax)))]
                dist.all_gather(parts, t.contiguous(), group=mesh.get_group(ax))
                t = torch.cat(parts, dim=i)
        return t

    from repro_torch.configs import get_config
    def get_reduced_served(arch):
        # the reduced config with the full one's sequence-sharded decode
        return dataclasses.replace(get_reduced(arch),
                                   decode_seq_shard=get_config(arch).decode_seq_shard)
    for shape in MESHES:
        mesh = init_device_mesh("cpu", shape, mesh_dim_names=("data", "model"))
        rows = slice(mesh.get_local_rank("data") * B // shape[0],
                     (mesh.get_local_rank("data") + 1) * B // shape[0])
        for arch in ARCHS:
            cfg = get_reduced_served(arch)
            with open(os.path.join(tmp, arch + ".pkl"), "rb") as f:
                model = lm_params_from_arrays(cfg, pickle.load(f), device="cpu")
            rules = default_rules(mesh)
            pc = PS.build_cell(cfg, "serve_prefill", mesh, rules)
            dc = PS.build_cell(cfg, "serve_decode", mesh, rules)
            params = shard_params(model.params, pc.tp)
            tag = f"{arch}.{shape[0]}x{shape[1]}"
            batch = {"tokens": torch.from_numpy(TOKENS[arch][rows])}
            if cfg.prefix_len:
                batch["prefix_embeds"] = torch.from_numpy(
                    PREFIX[rows, :cfg.prefix_len, :cfg.d_model].copy())
            if cfg.arch_type == "encdec":
                batch["frames"] = torch.from_numpy(FRAMES_IN[rows])
                logits, caches, enc = pc.fn(params, batch)
            else:
                logits, caches = pc.fn(params, batch)
            if cfg.decode_seq_shard:
                caches = T.shard_caches(cfg, caches, mesh, tp=pc.tp)
            logs, toks = [logits[:, -1]], []
            for i in range(STEPS):
                tok = logits[:, -1].argmax(-1)
                toks.append(tok)
                step = {"tokens": tok[:, None].int(),
                        "pos": torch.full((tok.shape[0],), cfg.prefix_len + P + i,
                                          dtype=torch.int32)}
                if cfg.arch_type == "encdec":
                    step["enc_out"] = enc
                logits, caches = dc.fn(params, caches, step)
                logs.append(logits[:, -1])
            out[tag + ".logits"] = torch.stack(logs).numpy()
            out[tag + ".tokens"] = torch.stack(toks).numpy()
            for li, (c, spec) in enumerate(zip(caches, dc.in_shardings[1])):
                for k, t in c.items():
                    out[f"{tag}.cache{li}.{k}"] = whole(t, spec[k], mesh).numpy()

    # block_apply under tp with a cache and a decode step; int8 KV with the
    # sequence-sharded decode refused
    mesh = init_device_mesh("cpu", (1, 4), mesh_dim_names=("data", "model"))
    for int8 in (False, True):
        cfg = dataclasses.replace(get_reduced_served("gemma3-4b"),
                                  kv_cache_dtype="int8" if int8 else "model")
        sm = lm_params_from_arrays(cfg, pickle.load(open(os.path.join(tmp, "gemma3-4b.pkl"), "rb")),
                                   device="cpu").shard(mesh, default_rules(mesh))
        x = torch.randn((2, 4, cfg.d_model), generator=torch.Generator().manual_seed(0))
        kind = cfg.pattern[0]
        cache = BL.block_cache(kind, cfg, 2, 8, torch.float32, "cpu", sm.tp,
                               sm.tp.dims["layers"][0], 4)
        with torch.inference_mode():
            try:
                pre = BL.block_cache(kind, cfg, 2, 8, torch.float32, "cpu", sm.tp,
                                     sm.tp.dims["layers"][0])
                BL.block_apply(kind, cfg, sm.params["layers"][0], x, torch.arange(4), cache=pre,
                               tp=sm.tp)
                BL.block_apply(kind, cfg, sm.params["layers"][0], x[:, :1],
                               torch.full((2,), 4), cache=cache, decode=True, mesh=mesh,
                               tp=sm.tp)
                out[f"block.int8_{int8}"] = np.array("ran")
            except NotImplementedError as e:
                out[f"block.int8_{int8}"] = np.array("refused: " + str(e))
    if rank == 0:
        np.savez(os.path.join(tmp, "port.npz"), **out)
    else:
        np.savez(os.path.join(tmp, f"port{rank}.npz"), **{k: v for k, v in out.items()
                                                        if k.endswith((".logits", ".tokens"))})
    dist.destroy_process_group()
""")

REF_CODE = textwrap.dedent("""
    import dataclasses
    import jax, jax.numpy as jnp
    from repro.configs import get_config, get_reduced
    from repro.launch import steps as RS
    from repro.launch.shapes import ShapeCell
    from repro.models import model as RM
    from repro.runtime.jax_compat import make_mesh, set_mesh
    from repro.sharding.rules import default_rules
    for name, (kind, seq, gb) in SERVE.items():
        RS.SHAPES[name] = ShapeCell(name, kind, seq, gb)
    out, caches_out = {}, {}
    for arch in ARCHS:
        cfg = dataclasses.replace(get_reduced(arch),
                                  decode_seq_shard=get_config(arch).decode_seq_shard)
        with open(TMP + "/" + arch + ".pkl", "rb") as f:
            tree = pickle.load(f)
        shapes, _ = RM.abstract_params(cfg)
        params = jax.tree.map(lambda a, s: jnp.asarray(a, s.dtype), tree, shapes)
        for shape in [MESHES[MESH_I]]:
            mesh = make_mesh(shape, ("data", "model"))
            rules = default_rules(mesh)
            pc = RS.build_cell(cfg, "serve_prefill", mesh, rules)
            dc = RS.build_cell(cfg, "serve_decode", mesh, rules)
            tag = f"{arch}.{shape[0]}x{shape[1]}"
            with set_mesh(mesh):
                batch = {"tokens": jnp.asarray(TOKENS[arch])}
                if cfg.prefix_len:
                    batch["prefix_embeds"] = jnp.asarray(PREFIX[:, :cfg.prefix_len, :cfg.d_model])
                if cfg.arch_type == "encdec":
                    batch["frames"] = jnp.asarray(FRAMES_IN)
                    logits, caches, enc = pc.fn(params, batch)
                else:
                    logits, caches = pc.fn(params, batch)
                logs, toks = [np.asarray(logits[:, -1])], []
                for i in range(STEPS):
                    tok = jnp.argmax(logits[:, -1], axis=-1)
                    toks.append(np.asarray(tok))
                    step = {"tokens": tok[:, None].astype(jnp.int32),
                            "pos": jnp.full((B,), cfg.prefix_len + P + i, jnp.int32)}
                    if cfg.arch_type == "encdec":
                        step["enc_out"] = enc
                    # the caches and the step laid out as the decode cell takes them
                    caches = jax.device_put(caches, dc.in_shardings[1])
                    step = jax.device_put(step, dc.in_shardings[2])
                    logits, caches = dc.fn(params, caches, step)
                    logs.append(np.asarray(logits[:, -1]))
            out[tag + ".logits"] = np.stack(logs)
            out[tag + ".tokens"] = np.stack(toks)
            caches_out[tag] = jax.tree.map(np.asarray, caches)
    np.savez(TMP + f"/ref{MESH_I}.npz", **out)
    with open(TMP + f"/ref_caches{MESH_I}.pkl", "wb") as f:
        pickle.dump(caches_out, f)
    print("ok")
""")


def _consts() -> str:
    return (f"ARCHS = {ARCHS!r}\nMESHES = {MESHES!r}\nSERVE = {SERVE!r}\nB = {B}\nP = {P}\n"
            f"STEPS = {STEPS}\nFRAMES_N = {FRAMES}\n") + COMMON


@pytest.fixture(scope="module")
def served():
    with tempfile.TemporaryDirectory() as tmp:
        for arch in ARCHS:
            with open(os.path.join(tmp, arch + ".pkl"), "wb") as f:
                pickle.dump(ref_weights(RC.get_reduced(arch), 7), f)
        env = dict(os.environ, PYTHONPATH=SRC + os.pathsep + os.environ.get("PYTHONPATH", ""),
                   OMP_NUM_THREADS="1")
        procs = [subprocess.Popen([sys.executable, "-c", _consts() + RANK_CODE, str(k),
                                   str(RANKS), tmp], env=env, stdout=subprocess.PIPE,
                                  stderr=subprocess.PIPE, text=True) for k in range(RANKS)]
        try:
            # the reference on each mesh in a process of its own, side by side
            with concurrent.futures.ThreadPoolExecutor(len(MESHES)) as ex:
                list(ex.map(lambda i: run_with_devices(
                    f"TMP = {tmp!r}\nMESH_I = {i}\n" + _consts() + REF_CODE, n_devices=RANKS,
                    timeout=300), range(len(MESHES))))
            errs = [p.communicate(timeout=300)[1] for p in procs]
        finally:
            for p in procs:
                p.kill()
                p.wait()
        for k, p in enumerate(procs):
            assert p.returncode == 0, f"rank {k} failed:\n{errs[k][-3000:]}"
        ref, ref_caches = {}, {}
        for i in range(len(MESHES)):
            ref.update(np.load(os.path.join(tmp, f"ref{i}.npz")))
            with open(os.path.join(tmp, f"ref_caches{i}.pkl"), "rb") as f:
                ref_caches.update(pickle.load(f))
        ranks = [dict(np.load(os.path.join(tmp, "port.npz" if k == 0 else f"port{k}.npz")))
                 for k in range(RANKS)]
    return ref, ref_caches, ranks


def _rows(k: int, shape) -> slice:
    """Rank ``k``'s rows of the batch on a (data, model) mesh of ``shape``."""
    d = k // shape[1]
    return slice(d * B // shape[0], (d + 1) * B // shape[0])


CASES = [(a, s) for s in MESHES for a in ARCHS]


def _id(case) -> str:
    return f"{case[0]}-{case[1][0]}x{case[1][1]}"


@pytest.mark.parametrize("case", CASES, ids=_id)
def test_logits_and_tokens(served, case):
    ref, _, ranks = served
    arch, shape = case
    tag = f"{arch}.{shape[0]}x{shape[1]}"
    want, want_tok = ref[tag + ".logits"], ref[tag + ".tokens"]
    for k, out in enumerate(ranks):
        rows = _rows(k, shape)
        got = out[tag + ".logits"]
        scale = np.abs(want[:, rows]).max()
        err = np.abs(got - want[:, rows]).max() / scale
        assert err <= TOL, f"rank {k}: logits off by {err:.2e} of max |logits|"
        np.testing.assert_array_equal(out[tag + ".tokens"], want_tok[:, rows])


@pytest.mark.parametrize("case", CASES, ids=_id)
def test_caches_gathered(served, case):
    _, ref_caches, ranks = served
    arch, shape = case
    tag = f"{arch}.{shape[0]}x{shape[1]}"
    cfg = PC.get_reduced(arch)
    want = lm_caches_from_arrays(cfg, ref_caches[tag], device="cpu")
    out = ranks[0]
    for li, layer in enumerate(want):
        for k, t in layer.items():
            got = out[f"{tag}.cache{li}.{k}"]
            w = t.numpy()
            assert got.shape == w.shape, (li, k, got.shape, w.shape)
            if k == "slot_pos":
                np.testing.assert_array_equal(got, w)
            else:
                scale = max(np.abs(w).max(), 1e-30)
                assert np.abs(got - w).max() <= TOL * scale, (li, k)


def test_block_apply_serves_under_tp(served):
    """block_apply runs a prefill and a sequence-sharded decode step with
    ``tp`` (the former refusal of a cache or a decode under tensor
    parallelism is gone)."""
    assert str(served[2][0]["block.int8_False"]) == "ran"


def test_int8_kv_with_seq_shard_refused(served):
    msg = str(served[2][0]["block.int8_True"])
    assert msg.startswith("refused") and "int8" in msg
