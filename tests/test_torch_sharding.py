"""The port's sharding rules and sequence-sharded decode against the
reference's.

Rules: for all ten full configurations on the production meshes (16, 16)
and (2, 16, 16), with ``default_rules`` sequence-sharded and not, every
parameter's spec equals the reference's ``spec_for_axes`` entry by entry,
and the ``fallbacks`` lists are equal string for string; both packages
read only the mesh's axis names and sizes, so the port's
``make_production_mesh`` shape stands in for both meshes (no devices).

Decode: the sequence-sharded split-KV decode on four gloo ranks (a mesh of
data 1 x model 4, each rank a quarter of every cache's slots) against the
reference's ``shard_map`` decode on four forced host devices, for
gemma3-4b's (sliding-window caches of 8 slots: two a rank) and
granite-moe's reduced configurations in f32, a prefill of 12 tokens and 5
decode steps: logits and caches (the ranks' shards put back together)
within ``TOL``, slot positions equal; the same four ranks against the
port's unsharded decode within ``TOL``; the reference's refusal of int8 KV
with the sequence-sharded decode, message and all.
"""
import dataclasses
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
from repro.models import blocks as RB  # noqa: E402
from repro.models import model as RM  # noqa: E402
from repro.sharding import rules as RR  # noqa: E402
from repro_torch import configs as PC  # noqa: E402
from repro_torch.ckpt.manager import _flatten  # noqa: E402
from repro_torch.interop import lm_params_from_arrays  # noqa: E402
from repro_torch.launch.mesh import make_production_mesh  # noqa: E402
from repro_torch.models import blocks as PB  # noqa: E402
from repro_torch.models.model import abstract_params  # noqa: E402
from repro_torch.sharding import rules as PR  # noqa: E402
from repro_torch.train.loop import build_shardings  # noqa: E402

from tests.test_torch_lm_model import ref_weights  # noqa: E402
from tests.util import run_with_devices  # noqa: E402

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
# f32 logits of unit scale: the split-KV combine sums the four shards'
# partial statistics in another order than one softmax does
TOL = dict(atol=2e-5, rtol=1e-5)
RANKS = 4
ARCHS = ("gemma3-4b", "granite-moe-1b-a400m")
PROMPT, STEPS, MAX_SEQ, ROWS = 12, 5, 32, 2


class _Model:
    """The two attributes ``build_shardings`` reads, without allocating."""

    def __init__(self, cfg):
        self.cfg = cfg

    def param_specs(self):
        return abstract_params(self.cfg)


@pytest.mark.parametrize("seq_shard", [False, True])
@pytest.mark.parametrize("multi_pod", [False, True])
@pytest.mark.parametrize("arch", PC.ALL_ARCHS)
def test_specs_and_fallbacks_match_reference(arch, multi_pod, seq_shard):
    mesh = make_production_mesh(multi_pod=multi_pod)
    rrules = RR.default_rules(mesh, seq_shard=seq_shard)
    prules = PR.default_rules(mesh, seq_shard=seq_shard)
    assert prules.rules == rrules.rules
    shapes, logical = RM.abstract_params(RC.get_config(arch))
    want = jax.tree.map(
        lambda s, ax: tuple(RR.spec_for_axes(mesh, rrules, tuple(ax), s.shape)),
        shapes, logical, is_leaf=lambda x: isinstance(x, jax.ShapeDtypeStruct))
    want = {jax.tree_util.keystr(k): v for k, v in
            jax.tree_util.tree_flatten_with_path(want, is_leaf=lambda x: isinstance(x, tuple))[0]}
    got_shapes, _, got = build_shardings(_Model(PC.get_config(arch)), mesh, prules)
    got = dict(_flatten(got, tuples_are_leaves=True))
    assert got == want
    assert prules.fallbacks == rrules.fallbacks
    assert {p: tuple(t.shape) for p, t in _flatten(got_shapes)} == {
        jax.tree_util.keystr(k): tuple(s.shape)
        for k, s in jax.tree_util.tree_flatten_with_path(shapes)[0]}


def test_spec_for_axes_drops_a_repeated_axis():
    mesh = make_production_mesh()
    rules = PR.default_rules(mesh)
    spec = PR.spec_for_axes(mesh, rules, ("heads", "ffn", None), (32, 64, 3))
    assert spec == tuple(RR.spec_for_axes(mesh, RR.default_rules(mesh), ("heads", "ffn", None),
                                          (32, 64, 3))) == ("model", None, None)


def test_int8_kv_refused_with_the_reference_message():
    cfgs = [dataclasses.replace(pkg.get_reduced("deepseek-7b"), kv_cache_dtype="int8",
                                decode_seq_shard=True) for pkg in (RC, PC)]
    rtree = ref_weights(cfgs[0], 0)
    x = np.random.default_rng(0).standard_normal((1, 1, cfgs[0].d_model)).astype(np.float32)
    layer0 = jax.tree.map(lambda a: a[0], rtree["cycles"][0])
    msgs = []
    with pytest.raises(NotImplementedError) as e:
        RB.block_apply("attn+mlp", cfgs[0], layer0, x, np.array([3]),
                       cache=RB.block_cache("attn+mlp", cfgs[0], 1, 8, np.float32),
                       decode=True, mesh=object())
    msgs.append(str(e.value))
    model = lm_params_from_arrays(cfgs[1], rtree, device="cpu")
    with pytest.raises(NotImplementedError) as e:
        PB.block_apply("attn+mlp", cfgs[1], model.params["layers"][0], torch.from_numpy(x),
                       torch.tensor([3]), cache=PB.block_cache("attn+mlp", cfgs[1], 1, 8,
                                                               torch.float32, "cpu"),
                       decode=True, mesh=object())
    msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


# four ranks: gloo subprocesses against the reference on four host devices
# ---------------------------------------------------------------------------

RANK_CODE = textwrap.dedent("""
    import dataclasses, datetime, os, pickle, sys
    import numpy as np
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    rank, world, tmp = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    dist.init_process_group(
        "gloo", store=dist.FileStore(os.path.join(tmp, "store"), world),
        rank=rank, world_size=world, timeout=datetime.timedelta(seconds=120))
    from repro_torch.configs import get_reduced
    from repro_torch.interop import lm_params_from_arrays
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models.transformer import decode_rows, shard_caches
    mesh = make_debug_mesh(n_data=1, n_model=world, device_type="cpu")
    out = {}
    for arch in ARCHS:
        cfg = dataclasses.replace(get_reduced(arch), decode_seq_shard=True)
        z = np.load(os.path.join(tmp, arch + ".npz"))
        with open(os.path.join(tmp, arch + ".pkl"), "rb") as f:
            tree = pickle.load(f)
        model = lm_params_from_arrays(cfg, tree, device="cpu")
        toks = torch.from_numpy(z["toks"])
        with torch.inference_mode():
            _, caches = model.prefill(toks[:, :PROMPT], MAX_SEQ)
            caches = shard_caches(cfg, caches, mesh)
            rows = decode_rows(cfg, mesh, toks.shape[0])
            logits = []
            for i in range(STEPS):
                pos = torch.full((rows.stop - rows.start,), PROMPT + i)
                lg, caches = model.decode_step(caches, toks[rows, PROMPT + i:PROMPT + i + 1],
                                               pos, mesh=mesh)
                logits.append(lg.numpy())
        out[arch + ".logits"] = np.concatenate(logits, 1)
        for i, c in enumerate(caches):
            for k, v in c.items():
                out[f"{arch}.cache{i}.{k}"] = v.numpy()
    np.savez(os.path.join(tmp, f"port{rank}.npz"), **out)
    dist.destroy_process_group()
""")

REF_CODE = textwrap.dedent("""
    import dataclasses, pickle
    import numpy as np, jax, jax.numpy as jnp
    from repro.configs import get_reduced
    from repro.models import model as RM
    from repro.runtime.jax_compat import make_mesh, set_mesh
    mesh = make_mesh((1, WORLD), ("data", "model"))
    out = {}
    for arch in ARCHS:
        cfg = dataclasses.replace(get_reduced(arch), decode_seq_shard=True)
        tree = pickle.load(open(TMP + "/" + arch + ".pkl", "rb"))
        shapes, _ = RM.abstract_params(cfg)
        params = jax.tree.map(lambda a, s: jnp.asarray(a, s.dtype), tree, shapes)
        m = RM.build_model(cfg)
        toks = np.load(TMP + "/" + arch + ".npz")["toks"].astype(np.int32)
        _, caches = jax.jit(lambda p, t: m.prefill(p, t, MAX_SEQ))(params, toks[:, :PROMPT])
        step = jax.jit(lambda p, c, t, pos: m.decode_step(p, c, t, pos, mesh=mesh))
        logits = []
        with set_mesh(mesh):
            for i in range(STEPS):
                pos = jnp.full((toks.shape[0],), PROMPT + i, jnp.int32)
                lg, caches = step(params, caches, toks[:, PROMPT + i:PROMPT + i + 1], pos)
                logits.append(np.asarray(lg))
        out[arch + ".logits"] = np.concatenate(logits, 1)
        for j, c in enumerate(caches["cycles"]):
            for k, v in c.items():
                out[f"{arch}.cycles{j}.{k}"] = np.asarray(v)
        for j, c in enumerate(caches["rem"]):
            for k, v in c.items():
                out[f"{arch}.rem{j}.{k}"] = np.asarray(v)
    np.savez(TMP + "/ref.npz", **out)
    print("ok")
""")


def _consts() -> str:
    return (f"ARCHS = {ARCHS!r}\nPROMPT, STEPS, MAX_SEQ = {PROMPT}, {STEPS}, {MAX_SEQ}\n"
            f"WORLD = {RANKS}\n")


@pytest.fixture(scope="module")
def four_ranks():
    """Both four-way decodes of each arch on the same weights and tokens."""
    import pickle

    with tempfile.TemporaryDirectory() as tmp:
        for seed, arch in enumerate(ARCHS):
            cfg = dataclasses.replace(RC.get_reduced(arch), decode_seq_shard=True)
            with open(os.path.join(tmp, arch + ".pkl"), "wb") as f:
                pickle.dump(ref_weights(cfg, seed), f)
            toks = np.random.default_rng(10 + seed).integers(0, cfg.vocab,
                                                             (ROWS, PROMPT + STEPS))
            np.savez(os.path.join(tmp, arch + ".npz"), toks=toks)
        # one thread a rank: four ranks beside the reference's process
        env = dict(os.environ, PYTHONPATH=SRC + os.pathsep + os.environ.get("PYTHONPATH", ""),
                   OMP_NUM_THREADS="1")
        procs = [subprocess.Popen([sys.executable, "-c", _consts() + RANK_CODE, str(k),
                                   str(RANKS), tmp], env=env, stdout=subprocess.PIPE,
                                  stderr=subprocess.PIPE, text=True) for k in range(RANKS)]
        try:
            run_with_devices(f"TMP = {tmp!r}\n" + _consts() + REF_CODE, n_devices=RANKS,
                             timeout=300)
            errs = [p.communicate(timeout=300)[1] for p in procs]
        finally:
            for p in procs:
                p.kill()
                p.wait()
        for k, p in enumerate(procs):
            assert p.returncode == 0, f"rank {k} failed:\n{errs[k][-3000:]}"
        ref = dict(np.load(os.path.join(tmp, "ref.npz")))
        ranks = [dict(np.load(os.path.join(tmp, f"port{k}.npz"))) for k in range(RANKS)]
        weights = {a: pickle.load(open(os.path.join(tmp, a + ".pkl"), "rb")) for a in ARCHS}
        toks = {a: np.load(os.path.join(tmp, a + ".npz"))["toks"] for a in ARCHS}
    return ref, ranks, weights, toks


def _joined(ranks, arch, i, k):
    """Layer ``i``'s cache entry ``k``, the ranks' slot shards in order."""
    return np.concatenate([r[f"{arch}.cache{i}.{k}"] for r in ranks], axis=1)


@pytest.mark.parametrize("arch", ARCHS)
def test_four_ranks_match_reference(four_ranks, arch):
    ref, ranks, _, _ = four_ranks
    for r in ranks:  # every rank holds every row's logits
        np.testing.assert_allclose(r[arch + ".logits"], ref[arch + ".logits"], **TOL)
    cfg = PC.get_reduced(arch)
    from repro_torch.models.transformer import _layer_plan, layer_kinds

    n_cycles, rem = _layer_plan(cfg)
    c = len(cfg.pattern)
    for i, kind in enumerate(layer_kinds(cfg)):
        if i < n_cycles * c:
            want = {k: ref[f"{arch}.cycles{i % c}.{k}"][i // c] for k in ("k", "v", "slot_pos")}
        else:
            want = {k: ref[f"{arch}.rem{i - n_cycles * c}.{k}"] for k in ("k", "v", "slot_pos")}
        np.testing.assert_array_equal(_joined(ranks, arch, i, "slot_pos"), want["slot_pos"])
        for k in ("k", "v"):
            np.testing.assert_allclose(_joined(ranks, arch, i, k), want[k], **TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_four_ranks_match_unsharded_port(four_ranks, arch):
    _, ranks, weights, toks = four_ranks
    cfg = PC.get_reduced(arch)
    model = lm_params_from_arrays(cfg, weights[arch], device="cpu")
    t = torch.from_numpy(toks[arch])
    with torch.inference_mode():
        _, caches = model.prefill(t[:, :PROMPT], MAX_SEQ)
        logits = []
        for i in range(STEPS):
            lg, caches = model.decode_step(caches, t[:, PROMPT + i:PROMPT + i + 1],
                                           torch.full((ROWS,), PROMPT + i))
            logits.append(lg.numpy())
    np.testing.assert_allclose(ranks[0][arch + ".logits"], np.concatenate(logits, 1), **TOL)
    for i, c in enumerate(caches):
        np.testing.assert_array_equal(_joined(ranks, arch, i, "slot_pos"), c["slot_pos"].numpy())
        for k in ("k", "v"):
            np.testing.assert_allclose(_joined(ranks, arch, i, k), c[k].numpy(), **TOL)
