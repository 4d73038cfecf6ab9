"""The port's training path against the reference's, on the CPU.

* AdamW (``train.optim``): ``lr_at`` within one f32 ulp of the
  reference's; ``clip_by_global_norm`` and ``adamw_update`` fed the
  reference's exact gradients and state, step by step: the clipped
  gradients, ``m``, ``v`` and f32 parameters within one ulp (the norm
  within ``NORM_ULPS``: both sum squares in their own order), bf16
  parameters bit for bit.
* ``TokenDataset``: the reference's batches bit for bit, restartable, each
  data rank a contiguous slice.
* Gradients of ``loss_fn`` against ``jax.grad`` for one reduced
  configuration of each family (dense, MoE, RG-LRU, mLSTM/sLSTM,
  encoder-decoder, the vision prefix) within ``GRAD_TOL`` of each leaf's
  largest entry, the port under remat "none" and "full" alike, and at 48
  tokens through the chunked attentions; on the port every remat policy
  gives the same bits.
* ``make_train_step``: three steps on one rank against the reference's on
  one device (microbatches, zero1; zero2 too); microbatch equivalence;
  ZeRO-1 over four gloo ranks against the reference's shards on four host
  devices (specs, shard shapes and values), ZeRO-2 too; manual-dp with
  ``grad_compress`` on four gloo ranks against the reference on four host
  devices.

The trajectory rule: AdamW's first steps move each entry by ~lr whatever
|g| is (m / sqrt(v) ~ sign(g)), so a gradient within rounding of zero may
move an entry either way, 2 lr apart. So the gradients (and the losses)
are held tightly; the parameters are held within ``PARAM_ATOL`` only
where sqrt(v) > ``CLEAR`` (the gradient is clear of rounding), and
everywhere within the 2 lr a step can move an entry. With int8 gradient
compression the rounding unit is the quantum (a tensor's absmax / 127,
summed over four ranks): a value on a rounding edge rounds either way on
either side, so one step is held entry by entry (equal, or a lattice step
a rank apart in the compressed gradient and then within 2 lr), and three
steps by their losses and their parameters at all but 0.1% of the entries.
"""
import dataclasses
import functools
import os
import subprocess
import sys
import tempfile
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro import configs as RC  # noqa: E402
from repro.data import tokens as RT  # noqa: E402
from repro.launch.mesh import make_debug_mesh as r_debug_mesh  # noqa: E402
from repro.models import model as RM  # noqa: E402
from repro.runtime.jax_compat import set_mesh  # noqa: E402
from repro.sharding.rules import default_rules as r_rules  # noqa: E402
from repro.train import loop as RL  # noqa: E402
from repro.train import optim as RO  # noqa: E402
from repro_torch import configs as PC  # noqa: E402
from repro_torch.ckpt.manager import _flatten  # noqa: E402
from repro_torch.data import tokens as PT  # noqa: E402
from repro_torch.interop import lm_params_from_arrays, reference_layout  # noqa: E402
from repro_torch.models.layers import tree_leaves, tree_map  # noqa: E402
from repro_torch.sharding.rules import default_rules  # noqa: E402
from repro_torch.train import loop as PL  # noqa: E402
from repro_torch.train import optim as PO  # noqa: E402

from tests.test_torch_lm_model import _ref_params, ref_weights  # noqa: E402
from tests.util import run_with_devices  # noqa: E402

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
NORM_ULPS = 16  # two summation orders of ~2,500 squares (a few ulps each way)
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)   # atol relative to the leaf's largest |g|
LOSS_TOL = dict(rtol=1e-5, atol=0.0)
PARAM_ATOL = 2e-5                       # 3 steps at lr 1e-3
CLEAR = 1e-6
OPT = dict(lr=1e-3, warmup_steps=2, total_steps=10)
FAMILIES = ("olmo-1b", "qwen2-moe-a2.7b", "recurrentgemma-2b", "xlstm-350m",
            "whisper-tiny", "internvl2-76b")


def _ulps(a, b) -> int:
    a = np.ascontiguousarray(a, np.float32).view(np.int32).astype(np.int64)
    b = np.ascontiguousarray(b, np.float32).view(np.int32).astype(np.int64)
    return int(np.abs(a - b).max()) if a.size else 0


def _t(a, dtype=None):
    return torch.from_numpy(np.array(a, dtype=np.float32)).to(dtype or torch.float32)


# ------------------------------------------------------------------ optim

@pytest.mark.parametrize("cfg", [dict(warmup_steps=0, total_steps=100),
                                 dict(warmup_steps=10, total_steps=100, min_lr_ratio=0.1),
                                 dict(lr=3e-4, warmup_steps=2, total_steps=8)])
def test_lr_at_matches_reference(cfg):
    rc, pc = RO.AdamWConfig(**cfg), PO.AdamWConfig(**cfg)
    for step in range(0, 130, 3):
        want = np.float32(RO.lr_at(rc, jnp.int32(step)))
        got = PO.lr_at(pc, torch.tensor(step, dtype=torch.int32)).numpy()
        assert _ulps(got, want) <= 1, (step, got, want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_clip_and_adamw_match_reference(dtype):
    rng = np.random.default_rng(0)
    shapes = {"a": (64, 32), "b": [(16,), (8, 4, 4)], "c": {"d": (200,)}}
    is_shape = lambda x: isinstance(x, tuple)  # noqa: E731
    draw = lambda s: (rng.standard_normal(s) * 0.3).astype(np.float32)  # noqa: E731
    p_np = jax.tree.map(draw, shapes, is_leaf=is_shape)
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "float32" else (jnp.bfloat16,
                                                                          torch.bfloat16)
    rcfg, pcfg = RO.AdamWConfig(**OPT), PO.AdamWConfig(**OPT)
    rp = jax.tree.map(lambda a: jnp.asarray(a, jdt), p_np)
    rstate = RO.init_opt_state(rp)
    for step in range(4):
        # the reference's exact gradients, larger than the clip norm on step 0
        g_np = jax.tree.map(lambda s: draw(s) * (3.0 if step == 0 else 0.01), shapes,
                            is_leaf=is_shape)
        rg = jax.tree.map(lambda a: jnp.asarray(a, jdt), g_np)
        pg = tree_map(lambda a: torch.from_numpy(np.array(jnp.asarray(a, jnp.float32)))
                      .to(tdt), g_np)
        pp = tree_map(lambda a: torch.from_numpy(np.array(a.astype(jnp.float32))).to(tdt),
                      rp)
        pstate = {"m": tree_map(lambda a: torch.from_numpy(np.array(a)), rstate["m"]),
                  "v": tree_map(lambda a: torch.from_numpy(np.array(a)), rstate["v"]),
                  "step": torch.tensor(int(rstate["step"]), dtype=torch.int32)}
        rclip, rnorm = RO.clip_by_global_norm(rg, 1.0)
        pclip, pnorm = PO.clip_by_global_norm(pg, 1.0)
        k = _ulps(pnorm.numpy(), np.float32(rnorm))
        assert k <= NORM_ULPS
        rnew, rstate_new, rmet = RO.adamw_update(rcfg, rp, rg, rstate)
        pnew, pstate_new, pmet = PO.adamw_update(pcfg, pp, pg, pstate)
        assert int(pstate_new["step"]) == int(rstate_new["step"]) == step + 1
        assert _ulps(pmet["lr"].numpy(), np.float32(rmet["lr"])) <= 1
        if step == 0:
            # a clipped step: the gradients, m and v carry the norm's relative
            # error (v squared), on top of one rounding of each op (the
            # scale's division, the product, m's and v's updates)
            eps32 = 2.0 ** -23
            rel = abs(float(pnorm) / float(rnorm) - 1.0)
            pairs = [(pclip, rclip, rel + 2 * eps32), (pstate_new["m"], rstate_new["m"],
                                                       rel + 3 * eps32),
                     (pstate_new["v"], rstate_new["v"], 2 * rel + 5 * eps32)]
            for got, want, rtol in pairs:
                for a, b in zip(tree_leaves(got), jax.tree.leaves(want)):
                    np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=rtol, atol=0)
        else:  # scale 1: the same inputs, one rounding apart at most
            for a, b in zip(tree_leaves(pclip), jax.tree.leaves(rclip)):
                assert _ulps(a.numpy(), np.asarray(b)) == 0
            for key in ("m", "v"):
                for a, b in zip(tree_leaves(pstate_new[key]),
                                jax.tree.leaves(rstate_new[key])):
                    assert _ulps(a.numpy(), np.asarray(b)) <= 1
        for a, b in zip(tree_leaves(pnew), jax.tree.leaves(rnew)):
            if dtype == "bfloat16":
                np.testing.assert_array_equal(a.float().numpy(),
                                              np.asarray(b.astype(jnp.float32)))
            elif dtype == "float32":
                # m / sqrt(v) cancels the clip's scale: one ulp whatever k is
                assert _ulps(a.numpy(), np.asarray(b)) <= 1
        rp, rstate = rnew, rstate_new


def test_clip_passes_layers_of_another_zero2_rank():
    """Under ZeRO-2 a layer owned whole by another data rank has no
    gradient on this one (None): the clip scales the others by the global
    norm it is given and passes the None on (the production dry-run's
    internvl2-76b train cell, 80 layers over 16 data ranks)."""
    out, norm = PO.clip_by_global_norm({"a": torch.full((3,), 2.0), "b": None}, 1.0,
                                       norm=torch.tensor(4.0))
    assert out["b"] is None and float(norm) == 4.0
    torch.testing.assert_close(out["a"], torch.full((3,), 0.5))


# ------------------------------------------------------------------ data

def test_token_dataset_bit_for_bit_and_restartable():
    kw = dict(vocab=97, seq_len=16, global_batch=8, seed=3, structure=0.7)
    ref = RT.TokenDataset(RT.TokenDatasetConfig(**kw), prefix_len=2, d_model=8)
    ours = PT.TokenDataset(PT.TokenDatasetConfig(**kw), prefix_len=2, d_model=8, device="cpu")
    for step in (0, 5, 6):
        want, got = ref(step), ours(step)
        assert sorted(want) == sorted(got)
        for k in want:
            assert got[k].dtype == (torch.int32 if k != "prefix_embeds" else torch.float32)
            np.testing.assert_array_equal(got[k].numpy(), want[k])
    again = PT.TokenDataset(PT.TokenDatasetConfig(**kw), prefix_len=2, d_model=8, device="cpu")
    np.testing.assert_array_equal(again(5)["tokens"].numpy(), ref(5)["tokens"])
    frames = PT.TokenDataset(PT.TokenDatasetConfig(**kw), frames=True, d_model=8, device="cpu")
    np.testing.assert_array_equal(
        frames(2)["frames"].numpy(),
        RT.TokenDataset(RT.TokenDatasetConfig(**kw), frames=True, d_model=8)(2)["frames"])


class _DataMesh:
    """The surface of a ("data", "model") DeviceMesh that data ranks read."""

    mesh_dim_names = ("data", "model")

    def __init__(self, n: int, rank: int):
        self.shape, self.rank = (n, 1), rank

    def get_local_rank(self, ax):
        return self.rank if ax == "data" else 0


def test_token_dataset_rank_slices():
    kw = dict(vocab=97, seq_len=8, global_batch=8, seed=1)
    want = RT.TokenDataset(RT.TokenDatasetConfig(**kw))(4)["labels"]
    parts = [PT.TokenDataset(PT.TokenDatasetConfig(**kw), mesh=_DataMesh(4, r),
                             device="cpu")(4)["labels"].numpy() for r in range(4)]
    np.testing.assert_array_equal(np.concatenate(parts), want)
    with pytest.raises(ValueError):
        PT.TokenDataset(PT.TokenDatasetConfig(**{**kw, "global_batch": 6}),
                        mesh=_DataMesh(4, 0), device="cpu")


@pytest.mark.parametrize("global_batch,nm", [(8, 4), (12, 2), (8, 1), (4, 4)])
def test_token_dataset_uneven_microbatch_rows(global_batch, nm):
    """Rank r of 4 holds rows [r c, min(b, (r + 1) c)) of each of the nm
    microbatches of b = B / nm rows (c = ceil(b / 4), GSPMD's shard; the
    batch says c): the ranks' parts of each microbatch, in rank order, are
    the reference's microbatch; the layouts the reference refuses raise."""
    kw = dict(vocab=97, seq_len=8, global_batch=global_batch, seed=1)
    want = RT.TokenDataset(RT.TokenDatasetConfig(**kw))(3)["tokens"]
    b, c = global_batch // nm, -(-(global_batch // nm) // 4)
    parts = []
    for r in range(4):
        batch = PT.TokenDataset(PT.TokenDatasetConfig(**kw), mesh=_DataMesh(4, r),
                                device="cpu", microbatches=nm)(3)
        assert batch.microbatches == nm and batch.shard_rows == c
        held = max(0, min(b, (r + 1) * c) - r * c)
        assert batch["tokens"].shape[0] == nm * held
        parts.append(batch["tokens"].numpy().reshape(nm, held, kw["seq_len"]))
    np.testing.assert_array_equal(np.concatenate(parts, axis=1).reshape(global_batch, -1), want)


@pytest.mark.parametrize("global_batch,nm", [(8, 3), (4, 8), (6, 2)])
def test_token_dataset_refuses_what_the_reference_refuses(global_batch, nm):
    """A global batch that does not split into the microbatches (the
    reference's reshape) or over the 4 data ranks (its input sharding)."""
    with pytest.raises(ValueError, match="does not split"):
        PT.TokenDataset(PT.TokenDatasetConfig(vocab=97, seq_len=8, global_batch=global_batch),
                        mesh=_DataMesh(4, 0), device="cpu", microbatches=nm)


# --------------------------------------------------------- loss gradients

def _batch(cfg, rows=2, seq=16, seed=0) -> dict:
    return RT.TokenDataset(RT.TokenDatasetConfig(vocab=cfg.vocab, seq_len=seq,
                                                 global_batch=rows, seed=seed),
                           prefix_len=cfg.prefix_len, d_model=cfg.d_model,
                           frames=cfg.arch_type == "encdec")(0)


def _port_grads(cfg, tree, batch):
    model = lm_params_from_arrays(cfg, tree, device="cpu")
    leaves = tree_map(lambda t: t.detach().requires_grad_(True), model.params)
    loss, _ = model.loss_fn({k: torch.from_numpy(v) for k, v in batch.items()}, params=leaves)
    gs = torch.autograd.grad(loss, tree_leaves(leaves), allow_unused=True,
                             materialize_grads=True)
    it = iter(gs)
    return float(loss.detach()), tree_map(lambda _: next(it), leaves)


@functools.lru_cache(maxsize=None)
def _ref_grads(rcfg, seq: int):
    """The reference's loss and gradients (``jax.grad``) on seed 0's
    weights and a batch of ``seq`` tokens; the batch and the weights."""
    tree = ref_weights(rcfg, 0)
    rparams = _ref_params(tree, RM.abstract_params(rcfg)[0])
    batch = _batch(rcfg, seq=seq)
    rm = RM.build_model(rcfg)
    (rloss, _), rgrads = jax.jit(jax.value_and_grad(
        lambda p, b: rm.loss_fn(p, b), has_aux=True))(rparams, batch)
    return float(rloss), rgrads, tree, batch


def _check_grads(rcfg, pcfg, seq: int = 16) -> None:
    rloss, rgrads, tree, batch = _ref_grads(rcfg, seq)
    ploss, pgrads = _port_grads(pcfg, tree, batch)
    np.testing.assert_allclose(ploss, rloss, **LOSS_TOL)
    got = reference_layout(pcfg, pgrads, lambda ts: torch.stack(ts))
    flat_got = [t.numpy() for _, t in _flatten(got)]
    want = jax.tree.leaves(rgrads)
    assert len(flat_got) == len(want)
    for a, b in zip(flat_got, want):
        b = np.asarray(b, np.float32)
        np.testing.assert_allclose(a, b, rtol=GRAD_TOL["rtol"],
                                   atol=GRAD_TOL["atol"] * max(np.abs(b).max(), 1e-30))


@pytest.mark.parametrize("remat", ["none", "full"])
@pytest.mark.parametrize("arch", FAMILIES)
def test_loss_grads_match_jax(arch, remat):
    """The port under each remat policy against the reference's
    ``jax.grad`` without remat (``jax.checkpoint`` changes what is kept,
    never the values): one reference compile serves both policies."""
    pcfg = dataclasses.replace(PC.get_reduced(arch), remat=remat)
    _check_grads(RC.get_reduced(arch), pcfg)


# The backward of the chunked online softmax: 48 tokens are more than the
# reduced config's kv_chunk of 32, so olmo runs attention_chunked, and with
# q_chunk 16 attention_chunked_q (the path of olmo-1b's 4,096-token training
# batch, where q_chunk is 2,048 and kv_chunk 1,024).
@pytest.mark.parametrize("q_chunk,remat", [(0, "none"), (16, "full")])
def test_chunked_attention_grads_match_jax(q_chunk, remat):
    rcfg = dataclasses.replace(RC.get_reduced("olmo-1b"), q_chunk=q_chunk)
    pcfg = dataclasses.replace(PC.get_reduced("olmo-1b"), q_chunk=q_chunk, remat=remat)
    assert 48 > rcfg.kv_chunk and (not q_chunk or 48 > q_chunk)
    _check_grads(rcfg, pcfg, seq=48)


@pytest.mark.parametrize("arch", FAMILIES)
def test_remat_keeps_the_bits(arch):
    tree = ref_weights(RC.get_reduced(arch), 1)
    batch = _batch(PC.get_reduced(arch), seed=1)
    runs = {r: _port_grads(dataclasses.replace(PC.get_reduced(arch), remat=r), tree, batch)
            for r in ("none", "full", "dots", "save_tp")}
    for r in ("full", "dots", "save_tp"):
        assert runs[r][0] == runs["none"][0]
        for a, b in zip(tree_leaves(runs[r][1]), tree_leaves(runs["none"][1])):
            assert torch.equal(a, b), r


# ------------------------------------------------------------- train step

def _excused_ok(got_p, want_p, want_v, steps: int) -> None:
    """The trajectory rule of the module docstring, over aligned leaves:
    within PARAM_ATOL where sqrt(v) > CLEAR, everywhere within the 2 lr a
    step an AdamW update can move an entry."""
    bound = 2 * OPT["lr"] * steps
    for p, q, v in zip(got_p, want_p, want_v):
        clear = np.sqrt(v) > CLEAR
        np.testing.assert_allclose(p[clear], q[clear], rtol=0, atol=PARAM_ATOL)
        np.testing.assert_allclose(p, q, rtol=0, atol=bound)


def _ref_arrays(tree):
    return [np.asarray(jnp.asarray(a, jnp.float32)) for a in jax.tree.leaves(tree)]


def _port_arrays(cfg, tree):
    stacked = reference_layout(cfg, tree, lambda ts: torch.stack(ts))
    return [t.float().numpy() for _, t in _flatten(stacked)]


@pytest.mark.parametrize("arch", ["olmo-1b", "deepseek-7b"])
def test_three_steps_match_reference(arch):
    """The arch's TRAIN_OVERRIDES (olmo: microbatches 2, zero1; deepseek:
    4, zero1, zero2), one rank against one device."""
    rcfg, pcfg = RC.get_reduced(arch), PC.get_reduced(arch)
    over = RC.get_train_overrides(arch)
    assert over == PC.get_train_overrides(arch)
    tree = ref_weights(rcfg, 2)
    rp = _ref_params(tree, RM.abstract_params(rcfg)[0])
    mesh = r_debug_mesh()
    rstep, _ = RL.make_train_step(RM.build_model(rcfg), mesh, r_rules(mesh),
                                  RL.TrainConfig(opt=RO.AdamWConfig(**OPT), **over))
    ropt = RO.init_opt_state(rp)
    model = lm_params_from_arrays(pcfg, tree, device="cpu")
    pstep, sh = PL.make_train_step(model, None, default_rules(None),
                                   PL.TrainConfig(opt=PO.AdamWConfig(**OPT), **over))
    assert sh["placements"] is None  # one rank: ZeRO changes nothing
    pp = tree_map(lambda t: t.detach(), model.params)
    popt = PL.init_opt_state(pp)
    dkw = dict(vocab=rcfg.vocab, seq_len=16, global_batch=4, seed=0)
    rds = RT.TokenDataset(RT.TokenDatasetConfig(**dkw))
    pds = PT.TokenDataset(PT.TokenDatasetConfig(**dkw), device="cpu")
    for s in range(3):
        with set_mesh(mesh):
            rp, ropt, rmet = rstep(rp, ropt, rds(s))
        pp, popt, pmet = pstep(pp, popt, pds(s))
        assert sorted(pmet) == sorted(rmet)
        for k in ("loss", "ce", "grad_norm"):
            np.testing.assert_allclose(float(pmet[k]), float(rmet[k]), **LOSS_TOL)
        assert _ulps(pmet["lr"].numpy(), np.float32(rmet["lr"])) <= 1
    want_v = _ref_arrays(ropt["v"])
    for key in ("m", "v"):
        for a, b in zip(_port_arrays(pcfg, popt[key]), _ref_arrays(ropt[key])):
            np.testing.assert_allclose(a, b, rtol=1e-3, atol=1e-7)
    _excused_ok(_port_arrays(pcfg, pp), _ref_arrays(rp), want_v, 3)
    assert int(popt["step"]) == int(ropt["step"]) == 3


def test_microbatch_equivalence():
    """Gradient accumulation over 4 microbatches == one batch (the
    reference's own test and tolerance)."""
    cfg = PC.get_reduced("deepseek-7b")
    tree = ref_weights(RC.get_reduced("deepseek-7b"), 0)
    batch = PT.TokenDataset(PT.TokenDatasetConfig(vocab=cfg.vocab, seq_len=16, global_batch=8,
                                                  seed=0), device="cpu")(0)
    outs = {}
    for nm in (1, 4):
        model = lm_params_from_arrays(cfg, tree, device="cpu")
        step, _ = PL.make_train_step(model, None, default_rules(None),
                                     PL.TrainConfig(microbatches=nm))
        params = tree_map(lambda t: t.detach(), model.params)
        p, _, m = step(params, PL.init_opt_state(params), batch)
        outs[nm] = (tree_leaves(p)[0], float(m["loss"]))
    np.testing.assert_allclose(outs[1][0].numpy(), outs[4][0].numpy(), atol=2e-5)
    assert abs(outs[1][1] - outs[4][1]) < 1e-4


# ------------------------------------------------ four ranks against four devices

RANKS = 4
# per case: arch, TrainConfig fields, steps
CASES = {
    "zero1": ("olmo-1b", dict(zero1=True, microbatches=2), 3),
    "zero2": ("deepseek-7b", dict(zero1=True, zero2_grads=True, microbatches=2), 1),
    "manual1": ("olmo-1b", dict(mode="manual-dp", grad_compress=True), 1),
    "manual3": ("olmo-1b", dict(mode="manual-dp", grad_compress=True), 3),
}

RANK_CODE = textwrap.dedent("""
    import datetime, os, pickle, sys
    import numpy as np
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    rank, world, tmp = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    dist.init_process_group(
        "gloo", store=dist.FileStore(os.path.join(tmp, "store"), world),
        rank=rank, world_size=world, timeout=datetime.timedelta(seconds=120))
    from repro_torch.ckpt.manager import _flatten
    from repro_torch.configs import get_reduced
    from repro_torch.data.tokens import TokenDataset, TokenDatasetConfig
    from repro_torch.interop import lm_params_from_arrays, reference_layout
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models.layers import tree_map
    from repro_torch.sharding.rules import default_rules
    from repro_torch.train import optim
    from repro_torch.train.grad_compress import init_error_tree
    from repro_torch.train.loop import TrainConfig, init_opt_state, make_train_step
    mesh = make_debug_mesh(n_model=1, device_type="cpu")
    out = {}
    for case, (arch, fields, steps) in CASES.items():
        cfg = get_reduced(arch)
        with open(os.path.join(tmp, arch + ".pkl"), "rb") as f:
            model = lm_params_from_arrays(cfg, pickle.load(f), device="cpu")
        tcfg = TrainConfig(opt=optim.AdamWConfig(**OPT), **fields)
        step, sh = make_train_step(model, mesh, default_rules(mesh), tcfg)
        params = tree_map(lambda t: t.detach(), model.params)
        opt = init_opt_state(params, sh["placements"])
        err = init_error_tree(params)
        ds = TokenDataset(TokenDatasetConfig(vocab=cfg.vocab, seq_len=16, global_batch=8,
                                             seed=0), mesh=mesh, device="cpu",
                          microbatches=tcfg.row_microbatches)
        losses = []
        for s in range(steps):
            if fields.get("mode") == "manual-dp":
                params, opt, err, met = step(params, opt, err, ds(s))
            else:
                params, opt, met = step(params, opt, ds(s))
            losses.append(float(met["loss"]))
        out[case + ".loss"] = np.array(losses)
        stack = lambda ts: torch.stack([t for t in ts if t is not None])
        for key, tree in (("p", params), ("m", opt["m"]), ("v", opt["v"]), ("err", err)):
            ref = reference_layout(cfg, tree, stack)
            for i, (_, t) in enumerate(_flatten(ref)):  # the reference's leaf order
                out[f"{case}.{key}{i}"] = t.float().numpy()
    np.savez(os.path.join(tmp, f"port{rank}.npz"), **out)
    dist.destroy_process_group()
""")

REF_CODE = textwrap.dedent("""
    import pickle
    import numpy as np, jax, jax.numpy as jnp
    from repro.configs import get_reduced
    from repro.data.tokens import TokenDataset, TokenDatasetConfig
    from repro.launch.mesh import make_debug_mesh
    from repro.models import model as RM
    from repro.runtime.jax_compat import set_mesh
    from repro.sharding.rules import default_rules
    from repro.train import optim
    from repro.train.grad_compress import init_error_tree
    from repro.train.loop import TrainConfig, make_train_step
    mesh = make_debug_mesh(n_data=WORLD, n_model=1)
    out = {}
    for case, (arch, fields, steps) in CASES.items():
        cfg = get_reduced(arch)
        with open(TMP + "/" + arch + ".pkl", "rb") as f:
            tree = pickle.load(f)
        shapes, _ = RM.abstract_params(cfg)
        params = jax.tree.map(lambda a, s: jnp.asarray(a, s.dtype), tree, shapes)
        step, sh = make_train_step(RM.build_model(cfg), mesh, default_rules(mesh),
                                   TrainConfig(opt=optim.AdamWConfig(**OPT), **fields))
        with set_mesh(mesh):
            opt = jax.jit(optim.init_opt_state, out_shardings=sh["opt"])(params)
            err = init_error_tree(params)
            ds = TokenDataset(TokenDatasetConfig(vocab=cfg.vocab, seq_len=16, global_batch=8,
                                                 seed=0))
            losses = []
            for s in range(steps):
                if fields.get("mode") == "manual-dp":
                    params, opt, err, met = step(params, opt, err, ds(s))
                else:
                    params, opt, met = step(params, opt, ds(s))
                losses.append(float(met["loss"]))
        out[case + ".loss"] = np.array(losses)
        for key, tree in (("p", params), ("m", opt["m"]), ("v", opt["v"])):
            for i, a in enumerate(jax.tree.leaves(tree)):
                out[f"{case}.{key}{i}"] = np.asarray(a.astype(jnp.float32))
                if key == "m":
                    for sd in a.addressable_shards:
                        d = mesh.devices.flatten().tolist().index(sd.device)
                        out[f"{case}.mshard{i}.dev{d}"] = np.asarray(sd.data)
                        out[f"{case}.mspec{i}"] = np.array(repr(tuple(a.sharding.spec)))
        if fields.get("mode") == "manual-dp":
            for i, a in enumerate(jax.tree.leaves(err)):  # each device's own residual
                for sd in a.addressable_shards:
                    d = mesh.devices.flatten().tolist().index(sd.device)
                    out[f"{case}.err{i}.dev{d}"] = np.asarray(sd.data)
    np.savez(TMP + "/ref.npz", **out)
    print("ok")
""")


def _consts() -> str:
    return f"CASES = {CASES!r}\nOPT = {OPT!r}\nWORLD = {RANKS}\n"


@pytest.fixture(scope="module")
def four_ranks():
    import pickle

    with tempfile.TemporaryDirectory() as tmp:
        for arch in {a for a, _, _ in CASES.values()}:
            with open(os.path.join(tmp, arch + ".pkl"), "wb") as f:
                pickle.dump(ref_weights(RC.get_reduced(arch), 5), f)
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
    return ref, ranks


def _n_leaves(out, case, key):
    return len([k for k in out if k.startswith(f"{case}.{key}") and k[len(case) + 1
                                                                       + len(key):].isdigit()])


@pytest.mark.parametrize("case", ["zero1", "zero2"])
def test_four_ranks_match_reference(four_ranks, case):
    ref, ranks = four_ranks
    n = _n_leaves(ref, case, "p")
    for r in ranks:
        np.testing.assert_allclose(r[case + ".loss"], ref[case + ".loss"], **LOSS_TOL)
        assert _n_leaves(r, case, "p") == n
        _excused_ok([r[f"{case}.p{i}"] for i in range(n)], [ref[f"{case}.p{i}"] for i in range(n)],
                    [ref[f"{case}.v{i}"] for i in range(n)], CASES[case][2])
        for i in range(n):  # every rank's parameters are the same bits
            np.testing.assert_array_equal(r[f"{case}.p{i}"], ranks[0][f"{case}.p{i}"])


@pytest.mark.parametrize("case", ["zero1", "zero2"])
def test_zero1_shards_match_reference_devices(four_ranks, case):
    """Each rank's m part, re-stacked to the reference's layout, has the
    shape and the values of the reference's shard on the matching device."""
    ref, ranks = four_ranks
    n = _n_leaves(ref, case, "p")
    sharded = 0
    for i in range(n):
        sharded += "'data'" in str(ref[f"{case}.mspec{i}"])
        for d, r in enumerate(ranks):
            want = ref[f"{case}.mshard{i}.dev{d}"]
            assert r[f"{case}.m{i}"].shape == want.shape, (i, d)
            np.testing.assert_allclose(r[f"{case}.m{i}"], want, rtol=1e-3, atol=1e-7)
    assert sharded >= n // 2


def test_manual_dp_compressed_one_step(four_ranks):
    """One step of manual-dp with grad_compress: the losses; each rank's
    error-feedback residual against its device's (within one quantum), and
    m (the clipped compressed mean gradient times 1 - b1, on a lattice
    of one quantum over four ranks), equal to float noise at all but 1% of the
    entries and elsewhere at most a lattice step a rank apart (a value on a
    rounding edge rounds either way); the parameters within PARAM_ATOL
    where m agrees, within 2 lr where it does not."""
    ref, ranks = four_ranks
    n = _n_leaves(ref, "manual1", "p")
    flipped = total = 0
    for i in range(n):
        # m = (1 - b1) * scale * (summed int8) / ranks: its smallest nonzero
        # entry is one step of that lattice (one quantum over four ranks)
        m_ref = ref[f"manual1.m{i}"]
        step_m = np.abs(m_ref[m_ref != 0]).min()
        # the residual lies within half a quantum, its largest entry next to it
        quantum = 2 * max(np.abs(ref[f"manual1.err{i}.dev{d}"]).max() for d in range(RANKS))
        dm = np.abs(ranks[0][f"manual1.m{i}"] - m_ref)
        same = dm <= 1e-7 + 1e-5 * np.abs(m_ref)
        # a value on a rounding edge on each of the four ranks at most
        assert dm.max() <= RANKS * step_m * 1.01 + 1e-9
        flipped += int((~same).sum())
        total += dm.size
        for d, r in enumerate(ranks):
            np.testing.assert_allclose(r["manual1.loss"], ref["manual1.loss"], **LOSS_TOL)
            de = np.abs(r[f"manual1.err{i}"] - ref[f"manual1.err{i}.dev{d}"])
            assert de.max() <= quantum * 1.05 + 1e-9
            assert (de > 1e-7).mean() <= 0.01
            p, q = r[f"manual1.p{i}"], ref[f"manual1.p{i}"]
            np.testing.assert_allclose(p[same], q[same], rtol=0, atol=PARAM_ATOL)
            np.testing.assert_allclose(p, q, rtol=0, atol=2 * OPT["lr"])
    assert flipped <= 0.01 * total, (flipped, total)


def test_manual_dp_compressed_three_steps(four_ranks):
    """Three steps: the losses held tightly; the parameters within
    PARAM_ATOL at all but 0.1% of the entries (a flip moves its entry's
    later updates) and within 2 lr a step everywhere; every rank's
    parameters the same bits."""
    ref, ranks = four_ranks
    n = _n_leaves(ref, "manual3", "p")
    for r in ranks:
        np.testing.assert_allclose(r["manual3.loss"], ref["manual3.loss"], **LOSS_TOL)
        for i in range(n):
            d = np.abs(r[f"manual3.p{i}"] - ref[f"manual3.p{i}"])
            assert d.max() <= 2 * OPT["lr"] * 3
            assert (d > PARAM_ATOL).mean() <= 1e-3
            np.testing.assert_array_equal(r[f"manual3.p{i}"], ranks[0][f"manual3.p{i}"])
