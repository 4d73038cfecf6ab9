"""Training over the reference's whole mesh: tensor and expert parallelism
over "model", ZeRO over (pod, data), on the CPU.

One module fixture starts four gloo rank processes beside the reference on
four forced host devices (``tests.util.run_with_devices``). For every case
of ``CASES`` both run ``make_train_step`` on the same mesh from the same
numpy weights and batches, and the tests hold:

* the losses to ``LOSS_TOL`` (and the MoE's aux loss, and its dropped
  share of (token, choice) pairs exactly);
* the parameters gathered over the mesh by the trajectory rule
  (``_excused_ok`` of ``tests.test_torch_train``), an entry clear of
  rounding where v is and where its first step's gradient was (|g| at the
  first step, sqrt(v_1 / (1 - b2)) of the reference's v: a gradient within
  rounding of zero there moves an entry by a fraction of lr that rounding
  decides, whatever v says after);
* each rank's ``m`` (its shard over "model", its ZeRO part over the batch
  axes) against the reference's ``addressable_shards`` on the matching
  device, rtol 1e-3;
* every rank's replicated parameters the same bits, and its gathered ones.

The int8-compressed manual-dp case holds its parameters and ``m`` by the
lattice rule of ``test_manual_dp_compressed_one_step``.

The same rank processes hold each module under tensor parallelism against
the unsharded port on the same inputs (``MODULES``: the vocab-parallel
loss, the attention with its fallbacks, the MLP and the MoE, outputs and
every gradient within ``MODULE_RTOL`` of its norm), and a checkpoint saved
on (data, model) = (2, 2): a restart there gives the uninterrupted run's
bits, and it restores on (4, 1) and on one rank to the state it saved;
the save makes each leaf whole on the first rank's host alone. A step fed
rows laid out for another microbatch count than its own is refused, and
so is a manual-dp step whose rank's rows do not split into its
microbatches. The cases on (4, 1) and (2, 2, 1) whose microbatches' rows
do not divide over the data ranks (a rank holds one row of each, or
none) are held to the reference as the others are; the MoE's dropped
pairs of the first step, summed over the ranks' real rows, are the
reference's.
"""
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
from repro_torch.ckpt.manager import CheckpointManager, _flatten  # noqa: E402
from repro_torch.interop import reference_layout  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.sharding.rules import default_rules  # noqa: E402
from repro_torch.train import loop as PL  # noqa: E402

from tests.test_torch_lm_model import ref_weights  # noqa: E402
from tests.test_torch_train import LOSS_TOL, OPT, PARAM_ATOL, _excused_ok  # noqa: E402
from tests.util import run_with_devices  # noqa: E402

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
RANKS = 4
MODULE_RTOL = 1e-5   # f32: the same sums split over two or four ranks
# per case: arch, mesh shape, its axis names, TrainConfig fields, steps
DM = ("data", "model")
CASES = {
    "olmo_zero1": ("olmo-1b", (2, 2), DM, dict(zero1=True, microbatches=2), 3),
    "deepseek_zero2": ("deepseek-7b", (2, 2), DM,
                       dict(zero1=True, zero2_grads=True, microbatches=2), 1),
    "qwen_ep": ("qwen2-moe-a2.7b", (2, 2), DM, dict(zero1=True), 2),
    # its TRAIN_OVERRIDES: each rank's rows its parts of the global microbatches
    "qwen_ep_mb4": ("qwen2-moe-a2.7b", (2, 2), DM, dict(zero1=True, microbatches=4), 1),
    "gemma3_tp4": ("gemma3-4b", (1, 4), DM, dict(microbatches=2), 1),
    "olmo_manual": ("olmo-1b", (2, 2), DM, dict(mode="manual-dp", grad_compress=True), 1),
    "olmo_pod": ("olmo-1b", (2, 2, 1), ("pod", "data", "model"),
                 dict(zero1=True, microbatches=2), 3),
    # the recurrent and encoder-decoder families over "model"
    "rglru_zero1": ("recurrentgemma-2b", (2, 2), DM, dict(zero1=True, microbatches=2), 2),
    "xlstm_tp4": ("xlstm-350m", (1, 4), DM, dict(microbatches=2), 1),
    "whisper_mb4": ("whisper-tiny", (2, 2), DM, dict(microbatches=4), 1),
    # microbatches whose rows do not divide over the data ranks: GSPMD pads
    # the shard; here ranks hold 1, 1, 0, 0 rows of each microbatch (2, 2,
    # 2, 0 of the 6-row microbatches of a global 12)
    "olmo_uneven_zero1": ("olmo-1b", (4, 1), DM, dict(zero1=True, microbatches=4), 2),
    "olmo_uneven12_zero2": ("olmo-1b", (4, 1), DM,
                            dict(zero1=True, zero2_grads=True, microbatches=2), 2),
    "qwen_uneven_mb4": ("qwen2-moe-a2.7b", (4, 1), DM, dict(zero1=True, microbatches=4), 1),
    "olmo_pod_uneven": ("olmo-1b", (2, 2, 1), ("pod", "data", "model"),
                        dict(zero1=True, microbatches=4), 2),
}
# the global batch of a case (default 8)
GLOBAL = {"olmo_uneven12_zero2": 12}
# per module case: what runs, the arch (config overrides), the model axis
MODULES = {
    "loss_vocab": ("loss", "olmo-1b", {}, 2),
    "attn_heads": ("attn", "olmo-1b", {}, 2),
    "attn_kv_fallback_window": ("attn", "gemma3-4b", {}, 4),
    "attn_out_split": ("attn", "olmo-1b", dict(n_heads=3, n_kv=3, d_model=48), 2),
    "mlp_ffn2": ("mlp", "deepseek-7b", {}, 2),
    "mlp_ffn4": ("mlp", "deepseek-7b", {}, 4),
    "moe_experts_shared": ("moe", "qwen2-moe-a2.7b", {}, 2),
    "moe_ffn_split": ("moe", "qwen2-moe-a2.7b",
                      dict(moe_pad_to=None, moe_shared=0, moe_capacity=1.0), 4),
    "rglru_ffn2": ("rglru", "recurrentgemma-2b", {}, 2),
    "rglru_ffn4": ("rglru", "recurrentgemma-2b", {}, 4),
    "mlstm_heads2": ("mlstm", "xlstm-350m", {}, 2),
    "mlstm_whole": ("mlstm", "xlstm-350m", dict(n_heads=2), 4),   # 2 heads over 4 ranks
    "slstm_heads4": ("slstm", "xlstm-350m", {}, 4),
    "slstm_whole": ("slstm", "xlstm-350m", dict(n_heads=2), 4),
    "cross_attn_heads": ("cross", "whisper-tiny", {}, 2),
}
# tp.own on a model axis of m ranks, its part as `groups` blocks: (m, groups)
OWN = [(2, 1), (2, 2), (2, 4), (4, 1), (4, 2), (4, 4)]
# the all_reduce calls of one block's forward and backward, at two lengths
# (the mLSTM's chunk is 8: one chunk, then three): (module case, lengths)
LOOP_COLLECTIVES = {"mlstm_heads2": (8, 24), "mlstm_whole": (8, 24),
                    "slstm_heads4": (8, 24), "slstm_whole": (8, 24)}
# remat "full" and "save_tp" against "none" under tensor parallelism on (2, 2)
REMAT_ARCHS = ("qwen2-moe-a2.7b", "recurrentgemma-2b", "xlstm-350m", "whisper-tiny")
# a data-parallel step fed rows laid out for another microbatch count than
# its own: arch, TrainConfig fields, the dataset's microbatches
REFUSE = {
    "moe_auto": ("qwen2-moe-a2.7b", dict(zero1=True, microbatches=4), 1),
    "dense_manual": ("olmo-1b", dict(mode="manual-dp", microbatches=2), 2),
    # 4 rows a data rank into 8 microbatches: auto trains this layout, the
    # reference's manual-dp reshape refuses it
    "manual_uneven": ("olmo-1b", dict(mode="manual-dp", microbatches=8), 1),
}
CKPT = dict(case="olmo_zero1", save_at=2)
CKPT_ARCH = CASES[CKPT["case"]][0]

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
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.ckpt.manager import CheckpointManager, _flatten
    from repro_torch.configs import get_reduced
    from repro_torch.data.tokens import TokenDataset, TokenDatasetConfig
    from repro_torch.interop import lm_params_from_arrays, reference_layout
    from repro_torch.models import blocks as B, encdec as E, moe as MO, recurrent as R
    from repro_torch.models.model import build_model
    from repro_torch.models.layers import apply_mlp, tree_leaves, tree_map
    from repro_torch.sharding.rules import default_rules
    from repro_torch.sharding.tp import TPContext, gather_params, shard_params
    from repro_torch.train import optim
    from repro_torch.train.grad_compress import init_error_tree
    from repro_torch.train.loop import (
        TrainConfig, _whole_on_first, full_opt_state, init_opt_state, init_train_state,
        make_train_step, restore_layout, save_train_state)
    out = {}
    meshes = {}
    def mesh_of(shape, names):
        if (shape, names) not in meshes:
            meshes[shape, names] = init_device_mesh("cpu", shape, mesh_dim_names=names)
        return meshes[shape, names]
    stack = lambda ts: torch.stack([t for t in ts if t is not None])
    def flat(cfg, tree):
        return [t.float().numpy() for _, t in _flatten(reference_layout(cfg, tree, stack))]
    def state(cfg, params, opt, sh):
        full = full_opt_state(params, opt, sh["placements"])
        tp = sh["tp"]
        return (flat(cfg, gather_params(params, tp)), flat(cfg, gather_params(full["m"], tp)),
                flat(cfg, gather_params(full["v"], tp)))
    def batches(cfg, mesh, nm, global_batch=8):
        return TokenDataset(TokenDatasetConfig(vocab=cfg.vocab, seq_len=16,
                                               global_batch=global_batch,
                                               seed=0), prefix_len=cfg.prefix_len,
                            d_model=cfg.d_model, frames=cfg.arch_type == "encdec", mesh=mesh,
                            device="cpu", microbatches=nm)
    def dropped(model, params, batch, tp):
        keeps = []
        route = MO.route
        def recording(*a, **k):
            r = route(*a, **k)
            keeps.append(r["keep"])
            return r
        MO.route = recording
        try:
            with torch.no_grad():
                model.loss_fn(batch, params=params, tp=tp)
        finally:
            MO.route = route
        return np.array([float(sum((~k).sum() for k in keeps)),
                         float(sum(k.numel() for k in keeps))])

    for case, (arch, shape, names, fields, steps) in CASES.items():
        cfg = get_reduced(arch)
        mesh = mesh_of(shape, names)
        with open(os.path.join(tmp, arch + ".pkl"), "rb") as f:
            model = lm_params_from_arrays(cfg, pickle.load(f), device="cpu")
        tcfg = TrainConfig(opt=optim.AdamWConfig(**OPT), **fields)
        step, sh = make_train_step(model, mesh, default_rules(mesh), tcfg)
        tp = sh["tp"]
        params = shard_params(tree_map(lambda t: t.detach(), model.params), tp)
        opt = init_opt_state(params, sh["placements"])
        err = init_error_tree(params)
        ds = batches(cfg, mesh, tcfg.row_microbatches, GLOBAL.get(case, 8))
        if cfg.moe_experts:
            full = TokenDataset(TokenDatasetConfig(vocab=cfg.vocab, seq_len=16, global_batch=8,
                                                   seed=0), device="cpu")
            out[case + ".dropped"] = dropped(model, params, full(0), tp)
        losses, aux = [], []
        route = MO.route
        if cfg.moe_experts and shape[-1] == 1:
            # the first step's routing, on this rank's real rows only
            first = ds(0)
            real = (first["tokens"].shape[0] // tcfg.microbatches, first.shard_rows)
            keeps = []
            def recording(*a, **k):
                r = route(*a, **k)
                keeps.append(r["keep"][:r["keep"].shape[0] * real[0] // real[1]])
                return r
            MO.route = recording
        for s in range(steps):
            if s == 1:
                MO.route = route
            if case == CKPT["case"] and s == CKPT["save_at"]:
                mgr = CheckpointManager(os.path.join(tmp, "ckpt"))
                save_train_state(mgr, model, s, params, opt, sh)
                saved = state(cfg, params, opt, sh)
                for key, leaves in zip("pmv", saved):
                    for i, a in enumerate(leaves):
                        out[f"ckpt.{key}{i}"] = a
            if fields.get("mode") == "manual-dp":
                params, opt, err, met = step(params, opt, err, ds(s))
            else:
                params, opt, met = step(params, opt, ds(s))
            losses.append(float(met["loss"]))
            aux.append(float(met["aux"]) if "aux" in met else 0.0)
        MO.route = route
        if cfg.moe_experts and shape[-1] == 1:
            out[case + ".dropped_step"] = np.array([float(sum((~k).sum() for k in keeps)),
                                                    float(sum(k.numel() for k in keeps))])
        out[case + ".loss"] = np.array(losses)
        out[case + ".aux"] = np.array(aux)
        # what the save takes of each m leaf to this rank's host
        unplaced = tree_map(lambda _: None, params)
        held = tree_leaves(tree_map(
            lambda t, p, pl, d: _whole_on_first(t, p, pl, d, tp, sh["zero_rank"]),
            opt["m"], params, sh["placements"] or unplaced, unplaced if tp is None else tp.dims))
        out[case + ".held"] = np.array([h is not None and h.device.type == "cpu" for h in held])
        for i, a in enumerate(state(cfg, params, opt, sh)[0]):
            out[f"{case}.p{i}"] = a
        for key, tree in (("pl", params), ("m", opt["m"]), ("err", err)):
            for i, a in enumerate(flat(cfg, tree)):
                out[f"{case}.{key}{i}"] = a
        if case == CKPT["case"]:
            # a restart on the same mesh, then the checkpoint on (4, 1)
            p2, o2, at = restore_layout(mgr, model, sh, step=CKPT["save_at"])
            for s in range(at, steps):
                p2, o2, _ = step(p2, o2, ds(s))
            out["ckpt.restart_same_bits"] = np.array(
                int(o2["step"]) == int(opt["step"]) and all(
                    np.array_equal(a, b) for key in ("m", "v")
                    for a, b in zip(flat(cfg, opt[key]), flat(cfg, o2[key])))
                and all(np.array_equal(a, b) for a, b in zip(flat(cfg, params), flat(cfg, p2))))
            m41 = mesh_of((4, 1), ("data", "model"))
            _, sh41 = make_train_step(model, m41, default_rules(m41), tcfg)
            p41, o41, _ = restore_layout(mgr, model, sh41, step=CKPT["save_at"])
            for key, leaves in zip("pmv", state(cfg, p41, o41, sh41)):
                for i, a in enumerate(leaves):
                    out[f"ckpt41.{key}{i}"] = a

    # init_train_state on (2, 2): this rank's shards of the one-rank draw
    cfg = get_reduced(CKPT_ARCH)
    model = build_model(cfg, device="cpu")
    mesh = mesh_of((2, 2), ("data", "model"))
    _, sh = make_train_step(model, mesh, default_rules(mesh), TrainConfig(zero1=True))
    p0, o0 = init_train_state(model, mesh, sh, seed=0)
    for key, leaves in zip("pm", state(cfg, p0, o0, sh)):
        for i, a in enumerate(leaves):
            out[f"init.{key}{i}"] = a

    for name, (arch, fields, laid) in REFUSE.items():
        cfg = get_reduced(arch)
        mesh = mesh_of((2, 2), ("data", "model"))
        model = build_model(cfg, device="cpu")
        step, sh = make_train_step(model, mesh, default_rules(mesh), TrainConfig(**fields))
        params, opt = init_train_state(model, mesh, sh, seed=0)
        state_ = (params, opt, init_error_tree(params)) if "mode" in fields else (params, opt)
        try:
            step(*state_, batches(cfg, mesh, laid)(0))
            out["refuse." + name] = np.array(False)
        except ValueError as e:
            out["refuse." + name] = np.array("microbatches" in str(e))

    # remat under tensor parallelism: "full" and "save_tp" recompute the
    # forward's collectives in the backward, and keep the bits of "none"
    for arch in REMAT_ARCHS:
        grads = {}
        for remat in ("none", "full", "save_tp"):
            cfg = dataclasses.replace(get_reduced(arch), remat=remat)
            model = build_model(cfg, device="cpu", generator=torch.Generator().manual_seed(3))
            mesh = mesh_of((2, 2), ("data", "model"))
            _, sh = make_train_step(model, mesh, default_rules(mesh), TrainConfig())
            leaves = tree_map(lambda t: t.detach().requires_grad_(True),
                              shard_params(tree_map(lambda t: t.detach(), model.params), sh["tp"]))
            batch = batches(cfg, mesh, 1)(0)
            loss, _ = model.loss_fn(batch, params=leaves, tp=sh["tp"])
            grads[remat] = [loss.detach()] + list(torch.autograd.grad(
                loss, tree_leaves(leaves), allow_unused=True, materialize_grads=True))
        out[f"remat.{arch}.same_bits"] = np.array(all(
            torch.equal(a, b) for r in ("full", "save_tp")
            for a, b in zip(grads[r], grads["none"])))

    # tp.own against the unsharded product u @ W (W split on its rows):
    # the value, and the gradients of W and u; and the slice of the sum
    # without the enter, whose gradient of W is wrong
    for m, groups in OWN:
        mesh = mesh_of((RANKS // m, m), ("data", "model"))
        tpc = TPContext(mesh.get_group("model"), mesh.get_local_rank("model"), m, None)
        g = torch.Generator().manual_seed(6)
        u, W = torch.randn((2, 5, 16), generator=g), torch.randn((16, 32), generator=g)
        w = torch.randn((2, 5, 32), generator=g)
        ul, Wl = u.clone().requires_grad_(True), W.clone().requires_grad_(True)
        want = torch.matmul(ul, Wl)
        gW, gu = torch.autograd.grad((want * w).sum(), (Wl, ul))
        rel = lambda a, b: float((a - b).norm() / b.norm())  # noqa: E731
        res = []
        for form in ("own", "slice_of_sum"):
            ul, Wl = u.clone().requires_grad_(True), tpc.take(W, 0).clone().requires_grad_(True)
            partial = torch.matmul(tpc.part(ul), Wl)
            got = (tpc.own(partial, groups=groups) if form == "own"
                   else tpc.take(tpc.leave(partial), groups=groups))
            dW, du = torch.autograd.grad((got * tpc.take(w, groups=groups)).sum(), (Wl, ul))
            res += [rel(got, tpc.take(want.detach(), groups=groups)), rel(dW, tpc.take(gW, 0)),
                    rel(du, gu)]
        out[f"own.{m}.{groups}"] = np.array(res)

    # each module under tensor parallelism against the unsharded port
    def sub(tree, path):
        for k in path:
            tree = tree[k]
        return tree
    for name, (what, arch, over, m) in MODULES.items():
        cfg = dataclasses.replace(get_reduced(arch), **over)
        mesh = mesh_of((RANKS // m, m), ("data", "model"))
        model = build_model(cfg, device="cpu", generator=torch.Generator().manual_seed(3))
        _, sh = make_train_step(model, mesh, default_rules(mesh), TrainConfig())
        tp = sh["tp"]
        full = tree_map(lambda t: t.detach(), model.params)
        g = torch.Generator().manual_seed(4)
        x = torch.randn((2, 16, cfg.d_model), generator=g)
        w = torch.randn((2, 16, cfg.d_model), generator=g)
        if what == "loss":
            path = ()
            batch = TokenDataset(TokenDatasetConfig(vocab=cfg.vocab, seq_len=16, global_batch=2,
                                                    seed=1), device="cpu")(0)
            f = lambda p, x, tp: model.loss_fn(batch, params=p, tp=tp)[0]
        elif what == "attn":  # gemma3's first layer is windowed (8 of 16 tokens)
            path = ("layers", 0, "attn")
            acfg = B._attn_cfg(cfg, cfg.window if cfg.pattern[0] == "local+mlp" else None)
            pos = torch.arange(16)
            f = lambda p, x, tp: (B.attend(cfg, acfg, p, x, pos, tp)[0] * w).sum()
        elif what == "mlp":
            path = ("layers", 0, "mlp")
            f = lambda p, x, tp: (apply_mlp(B._mlp_cfg(cfg), p, x, tp) * w).sum()
        elif what in ("rglru", "mlstm", "slstm"):
            path = ("layers", [k.split("+")[0] for k in cfg.pattern].index(what), what)
            run = {"rglru": (R.apply_rglru, B._rglru_cfg(cfg)),
                   "mlstm": (R.apply_mlstm, B._mlstm_cfg(cfg)),
                   "slstm": (R.apply_slstm, B._slstm_cfg(cfg))}[what]
            wl = torch.randn((2, 32, cfg.d_model), generator=g)  # up to 32 tokens
            f = lambda p, x, tp, run=run, wl=wl: (
                run[0](run[1], p, x, tp=tp)[0] * wl[:, :x.shape[1]]).sum()
        elif what == "cross":  # the encoder output stands in as x reversed
            path = ("dec", 0, "cross")
            f = lambda p, x, tp: (E.cross_attend(cfg, p, x, E._enc_kv(
                cfg, {"dec": [{"cross": p}]}, x.flip(1), tp)[0], tp) * w).sum()
        else:
            path = ("layers", 0, "moe")
            mcfg = B._moe_cfg(cfg)
            def f(p, x, tp):
                y, aux = MO.apply_moe(mcfg, p, x, tp)
                return (y * w).sum() + aux
            r = MO.route(mcfg, sub(full, path), x.reshape(
                *MO.group_shape(mcfg, 2, 16), cfg.d_model))
            out[f"mod.{name}.dropped"] = np.array(float((~r["keep"]).float().mean()))
        res = {}
        for tag, tpc in (("one", None), ("tp", dataclasses.replace(tp, dims=sub(tp.dims, path)))):
            p = sub(full, path)
            if tpc is not None:
                p = shard_params(p, tpc)
            leaves = tree_map(lambda t: t.detach().requires_grad_(True), p)
            xi = x.clone().requires_grad_(True)
            val = f(leaves, xi, tpc)
            flat_l = tree_leaves(leaves)
            gs = torch.autograd.grad(val, flat_l + [xi], allow_unused=True,
                                     materialize_grads=True)
            it = iter(gs[:-1])
            gp = tree_map(lambda _: next(it), leaves)
            if tpc is not None:
                gp = gather_params(gp, tpc)
            res[tag] = (val.detach(), tree_leaves(gp), gs[-1])
        (v1, g1, x1), (v2, g2, x2) = res["one"], res["tp"]
        rel = [float((a - b).norm() / b.norm().clamp_min(1e-30)) for a, b in
               zip(g2 + [x2], g1 + [x1])]
        out[f"mod.{name}.value"] = np.array([float(v1), float(v2)])
        out[f"mod.{name}.grad_rel"] = np.array(rel)
        out[f"mod.{name}.sharded"] = np.array(sum(d is not None for d in tree_leaves(
            sub(tp.dims, path))))
        if name in LOOP_COLLECTIVES:  # the all_reduce calls of a forward and backward
            counts = []
            p = shard_params(sub(full, path), dataclasses.replace(tp, dims=sub(tp.dims, path)))
            reduce_ = dist.all_reduce
            for s in LOOP_COLLECTIVES[name]:
                calls = []
                def counting(*a, **k):
                    calls.append(1)
                    return reduce_(*a, **k)
                leaves = tree_map(lambda t: t.detach().requires_grad_(True), p)
                xi = torch.randn((2, s, cfg.d_model), generator=g).requires_grad_(True)
                dist.all_reduce = counting
                try:
                    torch.autograd.grad(f(leaves, xi, tp), tree_leaves(leaves) + [xi])
                finally:
                    dist.all_reduce = reduce_
                counts.append(len(calls))
            out[f"loop.{name}"] = np.array(counts)
    np.savez(os.path.join(tmp, f"port{rank}.npz"), **out)
    dist.destroy_process_group()
""")

REF_CODE = textwrap.dedent("""
    import pickle
    import numpy as np, jax, jax.numpy as jnp
    from repro.configs import get_reduced
    from repro.data.tokens import TokenDataset, TokenDatasetConfig
    from repro.models import model as RM
    from repro.runtime.jax_compat import make_mesh, set_mesh
    from repro.sharding.rules import default_rules
    from repro.train import optim
    from repro.train.grad_compress import init_error_tree
    from repro.train.loop import TrainConfig, make_train_step
    out = {}
    for case, (arch, shape, names, fields, steps) in CASES.items():
        cfg = get_reduced(arch)
        mesh = make_mesh(shape, names)
        devices = mesh.devices.flatten().tolist()
        with open(TMP + "/" + arch + ".pkl", "rb") as f:
            tree = pickle.load(f)
        shapes, _ = RM.abstract_params(cfg)
        params = jax.tree.map(lambda a, s: jnp.asarray(a, s.dtype), tree, shapes)
        model = RM.build_model(cfg)
        ds = TokenDataset(TokenDatasetConfig(vocab=cfg.vocab, seq_len=16,
                                             global_batch=GLOBAL.get(case, 8),
                                             seed=0), frames=cfg.arch_type == "encdec",
                          d_model=cfg.d_model)
        if cfg.moe_experts:  # the first batch's routing at the initial weights
            seen, one_hot = [], jax.nn.one_hot
            def recording(idx, n, **kw):
                seen.append((np.asarray(idx), n))
                return one_hot(idx, n, **kw)
            jax.nn.one_hot = recording
            try:
                with jax.disable_jit():
                    model.loss_fn(params, ds(0))
            finally:
                jax.nn.one_hot = one_hot
            pos = [(p, n) for p, n in seen[1::2]]  # (top-k, positions) pairs per layer
            out[case + ".dropped"] = np.array([float(sum((p >= n).sum() for p, n in pos)),
                                               float(sum(p.size for p, _ in pos))])
        step, sh = make_train_step(model, mesh, default_rules(mesh),
                                   TrainConfig(opt=optim.AdamWConfig(**OPT), **fields))
        with set_mesh(mesh):
            params = jax.device_put(params, sh["params"])
            opt = jax.jit(optim.init_opt_state, out_shardings=sh["opt"])(params)
            err = init_error_tree(params)
            losses, aux = [], []
            b2 = optim.AdamWConfig(**OPT).b2
            for s in range(steps):
                if fields.get("mode") == "manual-dp":
                    params, opt, err, met = step(params, opt, err, ds(s))
                else:
                    params, opt, met = step(params, opt, ds(s))
                losses.append(float(met["loss"]))
                aux.append(float(met["aux"]) if "aux" in met else 0.0)
                if s == 0:  # each entry's |g| at the first step, read off v_1
                    for i, a in enumerate(jax.tree.leaves(opt["v"])):
                        out[f"{case}.gfirst{i}"] = np.sqrt(np.asarray(a) / (1 - b2))
        out[case + ".loss"] = np.array(losses)
        out[case + ".aux"] = np.array(aux)
        for key, t in (("p", params), ("m", opt["m"]), ("v", opt["v"])):
            for i, a in enumerate(jax.tree.leaves(t)):
                out[f"{case}.{key}{i}"] = np.asarray(a.astype(jnp.float32))
                if key == "m":
                    for sd in a.addressable_shards:
                        out[f"{case}.mshard{i}.dev{devices.index(sd.device)}"] = np.asarray(
                            sd.data)
        if fields.get("mode") == "manual-dp":
            for i, a in enumerate(jax.tree.leaves(err)):
                for sd in a.addressable_shards:
                    out[f"{case}.err{i}.dev{devices.index(sd.device)}"] = np.asarray(sd.data)
    np.savez(TMP + "/ref.npz", **out)
    print("ok")
""")


def _consts() -> str:
    return (f"CASES = {CASES!r}\nGLOBAL = {GLOBAL!r}\n"
            f"MODULES = {MODULES!r}\nCKPT = {CKPT!r}\nOPT = {OPT!r}\n"
            f"REFUSE = {REFUSE!r}\nOWN = {OWN!r}\nLOOP_COLLECTIVES = {LOOP_COLLECTIVES!r}\n"
            f"REMAT_ARCHS = {REMAT_ARCHS!r}\n"
            f"RANKS = {RANKS}\nCKPT_ARCH = {CKPT_ARCH!r}\n")


@pytest.fixture(scope="module")
def tp_ranks():
    with tempfile.TemporaryDirectory() as tmp:
        for arch in {a for a, *_ in CASES.values()}:
            with open(os.path.join(tmp, arch + ".pkl"), "wb") as f:
                pickle.dump(ref_weights(RC.get_reduced(arch), 5), f)
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
        # the checkpoint on one rank: the state it saved, in the port's layout
        cfg = PC.get_reduced(CKPT_ARCH)
        model = build_model(cfg, device="cpu")
        _, sh = PL.make_train_step(model, None, default_rules(None),
                                   PL.TrainConfig(**CASES[CKPT["case"]][3]))
        p1, o1, _ = PL.restore_layout(CheckpointManager(os.path.join(tmp, "ckpt")), model, sh,
                                      step=CKPT["save_at"])
    one = {}
    for key, tree in (("p", p1), ("m", o1["m"]), ("v", o1["v"])):
        stacked = reference_layout(cfg, tree, lambda ts: torch.stack(ts))
        for i, (_, t) in enumerate(_flatten(stacked)):
            one[f"{key}{i}"] = t.float().numpy()
    return ref, ranks, one



def _n(out, case, key="p"):
    return len([k for k in out if k.startswith(f"{case}.{key}")
                and k[len(case) + 1 + len(key):].isdigit()])


def _model_rank(case: str, k: int) -> tuple:
    """(index of rank ``k`` on the case's model axis, its coordinates on the
    other axes)."""
    shape = CASES[case][1]
    coords = np.unravel_index(k, shape)
    return coords[-1], tuple(coords[:-1])


AUTO = [c for c, v in CASES.items() if v[3].get("mode") != "manual-dp"]


@pytest.mark.parametrize("case", AUTO)
def test_steps_match_reference(tp_ranks, case):
    """Losses, the gathered parameters, every rank's the same bits."""
    ref, ranks, _ = tp_ranks
    steps = CASES[case][4]
    n = _n(ref, case)
    for r in ranks:
        np.testing.assert_allclose(r[case + ".loss"], ref[case + ".loss"], **LOSS_TOL)
        np.testing.assert_allclose(r[case + ".aux"], ref[case + ".aux"], rtol=1e-5, atol=1e-9)
        assert _n(r, case) == n
        # an entry is clear where v is and where its first step's |g| was
        _excused_ok([r[f"{case}.p{i}"] for i in range(n)], [ref[f"{case}.p{i}"] for i in range(n)],
                    [np.minimum(ref[f"{case}.v{i}"], ref[f"{case}.gfirst{i}"] ** 2)
                     for i in range(n)], steps)
        for i in range(n):
            np.testing.assert_array_equal(r[f"{case}.p{i}"], ranks[0][f"{case}.p{i}"])


@pytest.mark.parametrize("case", list(CASES))
def test_m_shards_match_reference_devices(tp_ranks, case):
    """Each rank's m (its model shard, its ZeRO part), re-stacked to the
    reference's layout, against the reference's shard on the matching
    device; the manual-dp case by its lattice rule: equal to float noise
    at all but 1% of the entries, elsewhere a lattice step a rank apart."""
    ref, ranks, _ = tp_ranks
    n = _n(ref, case)
    split = 0
    flipped = total = 0
    for i in range(n):
        split += ranks[0][f"{case}.m{i}"].shape != ref[f"{case}.m{i}"].shape
        for d, r in enumerate(ranks):
            want = ref[f"{case}.mshard{i}.dev{d}"]
            got = r[f"{case}.m{i}"]
            assert got.shape == want.shape, (case, i, d)
            if CASES[case][3].get("mode") != "manual-dp":
                np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-7)
                continue
            m_ref = ref[f"{case}.m{i}"]
            step_m = np.abs(m_ref[m_ref != 0]).min()
            dm = np.abs(got - want)
            assert dm.max() <= RANKS * step_m * 1.01 + 1e-9
            flipped += int((dm > 1e-7 + 1e-5 * np.abs(want)).sum())
            total += dm.size
    assert flipped <= 0.01 * max(total, 1)
    assert split >= n // 2  # most leaves are split over model or ZeRO


def test_manual_dp_compressed_matches_reference(tp_ranks):
    """manual-dp with int8 compression on (2, 2): the losses; the
    parameters within 2 lr everywhere and PARAM_ATOL at all but 1% of the
    entries; each rank's error-feedback residual against its device's
    within one quantum (the reference's own shard of the residual)."""
    ref, ranks, _ = tp_ranks
    case = "olmo_manual"
    n = _n(ref, case)
    off = total = 0
    for d, r in enumerate(ranks):
        np.testing.assert_allclose(r[case + ".loss"], ref[case + ".loss"], **LOSS_TOL)
        for i in range(n):
            p, q = r[f"{case}.p{i}"], ref[f"{case}.p{i}"]
            np.testing.assert_allclose(p, q, rtol=0, atol=2 * OPT["lr"])
            off += int((np.abs(p - q) > PARAM_ATOL).sum())
            total += p.size
            want = ref[f"{case}.err{i}.dev{d}"]
            got = r[f"{case}.err{i}"]
            assert got.shape == want.shape, (i, d)
            quantum = 2 * max(np.abs(ref[f"{case}.err{i}.dev{k}"]).max() for k in range(RANKS))
            assert np.abs(got - want).max() <= quantum * 1.05 + 1e-9
            np.testing.assert_array_equal(p, ranks[0][f"{case}.p{i}"])
    assert off <= 0.01 * total, (off, total)


@pytest.mark.parametrize("case", list(CASES))
def test_replicated_leaves_same_bits_on_model_ranks(tp_ranks, case):
    """A leaf that the model axis does not split is the same bits on every
    rank of a model group; a split one differs between them."""
    ref, ranks, _ = tp_ranks
    shape = CASES[case][1]
    n = _n(ref, case)
    groups: dict = {}
    for k in range(RANKS):
        groups.setdefault(_model_rank(case, k)[1], []).append(k)
    split = 0
    for i in range(n):
        whole = ranks[0][f"{case}.pl{i}"].shape == ref[f"{case}.p{i}"].shape
        split += not whole
        for members in groups.values():
            first = ranks[members[0]][f"{case}.pl{i}"]
            for k in members[1:]:
                if whole:
                    np.testing.assert_array_equal(ranks[k][f"{case}.pl{i}"], first)
                else:
                    assert not np.array_equal(ranks[k][f"{case}.pl{i}"], first)
    assert (split > 0) == (shape[-1] > 1)


def test_moe_dropped_share_matches_reference(tp_ranks):
    """Expert parallelism routes as the reference: the same count of
    dropped (token, choice) pairs on the first batch, on every rank."""
    ref, ranks, _ = tp_ranks
    want = ref["qwen_ep.dropped"]
    assert want[0] > 0  # the capacity bites
    for r in ranks:
        np.testing.assert_array_equal(r["qwen_ep.dropped"], want)


@pytest.mark.parametrize("case", [c for c in CASES if CASES[c][0] == "qwen2-moe-a2.7b"
                                  and CASES[c][1][-1] == 1])
def test_moe_dropped_share_over_uneven_parts(tp_ranks, case):
    """Each data rank routes its real rows of every microbatch (1, 1, 0,
    0 rows) as the reference routes the global batch: the dropped (token,
    choice) pairs of the first step, summed over the ranks, the
    reference's count on the same batch."""
    ref, ranks, _ = tp_ranks
    want = ref[case + ".dropped"]
    assert want[0] > 0
    np.testing.assert_array_equal(sum(r[case + ".dropped_step"] for r in ranks), want)


def test_checkpoint_restart_and_remesh(tp_ranks):
    """Saved on (2, 2) after two steps: a restart there gives the bits of
    the uninterrupted run; restored on (4, 1) and on one rank, the state
    it saved (the same bits)."""
    _, ranks, one = tp_ranks
    for r in ranks:
        assert bool(r["ckpt.restart_same_bits"])
        for key in one:
            np.testing.assert_array_equal(r["ckpt41." + key], ranks[0]["ckpt." + key])
            np.testing.assert_array_equal(one[key], ranks[0]["ckpt." + key])


@pytest.mark.parametrize("case", list(CASES))
def test_save_gathers_on_the_first_rank_only(tp_ranks, case):
    """Each m leaf of a save (split over the model axis, over ZeRO, both,
    or replicated) is made whole on the first rank's host; the other ranks
    hold none of it."""
    _, ranks, _ = tp_ranks
    assert ranks[0][case + ".held"].all()
    for r in ranks[1:]:
        assert not r[case + ".held"].any()


@pytest.mark.parametrize("name", list(REFUSE))
def test_batch_layout_mismatch_refused(tp_ranks, name):
    """A data-parallel step refuses a batch whose rows are laid out for
    another microbatch count than its own (``TrainConfig.row_microbatches``:
    the step's in auto mode, one in manual-dp), on every rank."""
    _, ranks, _ = tp_ranks
    assert all(bool(r["refuse." + name]) for r in ranks)


def test_remat_keeps_the_bits_under_tensor_parallelism(tp_ranks):
    """qwen2-moe-a2.7b on (2, 2): the loss and every gradient under remat
    "full" and "save_tp" (the forward's collectives recomputed in the
    backward) the bits of "none", on every rank."""
    _, ranks, _ = tp_ranks
    assert all(bool(r["remat.qwen2-moe-a2.7b.same_bits"]) for r in ranks)


@pytest.mark.parametrize("arch", REMAT_ARCHS[1:])
def test_remat_keeps_the_bits_recurrent_and_encdec(tp_ranks, arch):
    """The recurrent and encoder-decoder families on (2, 2): remat "full"
    and "save_tp" give the loss and every gradient of "none", on every
    rank (their partial sums, and the blocks' sums over the group,
    recomputed in the backward)."""
    _, ranks, _ = tp_ranks
    assert all(bool(r[f"remat.{arch}.same_bits"]) for r in ranks)


@pytest.mark.parametrize("m,groups", OWN)
def test_own_gradient_matches_unsharded(tp_ranks, m, groups):
    """``tp.own`` of the partial products of u @ W (W split on its rows
    over m ranks), its part as ``groups`` blocks: the value and the
    gradients of W and u those of the unsharded product within
    MODULE_RTOL; the slice of the sum without the enter gets the gradient
    of W wrong."""
    _, ranks, _ = tp_ranks
    for r in ranks:
        fwd, dW, du, wrong_fwd, wrong_dW, _ = r[f"own.{m}.{groups}"]
        assert max(fwd, dW, du, wrong_fwd) <= MODULE_RTOL, r[f"own.{m}.{groups}"]
        assert wrong_dW > 0.1


@pytest.mark.parametrize("name", list(LOOP_COLLECTIVES))
def test_no_collective_in_the_time_loop(tp_ranks, name):
    """One mLSTM or sLSTM block's forward and backward under tensor
    parallelism makes as many all_reduce calls at either length: none
    runs inside the recurrence's time loop (or the mLSTM's chunk loop)."""
    _, ranks, _ = tp_ranks
    for r in ranks:
        short, long_ = r[f"loop.{name}"]
        assert 0 < short == long_, r[f"loop.{name}"]


def test_init_train_state_shards_the_one_rank_draw(tp_ranks):
    """init_train_state on (2, 2) from seed 0: gathered, the bits of the
    one-rank draw; m zero."""
    _, ranks, _ = tp_ranks
    cfg = PC.get_reduced(CKPT_ARCH)
    model = build_model(cfg, device="cpu")
    _, sh = PL.make_train_step(model, None, default_rules(None), PL.TrainConfig())
    params, _ = PL.init_train_state(model, None, sh, seed=0)
    want = [t.numpy() for _, t in _flatten(reference_layout(cfg, params,
                                                            lambda ts: torch.stack(ts)))]
    for r in ranks:
        for i, a in enumerate(want):
            np.testing.assert_array_equal(r[f"init.p{i}"], a)
            assert not r[f"init.m{i}"].any()


@pytest.mark.parametrize("name", list(MODULES))
def test_module_matches_unsharded(tp_ranks, name):
    """Each module on its model axis against the unsharded port: the value
    (summed against fixed weights) and every gradient (the parameters
    gathered, the input's) within MODULE_RTOL of its norm."""
    _, ranks, _ = tp_ranks
    for r in ranks:
        one, tp = r[f"mod.{name}.value"]
        np.testing.assert_allclose(tp, one, rtol=MODULE_RTOL)
        assert r[f"mod.{name}.grad_rel"].max() <= MODULE_RTOL, r[f"mod.{name}.grad_rel"]
        assert int(r[f"mod.{name}.sharded"]) > 0
    if MODULES[name][0] == "moe":
        assert ranks[0][f"mod.{name}.dropped"] > 0


@pytest.mark.parametrize("arch", PC.ALL_ARCHS)
def test_published_configs_shard_on_every_model_axis(arch):
    """The ten configs at their published widths, on model axes of 2, 4
    and 16: every rank's shards (meta tensors) take a layout the models
    run (the rules' fallbacks included: replicated KV heads under split
    query heads, replicated heads under a split output projection, a
    replicated vocab; a recurrent block's ``ffn`` split evenly, its heads
    this rank's or all of them), and the shards tile each leaf."""
    import dataclasses

    from repro_torch.launch.mesh import MeshShape
    from repro_torch.models import attention as A
    from repro_torch.models import blocks as B
    from repro_torch.models import encdec as E
    from repro_torch.models import recurrent as R
    from repro_torch.models.layers import tree_leaves, tree_map
    from repro_torch.models.model import abstract_params
    from repro_torch.models.transformer import layer_kinds
    from repro_torch.sharding.tp import TPContext, shard_params, split_dim

    class _Model:  # the two attributes build_shardings reads, on the meta device
        cfg = dataclasses.replace(PC.get_config(arch), n_layers=len(PC.get_config(arch).pattern)
                                  + 1)

        def param_specs(self):
            return abstract_params(self.cfg)

    model = _Model()
    cfg = model.cfg
    full = model.param_specs()[0]
    seen = set()
    for m in (2, 4, 16):
        mesh = MeshShape(("data", "model"), (1, m))
        _, _, specs = PL.build_shardings(model, mesh, default_rules(mesh))
        dims = PL.port_layout(model.cfg, PL._map_specs(split_dim, specs), PL._local_dim)
        for r in range(m):
            tp = TPContext(None, r, m, dims)
            local = shard_params(full, tp)
            tiles = tree_map(lambda t, f, d: t.shape == f.shape if d is None else (
                t.shape[d] * m == f.shape[d]
                and t.shape[:d] + t.shape[d + 1:] == f.shape[:d] + f.shape[d + 1:]),
                local, full, dims)
            assert all(tree_leaves(tiles))
            if cfg.arch_type == "encdec":
                attns = ([("enc+mlp", p["attn"]) for p in local["enc"]]
                         + [(k, p[k]) for p in local["dec"] for k in ("self", "cross")])
                layers = []
            else:
                layers = list(zip(layer_kinds(cfg), local["layers"]))
                attns = [(k, p["attn"]) for k, p in layers if k in B.ATTN_KINDS]
            for kind, p in attns:
                window = cfg.window if kind == "local+mlp" else None
                acfg = (E._self_cfg(cfg, kind != "cross") if kind in ("self", "cross")
                        else B._attn_cfg(cfg, window))
                acfg, ap, split = A.tp_local(acfg, p, tp)
                assert acfg.n_heads % acfg.n_kv == 0 and ap["wk"].shape[1] == acfg.n_kv
                seen.add((m, split, p["wk"].shape[1] < cfg.n_kv))
            for kind, p in layers:
                if kind == "attn+moe":
                    e_loc, f_loc = p["moe"]["wi"].shape[0], p["moe"]["wi"].shape[2]
                    e = cfg.moe_pad_to or cfg.moe_experts  # experts, or each one's ffn, split
                    assert (e_loc * m == e) != (f_loc * m == cfg.moe_d_expert)
                elif kind == "rglru+mlp":
                    split = R.tp_split(tp, p["rglru"], R.RGLRU_TP_DIMS, cfg.d_model)
                    seen.add((m, split, False))
                elif kind == "mlstm":
                    split = R.tp_split(tp, p["mlstm"], R.MLSTM_TP_DIMS,
                                       B._mlstm_cfg(cfg).d_inner, cfg.n_heads)
                    seen.add((m, "mlstm_" + str(split), False))
                elif kind == "slstm":
                    split = R.tp_split(tp, p["slstm"], R.SLSTM_TP_DIMS,
                                       B._slstm_cfg(cfg).d_inner, cfg.n_heads)
                    seen.add((m, "slstm_" + str(split), False))
    assert {s for _, s, _ in seen} <= {"heads", "out", "channels", "mlstm_heads", "mlstm_whole",
                                       "slstm_heads", "slstm_whole"}
    # the published fallbacks at model = 16: gemma3's, recurrentgemma's and
    # whisper's heads replicated under a split output projection (whisper's
    # at 4 too); internvl2's and granite's KV heads replicated under split
    # query heads; xlstm's 4 heads each over several ranks, whole on every
    # one, its own at 4
    want = {"gemma3-4b": [(16, "out", False)], "internvl2-76b": [(16, "heads", False)],
            "granite-moe-1b-a400m": [(16, "heads", False)],
            "recurrentgemma-2b": [(16, "out", False), (16, "channels", False)],
            "whisper-tiny": [(4, "out", False), (2, "heads", True)],
            "xlstm-350m": [(4, "mlstm_heads", False), (16, "mlstm_whole", False),
                           (4, "slstm_heads", False), (16, "slstm_whole", False)]}.get(arch, [])
    assert set(want) <= seen, (set(want) - seen)
