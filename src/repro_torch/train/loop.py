"""The train step and the training loop.

Two step flavors, the reference's, with explicit collectives where the
reference lets XLA derive them from shardings:

* **auto** (default): data parallelism over the mesh's batch axes ("pod",
  "data"). Each rank runs its contiguous slice of the global batch (what
  ``data.tokens.TokenDataset(mesh=...)`` hands it); gradients and the loss
  are averaged over the data group in f32. Microbatches split the rank's
  batch into ``microbatches`` contiguous chunks, as the reference's reshape
  ``(nm, b // nm)`` does, with gradients accumulated in f32. ``zero1``
  shards ``m``/``v`` over the data group on the dimension the reference's
  ``_opt_shardings`` picks; the update runs on the shard and the new
  parameter is all-gathered (a stacked leaf sharded on its layers axis is
  owned whole, layer by layer, by one rank, which broadcasts it).
  ``zero2_grads`` reduce-scatters the accumulator each microbatch. On one
  rank zero1 and zero2 change nothing.
* **manual-dp**: the reference's ``shard_map`` step: per-rank gradients
  reduced with the int8 compressed sum (+ error feedback, a third piece of
  state) from ``train.grad_compress``, or averaged in f32; the loss is
  averaged over the first data axis only, as the reference does. The
  compression takes one scale per tensor of the reference's stacked tree
  (a pattern position's layers share it), so the gradients are stacked
  for it and unstacked after.

The placements of every parameter under the rules
(``sharding.rules.build_param_specs``) are computed in the reference's
stacked layout and returned in ``shardings``, but a "model" axis larger
than one (tensor or expert parallelism) is refused. ``mesh=None`` is one
rank with no process group.

The parameters are a tree of tensors in the port's layout
(``models.transformer``); a step draws its own leaves that require grad
from them and returns new tensors (nothing is updated in place). The
reference's ``_zero1_specs`` is a placeholder that changes nothing and has
no counterpart here.
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Any, Optional

import torch
import torch.distributed as dist

from repro_torch.interop import port_layout, reference_layout
from repro_torch.models.layers import tree_leaves, tree_map
from repro_torch.sharding.rules import (
    ShardingRules, axis_sizes, batch_axes_for_mesh, build_param_specs, spec_axes,
)
from repro_torch.train import optim
from repro_torch.train.grad_compress import compressed_psum_tree


@dataclasses.dataclass
class TrainConfig:
    opt: optim.AdamWConfig = dataclasses.field(default_factory=optim.AdamWConfig)
    microbatches: int = 1           # gradient-accumulation chunks per step
    zero1: bool = False             # shard optimizer m/v over the data axis
    zero2_grads: bool = False       # keep the grad accumulator DP-sharded
    grad_compress: bool = False     # int8 compressed DP all-reduce (manual-dp)
    mode: str = "auto"              # auto | manual-dp


def _zip(fn, tree, other):
    """``fn`` over the leaves of ``tree`` (None: an empty subtree) and the
    leaves at the same place in ``other``."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _zip(fn, v, other[k]) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_zip(fn, v, other[i]) for i, v in enumerate(tree)]
    return fn(tree, other)


def build_shardings(model, mesh, rules: ShardingRules):
    """(shapes, logical axes, specs) of the parameters in the reference's
    stacked layout: meta tensors, axes tuples and spec tuples, equal to
    the reference's ``build_shardings`` leaf by leaf."""
    cfg = model.cfg
    shapes, logical = model.param_specs()
    shapes = reference_layout(cfg, shapes, lambda ts: torch.empty(
        (len(ts),) + tuple(ts[0].shape), dtype=ts[0].dtype, device="meta"))
    logical = reference_layout(cfg, logical, lambda specs: (None,) + tuple(specs[0]),
                               is_leaf=lambda x: isinstance(x, tuple))
    return shapes, logical, build_param_specs(mesh, rules, shapes, logical)


def _dp(mesh) -> tuple[tuple, int]:
    ba = batch_axes_for_mesh(mesh)
    sizes = axis_sizes(mesh)
    return ba, int(math.prod(sizes[a] for a in ba)) if ba else 1


def _opt_shardings(mesh, rules, shapes, logical, param_sh, zero1: bool) -> dict:
    """The specs of ``m``/``v``: the parameters', or with ``zero1`` the
    batch axes added on the first free dimension they divide."""
    if not zero1:
        m = param_sh
    else:
        ba, dp = _dp(mesh)

        def one(struct, spec):
            spec = list(spec) + [None] * (len(struct.shape) - len(spec))
            if not set(ba) & spec_axes(spec):
                for i, e in enumerate(spec):
                    if e is None and struct.shape[i] % dp == 0 and struct.shape[i] >= dp:
                        spec[i] = ba if len(ba) > 1 else ba[0]
                        break
            return tuple(spec)

        m = _zip(one, shapes, param_sh)
    return {"m": m, "v": m, "step": ()}


@dataclasses.dataclass(frozen=True)
class Zero1Leaf:
    """Where one parameter's optimizer moments live over the data group
    (``size`` ranks, this one ``rank``): sharded on ``dim`` (each rank a
    contiguous ``1/size``), or, for a layer of a leaf the reference stacks
    and shards on its layers axis, whole on rank ``owner``."""

    group: Any
    rank: int
    size: int
    dim: Optional[int] = None
    owner: Optional[int] = None

    def local(self, t: torch.Tensor) -> Optional[torch.Tensor]:
        """This rank's part of the full ``t`` (None: a layer it does not own)."""
        if self.dim is not None:
            n = t.shape[self.dim] // self.size
            return t.narrow(self.dim, self.rank * n, n)
        return t if self.owner == self.rank else None

    def full(self, part: Optional[torch.Tensor], like: torch.Tensor) -> torch.Tensor:
        """The full tensor from every rank's part (``like``: its shape)."""
        if self.dim is not None:
            parts = [torch.empty_like(part) for _ in range(self.size)]
            dist.all_gather(parts, part.contiguous(), group=self.group)
            return torch.cat(parts, dim=self.dim)
        out = part if self.owner == self.rank else torch.empty(
            like.shape, dtype=like.dtype, device=like.device)
        dist.broadcast(out, src=dist.get_global_rank(self.group, self.owner), group=self.group)
        return out

    def update(self, upd, p, g, m, v):
        """``upd`` (``optim.adamw_update``'s elementwise step) on this rank's
        part; the new parameter gathered whole. ``g`` is full, or already
        this rank's part (ZeRO-2)."""
        pl = self.local(p)
        if pl is None:
            return self.full(None, p), None, None
        gl = g if g is None or g.shape != p.shape or self.dim is None else self.local(g)
        p_new, m_new, v_new = upd(pl, gl, m, v)
        return self.full(p_new, p), m_new, v_new

    def reduce(self, g: torch.Tensor) -> Optional[torch.Tensor]:
        """The sum over the data group of ``g`` (f32), left as this rank's
        part (reduce-scatter; the owner's reduce)."""
        if self.dim is None:
            dist.reduce(g, dst=dist.get_global_rank(self.group, self.owner), group=self.group)
            return g if self.owner == self.rank else None
        if dist.get_backend(self.group) == "gloo":  # gloo has no reduce-scatter
            dist.all_reduce(g, group=self.group)
            return self.local(g).contiguous()
        src = g.movedim(self.dim, 0).contiguous()
        out = torch.empty((src.shape[0] // self.size,) + src.shape[1:], dtype=g.dtype,
                          device=g.device)
        dist.reduce_scatter_tensor(out, src, group=self.group)
        return out.movedim(0, self.dim)


def _map_specs(fn, specs):
    if specs is None:
        return None
    if isinstance(specs, dict):
        return {k: _map_specs(fn, v) for k, v in specs.items()}
    if isinstance(specs, list):
        return [_map_specs(fn, v) for v in specs]
    return fn(specs)


def _placements(cfg, mesh, opt_specs) -> Optional[Any]:
    """The port-layout tree of :class:`Zero1Leaf` (None: replicated) for the
    ZeRO specs, or None on one data rank (nothing to shard)."""
    ba, dp = _dp(mesh)
    if dp == 1:
        return None
    if len(ba) > 1:
        raise NotImplementedError("ZeRO over two batch axes (pod, data) is not ported; "
                                  "use a (data, model) mesh")
    group, rank = mesh.get_group(ba[0]), mesh.get_local_rank(ba[0])
    dims = _map_specs(lambda s: next((i for i, e in enumerate(s) if e == ba[0]), None),
                      opt_specs)

    def leaf(d, i, n):
        if d is None:
            return None
        if i is None:
            return Zero1Leaf(group, rank, dp, dim=d)
        if d == 0:
            return Zero1Leaf(group, rank, dp, owner=i // (n // dp))
        return Zero1Leaf(group, rank, dp, dim=d - 1)

    return port_layout(cfg, dims, leaf)


def _leaves_like(like, flat: list):
    it = iter(flat)
    return tree_map(lambda _: next(it), like)


def init_opt_state(params, placements=None) -> dict:
    """``optim.init_opt_state``, with ``m``/``v`` this rank's parts under
    ZeRO-1 placements (None where a layer is owned by another rank)."""
    state = optim.init_opt_state(params)
    if placements is None:
        return state
    part = lambda z, pl: z if pl is None else pl.local(z)  # noqa: E731
    return {"m": tree_map(part, state["m"], placements),
            "v": tree_map(part, state["v"], placements), "step": state["step"]}


def make_train_step(model, mesh, rules: ShardingRules, tcfg: TrainConfig,
                    extra_batch_specs: Optional[dict] = None):
    """Returns (step_fn, shardings dict). auto: ``step(params, opt_state,
    batch)``; manual-dp: ``step(params, opt_state, err, batch)``; ``batch``
    is this rank's slice of the global batch."""
    cfg = model.cfg
    sizes = axis_sizes(mesh)
    if sizes.get("model", 1) > 1:
        raise NotImplementedError(
            f"training over a 'model' axis of {sizes['model']} (tensor or expert "
            "parallelism) is not ported yet; use a mesh with model=1")
    shapes, logical, param_sh = build_shardings(model, mesh, rules)
    opt_sh = _opt_shardings(mesh, rules, shapes, logical, param_sh, tcfg.zero1)
    ba, dp = _dp(mesh)
    batch_spec = (ba if len(ba) > 1 else (ba[0] if ba else None),)
    # ZeRO-1 placements of m/v (and, for ZeRO-2, of the gradients): the
    # reference's zero1 specs whatever tcfg.zero1 says, as its zero2 uses them
    zero_sh = _opt_shardings(mesh, rules, shapes, logical, param_sh, True)["m"]
    places = (_placements(cfg, mesh, zero_sh)
              if tcfg.mode == "auto" and (tcfg.zero1 or tcfg.zero2_grads) else None)
    groups = [] if mesh is None or dp == 1 else [mesh.get_group(a) for a in ba]

    def batch_shardings(batch_template: dict):
        return {k: extra_batch_specs[k] if extra_batch_specs and k in extra_batch_specs
                else batch_spec for k in batch_template}

    opt_cfg = tcfg.opt
    nm = tcfg.microbatches
    zero2 = tcfg.zero2_grads and places is not None

    def sum_over(t: torch.Tensor, grps) -> torch.Tensor:
        t = t.to(torch.float32).clone()
        for g in grps:
            dist.all_reduce(t, group=g)
        return t

    def mean_over(t: torch.Tensor, grps) -> torch.Tensor:
        return sum_over(t, grps) / math.prod(dist.get_world_size(g) for g in grps)

    def reduce2(g):
        """ZeRO-2: one microbatch's f32 gradient summed over the data group,
        left as this rank's part."""
        return tree_map(lambda t, pl: sum_over(t, groups) if pl is None
                        else pl.reduce(t.to(torch.float32).clone()), g, places)

    def grads_of(params, batch):
        leaves = tree_map(lambda p: p.detach().requires_grad_(True), params)
        flat = tree_leaves(leaves)

        def one(mb):
            loss, ex = model.loss_fn(mb, mesh=mesh, params=leaves)
            gs = torch.autograd.grad(loss, flat, allow_unused=True, materialize_grads=True)
            return loss.detach(), ex, _leaves_like(leaves, list(gs))

        if nm == 1:
            loss, ex, g = one(batch)
            return loss, ex, (reduce2(g) if zero2 else g)
        b = next(iter(batch.values())).shape[0]
        if b % nm:
            raise ValueError(f"batch of {b} rows does not split into {nm} microbatches")
        bm = b // nm
        acc, loss_sum = None, 0.0
        for i in range(nm):
            loss, _, g = one({k: v[i * bm:(i + 1) * bm] for k, v in batch.items()})
            g = reduce2(g) if zero2 else tree_map(lambda t: t.to(torch.float32), g)
            acc = g if acc is None else tree_map(
                lambda a, t: None if a is None else a + t, acc, g)
            loss_sum = loss_sum + loss
            del g
        grads = tree_map(lambda a: None if a is None else a / nm, acc)
        ce = loss_sum / nm
        return ce, {"ce": ce, "aux": torch.zeros((), device=ce.device)}, grads

    def metrics_of(ex, like: torch.Tensor) -> dict:
        return {k: torch.as_tensor(v, dtype=torch.float32, device=like.device)
                for k, v in ex.items()}

    if tcfg.mode == "auto":
        update_sh = places if tcfg.zero1 else None

        def step(params, opt_state, batch):
            loss, ex, grads = grads_of(params, batch)
            norm = None
            if zero2:
                grads = tree_map(lambda g: None if g is None else g / dp, grads)
                # the global norm: every rank's parts, then the replicated leaves once
                zero = torch.zeros((), device=loss.device)
                sq = lambda sharded: tree_map(  # noqa: E731
                    lambda g, pl: torch.sum(torch.square(g))
                    if g is not None and (pl is not None) == sharded else zero, grads, places)
                part = sum(tree_leaves(sq(True)), zero)
                dist.all_reduce(part, group=groups[0])
                norm = torch.sqrt(part + sum(tree_leaves(sq(False)), zero))
                if not tcfg.zero1:
                    grads = tree_map(lambda g, pl, p: g if pl is None else pl.full(g, _f32_like(p)),
                                     grads, places, params)
            elif groups:
                grads = tree_map(lambda g: mean_over(g, groups), grads)
            if groups:
                loss = mean_over(loss, groups)
                ex = {k: mean_over(torch.as_tensor(v, device=loss.device), groups)
                      for k, v in ex.items()}
            new_params, new_opt, om = optim.adamw_update(
                opt_cfg, params, grads, opt_state, update_shardings=update_sh, norm=norm)
            return new_params, new_opt, {"loss": loss, **metrics_of(ex, loss), **om}

    elif tcfg.mode == "manual-dp":
        dp_groups = [] if mesh is None else [mesh.get_group(a) for a in ba]

        def step(params, opt_state, err, batch):
            loss, _, grads = grads_of(params, batch)
            if tcfg.grad_compress:
                # one int8 scale per tensor of the reference's tree, whose
                # layers of one pattern position are stacked into one tensor
                stack = lambda ts: torch.stack(ts)  # noqa: E731
                mean, err = compressed_psum_tree(reference_layout(cfg, grads, stack), ba,
                                                 reference_layout(cfg, err, stack), dp, mesh)
                grads, err = port_layout(cfg, mean), port_layout(cfg, err)
            else:
                grads = tree_map(lambda g: mean_over(g, dp_groups), grads)
            loss = mean_over(loss, dp_groups[:1])
            new_params, new_opt, om = optim.adamw_update(opt_cfg, params, grads, opt_state)
            return new_params, new_opt, err, {"loss": loss, **om}
    else:
        raise ValueError(tcfg.mode)

    shardings = {
        "params": param_sh, "opt": opt_sh, "data": batch_spec,
        "batch_shardings": batch_shardings, "param_shapes": shapes,
        "placements": places if tcfg.zero1 else None, "zero_specs": zero_sh,
        "zero_rank": mesh.get_local_rank(ba[0]) if mesh is not None and ba else 0,
        "zero_size": dp,
    }
    return step, shardings


def _f32_like(p: torch.Tensor) -> torch.Tensor:
    """An f32 tensor of ``p``'s shape (the shape a gathered gradient takes)."""
    return torch.empty(p.shape, dtype=torch.float32, device=p.device)


def init_train_state(model, mesh, shardings, seed: int = 0):
    """Parameters drawn anew from a generator seeded ``seed`` on the
    model's device (``Model.init``), and the optimizer state, ``m``/``v``
    this rank's ZeRO-1 parts when ``shardings`` places them."""
    device = model.weights.emb.device
    params = tree_map(lambda t: t.detach(),
                      model.init(torch.Generator(device=device).manual_seed(seed)))
    return params, init_opt_state(params, shardings.get("placements"))


# ------------------------------------------------------------- checkpoints

def full_opt_state(params, opt_state, placements) -> dict:
    """``opt_state`` with every ZeRO-1 part gathered whole (a collective
    over the data group when ``placements`` is not None)."""
    if placements is None:
        return opt_state
    full = lambda t, pl, p: t if pl is None else pl.full(t, _f32_like(p))  # noqa: E731
    return {"m": tree_map(full, opt_state["m"], placements, params),
            "v": tree_map(full, opt_state["v"], placements, params),
            "step": opt_state["step"]}


def save_train_state(manager, model, step: int, params, opt_state, shardings) -> None:
    """Checkpoint ``step`` in the reference's format: ZeRO-1 parts gathered,
    the trees in the reference's stacked layout, written by the first rank
    of the default group (every rank takes part in the gather)."""
    cfg = model.cfg
    opt = full_opt_state(params, opt_state, shardings.get("placements"))
    if dist.is_available() and dist.is_initialized() and dist.get_rank() != 0:
        dist.barrier()
        return
    stack = lambda ts: torch.stack([t.detach().cpu() for t in ts])  # noqa: E731
    manager.save(step, reference_layout(cfg, params, stack),
                 {"m": reference_layout(cfg, opt["m"], stack),
                  "v": reference_layout(cfg, opt["v"], stack), "step": opt["step"]})
    if dist.is_available() and dist.is_initialized():
        dist.barrier()


@dataclasses.dataclass(frozen=True)
class _At:
    """A leaf of a stacked tree and where a port leaf takes it from: layer
    ``i`` of ``n`` (``i`` None: not stacked)."""

    x: Any
    i: Optional[int]
    n: Optional[int]


def restore_layout(manager, model, shardings, step=None):
    """(params, opt_state, step) from checkpoint ``step`` (the latest when
    None) in the port's layout on the model's device; ``m``/``v`` this
    rank's ZeRO-1 parts, each read as a shard of its memory-mapped leaf."""
    cfg = model.cfg
    device = model.weights.emb.device
    shapes = shardings["param_shapes"]
    whole = _map_specs(lambda s: (), shardings["params"])
    rank, size = shardings["zero_rank"], shardings["zero_size"]
    dims = None
    mv_index = whole
    if shardings.get("placements") is not None:
        dims = _map_specs(lambda s: next((i for i, e in enumerate(s) if e == "data"), None),
                          shardings["zero_specs"])

        def index(struct, d):
            if d is None:
                return ()
            n = struct.shape[d] // size
            return (slice(None),) * d + (slice(rank * n, (rank + 1) * n),)

        mv_index = _zip(index, shapes, dims)
    template = {"params": shapes, "opt": {"m": shapes, "v": shapes, "step": 0}}
    index_tree = {"params": whole, "opt": {"m": mv_index, "v": mv_index, "step": ()}}
    tree, manifest = manager.restore(step, template=template, shardings=index_tree)

    def port(ref, dtype_of, sharded: bool):
        at = port_layout(cfg, ref, _At)
        d = (tree_map(lambda _: None, at) if dims is None or not sharded
             else port_layout(cfg, dims, lambda d, i, n: d))

        def take(a, d):
            if a.i is None:
                return a.x
            if d == 0:  # a shard of the layers axis: this rank's layers only
                per = a.n // size
                return a.x[a.i - rank * per] if a.i // per == rank else None
            return a.x[a.i]

        # in the model's own key order (the checkpoint's is sorted)
        return tree_map(lambda s, t: None if t is None else t.to(device=device,
                                                                 dtype=dtype_of(s)),
                        model.param_specs()[0], tree_map(take, at, d))

    params = port(tree["params"], lambda s: s.dtype, False)
    f32 = lambda s: torch.float32  # noqa: E731
    opt = {"m": port(tree["opt"]["m"], f32, True), "v": port(tree["opt"]["v"], f32, True),
           "step": tree["opt"]["step"].to(device=device, dtype=torch.int32)}
    return params, opt, manifest["step"]


def train_loop(model, mesh, rules, tcfg: TrainConfig, dataset, steps: int,
               ckpt_manager=None, ckpt_every: int = 0, hooks: Optional[list] = None,
               params=None, opt_state=None, start_step: int = 0):
    """The end-to-end training loop (``examples/train_lm_torch.py`` uses it)."""
    step_fn, shardings = make_train_step(model, mesh, rules, tcfg)
    if params is None:
        params, opt_state = init_train_state(model, mesh, shardings)
    history = []
    for step in range(start_step, steps):
        t0 = time.perf_counter()
        batch = dataset(step)
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        loss = float(metrics["loss"])
        dt = time.perf_counter() - t0
        history.append({"step": step, "loss": loss, "dt": dt})
        for h in hooks or []:
            h(step, params, opt_state, metrics, dt)
        if ckpt_manager is not None and ckpt_every and (step + 1) % ckpt_every == 0:
            save_train_state(ckpt_manager, model, step + 1, params, opt_state, shardings)
    return params, opt_state, history
