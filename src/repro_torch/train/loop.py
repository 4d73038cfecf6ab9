"""The train step and the training loop.

Two step flavors, the reference's, with explicit collectives where the
reference lets XLA derive them from shardings:

* **auto** (default): data parallelism over the mesh's batch axes ("pod",
  "data"). Each rank runs its rows of the global batch (what
  ``data.tokens.TokenDataset(mesh=..., microbatches=tcfg.row_microbatches)``
  hands it: its part of each of the global batch's microbatches; a batch
  laid out for another count is refused); gradients and the loss are
  averaged over the data group in f32. Microbatches split the rank's
  batch into ``microbatches`` contiguous chunks, as the reference's reshape
  ``(nm, b // nm)`` does, with gradients accumulated in f32. Where a
  microbatch's rows do not divide over the data ranks, a rank's chunk is
  padded to the shard's rows (``TokenBatch.shard_rows``, GSPMD's padded
  shard; none may be real) with rows that weigh nothing, so every rank
  runs the same shapes and every collective; each rank's cross entropy and
  the MoE's statistics are its terms of the global microbatch's
  (``sharding.tp.BatchShare``: its sum over the global count, summed over
  the data group before the mean is read). ``zero1``
  shards ``m``/``v`` over the data group on the dimension the reference's
  ``_opt_shardings`` picks; the update runs on the shard and the new
  parameter is all-gathered (a stacked leaf sharded on its layers axis is
  owned whole, layer by layer, by one rank, which broadcasts it).
  ``zero2_grads`` reduce-scatters the accumulator each microbatch. On one
  rank zero1 and zero2 change nothing. On a (pod, data, model) mesh the
  ZeRO group spans both batch axes, pod-major, as the reference's tuple
  entry ``("pod", "data")``.
* **manual-dp**: the reference's ``shard_map`` step: per-rank gradients
  reduced with the int8 compressed sum (+ error feedback, a third piece of
  state) from ``train.grad_compress``, or averaged in f32; the loss is
  averaged over the first data axis only, as the reference does. Each
  rank's rows must split into the microbatches, as the reference's
  ``shard_map`` reshape needs: an uneven layout is refused. The
  compression takes one scale per tensor of the reference's stacked tree
  (a pattern position's layers share it), so the gradients are stacked
  for it and unstacked after.

The placements of every parameter under the rules
(``sharding.rules.build_param_specs``) are computed in the reference's
stacked layout and returned in ``shardings``. A "model" axis larger than
one is tensor and expert parallelism (``sharding.tp``): each rank holds
its shards of the parameters split over "model" (``m``/``v`` too, ZeRO's
parts taken from the shard), the models run with the ``tp`` context, the
clip's norm is the full gradient's (squares of split leaves summed over
the model group, replicated leaves counted once) and int8 compression
takes each tensor's scale over the model group as well. Every family
trains so. ``mesh=None`` is one rank with no process group.

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
from repro_torch.sharding.tp import BatchShare, shard_params, split_dim, tp_context
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

    @property
    def row_microbatches(self) -> int:
        """The microbatches that a data-parallel rank's rows are laid out
        for (``TokenDataset(microbatches=)``): the step's own in auto mode,
        where the reference splits the global batch before sharding it; one
        in manual-dp, where it splits each rank's rows."""
        return self.microbatches if self.mode == "auto" else 1


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


def model_tp(model, mesh, rules: ShardingRules):
    """(shapes, logical axes, specs) of :func:`build_shardings` and the
    ``sharding.tp.TPContext`` of ``mesh``'s "model" axis under them (None
    where it has one rank): the one way that training and serving
    (``Model.shard``) derive which dimension of each parameter a model
    rank splits."""
    shapes, logical, specs = build_shardings(model, mesh, rules)
    tp = tp_context(mesh, port_layout(model.cfg, _map_specs(split_dim, specs), _local_dim))
    return shapes, logical, specs, tp


def _dp(mesh) -> tuple[tuple, int]:
    ba = batch_axes_for_mesh(mesh)
    sizes = axis_sizes(mesh)
    return ba, int(math.prod(sizes[a] for a in ba)) if ba else 1


def _batch_entry(ba: tuple):
    """The spec entry of the batch axes: one name, or the tuple."""
    return ba if len(ba) > 1 else ba[0]


def _batch_group(mesh, ba: tuple) -> tuple:
    """(group, this rank's index in it) over every batch axis of ``mesh``
    (a DeviceMesh), pod-major, among the ranks that share this rank's other
    coordinates; (None, 0) on one batch rank. Two axes make new groups:
    every rank of the mesh takes part, in the same order."""
    if _dp(mesh)[1] == 1:
        return None, 0
    if len(ba) == 1:
        return mesh.get_group(ba[0]), mesh.get_local_rank(ba[0])
    names = list(mesh.mesh_dim_names)
    ranks = mesh.mesh.permute([names.index(a) for a in ba]
                              + [i for i, a in enumerate(names) if a not in ba])
    ranks = ranks.reshape(math.prod(ranks.shape[:len(ba)]), -1)
    mine = None
    for j in range(ranks.shape[1]):
        col = ranks[:, j].tolist()
        group = dist.new_group(col)
        if dist.get_rank() in col:
            mine = (group, col.index(dist.get_rank()))
    return mine


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

    def to_first(self, part: Optional[torch.Tensor], like: torch.Tensor):
        """The full moment on the group's first rank, None on the others,
        which keep no copy: the parts gathered there, or a layer owned by
        another rank broadcast from it (``like``: the parameter, its shape
        and device; the moments are f32)."""
        if self.dim is not None:
            return _gather_to_first(part, self.group, self.rank, self.size, self.dim)
        if self.owner != 0:
            out = part if self.owner == self.rank else torch.empty(
                like.shape, dtype=torch.float32, device=like.device)
            dist.broadcast(out, src=dist.get_global_rank(self.group, self.owner),
                           group=self.group)
            part = out
        return part if self.rank == 0 else None

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


def _gather_to_first(t: torch.Tensor, group, rank: int, size: int, dim: int):
    """The ``size`` ranks' ``t`` concatenated on ``dim`` on the group's
    first rank (this one ``rank``), None on the others; gloo gathers on
    the host."""
    if dist.get_backend(group) == "gloo":
        t = t.cpu()
    parts = [torch.empty_like(t) for _ in range(size)] if rank == 0 else None
    dist.gather(t.contiguous(), parts, dst=dist.get_global_rank(group, 0), group=group)
    return None if parts is None else torch.cat(parts, dim=dim)


def _map_specs(fn, specs):
    if specs is None:
        return None
    if isinstance(specs, dict):
        return {k: _map_specs(fn, v) for k, v in specs.items()}
    if isinstance(specs, list):
        return [_map_specs(fn, v) for v in specs]
    return fn(specs)


def _placements(cfg, mesh, opt_specs, group, rank: int) -> Optional[Any]:
    """The port-layout tree of :class:`Zero1Leaf` (None: replicated) for the
    ZeRO specs over the batch ``group`` (this rank ``rank`` of it), or None
    on one data rank (nothing to shard)."""
    ba, dp = _dp(mesh)
    if dp == 1:
        return None
    dims = _map_specs(lambda s: next((i for i, e in enumerate(s) if e == _batch_entry(ba)),
                                     None), opt_specs)

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
    ZeRO-1 placements (None where a layer is owned by another rank), each
    its own storage (a view would hold the whole moment)."""
    state = optim.init_opt_state(params)
    if placements is None:
        return state

    def part(z, pl):
        if pl is None:
            return z
        local = pl.local(z)
        return None if local is None else local.clone()

    return {"m": tree_map(part, state["m"], placements),
            "v": tree_map(part, state["v"], placements), "step": state["step"]}


def make_train_step(model, mesh, rules: ShardingRules, tcfg: TrainConfig,
                    extra_batch_specs: Optional[dict] = None):
    """Returns (step_fn, shardings dict). auto: ``step(params, opt_state,
    batch)``; manual-dp: ``step(params, opt_state, err, batch)``; ``batch``
    is this rank's slice of the global batch."""
    cfg = model.cfg
    shapes, logical, param_sh, tp = model_tp(model, mesh, rules)
    opt_sh = _opt_shardings(mesh, rules, shapes, logical, param_sh, tcfg.zero1)
    ba, dp = _dp(mesh)
    batch_spec = (_batch_entry(ba) if ba else None,)
    batch_group, batch_rank = _batch_group(mesh, ba)
    # the cross entropy and the MoE's aux loss are over the global
    # microbatch (auto mode: the reference's manual-dp takes them over each
    # rank's rows)
    global_stats = tcfg.mode == "auto" and dp > 1
    # ZeRO-1 placements of m/v (and, for ZeRO-2, of the gradients): the
    # reference's zero1 specs whatever tcfg.zero1 says, as its zero2 uses them
    zero_sh = _opt_shardings(mesh, rules, shapes, logical, param_sh, True)["m"]
    places = (_placements(cfg, mesh, zero_sh, batch_group, batch_rank)
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

    def shares_of(chunks: list, rows: int, padded: int) -> list:
        """Each microbatch's :class:`BatchShare`: the real rows and scored
        tokens summed over the data group (one all-reduce)."""
        counts = [(c["labels"] >= 0).sum() for c in chunks]
        total = sum_over(torch.stack([torch.full_like(counts[0], rows)] + counts), groups)
        even = total[0] / dp
        return [BatchShare(batch_group, rows, padded, even,
                           torch.clamp_min(t, 1.0) / dp) for t in total[1:]]

    def grads_of(params, batch):
        laid = getattr(batch, "microbatches", tcfg.row_microbatches)
        if dp > 1 and laid != tcfg.row_microbatches:
            raise ValueError(
                f"the batch's rows are laid out for {laid} microbatches but the step takes "
                f"{tcfg.row_microbatches} (mode {tcfg.mode!r}): build the dataset with "
                f"TokenDataset(microbatches=TrainConfig.row_microbatches)")
        b = next(iter(batch.values())).shape[0]
        if b % nm:
            raise ValueError(f"{b} rows on each of the {dp} data ranks do not split into {nm} "
                             f"microbatches (the reference's reshape refuses this layout)")
        rows = b // nm
        chunks = [batch] if nm == 1 else [{k: v[i * rows:(i + 1) * rows]
                                           for k, v in batch.items()} for i in range(nm)]
        shares = [None] * nm
        if global_stats:
            padded = getattr(batch, "shard_rows", None) or rows
            shares = shares_of(chunks, rows, padded)
            if padded > rows:
                chunks = [_pad_rows(c, padded) for c in chunks]
        leaves = tree_map(lambda p: p.detach().requires_grad_(True), params)
        flat = tree_leaves(leaves)

        def one(mb, share):
            loss, ex = model.loss_fn(mb, mesh=mesh, params=leaves, tp=tp, share=share)
            gs = torch.autograd.grad(loss, flat, allow_unused=True, materialize_grads=True)
            return loss.detach(), ex, _leaves_like(leaves, list(gs))

        if nm == 1:
            loss, ex, g = one(chunks[0], shares[0])
            return loss, ex, (reduce2(g) if zero2 else g)
        acc, loss_sum = None, 0.0
        for i in range(nm):
            loss, _, g = one(chunks[i], shares[i])
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
                norm = _global_norm(grads, places, batch_group, tp)
                if not tcfg.zero1:
                    grads = tree_map(lambda g, pl, p: g if pl is None else pl.full(g, _f32_like(p)),
                                     grads, places, params)
            elif groups:
                grads = tree_map(lambda g: mean_over(g, groups), grads)
            if tp is not None and not zero2:
                norm = _global_norm(grads, None, None, tp)
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
                mean, err = compressed_psum_tree(
                    reference_layout(cfg, grads, stack), ba, reference_layout(cfg, err, stack),
                    dp, mesh, model_group=None if tp is None else tp.group)
                grads, err = port_layout(cfg, mean), port_layout(cfg, err)
            else:
                grads = tree_map(lambda g: mean_over(g, dp_groups), grads)
            loss = mean_over(loss, dp_groups[:1])
            norm = None if tp is None else _global_norm(grads, None, None, tp)
            new_params, new_opt, om = optim.adamw_update(opt_cfg, params, grads, opt_state,
                                                         norm=norm)
            return new_params, new_opt, err, {"loss": loss, **om}
    else:
        raise ValueError(tcfg.mode)

    shardings = {
        "params": param_sh, "opt": opt_sh, "data": batch_spec,
        "batch_shardings": batch_shardings, "param_shapes": shapes,
        "placements": places if tcfg.zero1 else None, "zero_specs": zero_sh,
        "zero_rank": batch_rank,
        "zero_size": dp, "batch_entry": _batch_entry(ba) if ba else None, "tp": tp,
    }
    return step, shardings


def _pad_rows(mb: dict, rows: int) -> dict:
    """``mb`` padded to ``rows`` rows that weigh nothing: labels masked
    (-1), every other input zero."""
    out = {}
    for k, v in mb.items():
        fill = torch.full((rows - v.shape[0],) + tuple(v.shape[1:]), -1 if k == "labels" else 0,
                          dtype=v.dtype, device=v.device)
        out[k] = torch.cat([v, fill])
    return out


def _local_dim(d, i, n):
    """A stacked leaf's split dimension as its port leaf's (a layer of it)."""
    return d if i is None or d is None else d - 1


def _global_norm(grads, places, zero_group, tp) -> torch.Tensor:
    """The norm of the full gradient from this rank's parts: the squares
    of ZeRO-2's parts (``places`` not None) summed over ``zero_group``,
    those of leaves split over the model axis (``tp``) over its group,
    replicated leaves counted once."""
    zero = torch.zeros((), device=next(g for g in tree_leaves(grads) if g is not None).device)
    z = places if places is not None else tree_map(lambda _: None, grads)
    m = tp.dims if tp is not None else tree_map(lambda _: None, grads)

    def sq(zsplit: bool, msplit: bool) -> torch.Tensor:
        return sum(tree_leaves(tree_map(
            lambda g, pl, d: torch.sum(torch.square(g))
            if g is not None and (pl is not None) == zsplit and (d is not None) == msplit
            else zero, grads, z, m)), zero)

    if tp is None:  # ZeRO-2 alone
        part = sq(True, False)
        dist.all_reduce(part, group=zero_group)
        return torch.sqrt(part + sq(False, False))
    split = sq(False, True)
    if places is not None:
        both, part = sq(True, True), sq(True, False)
        dist.all_reduce(both, group=zero_group)
        dist.all_reduce(part, group=zero_group)
        split = split + both
    else:
        part = zero
    dist.all_reduce(split, group=tp.group)
    return torch.sqrt(split + part + sq(False, False))


def _f32_like(p: torch.Tensor) -> torch.Tensor:
    """An f32 tensor of ``p``'s shape (the shape a gathered gradient takes)."""
    return torch.empty(p.shape, dtype=torch.float32, device=p.device)


def init_train_state(model, mesh, shardings, seed: int = 0):
    """Parameters drawn anew from a generator seeded ``seed`` on the
    model's device (``Model.init``), this rank's shards of them over the
    model axis (so every mesh starts from the bits of the one-rank draw),
    and the optimizer state, ``m``/``v`` this rank's ZeRO-1 parts when
    ``shardings`` places them."""
    device = model.weights.emb.device
    params = tree_map(lambda t: t.detach(),
                      model.init(torch.Generator(device=device).manual_seed(seed)))
    params = shard_params(params, shardings.get("tp"))
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


def _whole_on_first(t, p, pl, d, tp, batch_rank: int) -> Optional[torch.Tensor]:
    """One leaf made whole on the host of the default group's first rank
    (None on every other rank, which keeps nothing): ``t`` is this rank's
    ZeRO part of it (``pl``; None: whole over the batch group, where this
    rank is ``batch_rank``) of its shard on dimension ``d`` over the model
    axis (``tp``); ``p`` is that shard's parameter."""
    if pl is not None:
        t = pl.to_first(t, p)
    if batch_rank != 0:
        return None
    if tp is not None and d is not None:
        t = _gather_to_first(t, tp.group, tp.rank, tp.size, d)
    elif tp is not None and tp.rank != 0:
        return None
    return None if t is None else t.detach().cpu()


def save_train_state(manager, model, step: int, params, opt_state, shardings) -> None:
    """Checkpoint ``step`` in the reference's format: each leaf's ZeRO-1
    parts and model-axis shards gathered to the first rank of the default
    group and moved to its host before the next leaf (so no rank holds the
    whole state on its device, and the other ranks keep nothing), the trees
    in the reference's stacked layout; the file is a one-rank save of the
    same state. Every rank takes part in the gathers."""
    cfg = model.cfg
    tp, places = shardings.get("tp"), shardings.get("placements")
    unplaced = tree_map(lambda _: None, params)
    dims = unplaced if tp is None else tp.dims

    def whole(tree, pls):
        return tree_map(lambda t, p, pl, d: _whole_on_first(t, p, pl, d, tp,
                                                            shardings["zero_rank"]),
                        tree, params, pls, dims)

    p_host = whole(params, unplaced)
    m_host = whole(opt_state["m"], places or unplaced)
    v_host = whole(opt_state["v"], places or unplaced)
    if dist.is_available() and dist.is_initialized() and dist.get_rank() != 0:
        dist.barrier()
        return
    stack = lambda ts: torch.stack(ts)  # noqa: E731
    manager.save(step, reference_layout(cfg, p_host, stack),
                 {"m": reference_layout(cfg, m_host, stack),
                  "v": reference_layout(cfg, v_host, stack), "step": opt_state["step"]})
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
    None) in the port's layout on the model's device: the parameters and
    ``m``/``v`` this rank's shards over the model axis, ``m``/``v`` also
    its ZeRO-1 parts, each read as a shard of its memory-mapped leaf."""
    cfg = model.cfg
    device = model.weights.emb.device
    shapes = shardings["param_shapes"]
    rank, size = shardings["zero_rank"], shardings["zero_size"]
    tp = shardings.get("tp")
    model_dims = _map_specs(lambda s: None if tp is None else split_dim(s), shardings["params"])
    dims = None
    if shardings.get("placements") is not None:
        entry = shardings["batch_entry"]
        dims = _map_specs(lambda s: next((i for i, e in enumerate(s) if e == entry), None),
                          shardings["zero_specs"])

    def index(struct, md, d=None):
        """This rank's slices of a stacked leaf: ``md`` over the model axis,
        ``d`` over the ZeRO group."""
        idx = [slice(None)] * len(struct.shape)
        for dim, r, k in ((md, None if tp is None else tp.rank, None if tp is None else tp.size),
                          (d, rank, size)):
            if dim is not None:
                n = struct.shape[dim] // k
                idx[dim] = slice(r * n, (r + 1) * n)
        while idx and idx[-1] == slice(None):
            idx.pop()
        return tuple(idx)

    whole = _zip(index, shapes, model_dims)
    mv_index = whole if dims is None else _zip(
        lambda struct_d, md: index(struct_d[0], md, struct_d[1]),
        _zip(lambda struct, d: (struct, d), shapes, dims), model_dims)
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

        # in the key order of the model's own tree (the checkpoint's is
        # sorted): a step sums the gradients' squares in that order
        return tree_map(lambda s, t: None if t is None else t.to(device=device,
                                                                 dtype=dtype_of(s)),
                        model.params, tree_map(take, at, d))

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
