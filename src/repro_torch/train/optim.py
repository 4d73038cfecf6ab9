"""AdamW + LR schedule + global-norm clipping, the reference's arithmetic.

Plain functions on trees of tensors (nests of dicts and lists), not
``torch.optim.AdamW``: like the reference, the state is ``m`` and ``v`` in
f32 beside an int32 ``step``, there is no f32 master copy (each step
computes in f32 from the parameter and rounds the result back to its
dtype), the bias corrections are f32 powers of an f32 step and the clip
multiplies f32-cast gradients by ``min(1, max_norm / max(norm, 1e-9))``.
Every Python constant enters as the reference's weak-typed scalar does:
rounded to f32 where it meets an f32 tensor.

ZeRO-1 (``train.loop``) passes ``update_shardings``: a tree of
:class:`~repro_torch.train.loop.Zero1Leaf` placements. A sharded leaf's
update then runs on this rank's shard of ``m``, ``v``, the gradient and the
f32 parameter, and the new parameter is gathered over the data group.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.models.layers import tree_leaves, tree_map


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1


def _f32(x, device=None) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32)
    return torch.tensor(x, dtype=torch.float32, device=device)


def lr_at(cfg: AdamWConfig, step) -> torch.Tensor:
    """Linear warmup + cosine decay to min_lr_ratio * lr (an f32 scalar)."""
    step = _f32(step)
    warm = torch.clamp_max(step / max(cfg.warmup_steps, 1), 1.0)
    t = torch.clamp((step - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1),
                    0.0, 1.0)
    # the cosine of the f32 angle rounded once from f64: torch's f32 cos and
    # XLA's part by an ulp at times, which 1 + cos(.) near -1 magnifies
    cos = 0.5 * (1.0 + torch.cos((math.pi * t).double()).float())
    return cfg.lr * warm * (cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * cos)


def init_opt_state(params) -> dict:
    """Zero ``m`` and ``v`` in f32 of each parameter's shape, ``step`` 0."""
    leaves = tree_leaves(params)
    device = leaves[0].device if leaves else None
    return {
        "m": tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device),
                      params),
        "v": tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device),
                      params),
        "step": torch.zeros((), dtype=torch.int32, device=device),
    }


def global_norm(tree) -> torch.Tensor:
    total = 0
    for g in tree_leaves(tree):
        total = total + torch.sum(torch.square(g.to(torch.float32)))
    return torch.sqrt(_f32(total))


def clip_by_global_norm(grads, max_norm: float, norm=None):
    """(f32 gradients scaled to at most ``max_norm`` in global norm, the
    norm). ``norm`` passes a norm computed elsewhere (ZeRO-2's sharded
    gradients sum their squares over the data group)."""
    norm = global_norm(grads) if norm is None else norm
    scale = torch.clamp_max(max_norm / torch.clamp_min(norm, 1e-9), 1.0)
    # None: a layer whose ZeRO-2 gradient lives on another data rank
    return tree_map(lambda g: None if g is None else g.to(torch.float32) * scale, grads), norm


def adamw_update(cfg: AdamWConfig, params, grads, state, update_shardings=None, norm=None):
    """Returns (new_params, new_state, metrics ``{"grad_norm", "lr"}``).

    ``update_shardings`` (optional): the ZeRO-1 placements of
    ``train.loop``, one per parameter (None: replicated). ``m``/``v`` then
    hold this rank's shard of each placed leaf, ``grads`` the full
    gradient or, under ZeRO-2, the rank's shard (``norm`` is then the
    global norm over the data group).
    """
    grads32, gnorm = clip_by_global_norm(grads, cfg.clip_norm, norm)
    step = state["step"] + 1
    lr = lr_at(cfg, step)
    step32 = step.to(torch.float32)
    b1c = 1.0 - torch.pow(cfg.b1, step32)
    b2c = 1.0 - torch.pow(cfg.b2, step32)

    def upd(p, g, m, v):
        m_new = cfg.b1 * m + (1 - cfg.b1) * g
        v_new = cfg.b2 * v + (1 - cfg.b2) * g * g
        mh = m_new / b1c
        vh = v_new / b2c
        p32 = p.to(torch.float32)
        delta = mh / (torch.sqrt(vh) + cfg.eps) + cfg.weight_decay * p32
        return (p32 - lr * delta).to(p.dtype), m_new, v_new

    def one(p, g, m, v, place=None):
        if place is None:
            return upd(p, g, m, v)
        return place.update(upd, p, g, m, v)

    if update_shardings is None:
        out = tree_map(one, params, grads32, state["m"], state["v"])
    else:
        out = tree_map(one, params, grads32, state["m"], state["v"], update_shardings)
    is_out = lambda t: isinstance(t, tuple) and len(t) == 3 and not isinstance(t[0], tuple)  # noqa: E731
    new = [_pick(out, i, is_out) for i in range(3)]
    return new[0], {"m": new[1], "v": new[2], "step": step}, {"grad_norm": gnorm, "lr": lr}


def _pick(tree, i, is_out):
    if is_out(tree):
        return tree[i]
    if isinstance(tree, dict):
        return {k: _pick(v, i, is_out) for k, v in tree.items()}
    return [_pick(v, i, is_out) for v in tree]
