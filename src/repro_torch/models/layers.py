"""Shared neural layers: norms, rotary embeddings, MLP variants, initializers.

Every ``init_*`` returns ``(params, specs)``: a nested dict of tensors and a
matching nested dict of *logical axis tuples* (strings or None per dim), the
names the reference's sharding rules map onto mesh axes. Weights keep the
reference's layout, ``(d_in, *d_out)``, so they cross without transposes.

Initialisation draws from an explicit ``torch.Generator`` on the parameters'
device; on the ``meta`` device (``generator=None``) it allocates nothing and
only the shapes and dtypes exist.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Callable, Optional

import torch
import torch.nn.functional as F


# ------------------------------------------------------------------- pytrees

def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """Apply ``fn`` to every leaf of a nest of dicts, lists and tuples (to
    the leaves at the same place in ``rest``, trees of the same structure,
    as further arguments)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree))
    return fn(tree, *rest)


def tree_leaves(tree: Any) -> list:
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


@functools.lru_cache(maxsize=None)
def dtype_scalar(c: float, dtype: torch.dtype) -> float:
    """``c`` rounded to ``dtype``. The reference multiplies by Python
    scalars, which JAX casts to the array's dtype first; torch keeps them in
    its f32 op math, so the port rounds them here to get the same product."""
    return float(torch.tensor(c, dtype=dtype))


# ---------------------------------------------------------------------- init

def _normal(generator: Optional[torch.Generator], shape: tuple, scale: float,
            dtype: torch.dtype, device) -> torch.Tensor:
    device = torch.device(device)
    if device.type == "meta":
        return torch.empty(shape, dtype=dtype, device=device)
    x = torch.randn(shape, generator=generator, device=device, dtype=torch.float32)
    return (x * scale).to(dtype)


def init_linear(generator, d_in: int, d_out_shape: tuple, axes: tuple, dtype,
                device, scale: Optional[float] = None):
    """Weight of shape (d_in, *d_out_shape); fan-in scaled init."""
    shape = (d_in,) + tuple(d_out_shape)
    scale = scale if scale is not None else d_in ** -0.5
    return _normal(generator, shape, scale, dtype, device), axes


def init_embedding(generator, vocab: int, d: int, dtype, device):
    # std d^-0.5: with the sqrt(d) input scaling this gives unit-RMS token
    # embeddings AND unit-variance tied logits
    return _normal(generator, (vocab, d), d ** -0.5, dtype, device), ("vocab", "embed")


# ---------------------------------------------------------------------- norm

def init_norm(kind: str, d: int, dtype, device):
    """kind: rms | layernorm | nonparam  (olmo-style non-parametric LN)."""
    if kind == "rms":
        # gemma convention: stored as zero-centered, applied as (1 + scale)
        return {"scale": torch.zeros((d,), dtype=dtype, device=device)}, {"scale": ("embed",)}
    if kind == "layernorm":
        return (
            {"scale": torch.ones((d,), dtype=dtype, device=device),
             "bias": torch.zeros((d,), dtype=dtype, device=device)},
            {"scale": ("embed",), "bias": ("embed",)},
        )
    if kind == "nonparam":
        return {}, {}
    raise ValueError(kind)


def apply_norm(kind: str, params, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    if kind == "rms":
        y = xf * torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
        return (y * (1.0 + params["scale"].float())).to(x.dtype)
    mean = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.var(xf, dim=-1, keepdim=True, correction=0)  # jnp.var: population
    y = (xf - mean) * torch.rsqrt(var + eps)
    if kind == "layernorm":
        y = y * params["scale"].float() + params["bias"].float()
    return y.to(x.dtype)


# ---------------------------------------------------------------------- rope

def rope_freqs(head_dim: int, theta: float = 10000.0, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float = 10000.0) -> torch.Tensor:
    """x: (..., S, H, hd); positions: broadcastable to (..., S). Rotates the
    two halves of ``hd`` (split, not interleaved) in f32."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, device=x.device)            # (hd/2,)
    angles = positions[..., None].float() * freqs             # (..., S, hd/2)
    cos = torch.cos(angles)[..., None, :]                     # (..., S, 1, hd/2)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ----------------------------------------------------------------------- mlp

@dataclasses.dataclass(frozen=True)
class MLPConfig:
    kind: str        # swiglu | geglu | gelu
    d_model: int
    d_ff: int


def init_mlp(generator, cfg: MLPConfig, dtype, device):
    gated = cfg.kind in ("swiglu", "geglu")
    params, specs = {}, {}
    params["wi"], specs["wi"] = init_linear(generator, cfg.d_model, (cfg.d_ff,),
                                            ("embed", "ffn"), dtype, device)
    if gated:
        params["wg"], specs["wg"] = init_linear(generator, cfg.d_model, (cfg.d_ff,),
                                                ("embed", "ffn"), dtype, device)
    params["wo"], specs["wo"] = init_linear(generator, cfg.d_ff, (cfg.d_model,),
                                            ("ffn", "embed"), dtype, device)
    return params, specs


def apply_mlp(cfg: MLPConfig, params, x: torch.Tensor, tp=None) -> torch.Tensor:
    """With ``tp`` (``sharding.tp.TPContext``) and ``ffn`` split over the
    model axis: ``wi``/``wg`` column-parallel, ``wo`` row-parallel, the
    partial sums left through the group."""
    split = tp is not None and params["wi"].shape[1] < cfg.d_ff
    if split:
        x = tp.enter(x)
    h = torch.matmul(x, params["wi"])
    if cfg.kind == "swiglu":
        h = F.silu(torch.matmul(x, params["wg"])) * h
    elif cfg.kind == "geglu":
        # jax.nn.gelu defaults to the tanh approximation
        h = F.gelu(torch.matmul(x, params["wg"]), approximate="tanh") * h
    elif cfg.kind == "gelu":
        h = F.gelu(h, approximate="tanh")
    else:
        raise ValueError(cfg.kind)
    y = torch.matmul(h, params["wo"])
    return tp.leave(y) if split else y


# ------------------------------------------------------------------- utility

def count_params(params) -> int:
    return int(sum(math.prod(p.shape) for p in tree_leaves(params)))
