"""Mixture-of-Experts layer: GShard-style top-k routing with capacity,
shared experts (Qwen-MoE style), expert padding and the load-balancing
auxiliary loss, in the reference's dense one-hot formulation.

Tokens are dispatched in groups of about ``group_tokens``; each expert takes
at most ``capacity`` tokens of a group, in token order, and the rest of its
(token, choice) pairs drop (their gate is zeroed, so the token keeps its
residual and the shared experts). Dispatch and combine are einsums over
one-hot tensors, never scatters: on the card a scatter-add sums in an order
that changes from run to run.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.models.layers import MLPConfig, apply_mlp, init_linear, init_mlp, _normal


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    d_model: int
    n_experts: int          # routed experts (real)
    top_k: int
    d_expert: int           # per-expert FFN width
    n_shared: int = 0       # always-on shared experts (fused into one MLP)
    capacity_factor: float = 1.25
    pad_experts_to: int | None = None   # pad E for divisibility (EP sharding)
    mlp_kind: str = "swiglu"
    aux_weight: float = 0.01
    group_tokens: int = 1024  # dispatch group length: bounds the (g,s,e,c)
                              # one-hot tensors at s*e*cap ~ O(group^2*k/cf)

    @property
    def e_padded(self) -> int:
        return self.pad_experts_to or self.n_experts

    def shared_mlp(self) -> MLPConfig:
        return MLPConfig(self.mlp_kind, self.d_model, self.n_shared * self.d_expert)


def init_moe(generator, cfg: MoEConfig, dtype, device):
    e = cfg.e_padded
    params, specs = {}, {}
    params["wg"], specs["wg"] = init_linear(generator, cfg.d_model, (e,), ("embed", None),
                                            dtype, device)
    scale = cfg.d_model ** -0.5
    params["wi"] = _normal(generator, (e, cfg.d_model, cfg.d_expert), scale, dtype, device)
    params["wg_up"] = _normal(generator, (e, cfg.d_model, cfg.d_expert), scale, dtype, device)
    params["wo"] = _normal(generator, (e, cfg.d_expert, cfg.d_model), cfg.d_expert ** -0.5,
                           dtype, device)
    specs["wi"] = ("expert", "embed", "ffn")
    specs["wg_up"] = ("expert", "embed", "ffn")
    specs["wo"] = ("expert", "ffn", "embed")
    if cfg.n_shared:
        params["shared"], specs["shared"] = init_mlp(generator, cfg.shared_mlp(), dtype, device)
        params["shared_gate"], specs["shared_gate"] = init_linear(
            generator, cfg.d_model, (1,), ("embed", None), dtype, device)
    return params, specs


def group_shape(cfg: MoEConfig, b: int, s: int) -> tuple[int, int]:
    """(groups, tokens a group): each row is split into the largest count
    of equal groups not above ``s // group_tokens`` (at least one)."""
    split = max(1, s // cfg.group_tokens)
    while s % split:
        split -= 1
    return b * split, s // split


def capacity(cfg: MoEConfig, s: int) -> int:
    """Slots of each expert in a group of ``s`` tokens."""
    return max(1, int(s * cfg.top_k * cfg.capacity_factor / cfg.n_experts))


def route(cfg: MoEConfig, params, x: torch.Tensor) -> dict:
    """Routing of grouped tokens x (G, s, D): router ``probs`` (G,s,E) in
    f32, the top-k ``gate_idx`` (G,s,k) lowest index first on ties (as
    ``jax.lax.top_k``), the renormalised ``gate_vals`` with dropped pairs
    zeroed, each pair's ``pos`` in its expert's buffer (f32), ``keep`` =
    pos < capacity, the choices' ``onehot`` (G,s,k,E) and ``capacity``."""
    b, s, _ = x.shape
    e = cfg.e_padded
    cap = capacity(cfg, s)
    logits = torch.matmul(x, params["wg"]).float()
    if e > cfg.n_experts:  # mask padded experts out of routing
        pad_mask = torch.arange(e, device=x.device) >= cfg.n_experts
        logits = torch.where(pad_mask, -1e30, logits)
    probs = torch.softmax(logits, dim=-1)
    # a stable descending sort keeps tied experts in index order
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate_vals, gate_idx = vals[..., :cfg.top_k], idx[..., :cfg.top_k]
    gate_vals = gate_vals / torch.clamp_min(gate_vals.sum(dim=-1, keepdim=True), 1e-9)

    experts = torch.arange(e, device=x.device)
    onehot = (gate_idx[..., None] == experts).float()             # (b, s, k, e)
    flat = onehot.reshape(b, s * cfg.top_k, e)
    pos_in_expert = (torch.cumsum(flat, dim=1) - flat).reshape(b, s, cfg.top_k, e)
    pos = torch.sum(pos_in_expert * onehot, dim=-1)               # (b, s, k)
    keep = pos < cap
    return {"probs": probs, "gate_idx": gate_idx, "gate_vals": gate_vals * keep,
            "pos": pos, "keep": keep, "onehot": onehot, "capacity": cap}


def apply_moe(cfg: MoEConfig, params, x: torch.Tensor):
    """x: (B, S, D) -> (y, aux_loss)."""
    b_orig, s_orig, d = x.shape
    x = x.reshape(*group_shape(cfg, b_orig, s_orig), d)
    r = route(cfg, params, x)
    onehot, keep = r["onehot"], r["keep"]

    # dispatch/combine tensors (b, s, e, c) in the model dtype: each
    # (token, expert) pair has at most one choice, so the sums over k are exact
    slots = torch.arange(r["capacity"], device=x.device)
    pos_onehot = (r["pos"][..., None] == slots).float() * keep[..., None]
    dispatch = torch.einsum("bske,bskc->bsec", onehot, pos_onehot).to(x.dtype)
    combine = torch.einsum("bske,bskc->bsec", r["gate_vals"][..., None] * onehot,
                           pos_onehot).to(x.dtype)

    xe = torch.einsum("bsec,bsd->becd", dispatch, x)              # (b, e, c, d)
    gb, e, c, _ = xe.shape
    xe_e = xe.permute(1, 0, 2, 3).reshape(e, gb * c, d)           # experts batched
    h = torch.bmm(xe_e, params["wi"])
    hg = torch.bmm(xe_e, params["wg_up"])
    if cfg.mlp_kind == "swiglu":
        h = F.silu(hg) * h
    else:  # jax.nn.gelu defaults to the tanh approximation
        h = F.gelu(hg, approximate="tanh") * h
    ye = torch.bmm(h, params["wo"]).reshape(e, gb, c, d).permute(1, 0, 2, 3)
    y = torch.einsum("bsec,becd->bsd", combine, ye)

    if cfg.n_shared:
        gate = torch.sigmoid(torch.matmul(x, params["shared_gate"]).float()).to(x.dtype)
        y = y + gate * apply_mlp(cfg.shared_mlp(), params["shared"], x)

    # Switch-style load-balance aux loss over the *real* experts
    me = onehot.sum(dim=2).mean(dim=(0, 1))[:cfg.n_experts]      # fraction routed
    pe = r["probs"].mean(dim=(0, 1))[:cfg.n_experts]              # mean prob
    aux = cfg.n_experts * torch.sum(me * pe) * cfg.aux_weight
    return y.reshape(b_orig, s_orig, d), aux
