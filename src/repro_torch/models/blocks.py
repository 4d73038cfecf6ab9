"""Layer-kind blocks: pre-norm residual compositions of the sub-layers.

A model's depth structure is a *pattern*, a tuple of layer kinds cycled over
``n_layers`` (e.g. gemma3's ``("local+mlp",)*5 + ("attn+mlp",)``). Each kind
knows how to init, apply over a full sequence (prefill, filling a cache) and
apply a single decode step against its cache.

Block kinds:
  attn+mlp    global causal attention + dense MLP
  local+mlp   sliding-window attention + dense MLP
  enc+mlp     bidirectional attention + dense MLP (encoder layers)
  attn+moe    global causal attention + routed MoE
  rglru+mlp   RG-LRU recurrence + dense MLP (RecurrentGemma)
  mlstm       xLSTM matrix-memory block (self-contained projections)
  slstm       xLSTM scalar-memory block

Caches are dicts of tensors: K/V caches for the attention kinds, the
recurrent state for the others. :func:`_fill_kv_cache` and
:func:`_append_kv_cache` write into the cache they are given and return it;
a recurrent block returns a new state.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.models import attention as A
from repro_torch.models import moe as M
from repro_torch.models import recurrent as R
from repro_torch.models.layers import MLPConfig, apply_mlp, apply_norm, init_mlp, init_norm
from repro_torch.models.remat import checkpoint_name

ATTN_KINDS = ("attn+mlp", "local+mlp", "enc+mlp", "attn+moe")


def _attn_cfg(cfg, window=None) -> A.AttnConfig:
    return A.AttnConfig(
        d_model=cfg.d_model, n_heads=cfg.n_heads, n_kv=cfg.n_kv,
        head_dim=cfg.head_dim, rope_theta=cfg.rope_theta,
        window=window, causal=True, kv_chunk=cfg.kv_chunk,
    )


def _mlp_cfg(cfg) -> MLPConfig:
    return MLPConfig(cfg.mlp_kind, cfg.d_model, cfg.d_ff)


def _rglru_cfg(cfg) -> R.RGLRUConfig:
    return R.RGLRUConfig(d_model=cfg.d_model, d_rnn=cfg.d_model)


def _mlstm_cfg(cfg) -> R.MLSTMConfig:
    return R.MLSTMConfig(d_model=cfg.d_model, n_heads=cfg.n_heads, chunk=cfg.rnn_chunk)


def _slstm_cfg(cfg) -> R.SLSTMConfig:
    return R.SLSTMConfig(d_model=cfg.d_model, n_heads=cfg.n_heads)


def _moe_cfg(cfg) -> M.MoEConfig:
    return M.MoEConfig(
        d_model=cfg.d_model, n_experts=cfg.moe_experts, top_k=cfg.moe_top_k,
        d_expert=cfg.moe_d_expert, n_shared=cfg.moe_shared,
        pad_experts_to=cfg.moe_pad_to, mlp_kind=cfg.mlp_kind,
        capacity_factor=cfg.moe_capacity,
    )


# ---------------------------------------------------------------------- init

def block_init(kind: str, generator, cfg, dtype, device):
    params, specs = {}, {}
    params["norm1"], specs["norm1"] = init_norm(cfg.norm_kind, cfg.d_model, dtype, device)
    if kind in ATTN_KINDS:
        window = cfg.window if kind == "local+mlp" else None
        params["attn"], specs["attn"] = A.init_attention(
            generator, _attn_cfg(cfg, window), dtype, device)
        params["norm2"], specs["norm2"] = init_norm(cfg.norm_kind, cfg.d_model, dtype, device)
        if kind == "attn+moe":
            params["moe"], specs["moe"] = M.init_moe(generator, _moe_cfg(cfg), dtype, device)
        else:
            params["mlp"], specs["mlp"] = init_mlp(generator, _mlp_cfg(cfg), dtype, device)
    elif kind == "rglru+mlp":
        params["rglru"], specs["rglru"] = R.init_rglru(generator, _rglru_cfg(cfg), dtype, device)
        params["norm2"], specs["norm2"] = init_norm(cfg.norm_kind, cfg.d_model, dtype, device)
        params["mlp"], specs["mlp"] = init_mlp(generator, _mlp_cfg(cfg), dtype, device)
    elif kind == "mlstm":
        params["mlstm"], specs["mlstm"] = R.init_mlstm(generator, _mlstm_cfg(cfg), dtype, device)
    elif kind == "slstm":
        params["slstm"], specs["slstm"] = R.init_slstm(generator, _slstm_cfg(cfg), dtype, device)
    else:
        raise ValueError(f"unknown block kind {kind}")
    return params, specs


# --------------------------------------------------------------------- cache

def _quantize_kv(t: torch.Tensor):
    """Per-(token, head) symmetric int8: t (..., hd) -> (int8, f32 scale)."""
    tf = t.float()
    scale = torch.clamp_min(tf.abs().amax(dim=-1) / 127.0, 1e-8)
    # torch.round, like jnp.round, rounds half to even
    q = torch.clamp(torch.round(tf / scale[..., None]), -127, 127).to(torch.int8)
    return q, scale


def _dequantize_kv(q: torch.Tensor, scale: torch.Tensor, dtype) -> torch.Tensor:
    return (q.float() * scale[..., None]).to(dtype)


def block_cache(kind: str, cfg, batch: int, max_seq: int, dtype, device) -> dict:
    """Allocate an empty decode cache (or the zero recurrent state) for one
    layer of this kind."""
    if kind == "rglru+mlp":
        return R.rglru_state(_rglru_cfg(cfg), batch, dtype, device)
    if kind == "mlstm":
        return R.mlstm_state(_mlstm_cfg(cfg), batch, device)
    if kind == "slstm":
        return R.slstm_state(_slstm_cfg(cfg), batch, device)
    if kind not in ATTN_KINDS:
        raise ValueError(kind)
    s_c = min(max_seq, cfg.window) if kind == "local+mlp" else max_seq
    shape = (batch, s_c, cfg.n_kv, cfg.head_dim)
    cache = {"slot_pos": torch.full((batch, s_c), -1, dtype=torch.int32, device=device)}
    if cfg.kv_cache_dtype == "int8":
        cache["k"] = torch.zeros(shape, dtype=torch.int8, device=device)
        cache["v"] = torch.zeros(shape, dtype=torch.int8, device=device)
        cache["k_scale"] = torch.zeros(shape[:3], dtype=torch.float32, device=device)
        cache["v_scale"] = torch.zeros(shape[:3], dtype=torch.float32, device=device)
    else:
        cache["k"] = torch.zeros(shape, dtype=dtype, device=device)
        cache["v"] = torch.zeros(shape, dtype=dtype, device=device)
    return cache


def _cache_kv_views(cfg, cache: dict):
    """Dequantized (k, v) views of a cache (no-op for non-quantized)."""
    if "k_scale" in cache:
        dt = cfg.torch_dtype
        return (_dequantize_kv(cache["k"], cache["k_scale"], dt),
                _dequantize_kv(cache["v"], cache["v_scale"], dt))
    return cache["k"], cache["v"]


def _fill_kv_cache(cache: dict, k, v, positions) -> dict:
    """Write a full-sequence prefill into a (possibly rolling) cache."""
    vals = {"k": k, "v": v}
    if "k_scale" in cache:
        vals["k"], vals["k_scale"] = _quantize_kv(k)
        vals["v"], vals["v_scale"] = _quantize_kv(v)
    s = k.shape[1]
    s_c = cache["k"].shape[1]
    if s >= s_c:
        # keep the last s_c entries, placed at slot = pos % s_c; the rest of
        # the cache is cleared, as the reference rebuilds it from zeros
        positions = positions[-s_c:]
        vals = {name: t[:, -s_c:] for name, t in vals.items()}
        for name in vals:
            cache[name].zero_()
        cache["slot_pos"].fill_(-1)
    slots = positions % s_c
    for name, t in vals.items():
        cache[name][:, slots] = t
    cache["slot_pos"][:, slots] = positions[None, :].to(torch.int32)
    return cache


def _append_kv_cache(cache: dict, k1, v1, pos) -> dict:
    """Decode-step write. k1/v1: (B,1,Hkv,hd); pos: (B,) absolute position."""
    vals = {"k": k1[:, 0], "v": v1[:, 0]}
    if "k_scale" in cache:
        (vals["k"], vals["k_scale"]), (vals["v"], vals["v_scale"]) = (
            _quantize_kv(vals["k"]), _quantize_kv(vals["v"]))
    s_c = cache["k"].shape[1]
    slot = pos % s_c
    bidx = torch.arange(k1.shape[0], device=k1.device)
    for name, t in vals.items():
        cache[name][bidx, slot] = t
    cache["slot_pos"][bidx, slot] = pos.to(torch.int32)
    return cache


# --------------------------------------------------------------------- apply

def block_apply(
    kind: str, cfg, params, x: torch.Tensor, positions: torch.Tensor,
    cache: Optional[dict] = None, decode: bool = False, mesh=None,
):
    """Returns (y, new_cache, aux_loss).

    Forward: cache=None, decode=False. Prefill: cache allocated,
    decode=False (the cache is filled). Decode: cache carried, decode=True,
    x is (B, 1, D) and positions is (B,) absolute position of the new token.
    Only ``attn+moe`` has an auxiliary loss; the other kinds give 0.0.
    """
    aux = 0.0
    new_cache = cache

    if kind in ATTN_KINDS:
        window = cfg.window if kind == "local+mlp" else None
        acfg = _attn_cfg(cfg, window)
        if kind == "enc+mlp":
            acfg = A.AttnConfig(**{**acfg.__dict__, "causal": False})
        h = apply_norm(cfg.norm_kind, params["norm1"], x)
        if decode:
            q, k1, v1 = A.project_qkv(acfg, params["attn"], h, positions[:, None])
            if cfg.kv_cache_dtype == "int8" and cfg.decode_seq_shard and mesh is not None:
                raise NotImplementedError(
                    "int8 KV + sequence-sharded decode not wired together yet; "
                    "use one or the other (tracked as future work)"
                )
            if cfg.decode_seq_shard and mesh is not None:
                attn_out, kc, vc, sp = A.decode_append_attend_seqsharded(
                    acfg, mesh, cfg.decode_seq_axis, q, k1, v1,
                    cache["k"], cache["v"], positions, cache["slot_pos"],
                )
                new_cache = {"k": kc, "v": vc, "slot_pos": sp}
            else:
                new_cache = _append_kv_cache(cache, k1, v1, positions)
                kd, vd = _cache_kv_views(cfg, new_cache)
                attn_out = A.decode_attention(acfg, q, kd, vd, positions,
                                              new_cache["slot_pos"])
        else:
            q, k, v = A.project_qkv(acfg, params["attn"], h, positions[None, :])
            if cfg.q_chunk and x.shape[1] > cfg.q_chunk:
                attn_out = A.attention_chunked_q(acfg, q, k, v, positions, positions,
                                                 cfg.q_chunk)
            elif x.shape[1] > cfg.kv_chunk:
                attn_out = A.attention_chunked(acfg, q, k, v, positions, positions)
            else:
                attn_out = A.attention_full(acfg, q, k, v, positions, positions)
            if cache is not None:
                new_cache = _fill_kv_cache(cache, k, v, positions)
        # named for the "save_tp" remat policy, which keeps these two
        x = x + checkpoint_name(A.output_proj(acfg, params["attn"], attn_out), "tp_attn_out")
        h = apply_norm(cfg.norm_kind, params["norm2"], x)
        if kind == "attn+moe":
            y, aux = M.apply_moe(_moe_cfg(cfg), params["moe"], h)
        else:
            y = apply_mlp(_mlp_cfg(cfg), params["mlp"], h)
        return x + checkpoint_name(y, "tp_mlp_out"), new_cache, aux

    if kind == "rglru+mlp":
        h = apply_norm(cfg.norm_kind, params["norm1"], x)
        y, new_cache = R.apply_rglru(_rglru_cfg(cfg), params["rglru"], h, cache)
        x = x + y
        h = apply_norm(cfg.norm_kind, params["norm2"], x)
        return x + apply_mlp(_mlp_cfg(cfg), params["mlp"], h), new_cache, aux

    if kind == "mlstm":
        h = apply_norm(cfg.norm_kind, params["norm1"], x)
        mcfg = _mlstm_cfg(cfg)
        if decode or x.shape[1] < mcfg.chunk:
            mcfg = dataclasses.replace(mcfg, chunk=x.shape[1])
        y, new_cache = R.apply_mlstm(mcfg, params["mlstm"], h, cache)
        return x + y, new_cache, aux

    if kind == "slstm":
        h = apply_norm(cfg.norm_kind, params["norm1"], x)
        y, new_cache = R.apply_slstm(_slstm_cfg(cfg), params["slstm"], h, cache)
        return x + y, new_cache, aux

    raise ValueError(kind)
