"""Whisper-style encoder-decoder backbone.

As in the reference, the audio frontend (log-mel + strided convs) is a stub:
callers supply precomputed frame embeddings (B, T, d_model) and one linear
``frontend_proj`` stands in for the conv stack. Encoder layers are
bidirectional; decoder layers are causal self-attention, cross-attention
over the encoder output, then an MLP.

The parameters are ``{"emb", "frontend_proj", "final_norm", "enc": [one
dict per encoder layer], "dec": [one dict per decoder layer]}`` and the
decoder caches a list of per-layer K/V cache dicts. The cross-attention K/V
are projected from the encoder output at every call, decode steps included,
as the reference does.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.models import attention as A
from repro_torch.models import blocks as B
from repro_torch.models.layers import (
    MLPConfig, apply_mlp, apply_norm, init_embedding, init_linear, init_mlp, init_norm,
)
from repro_torch.models.transformer import embed_tokens, logits_from


def _self_cfg(cfg, causal: bool) -> A.AttnConfig:
    return A.AttnConfig(
        d_model=cfg.d_model, n_heads=cfg.n_heads, n_kv=cfg.n_kv,
        head_dim=cfg.head_dim, rope_theta=cfg.rope_theta,
        window=None, causal=causal, kv_chunk=cfg.kv_chunk,
    )


def _dec_layer_init(generator, cfg, dtype, device):
    params, specs = {}, {}
    params["norm1"], specs["norm1"] = init_norm(cfg.norm_kind, cfg.d_model, dtype, device)
    params["self"], specs["self"] = A.init_attention(generator, _self_cfg(cfg, True),
                                                     dtype, device)
    params["norm_x"], specs["norm_x"] = init_norm(cfg.norm_kind, cfg.d_model, dtype, device)
    params["cross"], specs["cross"] = A.init_attention(generator, _self_cfg(cfg, False),
                                                       dtype, device)
    params["norm2"], specs["norm2"] = init_norm(cfg.norm_kind, cfg.d_model, dtype, device)
    params["mlp"], specs["mlp"] = init_mlp(
        generator, MLPConfig(cfg.mlp_kind, cfg.d_model, cfg.d_ff), dtype, device)
    return params, specs


def init_params(cfg, generator: Optional[torch.Generator] = None, device=None):
    """(params, specs). Draws from ``generator`` on its device (embedding,
    frontend, encoder layers, decoder layers); with ``device="meta"`` it
    allocates nothing and needs no generator."""
    device = torch.device(device if device is not None else generator.device)
    dtype = cfg.torch_dtype
    params, specs = {}, {}
    params["emb"], specs["emb"] = init_embedding(generator, cfg.vocab, cfg.d_model, dtype, device)
    params["frontend_proj"], specs["frontend_proj"] = init_linear(
        generator, cfg.d_model, (cfg.d_model,), ("embed", "embed_out"), dtype, device)
    params["final_norm"], specs["final_norm"] = init_norm(cfg.norm_kind, cfg.d_model, dtype, device)
    params["enc"], specs["enc"] = [], []
    for _ in range(cfg.enc_layers):
        p, s = B.block_init("enc+mlp", generator, cfg, dtype, device)
        params["enc"].append(p)
        specs["enc"].append(s)
    params["dec"], specs["dec"] = [], []
    for _ in range(cfg.dec_layers):
        p, s = _dec_layer_init(generator, cfg, dtype, device)
        params["dec"].append(p)
        specs["dec"].append(s)
    return params, specs


def encode(cfg, params, frames: torch.Tensor) -> torch.Tensor:
    """frames: (B, T, d_model) stub embeddings -> encoder states."""
    x = torch.matmul(frames.to(cfg.torch_dtype), params["frontend_proj"])
    positions = torch.arange(x.shape[1], device=x.device)
    for p in params["enc"]:
        x, _, _ = B.block_apply("enc+mlp", cfg, p, x, positions)
    return x


def _dec_layer(cfg, p, x, enc_kv, positions, cache=None, decode=False):
    scfg = _self_cfg(cfg, True)
    xcfg = _self_cfg(cfg, False)
    h = apply_norm(cfg.norm_kind, p["norm1"], x)
    if decode:
        q, k1, v1 = A.project_qkv(scfg, p["self"], h, positions[:, None])
        cache = B._append_kv_cache(cache, k1, v1, positions)
        kd, vd = B._cache_kv_views(cfg, cache)
        attn = A.decode_attention(scfg, q, kd, vd, positions, cache["slot_pos"])
    else:
        q, k, v = A.project_qkv(scfg, p["self"], h, positions[None, :])
        if x.shape[1] > cfg.kv_chunk:
            attn = A.attention_chunked(scfg, q, k, v, positions, positions)
        else:
            attn = A.attention_full(scfg, q, k, v, positions, positions)
        if cache is not None:
            cache = B._fill_kv_cache(cache, k, v, positions)
    x = x + A.output_proj(scfg, p["self"], attn)

    # cross attention over the encoder's keys/values, chunked online softmax
    # when the decoder side is long. It is neither causal nor windowed, so
    # the query positions do not enter its mask: arange(sq) stands for them
    h = apply_norm(cfg.norm_kind, p["norm_x"], x)
    qx = A._proj(h, p["cross"]["wq"])
    ek, ev = enc_kv
    sq = h.shape[1]
    enc_pos = torch.arange(ek.shape[1], device=x.device)
    q_pos = torch.arange(sq, device=x.device)
    if sq * ek.shape[1] > cfg.kv_chunk * cfg.kv_chunk:
        xout = A.attention_chunked(xcfg, qx, ek, ev, q_pos, enc_pos)
    else:
        xout = A.attention_full(xcfg, qx, ek, ev, q_pos, enc_pos)
    x = x + A.output_proj(xcfg, p["cross"], xout)

    h = apply_norm(cfg.norm_kind, p["norm2"], x)
    x = x + apply_mlp(MLPConfig(cfg.mlp_kind, cfg.d_model, cfg.d_ff), p["mlp"], h)
    return x, cache


def _enc_kv(params, enc_out: torch.Tensor) -> list:
    """Each decoder layer's cross K/V projected from the encoder output."""
    return [(A._proj(enc_out, p["cross"]["wk"]), A._proj(enc_out, p["cross"]["wv"]))
            for p in params["dec"]]


def decoder_forward(cfg, params, tokens: torch.Tensor, enc_out: torch.Tensor,
                    caches: Optional[list] = None, decode: bool = False, pos=None):
    """Returns (logits, new caches or None). Decode: tokens (B, 1), pos (B,)."""
    x = embed_tokens(cfg, params, tokens)
    positions = pos if decode else torch.arange(x.shape[1], device=x.device)
    new_caches = None if caches is None else []
    for i, (p, ekv) in enumerate(zip(params["dec"], _enc_kv(params, enc_out))):
        c = None if caches is None else caches[i]
        x, nc = _dec_layer(cfg, p, x, ekv, positions, cache=c, decode=decode)
        if caches is not None:
            new_caches.append(nc)
    x = apply_norm(cfg.norm_kind, params["final_norm"], x)
    return logits_from(cfg, params, x), new_caches


def loss_fn(cfg, params, batch: dict, mesh=None):
    """batch: frames (B,T,D), tokens (B,S), labels (B,S)."""
    enc_out = encode(cfg, params, batch["frames"])
    logits, _ = decoder_forward(cfg, params, batch["tokens"], enc_out)
    labels = batch["labels"]
    logp = F.log_softmax(logits, dim=-1)
    # negative labels index from the end, as the reference's take_along_axis
    idx = torch.where(labels < 0, labels + logits.shape[-1], labels).long()
    ll = torch.gather(logp, -1, idx[..., None])[..., 0]
    mask = (labels >= 0).float()
    ce = -torch.sum(ll * mask) / torch.clamp_min(torch.sum(mask), 1.0)
    return ce, {"ce": ce, "aux": torch.zeros((), device=ce.device)}


def init_dec_caches(cfg, batch: int, max_seq: int, device) -> list[dict]:
    shape = (batch, max_seq, cfg.n_kv, cfg.head_dim)
    return [{"k": torch.zeros(shape, dtype=cfg.torch_dtype, device=device),
             "v": torch.zeros(shape, dtype=cfg.torch_dtype, device=device),
             "slot_pos": torch.full((batch, max_seq), -1, dtype=torch.int32, device=device)}
            for _ in range(cfg.dec_layers)]


def prefill(cfg, params, frames: torch.Tensor, tokens: torch.Tensor, max_seq: int):
    """Returns (last logits (B, 1, V), decoder caches, encoder output)."""
    enc_out = encode(cfg, params, frames)
    caches = init_dec_caches(cfg, tokens.shape[0], max_seq, enc_out.device)
    logits, caches = decoder_forward(cfg, params, tokens, enc_out, caches=caches)
    return logits[:, -1:], caches, enc_out


def decode_step(cfg, params, caches: list, enc_out: torch.Tensor, tokens1: torch.Tensor,
                pos: torch.Tensor):
    """tokens1: (B, 1); pos: (B,). Writes the new token's K/V into ``caches``."""
    return decoder_forward(cfg, params, tokens1, enc_out, caches=caches, decode=True, pos=pos)
