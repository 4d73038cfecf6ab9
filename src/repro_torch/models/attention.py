"""GQA attention: projections, exact attention over a full sequence (one
materialized score matrix, online softmax over KV chunks, or doubly chunked
over query and KV chunks) and single-token decode over a KV cache.

Plain torch ops mirroring the reference's ``jnp``: the same ``NEG_INF``
fill, the same padding of KV positions to ``-10**9`` and the same masks. The
reference's score products ask for f32 results (``preferred_element_type``);
here they run on f32 copies of their operands, so bf16 scores are never
rounded to bf16. Probabilities are cast to the model dtype before the PV
product, as the reference casts them. The sequence-sharded split-KV decode
(:func:`decode_append_attend_seqsharded`) reassembles the exact softmax
from per-rank partial statistics with explicit collectives where the
reference uses ``shard_map`` with ``pmax``/``psum``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.distributed as dist

from repro_torch.models.layers import apply_rope, dtype_scalar, init_linear

NEG_INF = -1.0e30
PAD_POSITION = -(10 ** 9)


@dataclasses.dataclass(frozen=True)
class AttnConfig:
    d_model: int
    n_heads: int
    n_kv: int
    head_dim: int
    rope_theta: float = 10000.0
    window: Optional[int] = None     # sliding-window size (None = global)
    causal: bool = True
    q_scale: Optional[float] = None  # default 1/sqrt(head_dim)
    kv_chunk: int = 1024             # online-softmax chunk length


def init_attention(generator, cfg: AttnConfig, dtype, device):
    params, specs = {}, {}
    params["wq"], specs["wq"] = init_linear(
        generator, cfg.d_model, (cfg.n_heads, cfg.head_dim),
        ("embed", "heads", "head_dim"), dtype, device)
    params["wk"], specs["wk"] = init_linear(
        generator, cfg.d_model, (cfg.n_kv, cfg.head_dim),
        ("embed", "kv_heads", "head_dim"), dtype, device)
    params["wv"], specs["wv"] = init_linear(
        generator, cfg.d_model, (cfg.n_kv, cfg.head_dim),
        ("embed", "kv_heads", "head_dim"), dtype, device)
    params["wo"], specs["wo"] = init_linear(
        generator, cfg.n_heads * cfg.head_dim, (cfg.d_model,), ("heads_flat", "embed"),
        dtype, device, scale=(cfg.n_heads * cfg.head_dim) ** -0.5)
    return params, specs


def _proj(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """einsum("bsd,dhe->bshe") as one matmul on the flattened weight."""
    d, h, e = w.shape
    return torch.matmul(x, w.reshape(d, h * e)).unflatten(-1, (h, e))


def project_qkv(cfg: AttnConfig, params, x: torch.Tensor, positions: torch.Tensor):
    """x: (B, S, D) -> q (B,S,Hq,hd), k/v (B,S,Hkv,hd), RoPE applied."""
    q = apply_rope(_proj(x, params["wq"]), positions, cfg.rope_theta)
    k = apply_rope(_proj(x, params["wk"]), positions, cfg.rope_theta)
    v = _proj(x, params["wv"])
    return q, k, v


def output_proj(cfg: AttnConfig, params, attn_out: torch.Tensor) -> torch.Tensor:
    b, s = attn_out.shape[:2]
    flat = attn_out.reshape(b, s, cfg.n_heads * cfg.head_dim)
    return torch.matmul(flat, params["wo"])


def _scaled_q(cfg: AttnConfig, q: torch.Tensor) -> torch.Tensor:
    return q * dtype_scalar(cfg.q_scale or cfg.head_dim ** -0.5, q.dtype)


# ----------------------------------------------------------- full attention

def _expand_gqa(q: torch.Tensor, n_kv: int) -> torch.Tensor:
    """(B,S,Hq,hd) -> (B,S,Hkv,G,hd)."""
    b, s, hq, hd = q.shape
    return q.reshape(b, s, n_kv, hq // n_kv, hd)


def _band_mask(cfg: AttnConfig, q_positions, kv_positions) -> torch.Tensor:
    mask = torch.ones((q_positions.shape[0], kv_positions.shape[0]), dtype=torch.bool,
                      device=q_positions.device)
    if cfg.causal:
        mask &= q_positions[:, None] >= kv_positions[None, :]
    if cfg.window is not None:
        mask &= (q_positions[:, None] - kv_positions[None, :]) < cfg.window
    return mask


def attention_full(cfg: AttnConfig, q, k, v, q_positions, kv_positions) -> torch.Tensor:
    """Materialized-scores attention (short sequences / reference oracle)."""
    qg = _expand_gqa(_scaled_q(cfg, q), cfg.n_kv)
    scores = torch.einsum("bqhge,bkhe->bhgqk", qg.float(), k.float())
    mask = _band_mask(cfg, q_positions, kv_positions)
    scores = torch.where(mask, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bhgqk,bkhe->bqhge", probs, v)
    b, s = q.shape[:2]
    return out.reshape(b, s, cfg.n_heads, cfg.head_dim)


def attention_chunked(cfg: AttnConfig, q, k, v, q_positions, kv_positions) -> torch.Tensor:
    """Exact attention with online softmax over KV chunks (O(S) memory).

    The reference scans the chunks (``lax.scan``); this is the same loop in
    Python. Chunks that fall wholly outside the causal/window band are still
    visited and contribute exp(-inf) = 0, as in the reference.
    """
    b, sq, hq, hd = q.shape
    sk = k.shape[1]
    ck = min(cfg.kv_chunk, sk)
    n_chunks = (sk + ck - 1) // ck
    pad = n_chunks * ck - sk
    if pad:
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
        kv_positions = torch.nn.functional.pad(kv_positions, (0, pad), value=PAD_POSITION)
    qg = _expand_gqa(_scaled_q(cfg, q), cfg.n_kv).float()  # (b, sq, hkv, g, hd)

    g = hq // cfg.n_kv
    m = torch.full((b, cfg.n_kv, g, sq), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, cfg.n_kv, g, sq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, cfg.n_kv, g, sq, hd), dtype=torch.float32, device=q.device)
    for c in range(n_chunks):
        kb = k[:, c * ck:(c + 1) * ck]
        vb = v[:, c * ck:(c + 1) * ck]
        pb = kv_positions[c * ck:(c + 1) * ck]
        s = torch.einsum("bqhge,bkhe->bhgqk", qg, kb.float())
        mask = _band_mask(cfg, q_positions, pb)
        mask &= pb[None, :] >= 0  # padding chunk entries
        s = torch.where(mask, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum(
            "bhgqk,bkhe->bhgqe", p.to(q.dtype).float(), vb.float())
        m = m_new
    out = acc / torch.clamp_min(l, 1e-30)[..., None]
    out = out.permute(0, 3, 1, 2, 4).reshape(b, sq, cfg.n_heads, hd)
    return out.to(q.dtype)


def attention_chunked_q(cfg: AttnConfig, q, k, v, q_positions, kv_positions,
                        q_chunk: int) -> torch.Tensor:
    """Doubly-chunked attention: a loop over query chunks, each attending
    only the KV range its causal/window band can reach (aligned down to KV
    chunks); positions are ``arange`` in prefill, so index == position."""
    sq = q.shape[1]
    nq = (sq + q_chunk - 1) // q_chunk
    outs = []
    for i in range(nq):
        lo_q = i * q_chunk
        hi_q = min(sq, (i + 1) * q_chunk)
        hi_k = hi_q if cfg.causal else k.shape[1]
        lo_k = 0
        if cfg.window is not None:
            lo_k = max(0, lo_q - cfg.window + 1)
        lo_k = (lo_k // cfg.kv_chunk) * cfg.kv_chunk  # align to kv chunks
        outs.append(attention_chunked(
            cfg, q[:, lo_q:hi_q], k[:, lo_k:hi_k], v[:, lo_k:hi_k],
            q_positions[lo_q:hi_q], kv_positions[lo_k:hi_k],
        ))
    return torch.cat(outs, dim=1)


# ------------------------------------------------------------------- decode

def decode_attention(cfg: AttnConfig, q, k_cache, v_cache, pos, slot_positions) -> torch.Tensor:
    """Single-token attention over a cache.

    q: (B, 1, Hq, hd); caches: (B, S_cache, Hkv, hd); pos: (B,) current
    position; slot_positions: (B, S_cache) absolute position stored in each
    slot (-1 = empty). Works for both full and rolling (windowed) caches.
    """
    qg = _expand_gqa(_scaled_q(cfg, q), cfg.n_kv)[:, 0]  # (B, Hkv, G, hd)
    s = torch.einsum("bhge,bkhe->bhgk", qg.float(), k_cache.float())
    valid = (slot_positions >= 0) & (slot_positions <= pos[:, None])
    if cfg.window is not None:
        valid &= (pos[:, None] - slot_positions) < cfg.window
    s = torch.where(valid[:, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1).to(q.dtype)
    out = torch.einsum("bhgk,bkhe->bhge", p, v_cache)
    return out.reshape(q.shape[0], 1, cfg.n_heads, cfg.head_dim)


def decode_append_attend_seqsharded(
    cfg: AttnConfig, mesh, axis: str,
    q, k1, v1, k_cache, v_cache, pos, slot_positions,
):
    """Split-KV decode with in-shard cache append (FlashDecoding across
    ranks).

    This rank holds one contiguous shard of the cache's sequence dimension:
    shard ``i`` of the ``axis`` group of ``mesh`` (a ``DeviceMesh``) holds
    slots ``[i * S_local, (i + 1) * S_local)`` of ``S_total = S_local *
    size``. Its rows are its shard of the batch over the config's
    ``decode_batch_axes`` (the caller hands every argument as this rank's
    rows; the reference's ``shard_map`` splits them). The new token's K/V is written by the one
    shard that owns slot ``pos % S_total``; then each rank takes its partial
    max, the group's max (``all_reduce(MAX)``), ``p = exp(s - m_glob)``, and
    the group's sums (``all_reduce(SUM)``) of ``l`` and of the weighted V;
    the result is ``o / max(l, 1e-30)``. The per-token collective volume is
    O(B * Hq * hd). Writes into the cache shards it is given and returns
    (attn_out, k_cache, v_cache, slot_positions).
    """
    group = mesh.get_group(axis)
    shard = mesh.get_local_rank(axis)
    s_local = k_cache.shape[1]
    s_total = s_local * mesh.size(mesh.mesh_dim_names.index(axis))
    b = q.shape[0]
    bidx = torch.arange(b, device=q.device)
    slot = pos % s_total
    local = slot - shard * s_local
    mine = (local >= 0) & (local < s_local)
    local_c = torch.clamp(local, 0, s_local - 1)
    k_cache[bidx, local_c] = torch.where(mine[:, None, None], k1[:, 0], k_cache[bidx, local_c])
    v_cache[bidx, local_c] = torch.where(mine[:, None, None], v1[:, 0], v_cache[bidx, local_c])
    slot_positions[bidx, local_c] = torch.where(mine, pos.to(torch.int32),
                                                slot_positions[bidx, local_c])

    qg = _expand_gqa(_scaled_q(cfg, q), cfg.n_kv)[:, 0]
    s = torch.einsum("bhge,bkhe->bhgk", qg.float(), k_cache.float())
    valid = (slot_positions >= 0) & (slot_positions <= pos[:, None])
    if cfg.window is not None:
        valid &= (pos[:, None] - slot_positions) < cfg.window
    s = torch.where(valid[:, None, None, :], s, NEG_INF)
    m_glob = s.amax(dim=-1)                                   # (B, Hkv, G)
    dist.all_reduce(m_glob, op=dist.ReduceOp.MAX, group=group)
    p = torch.exp(s - m_glob[..., None])
    l_glob = p.sum(dim=-1)
    o_glob = torch.einsum("bhgk,bkhe->bhge", p.to(q.dtype).float(), v_cache.float())
    dist.all_reduce(l_glob, op=dist.ReduceOp.SUM, group=group)
    dist.all_reduce(o_glob, op=dist.ReduceOp.SUM, group=group)
    out = o_glob / torch.clamp_min(l_glob, 1e-30)[..., None]
    out = out.reshape(b, 1, cfg.n_heads, cfg.head_dim).to(q.dtype)
    return out, k_cache, v_cache, slot_positions
