"""internvl2-76b [vlm]: 80L d_model=8192 64H (GQA kv=8) d_ff=28672
vocab=128256 — InternViT + (Llama-3-70B-style) LM backbone
[arXiv:2404.16821; unverified].

The vision frontend (InternViT-6B) is a STUB per the assignment:
input_specs() supplies 256 precomputed patch embeddings per example that are
prepended to the token embeddings. kv=8 < 16-way model axis -> KV replicated;
decode uses the sequence-sharded split-KV path."""
from repro_torch.models.model import ModelConfig

PREFIX_LEN = 256  # vision patch tokens per image


def config() -> ModelConfig:
    return ModelConfig(
        name="internvl2-76b",
        vocab=128256, d_model=8192, n_layers=80, n_heads=64, n_kv=8,
        d_ff=28672, head_dim=128,
        pattern=("attn+mlp",), mlp_kind="swiglu", norm_kind="rms",
        prefix_len=PREFIX_LEN,
        decode_seq_shard=True,
        rope_theta=500_000.0,
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="internvl2-76b-reduced",
        vocab=512, d_model=64, n_layers=3, n_heads=8, n_kv=2,
        d_ff=224, head_dim=8,
        pattern=("attn+mlp",), mlp_kind="swiglu", norm_kind="rms",
        prefix_len=4, kv_chunk=32, remat="none", dtype="float32",
    )


# the reference's training overrides for 76B: shard optimizer state and the
# f32 grad accumulator over DP, one sequence per device per microbatch.
TRAIN_OVERRIDES = dict(microbatches=16, zero1=True, zero2_grads=True)
