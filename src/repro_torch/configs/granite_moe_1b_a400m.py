"""granite-moe-1b-a400m [moe]: 24L d_model=1024 16H (GQA kv=8) d_ff=512
vocab=49155, MoE 32 experts top-8
[hf:ibm-granite/granite-3.0-1b-a400m-base; hf].

kv=8 does not divide the 16-way model axis -> KV replicated, decode via the
sequence-sharded split-KV path."""
from repro_torch.models.model import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="granite-moe-1b-a400m",
        vocab=49155, d_model=1024, n_layers=24, n_heads=16, n_kv=8,
        d_ff=512, head_dim=64,
        pattern=("attn+moe",), mlp_kind="swiglu", norm_kind="rms",
        moe_experts=32, moe_top_k=8, moe_d_expert=512, moe_shared=0,
        decode_seq_shard=True,
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="granite-moe-1b-a400m-reduced",
        vocab=512, d_model=64, n_layers=2, n_heads=4, n_kv=2,
        d_ff=32, head_dim=16,
        pattern=("attn+moe",), mlp_kind="swiglu", norm_kind="rms",
        moe_experts=8, moe_top_k=4, moe_d_expert=32, moe_shared=0,
        kv_chunk=32, remat="none", dtype="float32",
    )


TRAIN_OVERRIDES = dict(microbatches=4, zero1=True)
