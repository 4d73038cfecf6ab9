"""qwen2-moe-a2.7b [moe]: 24L d_model=2048 16H (GQA kv=16) d_ff=1408
vocab=151936, MoE 60 routed experts top-4 + 4 shared
[hf:Qwen/Qwen1.5-MoE-A2.7B; hf].

Experts are padded 60 -> 64 for clean 16-way expert parallelism (pad experts
receive -inf router logits; gate renormalizes over real experts)."""
from repro_torch.models.model import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen2-moe-a2.7b",
        vocab=151936, d_model=2048, n_layers=24, n_heads=16, n_kv=16,
        d_ff=1408, head_dim=128,
        pattern=("attn+moe",), mlp_kind="swiglu", norm_kind="rms",
        moe_experts=60, moe_top_k=4, moe_d_expert=1408, moe_shared=4,
        moe_pad_to=64,
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="qwen2-moe-a2.7b-reduced",
        vocab=512, d_model=64, n_layers=2, n_heads=4, n_kv=4,
        d_ff=48, head_dim=16,
        pattern=("attn+moe",), mlp_kind="swiglu", norm_kind="rms",
        moe_experts=6, moe_top_k=4, moe_d_expert=48, moe_shared=2,
        moe_pad_to=8, kv_chunk=32, remat="none", dtype="float32",
    )


TRAIN_OVERRIDES = dict(microbatches=4, zero1=True)
