"""deepseek-7b [dense]: 30L d_model=4096 32H (GQA kv=32) d_ff=11008
vocab=102400 — llama-arch [arXiv:2401.02954; hf]."""
from repro_torch.models.model import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="deepseek-7b",
        vocab=102400, d_model=4096, n_layers=30, n_heads=32, n_kv=32,
        d_ff=11008, head_dim=128,
        pattern=("attn+mlp",), mlp_kind="swiglu", norm_kind="rms",
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="deepseek-7b-reduced",
        vocab=512, d_model=64, n_layers=3, n_heads=4, n_kv=4,
        d_ff=172, head_dim=16,
        pattern=("attn+mlp",), mlp_kind="swiglu", norm_kind="rms",
        kv_chunk=32, remat="none", dtype="float32",
    )


TRAIN_OVERRIDES = dict(microbatches=4, zero1=True, zero2_grads=True)


# decode_32k @ batch 128 with MHA (kv=32) KV caches is capacity-bound:
# int8 KV quantization halves cache bytes (see ModelConfig.kv_cache_dtype)
