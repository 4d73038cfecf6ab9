"""gemma-7b [dense]: 28L d_model=3072 16H (GQA kv=16) d_ff=24576 vocab=256000
— GeGLU, head_dim=256 (q-dim 4096 != d_model) [arXiv:2403.08295; hf]."""
from repro_torch.models.model import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="gemma-7b",
        vocab=256000, d_model=3072, n_layers=28, n_heads=16, n_kv=16,
        d_ff=24576, head_dim=256,
        pattern=("attn+mlp",), mlp_kind="geglu", norm_kind="rms",
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="gemma-7b-reduced",
        vocab=512, d_model=64, n_layers=2, n_heads=4, n_kv=4,
        d_ff=384, head_dim=32,   # head_dim * n_heads != d_model, as in gemma
        pattern=("attn+mlp",), mlp_kind="geglu", norm_kind="rms",
        kv_chunk=32, remat="none", dtype="float32",
    )


TRAIN_OVERRIDES = dict(microbatches=4, zero1=True, zero2_grads=True)
