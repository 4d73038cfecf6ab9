"""olmo-1b [dense]: 16L d_model=2048 16H (GQA kv=16) d_ff=8192 vocab=50304
— non-parametric LN [arXiv:2402.00838; hf]."""
from repro_torch.models.model import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="olmo-1b",
        vocab=50304, d_model=2048, n_layers=16, n_heads=16, n_kv=16,
        d_ff=8192, head_dim=128,
        pattern=("attn+mlp",), mlp_kind="swiglu", norm_kind="nonparam",
        subquadratic=False,
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="olmo-1b-reduced",
        vocab=512, d_model=64, n_layers=2, n_heads=4, n_kv=4,
        d_ff=256, head_dim=16,
        pattern=("attn+mlp",), mlp_kind="swiglu", norm_kind="nonparam",
        kv_chunk=32, remat="none", dtype="float32",
    )


TRAIN_OVERRIDES = dict(microbatches=2, zero1=True)
