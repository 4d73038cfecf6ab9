"""recurrentgemma-2b [hybrid]: 26L d_model=2560 10H (MQA kv=1) d_ff=7680
vocab=256000 — RG-LRU + local attention, 1 attention per 2 recurrent blocks
[arXiv:2402.19427; hf].

Pattern (rglru, rglru, local-attn) x 8 + 2 remainder rglru = 26 layers.
RG-LRU recurrence + 2048-window local attention -> long_500k eligible.
MQA kv=1 -> KV replicated; decode via split-KV over the window cache."""
from repro_torch.models.model import ModelConfig

PATTERN = ("rglru+mlp", "rglru+mlp", "local+mlp")


def config() -> ModelConfig:
    return ModelConfig(
        name="recurrentgemma-2b",
        vocab=256000, d_model=2560, n_layers=26, n_heads=10, n_kv=1,
        d_ff=7680, head_dim=256,
        pattern=PATTERN, mlp_kind="geglu", norm_kind="rms",
        window=2048,
        subquadratic=True,
        decode_seq_shard=True,
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="recurrentgemma-2b-reduced",
        vocab=512, d_model=64, n_layers=8, n_heads=4, n_kv=1,
        d_ff=128, head_dim=16,
        pattern=PATTERN, mlp_kind="geglu", norm_kind="rms",
        window=8, kv_chunk=32, remat="none", dtype="float32",
    )


TRAIN_OVERRIDES = dict(microbatches=2, zero1=True)
