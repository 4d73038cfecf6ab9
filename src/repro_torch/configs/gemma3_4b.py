"""gemma3-4b [dense]: 34L d_model=2560 8H (GQA kv=4) d_ff=10240 vocab=262144
— 5:1 local:global sliding-window attention, 128k context
[hf:google/gemma-3-1b-pt; unverified].

kv=4 does not divide the 16-way model axis, so KV projections replicate and
decode uses the sequence-sharded split-KV path (decode_seq_shard)."""
from repro_torch.models.model import ModelConfig

PATTERN = ("local+mlp",) * 5 + ("attn+mlp",)


def config() -> ModelConfig:
    return ModelConfig(
        name="gemma3-4b",
        vocab=262144, d_model=2560, n_layers=34, n_heads=8, n_kv=4,
        d_ff=10240, head_dim=256,
        pattern=PATTERN, mlp_kind="geglu", norm_kind="rms",
        window=1024, rope_theta=1_000_000.0,
        subquadratic=True,        # 5:1 local:global -> long_500k eligible
        decode_seq_shard=True,
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="gemma3-4b-reduced",
        vocab=512, d_model=64, n_layers=7, n_heads=4, n_kv=2,
        d_ff=128, head_dim=16,
        pattern=PATTERN, mlp_kind="geglu", norm_kind="rms",
        window=8, kv_chunk=32, remat="none", dtype="float32",
    )


TRAIN_OVERRIDES = dict(microbatches=4, zero1=True)
