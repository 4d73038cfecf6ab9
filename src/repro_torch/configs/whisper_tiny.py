"""whisper-tiny [audio]: 4L enc + 4L dec, d_model=384 6H d_ff=1536
vocab=51865 — enc-dec, conv frontend (STUB) [arXiv:2212.04356; unverified].

The log-mel + strided-conv frontend is a stub: input_specs() supplies
precomputed frame embeddings (B, T, 384). Full attention -> long_500k
skipped. kv=6 does not divide 16 -> KV replicated; decode via split-KV."""
from repro_torch.models.model import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="whisper-tiny",
        vocab=51865, d_model=384, n_layers=8, n_heads=6, n_kv=6,
        d_ff=1536, head_dim=64,
        arch_type="encdec", enc_layers=4, dec_layers=4,
        mlp_kind="gelu", norm_kind="layernorm",
        decode_seq_shard=True,
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="whisper-tiny-reduced",
        vocab=512, d_model=64, n_layers=4, n_heads=4, n_kv=4,
        d_ff=128, head_dim=16,
        arch_type="encdec", enc_layers=2, dec_layers=2,
        mlp_kind="gelu", norm_kind="layernorm",
        kv_chunk=32, remat="none", dtype="float32",
    )


TRAIN_OVERRIDES = dict(microbatches=4)
