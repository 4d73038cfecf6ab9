"""xlstm-350m [ssm]: 24L d_model=1024 4H d_ff=0 vocab=50304 — alternating
sLSTM + mLSTM blocks [arXiv:2405.04517; unverified].

d_ff=0: projections live inside the xLSTM blocks (mLSTM up-projects 2x,
sLSTM 4/3x). Linear recurrence -> long_500k eligible. No attention -> no KV
cache; decode carries (C, n, m) / (h, c, n, m) states."""
from repro_torch.models.model import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="xlstm-350m",
        vocab=50304, d_model=1024, n_layers=24, n_heads=4, n_kv=4,
        d_ff=0, head_dim=256,
        pattern=("mlstm", "slstm"), norm_kind="rms",
        rnn_chunk=256,
        subquadratic=True,
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="xlstm-350m-reduced",
        vocab=512, d_model=64, n_layers=4, n_heads=4, n_kv=4,
        d_ff=0, head_dim=16,
        pattern=("mlstm", "slstm"), norm_kind="rms",
        rnn_chunk=8, remat="none", dtype="float32",
    )


TRAIN_OVERRIDES = dict(microbatches=2, zero1=True)
