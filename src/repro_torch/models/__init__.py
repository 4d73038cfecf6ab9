"""The LM stack: layers, attention, the MoE, the recurrent blocks (RG-LRU,
mLSTM, sLSTM), blocks, the decoder-only transformer, the encoder-decoder
and the model entry point (``build_model``)."""
from repro_torch.models.model import ModelConfig, build_model

__all__ = ["ModelConfig", "build_model"]
