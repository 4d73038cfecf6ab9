"""The dense-decoder LM stack: layers, attention, blocks, the transformer
and the model entry point (``build_model``)."""
from repro_torch.models.model import ModelConfig, build_model

__all__ = ["ModelConfig", "build_model"]
