"""Architecture registry: one module per architecture, the same data as the
reference's ``repro.configs``. Each module exposes

    config()   -> ModelConfig   (exact published dims)
    reduced()  -> ModelConfig   (same family, tiny dims — CPU smoke tests)

`get_config(name)` / `get_reduced(name)` / `ALL_ARCHS` are the front door.
"""
from __future__ import annotations

import importlib

ALL_ARCHS = [
    "olmo-1b",
    "deepseek-7b",
    "gemma3-4b",
    "gemma-7b",
    "qwen2-moe-a2.7b",
    "granite-moe-1b-a400m",
    "internvl2-76b",
    "xlstm-350m",
    "whisper-tiny",
    "recurrentgemma-2b",
]

_MODULES = {name: "repro_torch.configs." + name.replace("-", "_").replace(".", "_")
            for name in ALL_ARCHS}


def _mod(name: str):
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; known: {ALL_ARCHS}")
    return importlib.import_module(_MODULES[name])


def get_config(name: str):
    return _mod(name).config()


def get_reduced(name: str):
    return _mod(name).reduced()


def get_train_overrides(name: str) -> dict:
    """Per-arch TrainConfig field overrides (microbatching / ZeRO tiers).

    The reference's values, set for its training runs: ZeRO-1
    optimizer-state sharding, ZeRO-2 gradient-accumulator sharding, and
    enough microbatches that saved activations stay bounded. The port has
    no trainer yet; they are carried as data.
    """
    mod = _mod(name)
    return getattr(mod, "TRAIN_OVERRIDES", {})
