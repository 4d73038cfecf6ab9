"""Assigned input-shape cells and applicability logic (the reference's,
unchanged).

LM transformer shapes are seq_len x global_batch. decode_*/long_* run
a decode step (one new token against a KV cache of seq_len), not a train step.
long_500k requires sub-quadratic attention and runs only for archs with
cfg.subquadratic=True (gemma3-4b 5:1 local:global, xlstm-350m, and
recurrentgemma-2b) — skips are recorded, not silently dropped.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    name: str
    kind: str          # train | prefill | decode
    seq: int
    global_batch: int


SHAPES = {
    "train_4k": ShapeCell("train_4k", "train", 4_096, 256),
    "prefill_32k": ShapeCell("prefill_32k", "prefill", 32_768, 32),
    "decode_32k": ShapeCell("decode_32k", "decode", 32_768, 128),
    "long_500k": ShapeCell("long_500k", "decode", 524_288, 1),
}

WHISPER_ENC_FRAMES = 1500  # whisper's native encoder length (30 s of audio)


def cell_applicable(cfg, shape_name: str) -> tuple[bool, str]:
    if shape_name == "long_500k" and not cfg.subquadratic:
        return False, (
            "long_500k skipped: pure full-attention arch (O(S) KV per layer "
            "with no sub-quadratic path); see DESIGN.md §4"
        )
    return True, ""


def all_cells(arch_names, cfgs) -> list[tuple[str, str, bool, str]]:
    """[(arch, shape, applicable, reason)] — the full 40-cell table."""
    out = []
    for a in arch_names:
        for s in SHAPES:
            ok, why = cell_applicable(cfgs[a], s)
            out.append((a, s, ok, why))
    return out
