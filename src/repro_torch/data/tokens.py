"""Deterministic synthetic token pipeline.

The reference's generator, bit for bit: a function of (seed, step), so a
restart at step k regenerates batches k, k+1, ...; numpy's PCG64 seeded by
``SeedSequence(entropy=seed, spawn_key=(step,))``; a random walk through a
fixed successor "grammar" (with probability ``structure`` token t+1 is the
successor of token t, else a uniform jump) so losses are learnable.

Batches are tensors on an explicit device (the card unless the caller asks
for the CPU). With a mesh, each data-parallel rank takes its contiguous
slice of the global batch: rank r of R data ranks (the mesh's "pod" and
"data" axes, pod major) gets rows [r * B / R, (r + 1) * B / R).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.sharding.rules import axis_sizes, batch_axes_for_mesh


@dataclasses.dataclass
class TokenDatasetConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    structure: float = 0.5   # fraction of positions from a learnable pattern


def _data_rank(mesh) -> tuple[int, int]:
    """(this process's rank among the mesh's data-parallel ranks, their
    count); (0, 1) without a mesh."""
    if mesh is None:
        return 0, 1
    sizes = axis_sizes(mesh)
    rank, count = 0, 1
    for ax in batch_axes_for_mesh(mesh):
        rank = rank * sizes[ax] + mesh.get_local_rank(ax)
        count *= sizes[ax]
    return rank, count


class TokenDataset:
    """dataset(step) -> batch dict of tensors on ``device``: ``tokens`` and
    ``labels`` (int32), ``prefix_embeds`` or ``frames`` (f32) when asked."""

    def __init__(self, cfg: TokenDatasetConfig, mesh=None, prefix_len: int = 0,
                 d_model: int = 0, frames: bool = False, device="cuda"):
        self.cfg = cfg
        self.mesh = mesh
        self.prefix_len = prefix_len
        self.d_model = d_model
        self.frames = frames
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("device='cuda' was asked for but no CUDA device is "
                               "available; pass device='cpu'")
        rank, count = _data_rank(mesh)
        if cfg.global_batch % count:
            raise ValueError(f"global batch {cfg.global_batch} does not split over "
                             f"{count} data ranks")
        per = cfg.global_batch // count
        self.rows = slice(rank * per, (rank + 1) * per)
        # a fixed "grammar": each token deterministically suggests a successor
        rng = np.random.default_rng(cfg.seed + 1234)
        self.successor = rng.integers(0, cfg.vocab, size=cfg.vocab)

    def _raw(self, step: int) -> np.ndarray:
        cfg = self.cfg
        rng = np.random.default_rng(
            np.random.SeedSequence(entropy=cfg.seed, spawn_key=(step,))
        )
        toks = np.empty((cfg.global_batch, cfg.seq_len + 1), dtype=np.int64)
        toks[:, 0] = rng.integers(0, cfg.vocab, size=cfg.global_batch)
        jumps = rng.integers(0, cfg.vocab, size=(cfg.global_batch, cfg.seq_len))
        use = rng.random((cfg.global_batch, cfg.seq_len)) < cfg.structure
        for t in range(cfg.seq_len):
            toks[:, t + 1] = np.where(use[:, t], self.successor[toks[:, t]],
                                      jumps[:, t])
        return toks.astype(np.int32)

    def arrays(self, step: int) -> dict:
        """The global batch of ``step`` as numpy arrays (every rank's rows)."""
        toks = self._raw(step)
        batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
        if self.prefix_len:
            rng = np.random.default_rng(self.cfg.seed + 7 + step)
            batch["prefix_embeds"] = rng.standard_normal(
                (self.cfg.global_batch, self.prefix_len, self.d_model)
            ).astype(np.float32)
        if self.frames:
            rng = np.random.default_rng(self.cfg.seed + 11 + step)
            batch["frames"] = rng.standard_normal(
                (self.cfg.global_batch, self.cfg.seq_len, self.d_model)
            ).astype(np.float32)
        return batch

    def __call__(self, step: int) -> dict:
        return {k: torch.from_numpy(np.ascontiguousarray(v[self.rows])).to(self.device)
                for k, v in self.arrays(step).items()}
