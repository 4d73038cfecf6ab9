"""Deterministic synthetic token pipeline.

The reference's generator, bit for bit: a function of (seed, step), so a
restart at step k regenerates batches k, k+1, ...; numpy's PCG64 seeded by
``SeedSequence(entropy=seed, spawn_key=(step,))``; a random walk through a
fixed successor "grammar" (with probability ``structure`` token t+1 is the
successor of token t, else a uniform jump) so losses are learnable.

Batches are tensors on an explicit device (the card unless the caller asks
for the CPU). With a mesh, each data-parallel rank (the mesh's "pod" and
"data" axes, pod major) takes its part of each of the ``microbatches`` nm
contiguous microbatches of the global batch, as the reference's step
splits the global batch (``reshape(nm, B // nm)``) before GSPMD shards
each microbatch over the data ranks: a microbatch of ``b = B / nm`` rows
is cut into shards of ``c = ceil(b / R)`` rows over R ranks, and rank r
holds rows ``[r c, min(b, (r + 1) c))`` of every microbatch, which can be
none (GSPMD pads the shard; the train step pads the rank's part to ``c``
rows that weigh nothing). With nm = 1 that is rank r's contiguous
``B / R`` rows. The train step's contiguous chunks of the rank's rows are
then its parts of the reference's microbatches (what a statistic over a
microbatch, the MoE's aux loss, needs). The layouts the reference refuses
are refused: a global batch that does not split into nm microbatches
(its reshape) or over the R data ranks (its input's batch sharding).
Each batch says which layout it has (:class:`TokenBatch`), and a
data-parallel train step refuses a batch laid out for another count than
its own.
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
    """(this process's rank among the mesh's data-parallel ranks, pod
    major, and their count); (0, 1) without a mesh."""
    if mesh is None:
        return 0, 1
    sizes = axis_sizes(mesh)
    rank, count = 0, 1
    for ax in batch_axes_for_mesh(mesh):
        rank = rank * sizes[ax] + mesh.get_local_rank(ax)
        count *= sizes[ax]
    return rank, count


def shard_rows(global_batch: int, microbatches: int, count: int,
               rank: int) -> tuple[int, int]:
    """(rows that data rank ``rank`` of ``count`` holds of each of the
    global batch's ``microbatches``, the rows of a shard, ``ceil(b /
    count)`` of a microbatch's ``b``), the layout of the module docstring;
    a ValueError where the reference refuses the layout."""
    if microbatches < 1 or global_batch % microbatches:
        raise ValueError(f"global batch {global_batch} does not split into "
                         f"{microbatches} microbatches")
    if global_batch % count:
        raise ValueError(f"global batch {global_batch} does not split over {count} "
                         f"data ranks (the batch's sharding over the data axes)")
    b = global_batch // microbatches
    c = -(-b // count)
    return max(0, min(b, (rank + 1) * c) - rank * c), c


class TokenBatch(dict):
    """A batch dict that says how its rows are laid out: this rank's parts
    of ``microbatches`` contiguous microbatches of the global batch, each
    part padded to ``shard_rows`` rows by the train step."""

    microbatches: int = 1
    shard_rows: int | None = None


class TokenDataset:
    """dataset(step) -> batch dict of tensors on ``device``: ``tokens`` and
    ``labels`` (int32), ``prefix_embeds`` or ``frames`` (f32) when asked,
    ``n_frames`` frames a row (default: the sequence length)."""

    def __init__(self, cfg: TokenDatasetConfig, mesh=None, prefix_len: int = 0,
                 d_model: int = 0, frames: bool = False, device="cuda",
                 microbatches: int = 1, n_frames: int = 0):
        self.cfg = cfg
        self.mesh = mesh
        self.prefix_len = prefix_len
        self.d_model = d_model
        self.frames = frames
        self.n_frames = n_frames or cfg.seq_len
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("device='cuda' was asked for but no CUDA device is "
                               "available; pass device='cpu'")
        rank, count = _data_rank(mesh)
        held, self.shard_rows = shard_rows(cfg.global_batch, microbatches, count, rank)
        mb, lo = cfg.global_batch // microbatches, rank * self.shard_rows
        self.rows = np.concatenate([np.arange(i * mb + lo, i * mb + lo + held)
                                    for i in range(microbatches)])
        self.microbatches = microbatches
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
                (self.cfg.global_batch, self.n_frames, self.d_model)
            ).astype(np.float32)
        return batch

    def __call__(self, step: int) -> TokenBatch:
        batch = TokenBatch({k: torch.from_numpy(np.ascontiguousarray(v[self.rows])).to(self.device)
                            for k, v in self.arrays(step).items()})
        batch.microbatches = self.microbatches
        batch.shard_rows = self.shard_rows
        return batch
