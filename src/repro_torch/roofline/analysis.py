"""Three-term roofline from counted operations (no hardware needed).

    T_compute    = FLOPs(per device)            / peak_FLOP/s
    T_memory     = bytes(per device)            / HBM_bw
    T_collective = collective_bytes(per device) / link_bw

The reference reads the three inputs off a compiled XLA program; the port
counts them while the step runs on fake tensors (``roofline.op_count``).
Each rank runs its own shard of the work, so the counts are per device
already. ``HW_H100`` (NVIDIA H100 SXM data sheet) is every function's
default; ``HW_V5E`` is the reference's table, kept so that the arithmetic
can be held to the reference's.
"""
from __future__ import annotations

import dataclasses

# NVIDIA H100 SXM, per GPU (data sheet)
HW_H100 = {
    "peak_flops": 989e12,     # bf16 FLOP/s, dense
    "hbm_bw": 3.35e12,        # bytes/s (HBM3)
    "link_bw": 450e9,         # bytes/s NVLink 4, one direction
    "hbm_bytes": 80e9,        # capacity
}

# TPU v5e, per chip (the reference's table)
HW_V5E = {
    "peak_flops": 197e12,     # bf16 FLOP/s
    "hbm_bw": 819e9,          # bytes/s
    "link_bw": 50e9,          # bytes/s/link ICI
    "hbm_bytes": 16e9,        # capacity
}


@dataclasses.dataclass
class RooflineTerms:
    t_compute: float
    t_memory: float
    t_collective: float
    flops: float
    bytes_accessed: float
    collective_bytes: float

    @property
    def dominant(self) -> str:
        terms = {
            "compute": self.t_compute,
            "memory": self.t_memory,
            "collective": self.t_collective,
        }
        return max(terms, key=terms.get)

    @property
    def bound_time(self) -> float:
        return max(self.t_compute, self.t_memory, self.t_collective)

    def as_dict(self) -> dict:
        return {
            "t_compute_s": self.t_compute,
            "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "dominant": self.dominant,
            "flops_per_device": self.flops,
            "bytes_per_device": self.bytes_accessed,
            "collective_bytes_per_device": self.collective_bytes,
        }


def roofline_terms(flops: float, bytes_accessed: float, collective_bytes: float,
                   hw: dict = HW_H100) -> RooflineTerms:
    return RooflineTerms(
        t_compute=flops / hw["peak_flops"],
        t_memory=bytes_accessed / hw["hbm_bw"],
        t_collective=collective_bytes / hw["link_bw"],
        flops=flops,
        bytes_accessed=bytes_accessed,
        collective_bytes=collective_bytes,
    )


def model_flops(cfg, shape) -> float:
    """MODEL_FLOPS = 6*N*D (train) / 2*N*D (inference), N_active for MoE."""
    n_active = cfg.n_active_params()
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq
        return 6.0 * n_active * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq
        return 2.0 * n_active * tokens
    # decode: one token per sequence
    return 2.0 * n_active * shape.global_batch


def mfu_fraction(terms: RooflineTerms, useful_flops_per_device: float,
                 hw: dict = HW_H100) -> float:
    """Model-FLOPs utilization implied by the roofline bound: the fraction of
    peak compute the step achieves if it runs exactly at its binding term."""
    if terms.bound_time <= 0:
        return 0.0
    return (useful_flops_per_device / hw["peak_flops"]) / terms.bound_time
