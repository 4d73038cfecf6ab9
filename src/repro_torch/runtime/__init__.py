"""Fault tolerance of the training loop (the port of ``repro.runtime``)."""
from repro_torch.runtime.fault import (
    FaultTolerantRunner,
    PreemptionGuard,
    StragglerMonitor,
)

__all__ = ["FaultTolerantRunner", "StragglerMonitor", "PreemptionGuard"]
