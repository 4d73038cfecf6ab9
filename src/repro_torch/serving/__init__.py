"""Continuous-batching serving layer of the port (port of
``repro.serving``): :class:`GraphServer` over `engine.async_block.
AsyncBlockSession` families, with admission scheduling, a region-invalidated
result cache and registry-backed telemetry."""
from repro_torch.graphs.delta import GraphDelta
from repro_torch.serving.cache import CacheEntry, ResultCache
from repro_torch.serving.scheduler import POLICIES, Scheduler, family_key
from repro_torch.serving.server import GraphServer, Ticket
from repro_torch.serving.stats import ServerStats, percentile

__all__ = [
    "GraphServer",
    "Ticket",
    "GraphDelta",
    "ResultCache",
    "CacheEntry",
    "Scheduler",
    "POLICIES",
    "family_key",
    "ServerStats",
    "percentile",
]
