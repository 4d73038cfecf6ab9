"""Iterative engines of the port: algorithm specs, round loops, the
synchronous (Jacobi), block Gauss–Seidel, distributed (blocks sharded
across ranks), priority-scheduled and residual-push engines, incremental delta absorption and the
:func:`solve` entry point.

Names resolve lazily so that ``repro_torch.engine.algorithms`` can be
imported without the engine stack.
"""
from __future__ import annotations

_NAMES = {
    "ALGORITHMS": "algorithms",
    "AlgoInstance": "algorithms",
    "get_algorithm": "algorithms",
    "make_multi_source_sssp": "algorithms",
    "make_personalized_pagerank": "algorithms",
    "multi_source_sssp": "algorithms",
    "personalized_pagerank": "algorithms",
    "remake": "algorithms",
    "EngineOptions": "api",
    "EngineOptionsError": "api",
    "EngineUnsupportedError": "api",
    "solve": "api",
    "AsyncBlockSession": "async_block",
    "BatchReport": "async_block",
    "run_async_block": "async_block",
    "run_distributed": "distributed",
    "run_priority_block": "priority",
    "run_sync": "sync",
    "RunResult": "convergence",
    "estimate_frontier_fraction": "push",
    "run_push": "push",
    "permute_state": "incremental",
    "run_incremental": "incremental",
    "warm_state": "incremental",
}

__all__ = sorted(_NAMES)


def __getattr__(name: str):
    import importlib

    if name in _NAMES:
        mod = importlib.import_module(f"repro_torch.engine.{_NAMES[name]}")
        return getattr(mod, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
