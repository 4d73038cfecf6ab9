"""PyTorch/CUDA port of the ``repro`` package.

The same surface as ``repro`` (see its ``__init__``) for what the port
provides so far: :func:`solve` / :class:`EngineOptions` on the synchronous
Jacobi engine (``engine="sync"``), the block Gauss–Seidel engine
(``engine="async_block"``), the distributed engine over the ranks of a
``torch.distributed`` device mesh (``engine="distributed"``), the
residual-push engine (``engine="push"``) and the frontier-size router
(``engine="auto"``), with backends ``"torch"`` and ``"kernel"`` and ``device="cuda"`` unless asked
otherwise; :func:`run_incremental` with :class:`GraphDelta` for evolving
graphs; the algorithm constructors; and :class:`Graph`. GoGraph ordering
and the competitor orders of the paper's evaluation live in
``repro_torch.core``; the priority-scheduled block engine is
``repro_torch.engine.run_priority_block``; :class:`GraphServer` serves
query traffic over resident state families (``repro_torch.serving``).
Attributes resolve lazily (PEP 562), and the package imports neither
``jax`` nor any module of ``repro``.
"""
from __future__ import annotations

__all__ = [
    # unified engine entry point
    "solve",
    "EngineOptions",
    "EngineOptionsError",
    "EngineUnsupportedError",
    # algorithms
    "get_algorithm",
    "ALGORITHMS",
    "AlgoInstance",
    "personalized_pagerank",
    "multi_source_sssp",
    "make_personalized_pagerank",
    "make_multi_source_sssp",
    "remake",
    # engine shims (legacy spellings; thin wrappers over solve())
    "run_sync",
    "run_async_block",
    "run_distributed",
    "run_push",
    "estimate_frontier_fraction",
    # incremental
    "run_incremental",
    "warm_state",
    "permute_state",
    "GraphDelta",
    "Graph",
    # serving
    "GraphServer",
    "Ticket",
]

_ENGINE = {
    "solve", "EngineOptions", "EngineOptionsError", "EngineUnsupportedError",
    "get_algorithm", "ALGORITHMS", "AlgoInstance", "personalized_pagerank",
    "multi_source_sssp", "make_personalized_pagerank",
    "make_multi_source_sssp", "remake", "run_sync", "run_async_block",
    "run_distributed", "run_push",
    "estimate_frontier_fraction", "run_incremental", "warm_state",
    "permute_state",
}
_MODULES = {
    "GraphDelta": "repro_torch.graphs.delta",
    "Graph": "repro_torch.graphs.graph",
    "GraphServer": "repro_torch.serving.server",
    "Ticket": "repro_torch.serving.server",
}


def __getattr__(name: str):
    import importlib

    if name in _ENGINE:
        return getattr(importlib.import_module("repro_torch.engine"), name)
    if name in _MODULES:
        return getattr(importlib.import_module(_MODULES[name]), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def __dir__():
    return sorted(set(globals()) | set(__all__))
