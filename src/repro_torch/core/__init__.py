"""The paper's contribution on the port: the M(.) metric over processing
orders and the GoGraph divide-and-conquer reordering (numpy, identical ranks
to the reference per seed)."""
from repro_torch.core.metric import (
    block_fresh_fraction,
    metric_m,
    metric_m_torch,
    positive_edge_fraction,
)
from repro_torch.core.gograph import (
    GoGraphConfig,
    RankMaintainer,
    extend_rank,
    gograph_order,
    regional_rerank,
)
from repro_torch.core import partition

__all__ = [
    "metric_m",
    "metric_m_torch",
    "positive_edge_fraction",
    "block_fresh_fraction",
    "gograph_order",
    "GoGraphConfig",
    "RankMaintainer",
    "extend_rank",
    "regional_rerank",
    "partition",
]
