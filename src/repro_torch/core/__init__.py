"""The paper's contribution on the port: the M(.) metric over processing
orders, the GoGraph divide-and-conquer reordering and the competitor orders
it is evaluated against (numpy, identical ranks to the reference per
seed)."""
from repro_torch.core.metric import (
    MetricTracker,
    block_fresh_fraction,
    edge_span,
    metric_m,
    metric_m_torch,
    metric_table,
    positive_edge_fraction,
)
from repro_torch.core.gograph import (
    GoGraphConfig,
    RankMaintainer,
    extend_rank,
    gograph_order,
    regional_rerank,
)
from repro_torch.core.baselines import (
    all_reorderers,
    default_order,
    degree_sort,
    gorder_like,
    hub_cluster,
    hub_sort,
    rabbit_like,
    random_order,
)
from repro_torch.core import baselines, partition

__all__ = [
    "metric_m",
    "metric_m_torch",
    "positive_edge_fraction",
    "block_fresh_fraction",
    "MetricTracker",
    "edge_span",
    "metric_table",
    "gograph_order",
    "GoGraphConfig",
    "RankMaintainer",
    "extend_rank",
    "regional_rerank",
    "partition",
    "baselines",
    "all_reorderers",
    "default_order",
    "random_order",
    "degree_sort",
    "hub_sort",
    "hub_cluster",
    "rabbit_like",
    "gorder_like",
]
