from tpusfm_torch.pgo.graph import (
    PgoConfig,
    chain_odometry,
    edge_residual,
    graph_cost,
    optimize_pose_graph,
    optimize_pose_graph_cg,
)
from tpusfm_torch.pgo import se3

__all__ = [
    "PgoConfig", "chain_odometry", "edge_residual", "graph_cost",
    "optimize_pose_graph", "optimize_pose_graph_cg", "se3",
]
