"""Multi-device paths over torch.distributed (the port of tpusfm.dist)."""
from tpusfm_torch.dist.group import Group, init_group, make_group
from tpusfm_torch.dist.pair_parallel import parallel_pair_match, parallel_two_view
from tpusfm_torch.dist.pipeline import pipeline_map
from tpusfm_torch.dist.ring_match import ring_nn_search
from tpusfm_torch.dist.sharded_ba import sharded_bundle_adjust, sharded_bundle_adjust_tm
from tpusfm_torch.dist.sharded_pgo import (sharded_optimize_pose_graph,
                                          sharded_optimize_pose_graph_cg)
