from tpusfm_torch.sfm.two_view import TwoViewResult, match_features, two_view_batch, two_view_sfm
from tpusfm_torch.sfm.fused import fused_two_view
from tpusfm_torch.sfm.pipelined import two_view_pipelined, two_view_stages
