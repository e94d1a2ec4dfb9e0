from tpusfm_torch.sfm.two_view import TwoViewResult, match_features, two_view_batch, two_view_sfm
