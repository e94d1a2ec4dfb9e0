from tpusfm_torch.stereo.block_matching import (normalize_disparity, stereo_bm,
                                                stereo_bm_filtered)
from tpusfm_torch.stereo.disparity import (disparity_rms, match_disparity_image,
                                           run_disparity_benchmark)
from tpusfm_torch.stereo.filters import box_filter, dilate, erode, median_blur
from tpusfm_torch.stereo.portrait import create_portrait_mode, foreground_mask_from_disparity
