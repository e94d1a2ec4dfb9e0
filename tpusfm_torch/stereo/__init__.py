from tpusfm_torch.stereo.disparity import (disparity_rms, match_disparity_image,
                                           run_disparity_benchmark)
