from tpusfm_torch.ba.tracks import build_tracks, Observations
from tpusfm_torch.ba.solver import bundle_adjust
from tpusfm_torch.ba.multiview import incremental_sfm
