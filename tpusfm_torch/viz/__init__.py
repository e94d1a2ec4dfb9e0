from tpusfm_torch.viz.ply import write_ply
from tpusfm_torch.viz.draw import draw_matches, draw_keypoints
