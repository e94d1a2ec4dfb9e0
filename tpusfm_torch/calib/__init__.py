from tpusfm_torch.calib.chessboard import find_chessboard_corners, refine_subpix
from tpusfm_torch.calib.zhang import board_object_points, calibrate_camera
