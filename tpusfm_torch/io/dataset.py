"""Dataset manifests for the reference's bundled assets.

Paths mirror the hard-coded lists in the reference's main program
(SfM-GMS/main.h:31-41, main.cpp:19-20,71-72,
DisparityUtil.cpp:436-438,465-466).
"""
from __future__ import annotations

import os

# The SfM-GMS data root: $TPUSFM_DATA, else reference/SfM-GMS in the checkout.
REFERENCE_ROOT = os.environ.get(
    "TPUSFM_DATA",
    os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
                 "reference", "SfM-GMS"),
)

SOURCE_DIR = os.path.join(REFERENCE_ROOT, "SourceImages")
CALIB_DIR = os.path.join(REFERENCE_ROOT, "CalibrationImages")

# Named asset groups from the reference's main program.
STEREO_DEMO_PAIR = ("Disparity_L.jpg", "Disparity_R.jpg")          # main.cpp:19-20
SFM_PAIR = ("PikaBun1.jpg", "PikaBun4.jpg")                        # main.cpp:71-72
SFM_SEQUENCE = tuple(f"PikaBun{i}.jpg" for i in range(1, 7))
BUN_SEQUENCE = tuple(f"Bun{i}.jpg" for i in range(1, 7))
MIDDLEBURY_TRIPLE = ("left1.png", "right1.png", "left_gt1.png")    # DisparityUtil.cpp:436-438
ROBOT_PAIR = ("leftRobot.png", "rightRobot.png")                   # DisparityUtil.cpp:465-466
VIEW_SET = tuple(f"view{i}.png" for i in range(4))


def source_image(name: str) -> str:
    return os.path.join(SOURCE_DIR, name)


def calibration_images() -> list[str]:
    """The 10 chessboard JPGs (reference main.h:31-41)."""
    return [os.path.join(CALIB_DIR, f"IMG_{i}.jpg") for i in range(10)]


def has_reference_data() -> bool:
    return os.path.isdir(SOURCE_DIR)
