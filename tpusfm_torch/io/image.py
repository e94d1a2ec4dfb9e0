"""Host-side grayscale decode (the reference's cv::imread + cvtColor)."""
from __future__ import annotations

import numpy as np

# ITU-R BT.601 luma weights — matches cv::cvtColor(COLOR_BGR2GRAY) semantics.
_LUMA = np.array([0.299, 0.587, 0.114], np.float32)


def imread_gray(path: str) -> np.ndarray:
    """Decode an image file to (H, W) float32 grayscale in [0, 1].

    PIL is imported here, not at module import: hosts without it can still
    import the package and feed arrays directly."""
    from PIL import Image

    rgb = np.asarray(Image.open(path).convert("RGB"), np.float32) / 255.0
    return rgb @ _LUMA
