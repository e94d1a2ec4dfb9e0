"""Synthetic-bokeh portrait mode from dense stereo.

The reference's createPortraitMode (SfM-GMS/DisparityUtil.cpp:274-428), as
tpusfm has it (tpusfm/stereo/portrait.py): dense GMS disparity ->
threshold -> dilate x2 -> keep the 5 largest connected regions as the
foreground -> median-blur(15) the whole image -> paste the sharp foreground
back. Disparity, threshold, dilation and median run on the input's device;
the component selection is the native union-find on the host (native.py).

Spans (utils/timing.py): ``portrait`` (items = pairs) holds
``portrait.describe``, ``.match`` (the chunked NN search), ``.gms`` (GMS and
the disparity image), ``.mask`` (threshold and dilation), ``.wait`` (the
mask's copy to the host, which waits for the device's queued work),
``.components`` (the host labelling and the selection, after the copy) and
``.blur`` (median and paste).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from tpusfm_torch.config import PipelineConfig
from tpusfm_torch.io.image import to_gray
from tpusfm_torch.match.gms import gms_filter
from tpusfm_torch.native import connected_components
from tpusfm_torch.stereo.disparity import dense_features, dense_raw_match, match_disparity_image
from tpusfm_torch.stereo.filters import dilate, median_blur
from tpusfm_torch.utils.timing import span


def foreground_mask_from_disparity(disp, valid, threshold: float = 60.0,
                                   dilate_iters: int = 2, keep: int = 5):
    """Threshold + dilate on disp's device, then keep the ``keep`` largest
    8-connected components (host). Returns an (H, W) bool tensor on disp's
    device."""
    with span("portrait.mask"):
        m = dilate((disp > threshold) & valid, dilate_iters)
    with span("portrait.wait"):
        m = m.cpu().numpy()
    with span("portrait.components"):
        labels, n, areas = connected_components(m, 8)
        if n == 0:
            return torch.zeros(m.shape, dtype=torch.bool, device=disp.device)
        order = np.argsort(areas)[::-1][:keep]
        keep_ids = np.zeros(n + 1, bool)
        keep_ids[order + 1] = True
        return torch.from_numpy(keep_ids[labels]).to(disp.device)


def create_portrait_mode(left_rgb, right_rgb, cfg: PipelineConfig = PipelineConfig(),
                         threshold: float = 60.0, blur_radius: int = 7, dtype=torch.float32):
    """Portrait mode of an (H, W, 3) RGB pair in [0, 1], on its device.
    ``dtype`` is dense_raw_match's: f32 by default, bf16 descriptors as an
    opt-in. Returns (portrait (H, W, 3), fg_mask (H, W) bool, disp (H, W))
    tensors."""
    with span("portrait", 1):
        with span("portrait.describe"):
            g1, g2 = to_gray(left_rgb), to_gray(right_rgb)
            h, w = g1.shape
            f1, f2 = dense_features(g1), dense_features(g2)
        with span("portrait.match"):
            mcfg = dataclasses.replace(cfg.match, cross_check=False)
            # the reference matches these descriptors with approximate FLANN
            # (DisparityUtil.cpp:286-300); here exact, in query chunks
            raw = dense_raw_match(f1, f2, "l2", mcfg, dtype=dtype)
        with span("portrait.gms"):
            matches = gms_filter(f1.kpts, f2.kpts, raw, (w, h), (w, h), cfg.gms)
            disp, valid = match_disparity_image(f1.kpts, f2.kpts, matches, h, w)
        fg = foreground_mask_from_disparity(disp, valid, threshold)
        with span("portrait.blur"):
            blurred = median_blur(left_rgb, blur_radius)
            return torch.where(fg[..., None], left_rgb, blurred), fg, disp
