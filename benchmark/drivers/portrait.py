"""Portrait mode on a stereo pair (DisparityUtil.cpp:274-428, run on the
robot pair at :464-479): dense descriptors on both grey images, every left
pixel's nearest right pixel, GMS, the thresholded and dilated mask, its
largest regions and the median-blurred image with the foreground pasted
back, through the program's ``create_portrait_mode`` with the
configuration's descriptor type. A step is one pair and ends when the
portrait, the foreground mask and the disparity map are on the host.

The configuration gives ``width``, ``height``, ``threshold``,
``blur_radius``, ``dilate_iters``, ``keep``, ``gms`` (GmsConfig's fields)
and ``descriptor_dtype``; ``create_portrait_mode`` fixes the dilation (2)
and the regions kept (5) at the reference's own values, which the plain
reference reads from the configuration, so ``setup`` refuses a
configuration that sets others. The traffic file gives
``pairs_per_step`` (1), ``pool_pairs`` and ``noise``. The scene is
``portrait_scene.py``'s; the plain reference ``reference/portrait.py``.

The check samples one pair (``check_items`` 1 of ``check_steps`` 2): at
2594x1131 a reference pair is a float32 search of 2.93M queries against
2.93M rows, over a minute on the card, and a control of ``control.py``
takes as long again. One pair keeps a run with its check within about
four minutes, and it still judges 2.93M pixels.
"""
from __future__ import annotations

import numpy as np
import torch

from benchmark.drivers import disparity
from benchmark.drivers.base import DriverBase, pool_seed, span
from benchmark.portrait_scene import render_robot_pair

# what create_portrait_mode runs, and takes no option for
PROGRAM_FIXED = {"dilate_iters": 2, "keep": 5}


class _Entries:
    def __init__(self, config: dict, reference: bool = False):
        self.reference = reference
        c = config
        self.dtype = getattr(torch, c["descriptor_dtype"])
        if reference:
            from benchmark.reference.portrait import create_portrait_mode
            self.fn = create_portrait_mode
            self.kw = {"threshold": float(c["threshold"]), "dilate_iters": int(c["dilate_iters"]),
                       "keep": int(c["keep"]), "blur_radius": int(c["blur_radius"]),
                       "gms_config": dict(c["gms"]), "dtype": self.dtype}
        else:
            from tpusfm_torch.config import GmsConfig, PipelineConfig
            from tpusfm_torch.stereo.portrait import create_portrait_mode
            self.fn = create_portrait_mode
            self.kw = {"cfg": PipelineConfig(gms=GmsConfig(**c["gms"])),
                       "threshold": float(c["threshold"]), "blur_radius": int(c["blur_radius"]),
                       "dtype": self.dtype}

    def portrait(self, left, right) -> dict:
        if self.reference:
            return self.fn(left, right, **self.kw)
        out, fg, disp = self.fn(left, right, **self.kw)
        return {"portrait": out, "fg": fg, "disp": disp}


class Driver(DriverBase):
    kind = "portrait"

    def setup(self):
        c = self.config
        if {k: int(c[k]) for k in PROGRAM_FIXED} != PROGRAM_FIXED:
            raise ValueError(f"create_portrait_mode runs {PROGRAM_FIXED}; the configuration "
                             f"sets {({k: c[k] for k in PROGRAM_FIXED})}")
        pool = [render_robot_pair(c["height"], c["width"], pool_seed(self.seed, k))
                for k in range(int(self.traffic["pool_pairs"]))]
        self.pool = torch.from_numpy(np.stack([np.stack(p[:2]) for p in pool])).to(self.device)
        self.program = _Entries(c)

    def entries(self, reference: bool):
        return _Entries(self.config, reference=reference)

    def work(self):
        n = self.config["height"] * self.config["width"]
        return [(1, n, n, 128)]

    def inputs(self, step: int):
        """(1, 2, H, W, 3) stereo pair with the step's noise."""
        k = step % len(self.pool)
        base = self.pool[k:k + 1]
        return base + self.noise(base.shape, step)

    def step(self, inp, entries=None, keep: bool = False, clock=None) -> list[dict]:
        e = entries or self.program
        with span(clock, "portrait", 1):
            r = e.portrait(inp[0, 0], inp[0, 1])
            out = {n: r[n].cpu() for n in ("portrait", "fg", "disp")}
        if keep and e.reference:
            out.update({n: r[n] for n in ("idx", "desc1", "desc2", "valid2")})
        return [out]

    def select(self, inp, p: int):
        return inp

    def compare(self, prog: dict, ref: dict) -> dict:
        """The readings of one pair. disp_diff and disp_gap as a dense SIFT
        cell's driver (``drivers/disparity.py``, L2) reads them, a pixel
        valid where its disparity is above 0 on either side alike (a pixel
        GMS kept at disparity 0 counts as dropped on both); fg_diff: the
        share of pixels whose foreground membership differs;
        portrait_diff: the share of output pixels that differ in any
        channel."""
        dev = ref["idx"].device
        p = {n: prog[n].to(dev) for n in ("portrait", "fg", "disp")}
        r = {n: ref[n].to(dev) for n in ("portrait", "fg", "disp")}
        both = {"rms": 0.0}
        judge = disparity.Driver(self.config, {"alg": "sift", "pairs_per_step": 1},
                                 self.seed, self.device)
        d = judge.compare(
            {**both, "disp": p["disp"], "valid": p["disp"] > 0},
            {**both, "disp": r["disp"], "valid": r["disp"] > 0,
             **{n: ref[n] for n in ("idx", "desc1", "desc2", "valid2")}})
        return {"disp_diff": d["disp_diff"], "disp_gap": d["disp_gap"],
                "fg_diff": float((p["fg"] != r["fg"]).float().mean()),
                "portrait_diff": float((p["portrait"] != r["portrait"]).any(-1).float().mean())}
