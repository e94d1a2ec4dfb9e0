"""The disparity grid's dense cells (DisparityUtil.cpp:430-461): every left
pixel's descriptor searched against every right pixel's, one way, no
cross-check, then the disparity image, its RMS against the ground truth
over disp_ratio and the valid count, through the program's
``run_disparity_benchmark(alg, "dense", disp_ratio)``. A step is one stereo
pair and ends when RMS and count are on the host.

The traffic file gives ``alg`` ("sift" or "orb"), ``pairs_per_step`` (1),
``pool_pairs`` and ``noise``.
"""
from __future__ import annotations

import numpy as np
import torch

from benchmark import scenes
from benchmark.drivers.base import DriverBase, pool_seed, span

GAP_PIXELS = 32768   # differing pixels judged a pair at most (drawn from the seed)
GAP_CHUNK = 128


class _Entries:
    def __init__(self, config: dict, traffic: dict, reference: bool = False):
        self.reference = reference
        self.alg, self.ratio = traffic["alg"], float(config["disp_ratio"])
        if reference:
            from benchmark.reference.disparity import dense_cell
            self.fn = dense_cell
        else:
            from tpusfm_torch.stereo.disparity import run_disparity_benchmark
            self.fn = run_disparity_benchmark

    def cell(self, left, right, gt) -> dict:
        if self.reference:
            return self.fn(left, right, gt, self.alg, self.ratio)
        return self.fn(left, right, gt, self.alg, "dense", self.ratio)


def _pair_dist(d1, d2, i, j, hamming: bool):
    """Squared L2 (Hamming: bit count) between rows i of d1 and rows j of d2
    (j (n, c)), in float64: (n, c)."""
    from benchmark.reference.distance import unpack_bits

    if hamming:      # packed words: no uint32 indexing on the card
        d1, d2 = d1.view(torch.int32), d2.view(torch.int32)
    q, c = d1[i], d2[j]
    if hamming:
        q, c = unpack_bits(q), unpack_bits(c)
    q, c = q.double(), c.double()
    return ((c - q[:, None, :]) ** 2).sum(-1)


class Driver(DriverBase):
    kind = "disparity"

    def setup(self):
        c = self.config
        pool = [scenes.render_stereo_pair(c["height"], c["width"], pool_seed(self.seed, k))
                for k in range(int(self.traffic["pool_pairs"]))]
        self.pool = torch.from_numpy(np.stack([np.stack(p[:2]) for p in pool])).to(self.device)
        self.gt = torch.from_numpy(np.stack([p[2] for p in pool])).to(self.device)
        self.program = _Entries(c, self.traffic)

    def entries(self, reference: bool):
        return _Entries(self.config, self.traffic, reference=reference)

    def work(self):
        n = self.config["height"] * self.config["width"]
        return [(1, n, n, 128)] if self.traffic["alg"] == "sift" else []

    def inputs(self, step: int):
        """(1, 2, H, W) stereo pair with the step's noise, and its pool index."""
        k = step % len(self.pool)
        base = self.pool[k:k + 1]
        return base + self.noise(base.shape, step), k

    def step(self, inp, entries=None, keep: bool = False, clock=None) -> list[dict]:
        e = entries or self.program
        imgs, k = inp
        with span(clock, "disparity", 1):
            r = e.cell(imgs[0, 0], imgs[0, 1], self.gt[k])
            out = {"rms": float(r["rms"]), "count": int(r["count"])}
        if keep:
            out.update({n: r[n] for n in ("disp", "valid", "idx", "desc1", "desc2", "valid2")
                        if n in r})
        return [out]

    def select(self, inp, p: int):
        return inp

    def compare(self, prog: dict, ref: dict) -> dict:
        """The readings of one pair. disp_diff: the share of pixels, valid on
        either side, whose validity or disparity differs. disp_gap judges the
        program's map by the reference's descriptors: at each pixel whose
        disparity differs, the least distance to a right pixel at that
        disparity less the distance to the reference's own match (0 where
        the program's disparity is as near as the reference's). rms_gap:
        the RMS's relative difference."""
        w = prog["disp"].shape[1]
        vp, vr = prog["valid"].reshape(-1), ref["valid"].reshape(-1)
        dp, dr = prog["disp"].reshape(-1), ref["disp"].reshape(-1)
        diff = (vp & vr & (dp != dr))
        n_diff = int(diff.sum()) + int((vp != vr).sum())
        gap = 0.0
        if int(diff.sum()):
            pix = torch.nonzero(diff)[:, 0]
            if len(pix) > GAP_PIXELS:
                g = torch.Generator(device="cpu").manual_seed(self.seed % (2 ** 63))
                pix = pix[torch.randperm(len(pix), generator=g)[:GAP_PIXELS].to(pix.device)]
            hamming = self.traffic["alg"] == "orb"
            d1, d2, v2 = ref["desc1"], ref["desc2"], ref["valid2"]
            h = len(v2) // w
            rows = torch.arange(h, device=pix.device)
            for c0 in range(0, len(pix), GAP_CHUNK):
                i = pix[c0:c0 + GAP_CHUNK]
                x = i % w
                d = dp[i].long()
                cand = torch.stack([x - d, x + d], 1)                    # (n, 2)
                ok_x = (cand >= 0) & (cand < w)
                j = rows[None, None, :] * w + cand.clamp(0, w - 1)[:, :, None]   # (n, 2, h)
                ok = ok_x[:, :, None] & v2[j]
                j = j.reshape(len(i), -1)
                dist = torch.where(ok.reshape(len(i), -1), _pair_dist(d1, d2, i, j, hamming),
                                   float("inf"))
                best_ref = _pair_dist(d1, d2, i, ref["idx"][i][:, None], hamming)[:, 0]
                gap = max(gap, float((dist.min(1).values - best_ref).max()))
        return {"disp_diff": n_diff / max(1, int((vp | vr).sum())),
                "disp_gap": max(gap, 0.0),
                "rms_gap": abs(prog["rms"] - ref["rms"]) / max(ref["rms"], 1e-12)}
