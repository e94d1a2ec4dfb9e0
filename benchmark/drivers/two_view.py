"""Two-view SfM pairs: the reference's structureFromMotion
(SfMUtil.cpp:4-83) on rendered pairs, SIFT on each pair's two images in one
batched call, then BF (``two_view_batch`` over the step's pairs) or LOGOS
(``two_view_sfm`` pair by pair). A step ends when each pair's pose, inlier
count, matches and points are on the host.

The traffic file gives ``matcher`` ("bf" or "logos"), ``pairs_per_step``,
``pool_pairs`` (distinct scenes rendered from the seed), ``noise`` (the
amplitude of each step's seeded noise) and ``fast_descriptor``.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from benchmark import scenes
from benchmark.drivers.base import DriverBase, pair_up, pool_seed, span

KP_TOL = 0.01        # px, px, rad: a keypoint or a match is the same within this


def _configs(mod_config, config: dict, traffic: dict):
    """The pipeline configuration of a package's config module."""
    c = mod_config
    return c.PipelineConfig(
        sift=c.SiftConfig(max_features=config["max_features"],
                          fast_descriptor=bool(traffic.get("fast_descriptor", True))),
        match=c.MatchConfig(max_matches=config["max_matches"]),
        logos=c.LogosConfig(num_words=config["logos_words"], kmeans_iters=config["kmeans_iters"]),
        ransac=c.RansacConfig(n_hypotheses=config["ransac_hypotheses"]))


def _host(r, i=None) -> dict:
    """A pair's answers on the host (pair i of a batched result)."""
    def get(t):
        t = t.cpu()
        return t if i is None else t[i]
    m = r.matches
    return {"R": get(r.R).double(), "t": get(r.t).double(),
            "n_inliers": int(get(r.n_inliers)), "n_points": int(get(r.n_points)),
            "n_matches": int(get(r.n_matches)), "points": get(r.points3d).double(),
            "point_mask": get(r.point_mask), "idx1": get(m.idx1).long(),
            "idx2": get(m.idx2).long(), "match_mask": get(m.mask)}


def _feats(f, i: int) -> dict:
    """Image i's keypoints, as (x, y, scale, angle) keys, and descriptors of
    a batched Features, on the device."""
    k = f.kpts
    key = torch.cat([k.xy[i], k.scale[i][:, None], k.angle[i][:, None]], 1)
    return {"key": key, "mask": k.mask[i], "desc": f.desc[i]}


class _Entries:
    """The entries a step calls: the program's, or the reference's put in
    their place (``reference=True``)."""

    def __init__(self, config: dict, traffic: dict, device: str, reference: bool = False):
        if reference:
            from benchmark.reference import config as cmod
            from benchmark.reference.sift import sift_detect_and_compute
            from benchmark.reference.two_view import two_view_sfm
            from benchmark.reference.types import CameraIntrinsics, Features, Keypoints
            self.batch = None
        else:
            from tpusfm_torch import config as cmod
            from tpusfm_torch.features.sift import sift_detect_and_compute
            from tpusfm_torch.sfm.two_view import two_view_batch, two_view_sfm
            from tpusfm_torch.types import CameraIntrinsics, Features, Keypoints
            self.batch = two_view_batch
        self.reference = reference
        self.sift_fn, self.pair_fn = sift_detect_and_compute, two_view_sfm
        self.Features, self.Keypoints = Features, Keypoints
        self.cfg = _configs(cmod, config, traffic)
        h, w = config["height"], config["width"]
        f = config["focal_factor"] * w
        self.size = (w, h)
        self.intr = CameraIntrinsics.ideal(f, f, w / 2, h / 2, device)
        self.algo = traffic["matcher"]

    def sift(self, imgs):
        return self.sift_fn(imgs, self.cfg.sift)

    def _cat(self, feats):
        kp = self.Keypoints(*(torch.cat([getattr(f.kpts, n) for f in feats])
                              for n in ("xy", "scale", "angle", "response", "mask")))
        return self.Features(kpts=kp, desc=torch.cat([f.desc for f in feats]))

    def pairs(self, feats) -> list[dict]:
        """Each pair's answers on the host; feats: one batched Features a pair."""
        if self.algo == "bf" and self.batch is not None:
            fb = self._cat(feats)
            r = self.batch(fb.index(slice(0, None, 2)), fb.index(slice(1, None, 2)),
                           self.intr, self.cfg)
            return [_host(r, i) for i in range(len(feats))]
        out = []
        for f in feats:
            if self.reference:
                r = self.pair_fn(f.index(0), f.index(1), self.intr, self.algo, self.cfg)
            else:
                r = self.pair_fn(f.index(0), f.index(1), self.intr, self.algo, self.size,
                                 self.size, self.cfg)
            out.append(_host(r))
        return out


class Driver(DriverBase):
    kind = "two_view"

    def setup(self):
        c = self.config
        pool = [np.stack(scenes.render_full_pair(c["height"], c["width"], pool_seed(self.seed, k),
                                                 device=self.device)[:2])
                for k in range(int(self.traffic["pool_pairs"]))]
        self.pool = torch.from_numpy(np.stack(pool)).to(self.device)      # (P, 2, H, W)
        self.program = _Entries(c, self.traffic, self.device)

    def entries(self, reference: bool):
        return _Entries(self.config, self.traffic, self.device, reference=reference)

    def inputs(self, step: int):
        """(pairs_per_step, 2, H, W): pool pairs in turn, with the step's noise."""
        n = self.pairs_per_step
        base = self.pool[[(step * n + p) % len(self.pool) for p in range(n)]]
        return base + self.noise(base.shape, step)

    def step(self, imgs, entries=None, keep: bool = False, clock=None) -> list[dict]:
        e = entries or self.program
        feats = []
        for p in range(imgs.shape[0]):
            with span(clock, "sift", 2):
                feats.append(e.sift(imgs[p]))
        with span(clock, "two_view", imgs.shape[0]):
            out = e.pairs(feats)
        if keep:
            for o, f in zip(out, feats):
                o["feats"] = (_feats(f, 0), _feats(f, 1))
        return out

    def select(self, imgs, p: int):
        """Pair p of a step's inputs, as a step of its own."""
        return imgs[p:p + 1]

    def compare(self, prog: dict, ref: dict) -> dict:
        """The readings of one pair, the program's against the reference's:
        the matches kept, compared by both ends' keypoints (x, y, scale,
        angle: SIFT keeps keypoints at one place that differ in angle), so
        that a keypoint moved or a descriptor that matches elsewhere shows;
        the pose; the inlier count; the points of the matches both kept."""
        def match_rows(o):
            f1, f2 = o["feats"]
            dev = f1["key"].device
            m = o["match_mask"].to(dev)
            i1, i2 = o["idx1"].to(dev)[m], o["idx2"].to(dev)[m]
            return torch.cat([f1["key"][i1], f2["key"][i2]], 1), torch.nonzero(m)[:, 0]

        mr, slot_r = match_rows(ref)
        mp, slot_p = match_rows(prog)
        ia, ib, miss = pair_up(mr, mp, KP_TOL)
        match_miss = miss / max(1, len(mr) + len(mp))

        # angles from chords: stable where acos of a trace near 3 is not
        rot_deg = math.degrees(2 * math.asin(min(1.0, float((prog["R"] - ref["R"]).norm())
                                                 / (2 * math.sqrt(2)))))
        tp, tr = prog["t"].reshape(-1), ref["t"].reshape(-1)
        tp, tr = tp / tp.norm().clamp(min=1e-12), tr / tr.norm().clamp(min=1e-12)
        t_deg = math.degrees(2 * math.asin(min(1.0, float((tp - tr).norm()) / 2)))
        inlier_gap = abs(prog["n_inliers"] - ref["n_inliers"]) / max(1, ref["n_inliers"])

        sr, sp = slot_r[ia].cpu(), slot_p[ib].cpu()
        both = ref["point_mask"][sr] & prog["point_mask"][sp]
        if int(both.sum()):
            xr, xp = ref["points"][sr[both]], prog["points"][sp[both]]
            rel = (xp - xr).norm(dim=1) / xr.norm(dim=1).clamp(min=1e-12)
            point_gap = float(rel.median())
        else:
            point_gap = math.inf if int(ref["point_mask"].sum()) else 0.0
        return {"match_miss": match_miss, "rot_deg": rot_deg, "t_deg": t_deg, "inlier_gap": inlier_gap,
                "point_gap": point_gap}
