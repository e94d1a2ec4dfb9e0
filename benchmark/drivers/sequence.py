"""Multi-view sequences: what ``cli sfm-seq`` runs on a photo collection.
SIFT on each view, one call a view, then ``incremental_sfm``: BF matches
over every pair within ``pair_span`` views, tracks, a two-view start from
views 0 and 1, PnP registration of the others with interim bundle
adjustment, and a global one. A step is one whole sequence and ends when
its cameras and points are on the host (``incremental_sfm`` returns them
as numpy arrays).

The configuration gives ``n_views``, ``width``, ``height``,
``max_features``, ``max_matches``, ``matcher`` ("bf"), ``pair_span``,
``max_tracks``, ``ransac_hypotheses``, ``ba`` (BaConfig's fields),
``interim_iters``, ``focal_factor`` and ``rail_step``. The program fixes
its interim solves at 4 iterations, which the plain reference reads from
the configuration, so ``setup`` refuses a configuration that sets other
values. The traffic file gives ``pairs_per_step`` (1: a step's item is a
sequence), ``pool_sequences`` and ``noise``. The scene is
``sequence_scene.py``'s; the plain reference ``reference/sequence.py``.

The matches of a checked step are read as the program made them: while
that step runs, ``incremental_sfm``'s call of ``match_features`` is
wrapped to keep each pair's result, which adds no device work.
"""
from __future__ import annotations

import contextlib
import math

import numpy as np
import torch

from benchmark.drivers.base import DriverBase, pair_up, pool_seed
from benchmark.reference.rotation import rodrigues
from benchmark.sequence_scene import render_rail

KP_TOL = 0.01        # px, px, rad: a keypoint or a match is the same within this
PROGRAM_FIXED = {"interim_iters": 4, "matcher": "bf"}


def _chord_deg(chord: float, radius: float) -> float:
    """The angle, in degrees, of a chord of a circle: stable where acos of
    a dot product near 1 is not. Rotations are at radius sqrt(2) in the
    Frobenius norm, unit vectors at 1."""
    return math.degrees(2 * math.asin(min(1.0, chord / (2 * radius))))


def _pair_order(n_views: int, span: int):
    return [(i, j) for i in range(n_views) for j in range(i + 1, min(n_views, i + 1 + span))]


@contextlib.contextmanager
def _matches_kept(kept: list):
    """The program's match_features, as incremental_sfm calls it, with
    each result appended to ``kept``."""
    import tpusfm_torch.ba.multiview as mv

    real = mv.match_features

    def keep(*a, **k):
        m = real(*a, **k)
        kept.append((m.idx1, m.idx2, m.mask))
        return m
    mv.match_features = keep
    try:
        yield
    finally:
        mv.match_features = real


class _Entries:
    """The entries a step calls: the program's, or the reference's put in
    their place (``reference=True``)."""

    def __init__(self, config: dict, device: str, focal: float, reference: bool = False):
        c = config
        if reference:
            from benchmark.reference import config as cmod
            from benchmark.reference.ba import BaConfig
            from benchmark.reference.sift import sift_detect_and_compute
            from benchmark.reference.types import CameraIntrinsics
            ba = BaConfig(**c["ba"])
        else:
            from tpusfm_torch import config as cmod
            from tpusfm_torch.features.sift import sift_detect_and_compute
            from tpusfm_torch.types import CameraIntrinsics
            ba = cmod.BaConfig(**c["ba"])
        self.reference = reference
        self.sift_fn = sift_detect_and_compute
        kw = {"sift": cmod.SiftConfig(max_features=c["max_features"]),
              "match": cmod.MatchConfig(max_matches=c["max_matches"]),
              "ransac": cmod.RansacConfig(n_hypotheses=c["ransac_hypotheses"])}
        # the program's settings carry BaConfig; the reference's take it apart
        self.cfg = cmod.PipelineConfig(**kw) if reference else cmod.PipelineConfig(**kw, ba=ba)
        self.ba = ba
        w, h = c["width"], c["height"]
        self.size = (w, h)
        self.intr = CameraIntrinsics.ideal(focal, focal, w / 2, h / 2, device)
        self.config = c

    def sequence(self, views, keep: bool) -> dict:
        c = self.config
        feats = [self.sift_fn(v, self.cfg.sift) for v in views]
        if self.reference:
            from benchmark.reference.sequence import incremental_sfm
            r = incremental_sfm(feats, self.intr, self.cfg, self.ba, pair_span=c["pair_span"],
                                max_tracks=c["max_tracks"], interim_iters=c["interim_iters"])
            out = {"cams": r["cams"], "points": r["points"], "point_valid": r["point_valid"],
                   "registered": r["registered"], "reproj_error_px": r["reproj_error_px"]}
            pairs = [r["pairs"][ij] for ij in _pair_order(len(views), c["pair_span"])]
            obs = r["obs"]
        else:
            from tpusfm_torch.ba.multiview import incremental_sfm
            pairs = []
            with _matches_kept(pairs) if keep else contextlib.nullcontext():
                r = incremental_sfm(feats, [self.size] * len(views), self.intr, self.cfg,
                                    algo=c["matcher"], pair_span=c["pair_span"],
                                    max_tracks=c["max_tracks"])
            m = r["metrics"]
            out = {"cams": r["cams"], "points": r["points"], "point_valid": r["point_valid"],
                   "registered": [v for v in range(len(views)) if f"view{v}" not in m],
                   "reproj_error_px": float(m["reproj_error_px"])}
            obs = r["obs"]
        if keep:
            out["pairs"] = pairs
            out["keys"] = [torch.cat([f.kpts.xy, f.kpts.scale[:, None], f.kpts.angle[:, None]], 1)
                           for f in feats]
            out["obs"] = (obs.xy, obs.cam, obs.pt)
        return out


class Driver(DriverBase):
    kind = "sequence"

    def setup(self):
        c = self.config
        if {k: c[k] for k in PROGRAM_FIXED} != PROGRAM_FIXED:
            raise ValueError(f"the driver runs incremental_sfm with {PROGRAM_FIXED}; the "
                             f"configuration sets {({k: c[k] for k in PROGRAM_FIXED})}")
        seqs = []
        for k in range(int(self.traffic["pool_sequences"])):
            views, f, _ = render_rail(c["n_views"], c["height"], c["width"],
                                      pool_seed(self.seed, k), c["rail_step"], self.device)
            seqs.append(views)
        if abs(f - c["focal_factor"] * c["width"]) > 1e-6 * f:
            raise ValueError(f"the rail is rendered at focal {f}, the configuration states "
                             f"{c['focal_factor']} w")
        self.focal = f
        self.pool = torch.from_numpy(np.stack(seqs)).to(self.device)      # (S, V, H, W)
        self.program = _Entries(c, self.device, f)

    def entries(self, reference: bool):
        return _Entries(self.config, self.device, self.focal, reference=reference)

    def inputs(self, step: int):
        """(V, H, W): the pool's sequences in turn, with the step's noise."""
        base = self.pool[step % len(self.pool)]
        return base + self.noise(base.shape, step)

    def step(self, views, entries=None, keep: bool = False, clock=None) -> list[dict]:
        e = entries or self.program
        return [e.sequence(views, keep)]

    def select(self, views, p: int):
        return views

    def compare(self, prog: dict, ref: dict) -> dict:
        """The readings of one sequence, the program's against the
        reference's. match_miss: each pair's kept matches keyed by both
        ends' (x, y, scale, angle), on one side only, over all of them;
        reg_miss: views registered on one side only; rot_deg: the widest
        chord angle between the two sides' rotations of a view both
        registered; t_deg: the widest angle between the camera centres
        (relative to view 0, which both fix at the origin) each made unit
        length, the scale being a free gauge; point_gap: the median of
        |Xp - Xr| / |Xr| over the tracks both keep, matched by their first
        observation's view and pixel, each side's points in units of its
        view 1 centre's distance; reproj_gap: the final mean reprojection
        error, program less reference, px."""
        dev = ref["keys"][0].device
        miss, total = 0, 0
        order = _pair_order(len(ref["keys"]), self.config["pair_span"])
        for (i, j), pp, rp in zip(order, prog["pairs"], ref["pairs"], strict=True):
            rows = []
            for (i1, i2, m), keys in ((pp, prog["keys"]), (rp, ref["keys"])):
                i1, i2, m = (torch.as_tensor(x, device=dev) for x in (i1, i2, m))
                rows.append(torch.cat([keys[i].to(dev)[i1[m].long()],
                                       keys[j].to(dev)[i2[m].long()]], 1))
            _, _, n = pair_up(rows[1], rows[0], KP_TOL)
            miss += n
            total += len(rows[0]) + len(rows[1])
        match_miss = miss / max(1, total)

        both = sorted(set(prog["registered"]) & set(ref["registered"]))
        reg_miss = len(set(prog["registered"]) ^ set(ref["registered"]))
        cp, cr = (torch.as_tensor(np.asarray(o["cams"]), dtype=torch.float64)
                  for o in (prog, ref))
        Rp, Rr = rodrigues(cp[:, :3]), rodrigues(cr[:, :3])
        rot_deg = max(_chord_deg(float((Rp[v] - Rr[v]).norm()), math.sqrt(2)) for v in both)
        Cp = -(Rp.transpose(1, 2) @ cp[:, 3:, None])[..., 0]
        Cr = -(Rr.transpose(1, 2) @ cr[:, 3:, None])[..., 0]
        up, ur = (C / C.norm(dim=1, keepdim=True).clamp(min=1e-12) for C in (Cp, Cr))
        t_deg = max(_chord_deg(float((up[v] - ur[v]).norm()), 1.0) for v in both)

        kp, vp = self._track_keys(prog, dev)
        kr, vr = self._track_keys(ref, dev)
        ia, ib, _ = pair_up(kr, kp, KP_TOL)
        ia, ib = ia.cpu(), ib.cpu()
        keep = torch.as_tensor(vr)[ia] & torch.as_tensor(vp)[ib]
        if int(keep.sum()):
            xr = torch.as_tensor(np.asarray(ref["points"]), dtype=torch.float64)[ia[keep]]
            xp = torch.as_tensor(np.asarray(prog["points"]), dtype=torch.float64)[ib[keep]]
            xr, xp = xr / Cr[1].norm().clamp(min=1e-12), xp / Cp[1].norm().clamp(min=1e-12)
            point_gap = float(((xp - xr).norm(dim=1) / xr.norm(dim=1).clamp(min=1e-12)).median())
        else:
            point_gap = math.inf if int(np.asarray(ref["point_valid"]).sum()) else 0.0
        return {"match_miss": match_miss, "reg_miss": reg_miss, "rot_deg": rot_deg,
                "t_deg": t_deg, "point_gap": point_gap,
                "reproj_gap": prog["reproj_error_px"] - ref["reproj_error_px"]}

    @staticmethod
    def _track_keys(o: dict, dev):
        """Each track's key, (view, x, y) of its observation in its first
        view, and whether its point is kept."""
        xy, cam, pt = (t.to(dev) for t in o["obs"])
        n = len(o["point_valid"])
        first = torch.full((n,), len(cam), dtype=torch.long, device=dev)
        rows = torch.arange(len(cam), device=dev)
        first = first.scatter_reduce(0, pt.long(), rows, reduce="amin")
        key = torch.cat([cam[first].double()[:, None], xy[first].double()], 1)
        return key, np.asarray(o["point_valid"], bool)
