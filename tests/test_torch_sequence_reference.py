"""The port's multi-view path (tpusfm_torch.ba and geometry.pnp) against the
benchmark's plain reference (benchmark/reference/tracks.py, pnp.py, ba.py,
sequence.py) on the CPU: tracks bit for bit on seeded matches, PnP with
one sample table, bundle adjustment on ba/synthetic.py's 6-view problem,
and incremental_sfm on seeded 6-view rails at 160x120, each side from its
own SIFT.

Each tolerance is written with its reason beside it. A reference that
holds its inputs in bfloat16 (the step below the configuration's float32)
fails them: see the last two cases.
"""
import math

import numpy as np
import pytest
import torch

from benchmark.drivers.sequence import _chord_deg
from benchmark.reference import ba as ref_ba
from benchmark.reference import config as ref_config
from benchmark.reference import pnp as ref_pnp
from benchmark.reference import sequence as ref_sequence
from benchmark.reference import sift as ref_sift
from benchmark.reference import tracks as ref_tracks
from benchmark.reference import types as ref_types
from benchmark.reference.rotation import rodrigues as ref_rodrigues
from benchmark.sequence_scene import render_rail
from tpusfm_torch.ba.multiview import incremental_sfm
from tpusfm_torch.ba.solver import bundle_adjust, mean_reprojection_error
from tpusfm_torch.ba.synthetic import synth_ba_problem
from tpusfm_torch.ba.tracks import build_tracks
from tpusfm_torch.config import BaConfig, MatchConfig, PipelineConfig, SiftConfig
from tpusfm_torch.features.sift import sift_detect_and_compute
from tpusfm_torch.geometry.epipolar import draw_samples
from tpusfm_torch.geometry.pnp import pnp_ransac
from tpusfm_torch.geometry.projection import rodrigues
from tpusfm_torch.types import CameraIntrinsics

torch.set_num_threads(2)


def _pair_matches(seed, n_views=6, n_kp=600, n_true=450, outliers=0.03):
    """Seeded matches over every pair within 3 views: true tracks over 2-5
    consecutive views, a share of random matches (so chains, merges,
    masked matches and view conflicts all occur)."""
    rng = np.random.default_rng(seed)
    kp = np.stack([rng.permutation(n_kp)[:n_true] for _ in range(n_views)])
    first = rng.integers(0, n_views - 1, n_true)
    last = np.minimum(first + rng.integers(1, 5, n_true), n_views - 1)
    pm = {}
    for i in range(n_views):
        for j in range(i + 1, min(n_views, i + 4)):
            t = np.flatnonzero((first <= i) & (j <= last))
            n_out = max(1, int(len(t) * outliers))
            ii = np.concatenate([kp[i, t], rng.integers(0, n_kp, n_out)])
            jj = np.concatenate([kp[j, t], rng.integers(0, n_kp, n_out)])
            order = rng.permutation(len(ii))
            pm[(i, j)] = (ii[order], jj[order], rng.random(len(ii)) < 0.97)
    kxy = [rng.uniform(0, 640, (n_kp, 2)).astype(np.float32) for _ in range(n_views)]
    return pm, kxy, n_views


@pytest.mark.parametrize("seed,max_tracks,outliers", [(0, None, 0.03), (1, 8192, 0.03),
                                                      (2, 150, 0.03), (3, None, 0.3)])
def test_tracks_equal_the_reference_bit_for_bit(seed, max_tracks, outliers):
    """The same tracks, in the same order, observation for observation:
    both sides are integer bookkeeping and copies of the same float32
    pixels, so nothing may differ. Cases: all tracks, the cell's cap,
    a cap that cuts (ties in length kept in order), many conflicts."""
    pm, kxy, V = _pair_matches(seed, outliers=outliers)
    got, n = build_tracks(pm, [torch.from_numpy(k) for k in kxy], V, max_tracks=max_tracks)
    ref, n_ref = ref_tracks.build_tracks(pm, [torch.from_numpy(k) for k in kxy], V,
                                         max_tracks=max_tracks)
    assert n == n_ref and n > (140 if max_tracks == 150 else 300)
    for f in ("xy", "cam", "pt", "mask"):
        assert torch.equal(getattr(got, f), getattr(ref, f)), f


def _pnp_problem(seed, n=150, outliers=0.3):
    g = torch.Generator().manual_seed(seed)
    X = torch.rand(n, 3, generator=g) * torch.tensor([4.0, 4.0, 5.0]) + torch.tensor([-2.0, -2, 4])
    rv, tv = torch.tensor([0.05, -0.2, 0.03]), torch.tensor([0.3, -0.1, 0.4])
    Xc = X @ rodrigues(rv).T + tv
    xn = Xc[:, :2] / Xc[:, 2:] + torch.randn(n, 2, generator=g) * 1e-3
    k = int(n * outliers)
    xn[:k] += torch.rand(k, 2, generator=g) * 0.4 - 0.2
    return X, xn, torch.rand(n, generator=g) < 0.95, rv, tv


@pytest.mark.parametrize("seed", [0, 2 ** 33 + 5])
def test_pnp_equals_the_reference_with_one_sample_table(seed):
    """One (256, 6) table for both: the same inliers and count; rvec and
    tvec within 1e-5 (equal on this CPU: both run the same float32
    operations in the same order; 1e-5 leaves room for another CPU's
    library, and is a tenth of the pose's own error from the 1e-3
    noise)."""
    X, xn, mask, rv, tv = _pnp_problem(seed)
    table = draw_samples(mask, 256, 6, seed % 1000)
    r, t, inl, cnt = pnp_ransac(X, xn, mask, 500.0, sample_idx=table)
    rr, rt, rinl, rcnt = ref_pnp.pnp_ransac(X, xn, mask, 500.0, sample_idx=table)
    assert torch.equal(inl, rinl) and int(cnt) == int(rcnt) >= 0.6 * int(mask.sum())
    torch.testing.assert_close(r, rr, rtol=0, atol=1e-5)
    torch.testing.assert_close(t, rt, rtol=0, atol=1e-5)
    torch.testing.assert_close(r, rv, rtol=0, atol=5e-3)


def _ba_problem(dtype):
    K, dist, cams, X, obs = synth_ba_problem(6, 512, seed=3, device="cpu")
    obs = ref_tracks.Observations(obs.xy.to(dtype), obs.cam, obs.pt, obs.mask)
    return K.to(dtype), dist.to(dtype), cams.to(dtype), X.to(dtype), obs


def _gauge_free(cams, points):
    """Rotations as matrices; camera centres and points in camera 0's frame
    (camera 0 is fixed), in units of camera 1's distance from camera 0:
    the scale is free."""
    cams, points = cams.double(), points.double()
    R = ref_rodrigues(cams[:, :3])
    centres = -(R.transpose(1, 2) @ cams[:, 3:, None])[..., 0]

    def in_cam0(X):
        return X @ R[0].T + cams[0, 3:]
    s = in_cam0(centres[1]).norm()
    return R, in_cam0(centres) / s, in_cam0(points) / s


def _ba_gap(got, ref):
    """The largest differences of rotations, translations and points."""
    g, r = _gauge_free(*got[:2]), _gauge_free(*ref[:2])
    return [float((a - b).abs().max()) for a, b in zip(g, r)]


def test_bundle_adjust_equals_the_reference_in_float64():
    """20 LM iterations of each on the same 6-view, 512-track problem in
    float64, where no step's accept test is decided by rounding: the cost
    curves within 1e-9 relative, rotations, translations and points
    (gauge-free) within 1e-8. In float32 the sums of thousands of
    Jacobian products cancel to 1e-4 relative, which the next case
    bounds."""
    K, dist, cams, X, obs = _ba_problem(torch.float64)
    got = bundle_adjust(cams, X, obs, K, dist, BaConfig(), n_fixed_cams=1)
    ref = ref_ba.bundle_adjust(cams, X, obs, K, dist, ref_ba.BaConfig(), n_fixed_cams=1)
    torch.testing.assert_close(got[2], ref[2], rtol=1e-9, atol=0)
    assert max(_ba_gap(got, ref)) < 1e-8, _ba_gap(got, ref)
    assert float(mean_reprojection_error(got[0], got[1], obs, K, dist)) < 0.5


def _f32_gap(reference_inputs):
    K, dist, cams, X, obs = _ba_problem(torch.float32)
    got = bundle_adjust(cams, X, obs, K, dist, BaConfig(), n_fixed_cams=1)
    rK, rdist, rcams, rX, robs = reference_inputs(K, dist, cams, X, obs)
    ref = ref_ba.bundle_adjust(rcams, rX, robs, rK, rdist, ref_ba.BaConfig(), n_fixed_cams=1)
    return _ba_gap(got, ref)


# float32 against float32, measured on this problem: 2.7e-7 (rotation),
# 4.4e-6 (camera centre), 7.0e-5 (point), all in units of the baseline.
# The bounds leave 7-9x for other rounding; a bfloat16 reference reads
# 2,500-4,500x them (4.9e-3, 0.16, 2.3).
F32_BA = (2e-6, 4e-5, 5e-4)


def test_bundle_adjust_equals_the_reference_in_float32():
    gap = _f32_gap(lambda *a: a)
    assert all(g < b for g, b in zip(gap, F32_BA)), gap


def test_a_bfloat16_reference_fails_the_bundle_adjustment_bounds():
    """The reference fed the observations and the start rounded to
    bfloat16 (what it would hold computing in bfloat16): 0.5 px steps at
    these pixel values move the solution past F32_BA."""
    def bf16(K, dist, cams, X, obs):
        def r(t):
            return t.bfloat16().float()
        return K, dist, r(cams), r(X), ref_tracks.Observations(r(obs.xy), obs.cam, obs.pt,
                                                               obs.mask)
    gap = _f32_gap(bf16)
    assert any(g > b for g, b in zip(gap, F32_BA)), gap


SEQ_H, SEQ_W = 120, 160


def _sequence(seed, keypoint_dtype=torch.float32):
    """Both sides on a seeded rail: (program's result, reference's result).
    Each runs its own SIFT on the same views. ``keypoint_dtype`` rounds the
    reference's keypoints (the bfloat16 case)."""
    views, f, _ = render_rail(6, SEQ_H, SEQ_W, seed)
    views = torch.from_numpy(views)
    cfg = PipelineConfig(sift=SiftConfig(max_features=3000), match=MatchConfig(max_matches=1000))
    intr = CameraIntrinsics.ideal(f, f, SEQ_W / 2, SEQ_H / 2, "cpu")
    got = incremental_sfm([sift_detect_and_compute(v, cfg.sift) for v in views],
                          [(SEQ_W, SEQ_H)] * 6, intr, cfg, algo="bf", pair_span=3)
    rcfg = ref_config.PipelineConfig(sift=ref_config.SiftConfig(max_features=3000),
                                     match=ref_config.MatchConfig(max_matches=1000))
    feats = []
    for v in views:
        ft = ref_sift.sift_detect_and_compute(v, rcfg.sift)
        k = ft.kpts
        feats.append(ref_types.Features(kpts=ref_types.Keypoints(
            k.xy.to(keypoint_dtype).float(), k.scale, k.angle, k.response, k.mask), desc=ft.desc))
    ref = ref_sequence.incremental_sfm(feats, ref_types.CameraIntrinsics.ideal(
        f, f, SEQ_W / 2, SEQ_H / 2, "cpu"), rcfg)
    return got, ref


def _angles(got, ref):
    """(views registered on one side only, rot_deg, t_deg, the program's
    registered views) as the cell's driver reads them."""
    reg = [v for v in range(6) if f"view{v}" not in got["metrics"]]
    cp, cr = (torch.as_tensor(np.asarray(c), dtype=torch.float64)
              for c in (got["cams"], ref["cams"]))
    Rp, Rr = ref_rodrigues(cp[:, :3]), ref_rodrigues(cr[:, :3])
    rot = max(_chord_deg(float((Rp[v] - Rr[v]).norm()), math.sqrt(2)) for v in reg)
    Cp = -(Rp.transpose(1, 2) @ cp[:, 3:, None])[..., 0]
    Cr = -(Rr.transpose(1, 2) @ cr[:, 3:, None])[..., 0]
    t = max(_chord_deg(float((Cp[v] / Cp[v].norm() - Cr[v] / Cr[v].norm()).norm()), 1.0)
            for v in reg if v)
    return set(reg) ^ set(ref["registered"]), rot, t, reg


# rot_deg and t_deg between the two sides' float32 reconstructions, each
# from its own SIFT: measured 1.7e-5 to 8.5e-4 degrees at 160x120 (76 LM
# iterations whose sums round apart); the bound leaves 6x, and a bfloat16
# reference reads 14x (rot_deg 0.07) and 200x (t_deg 0.98) it.
SEQ_DEG = 5e-3


@pytest.mark.parametrize("seed", [0, 2 ** 33 + 17])
def test_incremental_sfm_equals_the_reference_on_a_rail(seed):
    """Every view registered on both sides, the rotations and the camera
    directions within SEQ_DEG, the final reprojection errors within 1e-4
    px of each other (each below 0.1 px: the render is exact)."""
    got, ref = _sequence(seed)
    miss, rot, t, reg = _angles(got, ref)
    assert reg == list(range(6)) and not miss
    assert rot < SEQ_DEG and t < SEQ_DEG, (rot, t)
    gap = got["metrics"]["reproj_error_px"] - ref["reproj_error_px"]
    assert abs(gap) < 1e-4 and ref["reproj_error_px"] < 0.1


def test_a_bfloat16_reference_fails_the_sequence_bound():
    """The reference's keypoints rounded to bfloat16 (steps of 0.25-0.5 px
    at these coordinates): its cameras leave SEQ_DEG."""
    got, ref = _sequence(0, keypoint_dtype=torch.bfloat16)
    miss, rot, t, _ = _angles(got, ref)
    assert miss or rot > SEQ_DEG or t > SEQ_DEG, (rot, t)
