"""The port's pipelined two-view stages and fused_two_view against tpusfm's
(tpusfm/sfm/pipelined.py, tpusfm/sfm/fused.py) on the CPU, on the rendered
pair of tests/test_e2e.py at that test's configuration, the one its fused
check runs (the reference's PikaBun images are absent here).

tpusfm's fused_two_view is one XLA program with SIFT inlined twice, ~30 s
of compile on one worker; its stage chain runs with SIFT jitted once for
both images and the geometry stage jitted, ~20 s (the two compiles would
take half as long again at tests/test_dist.py's upsampled
configuration). So one pair goes through tpusfm. The stages over ranks, at tests/test_dist.py's
configuration, are tests/test_torch_dist.py's (pipeline_map on gloo
groups)."""
import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from torch_scenes import render_small_pair
from tpusfm.config import MatchConfig, PipelineConfig, RansacConfig, SiftConfig
from tpusfm.sfm.fused import fused_two_view as jax_fused_two_view
from tpusfm.sfm import pipelined as jax_pipelined
from tpusfm.sfm.pipelined import two_view_stages as jax_two_view_stages
from tpusfm.types import CameraIntrinsics as JaxIntrinsics
from tpusfm_torch.config import PipelineConfig as TPipelineConfig
from tpusfm_torch.sfm import fused_two_view, two_view_sfm, two_view_stages
from tpusfm_torch.features.sift import sift_detect_and_compute
from tpusfm_torch.utils.convert import config_from, intrinsics_from_numpy

torch.set_num_threads(2)

_CFG = PipelineConfig(sift=SiftConfig(max_features=256, upsample=False),
                      match=MatchConfig(max_matches=256),
                      ransac=RansacConfig(n_hypotheses=128, threshold_px=2.0))
_INTR = JaxIntrinsics.ideal(160.0, 160.0, 80.0, 80.0)


def _port():
    return (config_from(TPipelineConfig, _CFG),
            intrinsics_from_numpy(_INTR.K, _INTR.dist, device="cpu"))


@functools.lru_cache(maxsize=None)
def _tpusfm(which):
    g1, g2 = render_small_pair()
    if which == "fused":
        return jax_fused_two_view(jnp.array(g1), jnp.array(g2), _INTR.K, _INTR.dist,
                                  (160, 160), (160, 160), _CFG)
    with pytest.MonkeyPatch.context() as mp:
        # the detect stage's SIFT, compiled once for both images
        mp.setattr(jax_pipelined, "_sift_inline", jax.jit(jax_pipelined._sift_inline,
                                                          static_argnums=1))
        detect, geometry = jax_two_view_stages(_INTR, _CFG, 2)
        return jax.jit(geometry)(detect(jnp.asarray(np.stack([g1, g2]))))


def _assert_pose_like_tpusfm(r, rj):
    """tests/test_e2e.py's pose assertions, and tpusfm's pose on the same
    pair: R within 0.01, t . t' > 0.999 (the two RANSACs draw different
    samples, as in tests/test_torch_two_view.py)."""
    assert int(r.n_inliers) >= 20, int(r.n_inliers)
    t, R = r.t.numpy(), r.R.numpy()
    assert np.abs(R - np.eye(3)).max() < 0.05, R
    assert abs(t[0]) > 0.98, t
    X = r.points3d.numpy()[r.point_mask.numpy()]
    assert 5.0 < np.median(X[:, 2]) < 20.0
    assert np.abs(R - np.asarray(rj.R)).max() < 0.01
    assert float(np.dot(t, np.asarray(rj.t))) > 0.999
    assert int(r.n_matches) == int(rj.n_matches)


def _chain(stages, pair):
    y = pair
    for fn in stages:
        y = fn(y)
    return y


def test_serial_stage_chain_matches_tpusfm():
    """The port's two_view_stages(intr, cfg, 2) chain against tpusfm's on
    the same numpy images."""
    cfg, intr = _port()
    g1, g2 = render_small_pair()
    r = _chain(two_view_stages(intr, cfg, 2), torch.from_numpy(np.stack([g1, g2])))
    _assert_pose_like_tpusfm(r, _tpusfm("stages"))


def test_four_stage_chain_equals_two_stage_chain():
    """Both splits compose the same functions: bit-equal on every field."""
    cfg, intr = _port()
    g1, g2 = render_small_pair()
    pair = torch.from_numpy(np.stack([g1 + 1e-4, g2]))
    r2, r4 = (_chain(two_view_stages(intr, cfg, n), pair) for n in (2, 4))
    for f in ("R", "t", "E", "points3d", "point_mask", "n_matches", "n_inliers", "n_points"):
        assert torch.equal(getattr(r2, f), getattr(r4, f)), f
    for f in ("idx1", "idx2", "distance", "mask"):
        assert torch.equal(getattr(r2.matches, f), getattr(r4.matches, f)), f


def test_fused_two_view_matches_composed_chain_and_tpusfm():
    """tests/test_e2e.py's check (fused against SIFT + two_view_sfm with
    "bf": n_matches equal, R and t to 1e-4; here bit-equal, since the port
    composes the same functions), then against tpusfm's fused_two_view."""
    cfg, intr = _port()
    g1, g2 = (torch.from_numpy(g) for g in render_small_pair())
    rf = fused_two_view(g1, g2, intr.K, intr.dist, (160, 160), (160, 160), cfg)
    rc = two_view_sfm(sift_detect_and_compute(g1, cfg.sift), sift_detect_and_compute(g2, cfg.sift),
                      intr, "bf", (160, 160), (160, 160), cfg)
    assert int(rf.n_matches) == int(rc.n_matches)
    assert torch.equal(rf.R, rc.R) and torch.equal(rf.t, rc.t)
    assert torch.equal(rf.points3d, rc.points3d) and torch.equal(rf.matches.idx2, rc.matches.idx2)
    _assert_pose_like_tpusfm(rf, _tpusfm("fused"))
