"""tpusfm (XLA on the CPU) against the port (torch on the CPU) on two inputs
that are too large for the tests. Run once by hand, not in Tier-1:

    JAX_PLATFORMS=cpu python tests/torch_reference_check.py two-view 378 504 625
    JAX_PLATFORMS=cpu python tests/torch_reference_check.py loop

``two-view H W FEATURES``: both SIFT descriptor paths of each package, then
two-view SfM ("bf", 500 matches, 128 hypotheses, tpusfm's RANSAC samples
given to the port) on bench/scenes.render_full_pair at H x W: keypoints,
matches, inliers, whether the match sets are equal. tpusfm's per-sample
path gathers a whole gradient layer for each keypoint slot under vmap on
the CPU, about 8 bytes x FEATURES x the upsampled octave's pixels (244 GB
at half of 2016x1512), so keep that product to a few GB.

``loop``: torch_scenes.noisy_loop_problem's 1,024-node pose-graph loop (seed 7,
noise 0.01, chords every 64 and 256 nodes, the 66 exact edges weighted 5,
20 LM iterations, 224 CG steps, Huber delta 1e4) through both packages'
dense and CG solvers in f32: final cost and ATE against the true poses.
"""
import os
import sys
import time

os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

jax.config.update("jax_platforms", "cpu")
torch.set_num_threads(4)


def two_view(h: int, w: int, n_features: int):
    from tpusfm.config import MatchConfig, PipelineConfig, RansacConfig, SiftConfig
    from tpusfm.features.sift import sift_detect_and_compute as jax_sift
    from tpusfm.sfm import two_view_sfm as jax_two_view_sfm
    from tpusfm.types import CameraIntrinsics as JaxIntrinsics
    from tpusfm_torch.bench.scenes import render_full_pair
    from tpusfm_torch.config import PipelineConfig as TorchPipelineConfig
    from tpusfm_torch.features.sift import sift_detect_and_compute
    from tpusfm_torch.sfm import two_view_sfm
    from tpusfm_torch.types import CameraIntrinsics
    from tpusfm_torch.utils.convert import config_from

    g1, g2, f = render_full_pair(h, w)
    print(f"rendered pair {w}x{h}, focal {f}, {n_features} features", flush=True)
    for fast in (True, False):
        cfg = PipelineConfig(sift=SiftConfig(max_features=n_features, fast_descriptor=fast),
                             match=MatchConfig(max_matches=500),
                             ransac=RansacConfig(n_hypotheses=128))
        t0 = time.perf_counter()
        fj = [jax_sift(jnp.array(g), cfg.sift) for g in (g1, g2)]
        rj = jax_two_view_sfm(*fj, JaxIntrinsics.ideal(f, f, w / 2, h / 2), "bf", cfg=cfg)
        mask = np.asarray(rj.matches.mask)
        tj = time.perf_counter() - t0
        # tpusfm's sample table, drawn as tpusfm/geometry/epipolar.py draws it
        probs = jnp.asarray(mask, jnp.float32)
        probs = probs / jnp.maximum(jnp.sum(probs), 1.0)
        keys = jax.random.split(jax.random.PRNGKey(cfg.ransac.seed), cfg.ransac.n_hypotheses)
        table = np.asarray(jax.vmap(lambda k: jax.random.choice(
            k, mask.shape[0], shape=(5,), replace=False, p=probs))(keys))
        tcfg = config_from(TorchPipelineConfig, cfg)
        t0 = time.perf_counter()
        ft = [sift_detect_and_compute(torch.from_numpy(g), tcfg.sift) for g in (g1, g2)]
        rt = two_view_sfm(*ft, CameraIntrinsics.ideal(f, f, w / 2, h / 2, device="cpu"), "bf",
                          cfg=tcfg, sample_idx=torch.from_numpy(table).long())
        tt = time.perf_counter() - t0
        print(f"{'fast' if fast else 'per-sample'}: tpusfm keypoints "
              f"{[int(np.asarray(x.kpts.mask).sum()) for x in fj]} matches {int(rj.n_matches)} "
              f"inliers {int(rj.n_inliers)} ({tj:.0f} s); port keypoints "
              f"{[int(x.kpts.mask.sum()) for x in ft]} matches {int(rt.n_matches)} inliers "
              f"{int(rt.n_inliers)} ({tt:.0f} s); match sets equal "
              f"{np.array_equal(mask, rt.matches.mask.numpy())}; R apart "
              f"{np.abs(rt.R.numpy() - np.asarray(rj.R)).max():.2e}", flush=True)


def loop():
    from torch_scenes import noisy_loop_problem
    from tpusfm.pgo import graph as jgraph
    from tpusfm_torch.pgo import PgoConfig, optimize_pose_graph, optimize_pose_graph_cg

    n = 1024
    (_, tg), (Ri, ti), (ei, ej, Zr, Zt) = noisy_loop_problem(n=n, seed=7, noise=0.01,
                                                           chords=(64, 256), device="cpu")
    w = torch.ones(ei.shape[0])
    w[n - 1:] = 5.0

    def ate(t):
        return float(np.sqrt(((np.asarray(t) - tg.numpy()) ** 2).sum(-1).mean()))

    print(f"{n} nodes / {ei.shape[0]} edges: odometry ATE {ate(ti)!r}", flush=True)
    args = [jnp.asarray(x.numpy()) for x in (Ri, ti, ei, ej, Zr, Zt, w)]
    for name, jsolve, tsolve in (("dense", jgraph.optimize_pose_graph, optimize_pose_graph),
                                 ("cg", jgraph.optimize_pose_graph_cg, optimize_pose_graph_cg)):
        _, t, c = jsolve(*args, cfg=jgraph.PgoConfig(max_iters=20, cg_iters=224, huber_delta=1e4))
        print(f"tpusfm {name}, f32, XLA CPU: cost {float(c[0])!r} -> {float(c[-1])!r}, ATE "
              f"{ate(t)!r}", flush=True)
        _, t, c = tsolve(Ri, ti, ei, ej, Zr, Zt, w,
                         cfg=PgoConfig(max_iters=20, cg_iters=224, huber_delta=1e4))
        print(f"port {name}, f32, CPU: cost {float(c[0])!r} -> {float(c[-1])!r}, ATE "
              f"{ate(t)!r}", flush=True)


if __name__ == "__main__":
    if sys.argv[1:2] == ["two-view"] and len(sys.argv) == 5:
        two_view(*(int(a) for a in sys.argv[2:]))
    elif sys.argv[1:] == ["loop"]:
        loop()
    else:
        raise SystemExit(__doc__)
