"""Parity of the port's pose graph (tpusfm_torch.pgo) and trajectory metric
with tpusfm on CPU: se3 maps, the normal system, the dense and CG LM on
tests/test_pgo.py's noisy loop, odometry chaining, the sequence graph
built from a small rendered rail, and ATE."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from torch_scenes import noisy_loop_problem, render_sequence
from test_pgo import _noisy_loop_problem
from tpusfm.config import MatchConfig as JaxMatchConfig
from tpusfm.config import PipelineConfig as JaxPipelineConfig
from tpusfm.pgo import PgoConfig as JaxPgoConfig
from tpusfm.pgo import chain_odometry as jax_chain_odometry
from tpusfm.pgo import graph as jgraph
from tpusfm.pgo import se3 as jse3
from tpusfm.pgo.builder import build_sequence_graph as jax_build_sequence_graph
from tpusfm.pgo.builder import edges_to_arrays as jax_edges_to_arrays
from tpusfm.types import CameraIntrinsics as JaxIntrinsics
from tpusfm.types import Features as JaxFeatures
from tpusfm.types import Keypoints as JaxKeypoints
from tpusfm.utils.traj import ate_rmse as jax_ate_rmse
from tpusfm_torch.config import MatchConfig, PipelineConfig, SiftConfig
from tpusfm_torch.features.sift import sift_detect_and_compute
from tpusfm_torch.pgo import PgoConfig, chain_odometry, graph, se3
from tpusfm_torch.pgo.builder import build_sequence_graph, edges_to_arrays
from tpusfm_torch.types import CameraIntrinsics
from tpusfm_torch.utils.convert import config_from, pose_graph_from_numpy
from tpusfm_torch.utils.jacobian import rowwise_jacobian
from tpusfm_torch.utils.traj import ate_rmse, camera_centers_from_w2c

torch.set_num_threads(2)


def _np(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def test_se3_maps_match_tpusfm():
    rng = np.random.default_rng(0)
    xi = rng.normal(size=(32, 6)).astype(np.float32)
    xi[0] = 0.0                                     # the identity, exactly
    xi[1, :3] = 1e-5                                # inside the Taylor branch
    jR, jt = jse3.se3_exp(jnp.asarray(xi))
    R, t = se3.se3_exp(torch.from_numpy(xi))
    np.testing.assert_allclose(R.numpy(), np.asarray(jR), atol=1e-6)
    np.testing.assert_allclose(t.numpy(), np.asarray(jt), atol=1e-6)
    np.testing.assert_allclose(se3.se3_log(R, t).numpy(), np.asarray(jse3.se3_log(jR, jt)),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(se3.so3_exp(torch.from_numpy(xi[:, :3])).numpy(),
                               np.asarray(jse3.so3_exp(jnp.asarray(xi[:, :3]))), atol=1e-6)
    np.testing.assert_allclose(se3.so3_log(R).numpy(), np.asarray(jse3.so3_log(jR)),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(se3.vee(se3.hat(torch.from_numpy(xi[:, :3]))).numpy(), xi[:, :3])
    # the Jacobian of log . exp at the identity is finite and I, as tpusfm's
    J = rowwise_jacobian(lambda d: se3.se3_log(*se3.se3_exp(d)), torch.zeros(6))
    np.testing.assert_allclose(J.numpy(), np.eye(6), atol=1e-5)


def _loop(n=12, seed=2, closure_weight=10.0):
    (Rg, tg), (R0, t0), (ei, ej, Zr, Zt) = _noisy_loop_problem(n=n, seed=seed)
    w = jnp.ones(ei.shape[0]).at[-1].set(closure_weight)
    jax_in = (R0, t0, ei, ej, Zr, Zt, w)
    return (Rg, tg), jax_in, pose_graph_from_numpy(*jax_in, device="cpu")


def test_build_normal_system_matches_tpusfm():
    """H, g and the surrogate cost of one linearization, within 1e-4 of
    each array's largest entry (f32)."""
    _, (R, t, ei, ej, Zr, Zt, w), tin = _loop()
    want = jax.jit(jgraph.build_normal_system, static_argnums=(7, 8))(
        R, t, ei, ej, Zr, Zt, w, 12, JaxPgoConfig())
    got = graph.build_normal_system(*tin, 12, PgoConfig())
    for g, wnt in zip(got, want):
        wnt = np.asarray(wnt)
        assert np.abs(_np(g) - wnt).max() <= 1e-4 * np.abs(wnt).max(), (g, wnt)
    np.testing.assert_allclose(float(graph.graph_cost(*tin, PgoConfig())),
                               float(jgraph.graph_cost(R, t, ei, ej, Zr, Zt, w)), rtol=1e-5)


def _f64(jax_in, port_in):
    return ([jnp.asarray(np.asarray(a), jnp.float64 if np.asarray(a).dtype == np.float32 else None)
             for a in jax_in], [a.double() if a.is_floating_point() else a for a in port_in])


@pytest.mark.parametrize("solver", ["dense", "cg"])
def test_optimize_pose_graph_matches_tpusfm(solver):
    """tests/test_pgo.py's 12-node noisy loop, its closure trusted 10x, 15
    LM iterations. In float64 the two packages take the same steps: R and t
    within 1e-4 and the costs within rtol 1e-4. In f32 the port reaches the
    float64 optimum (rtol 1e-4), while tpusfm's steps stall up to 1% above
    it: its se3_log divides by a (1 - cos t) / t^2 that f32 resolves
    poorly near the identity (ROADMAP, Queue 3). The loop closure halves
    the drift, as in test_pgo.py."""
    (Rg, tg), jin, tin = _loop()
    if solver == "dense":
        jcfg, cfg = JaxPgoConfig(max_iters=15), PgoConfig(max_iters=15)
        jrun, run = jgraph.optimize_pose_graph, graph.optimize_pose_graph
    else:
        jcfg, cfg = JaxPgoConfig(max_iters=15, cg_iters=100), PgoConfig(max_iters=15, cg_iters=100)
        jrun, run = jgraph.optimize_pose_graph_cg, graph.optimize_pose_graph_cg
    with jax.enable_x64(True):
        j64, t64 = _f64(jin, tin)
        jR, jt, jc = (np.asarray(a) for a in jrun(*j64, cfg=jcfg))
    R, t, c = run(*t64, cfg=cfg)
    np.testing.assert_allclose(R.numpy(), jR, atol=1e-4)
    np.testing.assert_allclose(t.numpy(), jt, atol=1e-4)
    np.testing.assert_allclose(c.numpy(), jc, rtol=1e-4)

    _, _, jc32 = jrun(*jin, cfg=jcfg)
    R, t, c = run(*tin, cfg=cfg)
    np.testing.assert_allclose(float(c[-1]), jc[-1], rtol=1e-4)
    assert jc[-1] * (1 - 1e-4) <= float(jc32[-1]) <= jc[-1] * 1.01
    ate = lambda x: float(np.sqrt(((_np(x) - np.asarray(tg)) ** 2).sum(-1).mean()))  # noqa: E731
    assert ate(t) < 0.5 * ate(tin[1])


def test_chain_odometry_matches_tpusfm():
    _, (R0, t0, ei, ej, Zr, Zt, w), tin = _loop()
    jR, jt = jax_chain_odometry(Zr[:11], Zt[:11])
    R, t = chain_odometry(tin[4][:11], tin[5][:11])
    np.testing.assert_allclose(R.numpy(), np.asarray(jR), atol=1e-5)
    np.testing.assert_allclose(t.numpy(), np.asarray(jt), atol=1e-5)


def test_loop_generator_is_tpusfms():
    """torch_scenes.noisy_loop_problem, the torch rewrite of tests/test_pgo.py's
    generator, gives its poses and measurements (1e-6)."""
    want = _noisy_loop_problem(n=12, seed=2)
    got = noisy_loop_problem(n=12, seed=2, device="cpu")
    for g, w in zip(sum(got, ()), sum(want, ())):
        np.testing.assert_allclose(_np(g), np.asarray(w), atol=1e-6)


def test_pose_graph_converters_round_trip():
    _, jin, tin = _loop()
    for got, want in zip(tin, jin):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert tin[2].dtype == torch.int32 and tin[0].dtype == torch.float32
    cfg = JaxPgoConfig(max_iters=3, huber_delta=1e4, cg_iters=7)
    assert config_from(PgoConfig, cfg) == PgoConfig(max_iters=3, huber_delta=1e4, cg_iters=7)


def test_ate_rmse_matches_tpusfm():
    rng = np.random.default_rng(3)
    ref = rng.normal(size=(8, 3))
    est = 2.5 * ref @ np.linalg.qr(rng.normal(size=(3, 3)))[0].T + 1.0
    est += rng.normal(size=est.shape) * 0.01
    e, aligned = ate_rmse(est, ref)
    je, jaligned = jax_ate_rmse(est, ref)
    assert e == je and np.array_equal(aligned, jaligned) and e < 0.05
    R = rng.normal(size=(5, 3, 3))
    np.testing.assert_array_equal(camera_centers_from_w2c(R, ref[:5]),
                                  -np.einsum("vji,vj->vi", R, ref[:5]))


def test_build_sequence_graph_matches_tpusfm():
    """The sequence graph of a 4-view rendered rail (160x120) from the same
    SIFT features in both packages: the same edges (odometry, span 2, the
    closure), inlier counts within 3 (their RANSAC samples differ),
    relative poses within 0.02 and the same arrays' shapes."""
    views, f, _ = render_sequence(4, 120, 160)
    cfg = PipelineConfig(sift=SiftConfig(max_features=256, upsample=False),
                         match=MatchConfig(max_matches=256))
    feats = [sift_detect_and_compute(torch.from_numpy(v), cfg.sift) for v in views]
    jfeats = [JaxFeatures(kpts=JaxKeypoints(*(jnp.asarray(getattr(f_.kpts, n).numpy()) for n in
                                              ("xy", "scale", "angle", "response", "mask"))),
                          desc=jnp.asarray(f_.desc.numpy())) for f_ in feats]
    sizes = [(160, 120)] * 4
    jcfg = JaxPipelineConfig(match=JaxMatchConfig(max_matches=256))
    jedges, jm = jax_build_sequence_graph(jfeats, sizes, JaxIntrinsics.ideal(f, f, 80.0, 60.0),
                                          jcfg, algo="bf", spans=(2,), closure=True)
    edges, m = build_sequence_graph(feats, sizes, CameraIntrinsics.ideal(f, f, 80.0, 60.0, "cpu"),
                                    cfg, algo="bf", spans=(2,), closure=True)
    assert [(e.i, e.j) for e in edges] == [(e.i, e.j) for e in jedges]
    assert m["n_edges"] == jm["n_edges"] == 6
    for e, je in zip(edges, jedges):
        assert abs(e.n_inliers - je.n_inliers) <= 3, (e.i, e.j, e.n_inliers, je.n_inliers)
        np.testing.assert_allclose(e.R, je.R, atol=0.02)
        assert float(e.t_unit @ je.t_unit) > 0.999
    arrays, jarrays = edges_to_arrays(edges, device="cpu"), jax_edges_to_arrays(jedges)
    for a, ja in zip(arrays, jarrays):
        assert tuple(a.shape) == tuple(ja.shape)
    np.testing.assert_array_equal(arrays[0].numpy(), np.asarray(jarrays[0]))


def test_cg_pose_graph_at_1024_nodes_matches_tpusfm():
    """tests/test_pgo.py:157's 1,024-node loop (chords every 64 and 256
    nodes, their config: 20 LM iterations of 224 CG steps, Huber 1e4), both
    packages' CG in float64: the port ends within that test's 15% of
    tpusfm's final cost (they agree to 1e-6 here) and meets its criteria,
    cost under 2% of the start and ATE under 80% of the odometry's. In f32
    tpusfm stalls higher (3.15 against 2.32: its se3_log near the identity,
    ROADMAP Queue 3), and both stop far above the dense optimum (about
    0.03): the block-Jacobi CG carries information about one hop a step."""
    n = 1024
    (Rg, tg), (R0, t0), (ei, ej, Zr, Zt) = noisy_loop_problem(n=n, seed=7, noise=0.01,
                                                              chords=(64, 256), device="cpu")
    w = torch.ones(ei.shape[0])
    w[n - 1:] = 5.0
    tin = [a.double() if a.is_floating_point() else a for a in (R0, t0, ei, ej, Zr, Zt, w)]
    R, t, c = graph.optimize_pose_graph_cg(*tin, cfg=PgoConfig(max_iters=20, cg_iters=224,
                                                                huber_delta=1e4))
    with jax.enable_x64(True):
        jin = [jnp.asarray(a.numpy()) for a in tin]
        _, jt, jc = jgraph.optimize_pose_graph_cg(
            *jin, cfg=JaxPgoConfig(max_iters=20, cg_iters=224, huber_delta=1e4))
        jt, jc = np.asarray(jt), np.asarray(jc)
    assert abs(float(c[-1]) - jc[-1]) < 0.15 * jc[-1] + 1e-3
    np.testing.assert_allclose(c.numpy(), jc, rtol=1e-4)
    ate = lambda x: float(np.sqrt(((_np(x) - _np(tg)) ** 2).sum(-1).mean()))  # noqa: E731
    assert float(c[-1]) < 0.02 * float(c[0]) and jc[-1] < 0.02 * jc[0]
    assert ate(t) < 0.8 * ate(t0) and ate(jt) < 0.8 * ate(t0)
