"""Parity of the port's brute-force matcher (tpusfm_torch.match.bf) with
tpusfm's on CPU: the tests/test_match.py scenarios through both bf_match."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from tpusfm.config import MatchConfig
from tpusfm.match.bf import bf_match as jax_bf_match
from tpusfm_torch.config import MatchConfig as TMatchConfig
from tpusfm_torch.match.bf import bf_match
from tpusfm_torch.utils.convert import config_from

torch.set_num_threads(2)


def _scenario(name):
    """(desc1, desc2, mask2, cfg, metric) of each tests/test_match.py case."""
    if name == "xla_masked":
        rng = np.random.default_rng(0)
        d1 = rng.normal(size=(100, 32)).astype(np.float32)
        d2 = rng.normal(size=(200, 32)).astype(np.float32)
        mask = np.ones(200, bool)
        mask[150:] = False
        return d1, d2, mask, MatchConfig(max_matches=100), "l2"
    if name == "pallas_shapes":
        rng = np.random.default_rng(1)
        d1 = rng.normal(size=(256, 128)).astype(np.float32)
        d2 = rng.normal(size=(512, 128)).astype(np.float32)
        mask = np.ones(512, bool)
        mask[400:] = False
        return d1, d2, mask, MatchConfig(), "l2"
    if name == "hamming":
        rng = np.random.default_rng(2)
        d1 = rng.integers(0, 2**31, size=(20, 8)).astype(np.uint32)
        d2 = rng.integers(0, 2**31, size=(30, 8)).astype(np.uint32)
        return d1, d2, None, MatchConfig(max_matches=20), "hamming"
    if name == "cross_check_and_prune":
        rng = np.random.default_rng(3)
        n = 64
        d1 = rng.normal(size=(n, 16)).astype(np.float32) * 10
        perm = rng.permutation(n)
        d2 = d1[perm] + rng.normal(size=(n, 16)).astype(np.float32) * 0.01
        return d1, d2, None, MatchConfig(max_matches=n), "l2"
    if name == "prune_rule":
        rng = np.random.default_rng(4)
        d1 = np.eye(8, dtype=np.float32) * 5
        d2 = d1 + rng.normal(size=d1.shape).astype(np.float32) * 0.003
        d2[7] += 100.0
        return d1, d2, None, MatchConfig(max_matches=8), "l2"
    raise ValueError(name)


def _compare(got, ref):
    np.testing.assert_array_equal(got.idx1.numpy(), np.asarray(ref.idx1))
    np.testing.assert_array_equal(got.idx2.numpy(), np.asarray(ref.idx2))
    np.testing.assert_array_equal(got.mask.numpy(), np.asarray(ref.mask))
    np.testing.assert_allclose(got.distance.numpy(), np.asarray(ref.distance), rtol=1e-5, atol=0)


def _compare_at_rounding_floor(got, ref, d1, d2):
    """For descriptors whose match distances sit at f32's rounding floor of
    |q|^2 + |db|^2 - 2 q.db (the cross-check scenario: norms ~40, distances
    ~0.03), both packages' distances are rounding noise and their order is
    too. The matched pairs must be the same set, and the squared distances
    agree within that floor: 16 f32 ulps of |q|^2 + |db|^2."""
    gm, rm = got.mask.numpy(), np.asarray(ref.mask)
    assert gm.sum() == rm.sum()
    gp = sorted(zip(got.idx1.numpy()[gm].tolist(), got.idx2.numpy()[gm].tolist()))
    rp = sorted(zip(np.asarray(ref.idx1)[rm].tolist(), np.asarray(ref.idx2)[rm].tolist()))
    assert gp == rp
    i1, i2 = np.array(gp).T
    floor = 16 * np.finfo(np.float32).eps * ((d1[i1] ** 2).sum(1) + (d2[i2] ** 2).sum(1))
    gd = dict(zip(got.idx1.numpy()[gm].tolist(), got.distance.numpy()[gm]))
    rd = dict(zip(np.asarray(ref.idx1)[rm].tolist(), np.asarray(ref.distance)[rm]))
    diff = np.array([gd[i] ** 2 - rd[i] ** 2 for i in i1])
    assert (np.abs(diff) <= floor).all(), (np.abs(diff) / floor).max()


@pytest.mark.parametrize("prune", [True, False])
@pytest.mark.parametrize("name", ["xla_masked", "pallas_shapes", "hamming",
                                  "cross_check_and_prune", "prune_rule"])
def test_bf_match_matches_tpusfm(name, prune):
    d1, d2, mask2, cfg, metric = _scenario(name)
    jm2 = None if mask2 is None else jnp.array(mask2)
    ref = jax_bf_match(jnp.array(d1), jnp.array(d2), None, jm2, cfg, metric, prune)
    tm2 = None if mask2 is None else torch.from_numpy(mask2)
    got = bf_match(torch.from_numpy(d1), torch.from_numpy(d2), None, tm2,
                   config_from(TMatchConfig, cfg), metric, prune)
    if name == "cross_check_and_prune":
        _compare_at_rounding_floor(got, ref, d1, d2)
    else:
        _compare(got, ref)


def test_bf_match_without_cross_check_matches_tpusfm():
    d1, d2, mask2, cfg, metric = _scenario("xla_masked")
    cfg = MatchConfig(cross_check=False, max_matches=40)
    ref = jax_bf_match(jnp.array(d1), jnp.array(d2), None, jnp.array(mask2), cfg)
    got = bf_match(torch.from_numpy(d1), torch.from_numpy(d2), None, torch.from_numpy(mask2),
                   config_from(TMatchConfig, cfg))
    _compare(got, ref)


def test_bf_match_batch_axis_equals_per_pair():
    a = _scenario("cross_check_and_prune")
    b = _scenario("cross_check_and_prune")
    d2b = b[1][::-1].copy()
    cfg = TMatchConfig(max_matches=64)
    got = bf_match(torch.from_numpy(np.stack([a[0], b[0]])),
                   torch.from_numpy(np.stack([a[1], d2b])), cfg=cfg)
    for i, (d1, d2) in enumerate(((a[0], a[1]), (b[0], d2b))):
        one = bf_match(torch.from_numpy(d1), torch.from_numpy(d2), cfg=cfg)
        for f in ("idx1", "idx2", "mask", "distance"):
            assert torch.equal(getattr(got, f)[i], getattr(one, f)), f
