"""The port's portrait chain (tpusfm_torch.stereo.portrait and what it
calls) against the benchmark's plain reference (benchmark/reference/
portrait.py and gms.py), on the CPU: whole portraits of seeded rendered
pairs at 96x64 in float32 and in the bfloat16 opt-in, GMS on seeded random
matches with rotation and scale on and off, and the median, the dilation
and the labelling on random inputs.

Every comparison here is exact. On the CPU both sides compute the same
float32 operations: the grey image and the descriptors by the same ops,
the search's (|q|^2 + |d|^2) - 2 q.d rounded alike, counts as integers,
and the median as the same integer levels scaled by the same reciprocal.
"""
import numpy as np
import pytest
import torch

from benchmark.portrait_scene import render_robot_pair
from benchmark.reference import gms as ref_gms
from benchmark.reference import portrait as ref
from tpusfm_torch import native
from tpusfm_torch.config import GmsConfig
from tpusfm_torch.match.gms import gms_inliers
from tpusfm_torch.stereo import filters, portrait

torch.set_num_threads(2)

H, W = 64, 96
THRESHOLD = 60.0 * W / 2594          # the cell's 60 px, scaled as the render is


@pytest.fixture(scope="module", params=[11, 2 ** 33 + 7])
def pair(request):
    left, right, disp, near = render_robot_pair(H, W, request.param)
    return torch.from_numpy(left), torch.from_numpy(right), near


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_portrait_equals_the_plain_reference(pair, dtype):
    """Disparity, foreground and portrait equal the reference's bit for bit,
    and most of the foreground lies on the scene's near objects, which
    cover 18% of the image (at this size the 16 px span of a descriptor
    and the dilation blur the objects' edges: 62-64% measured)."""
    left, right, near = pair
    out, fg, disp = portrait.create_portrait_mode(left, right, threshold=THRESHOLD, dtype=dtype)
    r = ref.create_portrait_mode(left, right, threshold=THRESHOLD, dtype=dtype)
    assert torch.equal(disp, r["disp"])
    assert torch.equal(fg, r["fg"]) and int(fg.sum()) > 300
    assert torch.equal(out, r["portrait"])
    assert (fg.numpy() & near).sum() / fg.sum().item() > 0.5


def _matches(seed, n=3000, size=(320, 240)):
    """Seeded matches: a coherent shift for 70% of them, random
    destinations for the rest."""
    g = np.random.default_rng(seed)
    w, h = size
    xy1 = g.uniform([0, 0], [w, h], size=(n, 2)).astype(np.float32)
    xy2 = np.clip(xy1 + np.array([17.0, -6.0], np.float32), 0, [w - 1, h - 1])
    out = g.random(n) > 0.7
    xy2[out] = g.uniform([0, 0], [w, h], size=(int(out.sum()), 2))
    return torch.from_numpy(xy1), torch.from_numpy(xy2.astype(np.float32)), size


@pytest.mark.parametrize("with_scale", [False, True])
@pytest.mark.parametrize("with_rotation", [False, True])
@pytest.mark.parametrize("seed", [3, 2 ** 32 + 9])
def test_gms_equals_the_plain_reference(seed, with_rotation, with_scale):
    """The inlier masks are equal: votes are counts and cells are found by
    the same float32 arithmetic."""
    xy1, xy2, size = _matches(seed)
    valid = torch.ones(len(xy1), dtype=torch.bool)
    valid[::13] = False
    cfg = GmsConfig(with_rotation=with_rotation, with_scale=with_scale)
    got = gms_inliers(xy1, xy2, valid, size, size, cfg)
    want = ref_gms.gms_inliers(xy1, xy2, valid, size, size, with_rotation=with_rotation,
                               with_scale=with_scale)
    assert torch.equal(got, want) and int(want.sum()) > 500


@pytest.mark.parametrize("radius", [1, 3, 7])
def test_median_equals_the_plain_reference(radius):
    """The histogram median equals the sorting median at 256 levels, border
    bands included; values outside [0, 1] are clamped alike."""
    g = torch.Generator().manual_seed(radius)
    img = torch.rand(37, 45, 3, generator=g) * 1.2 - 0.1
    assert torch.equal(filters.median_blur(img, radius), ref.median_blur(img, radius, row_block=8))


@pytest.mark.parametrize("iterations", [1, 2, 3])
def test_dilation_equals_the_plain_reference(iterations):
    g = torch.Generator().manual_seed(iterations)
    mask = torch.rand(41, 53, generator=g) > 0.93
    assert torch.equal(filters.dilate(mask, iterations), ref.dilate(mask, iterations))


def _blobs(seed, h=90, w=120):
    """A mask of a few dozen discs and single pixels of varied sizes."""
    g = np.random.default_rng(seed)
    ys, xs = np.mgrid[0:h, 0:w]
    m = g.random((h, w)) > 0.985
    for _ in range(40):
        cy, cx, rad = g.uniform(0, h), g.uniform(0, w), g.uniform(1.0, 7.0)
        m |= (ys - cy) ** 2 + (xs - cx) ** 2 < rad * rad
    return m


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_labelling_partitions_as_the_native_union_find(seed):
    """The device labelling's regions are the host union-find's, 8-connected."""
    m = _blobs(seed)
    labels, n, _ = native.connected_components(m, 8)
    lab = ref.label(torch.from_numpy(m)).numpy()
    assert n > 20 and len(np.unique(lab[m])) == n
    pairs = set(zip(labels[m].tolist(), lab[m].tolist()))
    assert len(pairs) == n          # one reference label for each native one
    assert (lab[~m] == m.size).all()


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_largest_regions_are_the_programs_foreground(seed):
    """Keeping the 5 largest regions gives the program's foreground where the
    fifth and sixth areas differ (the program leaves equal areas' order open)."""
    m = _blobs(seed)
    areas = np.sort(native.connected_components(m, 8)[2])[::-1]
    assert areas[4] > areas[5]
    disp = torch.from_numpy(m.astype(np.float32) * 100.0)
    got = portrait.foreground_mask_from_disparity(disp, torch.ones_like(disp, dtype=torch.bool),
                                                  dilate_iters=0)
    assert torch.equal(got, ref.largest_regions(torch.from_numpy(m), 5))
