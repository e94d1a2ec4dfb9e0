"""GMS filtering with the MATCH axis sharded over a process group.

Dense-mode GMS scores one match per pixel; the vote scatter and the
per-match verdict are match-parallel while the grid is tiny. Each rank
scatters its shard's matches into the (cells1, cells2) histograms, one sum
over the group replicates the votes (counts of 1.0, exact in f32 below
2^24 in any order), the cell scoring runs identically everywhere and the
per-match verdict stays local until the masks are gathered.
"""
from __future__ import annotations

import functools

from tpusfm_torch.config import GmsConfig
from tpusfm_torch.dist.group import Group, all_gather_cat, all_reduce_sum, shard
from tpusfm_torch.match.gms import gms_inliers
from tpusfm_torch.types import Keypoints, Matches
from tpusfm_torch.utils.pad import pad_axis, round_up


def sharded_gms_filter(kpts1: Keypoints, kpts2: Keypoints, matches: Matches,
                       size1, size2, group: Group | None,
                       cfg: GmsConfig = GmsConfig()) -> Matches:
    """gms_filter with the match axis sharded over ``group``; the mask is
    bit-equal to gms_filter's."""
    xy1, xy2 = matches.gather_xy(kpts1, kpts2)
    n = xy1.shape[0]
    size = 1 if group is None else group.size
    cap = round_up(max(n, size), size)
    s = shard(group, cap)
    inl = gms_inliers(pad_axis(xy1, cap)[s], pad_axis(xy2, cap)[s], pad_axis(matches.mask, cap)[s],
                      size1, size2, cfg, functools.partial(all_reduce_sum, group))
    return Matches(idx1=matches.idx1, idx2=matches.idx2, distance=matches.distance,
                   mask=all_gather_cat(group, inl)[:n])
