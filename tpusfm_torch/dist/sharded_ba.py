"""Distributed bundle adjustment over a process group.

* ``sharded_bundle_adjust``: the flat solver with the OBSERVATION axis
  sharded. Every normal-equation block (U, Vp, W, g_c, g_p) and the cost
  are segment sums over observations, so each rank reduces its shard and
  one sum over the group replicates them; the reduced camera system is then
  solved identically on every rank.
* ``sharded_bundle_adjust_tm``: the track-major solver with the TRACK axis
  sharded. A track's point block, its update and its observations stay on
  its rank; the reduced camera system (V,6,V,6), its rhs and the cost are
  summed each LM step -- O((6V)^2) numbers, independent of the track count.

Both run the single-process LM loops (ba/solver.py, ba/track_solver.py)
with a ``reduce_fn`` that sums over the group, so accept/reject stays on
the device and every rank takes the same steps.
"""
from __future__ import annotations

import functools

from tpusfm_torch.ba.solver import bundle_adjust
from tpusfm_torch.ba.track_solver import TrackObservations, bundle_adjust_tm
from tpusfm_torch.ba.tracks import Observations, pad_observations
from tpusfm_torch.config import BaConfig
from tpusfm_torch.dist.group import Group, all_gather_cat, all_reduce_sum, shard
from tpusfm_torch.utils.pad import pad_axis, round_up


def sharded_bundle_adjust(cams, points, obs: Observations, K, dist, group: Group | None,
                          cfg: BaConfig = BaConfig(), n_fixed_cams: int = 1):
    """bundle_adjust with the observation axis sharded over ``group``.

    Every rank passes the full problem and gets the full result:
    (cams, points, costs), as bundle_adjust returns them."""
    size = 1 if group is None else group.size
    obs = pad_observations(obs, round_up(max(obs.xy.shape[0], size), size))
    s = shard(group, obs.xy.shape[0])
    local = Observations(xy=obs.xy[s], cam=obs.cam[s], pt=obs.pt[s], mask=obs.mask[s])
    return bundle_adjust(cams, points, local, K, dist, cfg, n_fixed_cams,
                         reduce_fn=functools.partial(all_reduce_sum, group))


def sharded_bundle_adjust_tm(cams, points, tobs: TrackObservations, K, dist,
                             group: Group | None, cfg: BaConfig = BaConfig(),
                             n_fixed_cams: int = 1):
    """bundle_adjust_tm with the track axis sharded over ``group``; every
    rank passes the full problem and gets the full (cams, points, costs)."""
    size = 1 if group is None else group.size
    n = tobs.xy.shape[0]
    cap = round_up(max(n, size), size)
    s = shard(group, cap)
    local = TrackObservations(xy=pad_axis(tobs.xy, cap)[s], cam=pad_axis(tobs.cam, cap)[s],
                              mask=pad_axis(tobs.mask, cap)[s])
    cams, pts, costs = bundle_adjust_tm(cams, pad_axis(points, cap)[s], local, K, dist, cfg,
                                        n_fixed_cams,
                                        reduce_fn=functools.partial(all_reduce_sum, group))
    return cams, all_gather_cat(group, pts)[:n], costs
