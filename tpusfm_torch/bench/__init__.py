"""The port's benchmarks, tpusfm's ``bench`` subcommand on the card.

  two_view   two-view SfM frames/s at the reference's operating point
             against OpenCV (the repo's bench.py);
             ``python -m tpusfm_torch.bench``
  scaling    BA iterations/s, the track-major BA at scale, and the device
             curve of the sharded BA, the ring matcher, pair-parallel and
             pipelined two-view (the repo's scripts/scaling_bench.py);
             ``python -m tpusfm_torch.bench.scaling``
  scenes     the seeded rendered pair used where PikaBun is absent

Both also run through ``python -m tpusfm_torch.cli bench [--ba]``.
"""
