"""The plain reference that decides a benchmark run's ``correct``.

A frozen copy of the port's plain PyTorch code as the benchmark was
defined: SIFT (``sift``, ``scalespace``), dense SIFT (``dense``), dense
ORB (``orb_dense``), the blocked-matmul NN search (``distance``, the only
search here: no hand-written kernel), brute-force matching (``bf``),
k-means and LOGOS (``kmeans``, ``logos``), five-point RANSAC, pose and
triangulation (``epipolar``, ``five_point``, ``pose``, ``triangulate``,
``undistort``, ``projection``), and the two entries the cells drive
(``two_view``, ``disparity``). It imports nothing of the program, so a
later change to the program cannot move it. Run it with TF32 off
(``precision.py``): float32 in, float32 math.
"""
