"""Loader for the port's native host library, ``csrc/ccl.cpp`` (the port's
own copy of tpusfm's): union-find connected components, per-component
areas, boundary pixels and StereoBM's speckle filter.

The library is built with g++ at first use into ``build/tpusfm_torch/``,
keyed by the hash of the source and the flags (utils/build.py), so test
workers never race on one file. There is no fallback: every host of the
port has g++ (nvcc needs it), and a failed build or load raises. These are
host passes on numpy arrays, as in tpusfm: data-dependent labeling that an
iterative device formulation would spend many launches on.
"""
from __future__ import annotations

import ctypes
import pathlib

import numpy as np

from tpusfm_torch.utils.build import build_library

_SRC = pathlib.Path(__file__).resolve().parent / "csrc" / "ccl.cpp"
_FLAGS = ("-O3", "-shared", "-fPIC")
_lib = None

_u8p = ctypes.POINTER(ctypes.c_uint8)
_i32p = ctypes.POINTER(ctypes.c_int32)
_i64p = ctypes.POINTER(ctypes.c_int64)
_f32p = ctypes.POINTER(ctypes.c_float)


def library_path() -> pathlib.Path:
    """Build (at first use) the library; returns its path."""
    return build_library(_SRC, "g++", _FLAGS, "ccl")


def _load():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(library_path()))
        lib.tpusfm_ccl_label.restype = ctypes.c_int32
        lib.tpusfm_ccl_label.argtypes = [_u8p, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
                                         _i32p]
        lib.tpusfm_ccl_areas.restype = None
        lib.tpusfm_ccl_areas.argtypes = [_i32p, ctypes.c_int64, ctypes.c_int32, _i64p]
        lib.tpusfm_ccl_boundary.restype = None
        lib.tpusfm_ccl_boundary.argtypes = [_i32p, ctypes.c_int32, ctypes.c_int32, _u8p]
        lib.tpusfm_filter_speckles.restype = None
        lib.tpusfm_filter_speckles.argtypes = [_f32p, _u8p, ctypes.c_int32, ctypes.c_int32,
                                               ctypes.c_float, ctypes.c_int32]
        _lib = lib
    return _lib


def _image(a, dtype) -> np.ndarray:
    a = np.ascontiguousarray(np.asarray(a), dtype)
    if a.ndim != 2:
        raise ValueError(f"expected an (H, W) array, got shape {a.shape}")
    return a


def connected_components(mask, connectivity: int = 8):
    """Label the nonzero pixels of an (H, W) mask. Returns (labels (H, W)
    int32 with 0 for the background, n_components, areas (n,) int64)."""
    if connectivity not in (4, 8):
        raise ValueError(f"connectivity must be 4 or 8, got {connectivity}")
    m = _image(mask, np.uint8)
    h, w = m.shape
    lib = _load()
    labels = np.zeros((h, w), np.int32)
    n = lib.tpusfm_ccl_label(m.ctypes.data_as(_u8p), h, w, connectivity,
                             labels.ctypes.data_as(_i32p))
    areas = np.zeros(max(n, 1), np.int64)
    lib.tpusfm_ccl_areas(labels.ctypes.data_as(_i32p), h * w, max(n, 1),
                         areas.ctypes.data_as(_i64p))
    return labels, int(n), areas[:n]


def filter_speckles(disp, valid, max_diff: float, max_size: int):
    """cv::filterSpeckles in the StereoBM sense: invalidate the connected
    regions (4-neighbours whose disparities differ by at most ``max_diff``)
    of fewer than ``max_size`` valid pixels. Returns numpy (disp, valid)."""
    d = _image(disp, np.float32)
    v = _image(valid, np.uint8).copy()          # the library clears it in place
    if d.shape != v.shape:
        raise ValueError(f"disp {d.shape} and valid {v.shape} differ in shape")
    h, w = d.shape
    _load().tpusfm_filter_speckles(d.ctypes.data_as(_f32p), v.ctypes.data_as(_u8p), h, w,
                                   float(max_diff), int(max_size))
    return d, v.astype(bool)


def boundary(labels):
    """(H, W) bool: labelled pixels with a 4-neighbour of another label (or
    outside the image)."""
    l = _image(labels, np.int32)
    h, w = l.shape
    out = np.zeros((h, w), np.uint8)
    _load().tpusfm_ccl_boundary(l.ctypes.data_as(_i32p), h, w, out.ctypes.data_as(_u8p))
    return out.astype(bool)
