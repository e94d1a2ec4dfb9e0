"""Descriptor nearest-neighbour search — the matching hot loop.

For each query row: the index of the nearest unmasked db row and the best
and second-best distances (squared L2, or Hamming on packed uint32 words).
Masked db rows never win; a query whose db is all masked gets index -1 and
distances 1e30. Ties go to the lowest db index.

Three functions, one contract:
  * ``nn_search_torch`` — the plain PyTorch version (port of tpusfm's
    ``nn_search_xla``): blocked matmul + running top-2;
  * ``nn_search_cuda`` — the hand-written CUDA kernel
    (``csrc/nn_search.cu``: wgmma on the tensor cores; f32 as 3xTF32, bf16
    in one pass, Hamming as int8 products of the unpacked 0/1 bits ranked
    on packed integer (distance, index) keys), built with nvcc at first use;
  * ``nn_search`` — dispatch on the tensors' device: CPU tensors take the
    plain version, CUDA tensors take the kernel, anything else raises.

All accept an optional leading batch axis: q (B, Nq, D), db (B, Ndb, D),
db_mask (B, Ndb).

``split_tf32`` and ``hamming_top2_keys`` are the plain versions of the
kernel's f32 split and of its Hamming epilogue, for the tests.
"""
from __future__ import annotations

import ctypes
import os
import pathlib

import torch

from tpusfm_torch.utils.build import BUILD_DIR as _BUILD_DIR, build_library

BIG = 1e30

# Number of times nn_search_cuda launched its kernel (one per call).
launches = 0
# Of those, the bf16 L2 calls that took the overlapped path: two accumulators
# a consumer, the top-2 fold of one db tile after the next tile's products
# are issued, and a fold that skips warp-tiles that cannot enter the top-2
# (full_update_share).
dual_launches = 0
# nvcc's output for the loaded library (-Xptxas -v: registers, shared memory, spills).
build_log = ""

_SRC = pathlib.Path(__file__).resolve().parent / "csrc" / "nn_search.cu"
_NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
               "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
_VARIANTS = {torch.float32: 0, torch.bfloat16: 1}
_HAMMING = 2
_lib = None


def unpack_bits(x: torch.Tensor) -> torch.Tensor:
    """Packed binary descriptors (..., W) uint32/int32 -> (..., 32*W) bf16
    of 0/1 bits. Hamming distance between packed descriptors equals squared
    L2 between their bit vectors, exactly (integers <= 256)."""
    w = x.view(torch.int32) if x.dtype == torch.uint32 else x.to(torch.int32)
    shifts = torch.arange(32, dtype=torch.int32, device=x.device)
    bits = (w.unsqueeze(-1) >> shifts) & 1  # arithmetic shift: bit s is still bit 0
    return bits.reshape(*x.shape[:-1], -1).to(torch.bfloat16)


def split_tf32(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """x (f32) = hi + lo + r: hi is x rounded to TF32 (10 explicit mantissa
    bits, to nearest, ties away from zero, as ``cvt.rna.tf32.f32``), lo the
    remainder x - hi rounded the same way. The plain version of the CUDA prep
    kernel's 3xTF32 split; used by the tests."""
    def rna(v):
        return ((v.view(torch.int32) + 0x1000) & ~0x1FFF).view(torch.float32)

    hi = rna(x.float().contiguous())
    return hi, rna(x.float() - hi)


def hamming_key_shift(words: int, ndb: int) -> int:
    """Index bits below the distance field of the kernel's Hamming keys for
    a db of ``ndb`` rows of ``words`` words: the bits of the last index of
    the db padded to 128-row tiles, or 32 (64-bit keys) where that and the
    field (up to the sentinel 64 * words + 1) do not fit 32 bits together."""
    shift = (-(-ndb // 128) * 128 - 1).bit_length()
    return 32 if (64 * words + 1).bit_length() + shift > 32 else shift


def hamming_top2_keys(q_bits, db_bits, db_mask=None, kshift=None):
    """The plain version of the CUDA kernel's Hamming epilogue, used by the
    tests. q_bits (..., Nq, 32W), db_bits (..., Ndb, 32W) of 0/1, in
    ``unpack_bits``' order. Masked db rows are zeroed and the db is padded
    to 128-row tiles; each column's key base is f = popc(db) + 32W (the
    sentinel 64W + 1 where masked or padded) and its key, from the s32 dot
    a.b, is base - (a.b << (s + 1)) with base = (f << s) | column, or
    ((f - 2 a.b) << 32) | column for 64-bit keys (s = 32). The two least
    keys per query are decoded: the index from the low s bits, the distance
    from the field plus popc(q) - 32W; a sentinel field gives -1 and 1e30.
    ``kshift`` defaults to ``hamming_key_shift``'s choice.

    Returns (idx int32, best f32, second f32), each shaped q_bits.shape[:-1]."""
    qb, dbb = q_bits.to(torch.int32), db_bits.to(torch.int32)
    words = qb.shape[-1] // 32
    off, sent = 32 * words, 64 * words + 1
    ndb = dbb.shape[-2]
    rows = -(-ndb // 128) * 128
    if kshift is None:
        kshift = hamming_key_shift(words, ndb)
    valid = (_ones_mask(dbb) if db_mask is None else db_mask) != 0
    pad = rows - ndb
    valid = torch.nn.functional.pad(valid, (0, pad), value=False)
    dbb = torch.nn.functional.pad(dbb, (0, 0, 0, pad)) * valid.unsqueeze(-1)
    dot = (qb @ dbb.transpose(-1, -2)).long()
    field = torch.where(valid, dbb.sum(-1) + off, sent).long().unsqueeze(-2)
    col = torch.arange(rows, dtype=torch.int64)
    if kshift < 32:
        key = ((field << kshift) | col) - (dot << (kshift + 1))
    else:
        key = ((field - 2 * dot) << 32) | col
    k1, k2 = torch.topk(key, 2, dim=-1, largest=False).values.unbind(-1)
    v1, v2 = k1 < (sent << kshift), k2 < (sent << kshift)
    base = (qb.sum(-1) - off).long()
    idx = torch.where(v1, k1 & ((1 << kshift) - 1), -1).to(torch.int32)
    best = torch.where(v1, (k1 >> kshift) + base, 0).float().masked_fill(~v1, BIG)
    second = torch.where(v2, (k2 >> kshift) + base, 0).float().masked_fill(~v2, BIG)
    return idx, best, second


def _ones_mask(db):
    return torch.ones(db.shape[:-1], dtype=torch.float32, device=db.device)


def nn_search_torch(q, db, db_mask=None, metric: str = "l2", block: int = 1024):
    """Plain PyTorch NN search: blocks of db, a matmul per block, and a
    running (best, second, idx) merged with a strict < (lowest index wins).

    Returns (idx int32, best f32, second f32), each shaped q.shape[:-1]."""
    if db_mask is None:
        db_mask = _ones_mask(db)
    if metric == "hamming":
        q, db = unpack_bits(q), unpack_bits(db)
    elif metric != "l2":
        raise ValueError(f"unknown metric {metric!r}")
    qf = q.float()
    dbf = db.float()
    pen = (1.0 - db_mask.float()) * BIG
    qn = (qf * qf).sum(-1)
    dn = (dbf * dbf).sum(-1)
    shape = q.shape[:-1]
    best = torch.full(shape, BIG, dtype=torch.float32, device=q.device)
    second = torch.full(shape, BIG, dtype=torch.float32, device=q.device)
    idx = torch.full(shape, -1, dtype=torch.int32, device=q.device)
    for off in range(0, db.shape[-2], block):
        blk = slice(off, off + block)
        cross = qf @ dbf[..., blk, :].transpose(-1, -2)
        dist = torch.clamp(qn.unsqueeze(-1) + dn[..., blk].unsqueeze(-2) - 2.0 * cross, min=0.0)
        dist = dist + pen[..., blk].unsqueeze(-2)
        bidx = torch.argmin(dist, dim=-1, keepdim=True)  # first occurrence
        bmin = torch.gather(dist, -1, bidx)
        bmin2 = dist.scatter(-1, bidx, BIG).amin(-1)
        bmin, bidx = bmin.squeeze(-1), bidx.squeeze(-1).to(torch.int32) + off
        take = bmin < best
        loser = torch.where(take, best, bmin)
        second = torch.minimum(second, torch.minimum(loser, bmin2))
        best = torch.where(take, bmin, best)
        idx = torch.where(take, bidx, idx)
    return idx, best, second


def _build() -> pathlib.Path:
    """Compile csrc/nn_search.cu with nvcc into build/tpusfm_torch/ (see
    utils/build.py); nvcc's output goes beside the library (.log)."""
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")
    return build_library(_SRC, os.path.join(CUDA_HOME, "bin", "nvcc"), _NVCC_FLAGS, "nn_search")


def load_kernel():
    """Build (at first use) and load the CUDA library; returns its handle."""
    global _lib, build_log
    if _lib is None:
        path = _build()
        lib = ctypes.CDLL(str(path))
        lib.tpusfm_nn_workspace.argtypes = [ctypes.c_int] * 5 + [ctypes.c_void_p] * 2
        lib.tpusfm_nn_workspace.restype = ctypes.c_longlong
        lib.tpusfm_nn_fold_counts.argtypes = [ctypes.c_void_p]
        lib.tpusfm_nn_fold_counts.restype = ctypes.c_int
        lib.tpusfm_nn_search.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 5
                                         + [ctypes.c_void_p])
        lib.tpusfm_nn_search.restype = ctypes.c_int
        lib.tpusfm_nn_key_shift.argtypes = [ctypes.c_int] * 5
        lib.tpusfm_nn_key_shift.restype = ctypes.c_int
        log = path.with_suffix(".log")
        build_log = log.read_text() if log.exists() else ""
        _lib = lib
    return _lib


def _variant(metric: str, dtype) -> int:
    """The kernel's variant for a metric and operand type (see nn_search.cu)."""
    if metric == "l2":
        if dtype not in _VARIANTS:
            raise TypeError(f"l2 takes float32 or bfloat16, got {dtype}")
        return _VARIANTS[dtype]
    if metric == "hamming":
        if dtype not in (torch.uint32, torch.int32):
            raise TypeError(f"hamming takes packed uint32/int32 words, got {dtype}")
        return _HAMMING
    raise ValueError(f"unknown metric {metric!r}")


def db_splits(B: int, nq: int, ndb: int, d: int, dtype=torch.float32,
              metric: str = "l2") -> int:
    """The number of db slices the kernel splits a (B, nq, d) x (B, ndb, d)
    call into on the current CUDA device (1: no merge pass)."""
    s = ctypes.c_int(0)
    load_kernel().tpusfm_nn_workspace(B, nq, ndb, d, _variant(metric, dtype), ctypes.byref(s),
                                      None)
    return s.value


def full_update_counts() -> tuple[int, int]:
    """(warp-tiles that took the full top-2 fold, all warp-tiles) of the
    bf16 overlapped path on the current CUDA device, summed over every
    call since the library was loaded. Synchronizes with the device."""
    torch.cuda.synchronize()
    out = (ctypes.c_ulonglong * 2)()
    err = load_kernel().tpusfm_nn_fold_counts(out)
    if err != 0:
        raise RuntimeError(f"reading the fold counts failed: cudaError {err}")
    return int(out[0]), int(out[1])


def full_update_share(since: tuple[int, int] = (0, 0)) -> float:
    """The share of warp-tiles that took the full top-2 fold on the bf16
    overlapped path, over the calls after the ``full_update_counts()``
    reading ``since`` (default: every call). NaN where there were none."""
    full, tiles = full_update_counts()
    tiles -= since[1]
    return (full - since[0]) / tiles if tiles else float("nan")


def key_shift(B: int, nq: int, ndb: int, words: int) -> int:
    """The index bits of the kernel's Hamming keys for these shapes, as the
    library computes them (32: 64-bit keys); equals hamming_key_shift."""
    return load_kernel().tpusfm_nn_key_shift(B, nq, ndb, words, _HAMMING)


def nn_search_cuda(q, db, db_mask=None, metric: str = "l2"):
    """NN search through the hand-written CUDA kernel; one launch covers the
    whole leading batch axis (the C call runs the prep, product and merge
    kernels on the current stream). Same contract as nn_search_torch:
    Hamming distances are exact and the lowest index wins ties."""
    global launches, dual_launches
    variant = _variant(metric, q.dtype)
    if db_mask is None:
        db_mask = _ones_mask(db)
    for name, t in (("q", q), ("db", db), ("db_mask", db_mask)):
        if t.device.type != "cuda":
            raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    for name, t in (("q", q), ("db", db)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if db.dtype != q.dtype or db.device != q.device or db_mask.device != q.device:
        raise ValueError("q and db must share dtype and device with db_mask")
    batched = q.dim() == 3
    if q.dim() not in (2, 3) or db.dim() != q.dim() or db_mask.dim() != q.dim() - 1:
        raise ValueError(f"bad ranks: q {tuple(q.shape)} db {tuple(db.shape)} "
                         f"mask {tuple(db_mask.shape)}")
    if not batched:
        q, db, db_mask = q[None], db[None], db_mask[None]
    B, nq, d = q.shape
    ndb = db.shape[1]
    if db.shape[0] != B or db.shape[2] != d or tuple(db_mask.shape) != (B, ndb) or d == 0:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)} db {tuple(db.shape)} "
                         f"mask {tuple(db_mask.shape)}")
    mask = db_mask.to(torch.float32).contiguous()
    idx = torch.empty((B, nq), dtype=torch.int32, device=q.device)
    best = torch.empty((B, nq), dtype=torch.float32, device=q.device)
    second = torch.empty((B, nq), dtype=torch.float32, device=q.device)
    if B * nq > 0:
        lib = load_kernel()
        with torch.cuda.device(q.device):
            # prepped operands, norms, penalties and per-slice partials
            overlap = ctypes.c_int(0)
            ws = torch.empty(lib.tpusfm_nn_workspace(B, nq, ndb, d, variant, None,
                                                     ctypes.byref(overlap)),
                             dtype=torch.uint8, device=q.device)
            stream = torch.cuda.current_stream().cuda_stream
            err = lib.tpusfm_nn_search(
                q.data_ptr(), db.data_ptr(), mask.data_ptr(), ws.data_ptr(),
                idx.data_ptr(), best.data_ptr(), second.data_ptr(),
                B, nq, ndb, d, variant, stream)
        if err != 0:
            raise RuntimeError(f"nn_search kernel launch failed: cudaError {err}")
        launches += 1
        dual_launches += overlap.value
    if not batched:
        idx, best, second = idx[0], best[0], second[0]
    return idx, best, second


def nn_search(q, db, db_mask=None, metric: str = "l2"):
    """Dispatching NN search: the plain version for CPU tensors, the CUDA
    kernel for CUDA tensors (it launches or raises; there is no fallback)."""
    if q.device.type == "cpu":
        return nn_search_torch(q, db, db_mask, metric)
    if q.device.type == "cuda":
        return nn_search_cuda(q, db, db_mask, metric)
    raise ValueError(f"nn_search has no path for device {q.device}")
