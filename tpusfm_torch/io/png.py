"""PNG decode and encode with zlib and numpy (no PIL).

The machine the port runs on has no PIL, and every CLI subcommand reads or
writes PNGs, so PNG goes through this one path everywhere.

* ``read_rgb`` decodes 8-bit greyscale, greyscale + alpha, RGB and RGBA,
  and palette or greyscale images of 1, 2, 4 or 8 bits, undoing all five
  row filters (None, Sub, Up, Average, Paeth), and converts to (H, W, 3)
  uint8 RGB as ``PIL.Image.convert("RGB")`` does: grey is repeated, alpha
  dropped, palette indices looked up. Interlaced and 16-bit images raise.
* ``write`` encodes (H, W) uint8 as greyscale or (H, W, 3) uint8 as RGB,
  every row with filter None.

Sub and Up rows are undone with whole-row numpy operations; Average and
Paeth depend on the pixel to their left and run a Python loop per byte
(a few seconds for a 2000 x 1500 photo; this package's own files never
use them).
"""
from __future__ import annotations

import struct
import zlib

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
# colour type -> samples per pixel
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


def is_png(path: str) -> bool:
    """True when the file starts with the PNG signature."""
    with open(path, "rb") as f:
        return f.read(8) == SIGNATURE


def _chunks(data: bytes, path: str):
    pos = 8
    while pos + 8 <= len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        if len(body) != n:
            raise ValueError(f"{path}: truncated {kind!r} chunk")
        yield kind, body
        if kind == b"IEND":
            return
        pos += 12 + n
    raise ValueError(f"{path}: no IEND chunk")


def _paeth_row(raw: np.ndarray, up: np.ndarray, bpp: int) -> np.ndarray:
    out = bytearray(raw.tobytes())
    b = up.tobytes()
    for i in range(len(out)):
        a = out[i - bpp] if i >= bpp else 0
        c = b[i - bpp] if i >= bpp else 0
        p = a + b[i] - c
        pa, pb, pc = abs(p - a), abs(p - b[i]), abs(p - c)
        pred = a if pa <= pb and pa <= pc else (b[i] if pb <= pc else c)
        out[i] = (out[i] + pred) & 0xFF
    return np.frombuffer(bytes(out), np.uint8)


def _average_row(raw: np.ndarray, up: np.ndarray, bpp: int) -> np.ndarray:
    out = bytearray(raw.tobytes())
    b = up.tobytes()
    for i in range(len(out)):
        a = out[i - bpp] if i >= bpp else 0
        out[i] = (out[i] + ((a + b[i]) >> 1)) & 0xFF
    return np.frombuffer(bytes(out), np.uint8)


def _unfilter(data: np.ndarray, height: int, stride: int, bpp: int, path: str) -> np.ndarray:
    """Undo the per-row filters: data (height * (1 + stride),) -> (height, stride)."""
    rows = data.reshape(height, 1 + stride)
    out = np.zeros((height, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(height):
        kind, raw = rows[y, 0], rows[y, 1:]
        if kind == 0:
            cur = raw
        elif kind == 1:      # Sub: a running sum per byte of the pixel, mod 256
            run = np.cumsum(raw.reshape(-1, bpp), axis=0, dtype=np.uint64)
            cur = (run & 0xFF).astype(np.uint8).reshape(-1)
        elif kind == 2:      # Up
            cur = raw + prev
        elif kind == 3:
            cur = _average_row(raw, prev, bpp)
        elif kind == 4:
            cur = _paeth_row(raw, prev, bpp)
        else:
            raise ValueError(f"{path}: bad filter type {kind} on row {y}")
        out[y] = cur
        prev = out[y]
    return out


def read_rgb(path: str) -> np.ndarray:
    """Decode a PNG file to (H, W, 3) uint8 RGB (see the module docstring)."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != SIGNATURE:
        raise ValueError(f"{path}: not a PNG file")
    header, palette, idat = None, None, []
    for kind, body in _chunks(data, path):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(body)
    if header is None:
        raise ValueError(f"{path}: no IHDR chunk")
    width, height, depth, ctype, _, _, interlace = header
    if ctype not in _CHANNELS:
        raise ValueError(f"{path}: bad colour type {ctype}")
    if interlace:
        raise ValueError(f"{path}: interlaced PNGs are not supported")
    if depth != 8 and not (ctype in (0, 3) and depth in (1, 2, 4)):
        raise ValueError(f"{path}: {depth}-bit colour type {ctype} is not supported")
    ch = _CHANNELS[ctype]
    stride = (width * ch * depth + 7) // 8
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size < height * (1 + stride):
        raise ValueError(f"{path}: image data too short")
    rows = _unfilter(raw[:height * (1 + stride)], height, stride, max(1, ch * depth // 8), path)
    if depth < 8:            # packed samples, most significant bits first
        weights = (1 << np.arange(depth - 1, -1, -1)).astype(np.uint8)
        bits = np.unpackbits(rows, axis=1)[:, :width * depth].reshape(height, width, depth)
        samples = (bits * weights).sum(-1).astype(np.uint8)[..., None]
    else:
        samples = rows[:, :width * ch].reshape(height, width, ch)
    if ctype == 3:
        if palette is None:
            raise ValueError(f"{path}: palette image without PLTE")
        return palette[np.minimum(samples[..., 0], len(palette) - 1)]
    if ctype in (0, 4):
        g = samples[..., 0]
        if depth < 8:
            g = (g.astype(np.uint16) * (255 // ((1 << depth) - 1))).astype(np.uint8)
        return np.repeat(g[..., None], 3, axis=-1)
    return np.ascontiguousarray(samples[..., :3])


def _chunk(kind: bytes, body: bytes) -> bytes:
    return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))


def write(path: str, img: np.ndarray) -> None:
    """Encode (H, W) uint8 as 8-bit greyscale or (H, W, 3) uint8 as RGB."""
    a = np.ascontiguousarray(img)
    if a.dtype != np.uint8 or not (a.ndim == 2 or (a.ndim == 3 and a.shape[2] == 3)):
        raise ValueError(f"PNG encode takes (H, W) or (H, W, 3) uint8, got {a.dtype} {a.shape}")
    h, w = a.shape[:2]
    ctype = 0 if a.ndim == 2 else 2
    rows = np.concatenate([np.zeros((h, 1), np.uint8), a.reshape(h, -1)], axis=1)
    with open(path, "wb") as f:
        f.write(SIGNATURE)
        f.write(_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, ctype, 0, 0, 0)))
        f.write(_chunk(b"IDAT", zlib.compress(rows.tobytes(), 6)))
        f.write(_chunk(b"IEND", b""))
