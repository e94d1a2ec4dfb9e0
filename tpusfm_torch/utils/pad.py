"""Static-shape padding helpers."""
from __future__ import annotations

import torch
import torch.nn.functional as F


def round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def pad_axis(arr: torch.Tensor, size: int, axis: int = 0, value=0) -> torch.Tensor:
    """Pad ``arr`` along ``axis`` up to ``size`` with ``value``."""
    axis = axis % arr.ndim
    cur = arr.shape[axis]
    if cur == size:
        return arr
    if cur > size:
        raise ValueError(f"cannot pad axis {axis} from {cur} down to {size}")
    pads = [0, 0] * (arr.ndim - axis - 1) + [0, size - cur]
    if arr.dtype == torch.bool:
        return F.pad(arr.to(torch.uint8), pads, value=int(value)).to(torch.bool)
    return F.pad(arr, pads, value=value)


def pad_to_multiple(arr: torch.Tensor, multiple: int, axis: int = 0, value=0) -> torch.Tensor:
    return pad_axis(arr, round_up(arr.shape[axis], multiple), axis, value)
