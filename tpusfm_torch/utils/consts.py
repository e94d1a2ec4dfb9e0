"""Host constants kept on the device."""
from __future__ import annotations

import numpy as np
import torch

_CONSTS: dict = {}


def device_const(values, device, dtype=None):
    """``values`` (a host array of constants: taps, offsets, weights) as a
    tensor on ``device``, made once and cached by its bytes, dtype and
    device. A fresh ``torch.as_tensor`` at each use would copy it from
    pageable host memory, a copy that blocks the host until the device
    has caught up and that no CUDA graph capture can hold."""
    a = np.ascontiguousarray(values)
    key = (a.dtype.str, a.shape, a.tobytes(), dtype, torch.device(device))
    t = _CONSTS.get(key)
    if t is None:
        t = _CONSTS[key] = torch.tensor(a, dtype=dtype, device=device)
    return t
