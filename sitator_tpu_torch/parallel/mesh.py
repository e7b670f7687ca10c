"""Frame-axis helpers (counterpart of ``sitator_tpu.parallel.mesh``).

Only :func:`pad_frames` is ported: the port runs on one device, and frame
sharding over several cards waits until there is more than one."""
from __future__ import annotations

import numpy as np

__all__ = ["pad_frames"]


def pad_frames(arr, multiple):
    """Pad the leading axis to a multiple (repeating the last frame).
    Returns (padded, n_valid)."""
    n = arr.shape[0]
    rem = (-n) % multiple
    if rem == 0:
        return arr, n
    pad = np.broadcast_to(arr[-1:], (rem,) + arr.shape[1:])
    return np.concatenate([arr, pad], axis=0), n
