"""Pad-and-mask helpers: the framework's answer to the reference's dynamic
containers (SURVEY.md "hard parts": variable keypoint/match/point counts
become fixed capacities so every kernel compiles once)."""
from __future__ import annotations

import numpy as np


def pad_to(arr: np.ndarray, n: int, fill=0):
    """Pad/truncate axis 0 to n. Returns (padded, mask)."""
    arr = np.asarray(arr)
    k = min(len(arr), n)
    out_shape = (n,) + arr.shape[1:]
    out = np.full(out_shape, fill, dtype=arr.dtype)
    out[:k] = arr[:k]
    mask = np.zeros(n, bool)
    mask[:k] = True
    return out, mask


def pad_rows(n: int, *arrays, fills=None):
    """Pad several parallel arrays to the same capacity; returns
    (padded..., mask)."""
    fills = fills or [0] * len(arrays)
    outs = []
    mask = None
    for a, f in zip(arrays, fills):
        p, m = pad_to(a, n, f)
        outs.append(p)
        mask = m if mask is None else mask
    return (*outs, mask)


def round_capacity(n: int, quantum: int = 256) -> int:
    """Round a needed size up to a capacity quantum (bounds re-jits)."""
    return max(quantum, -(-n // quantum) * quantum)
