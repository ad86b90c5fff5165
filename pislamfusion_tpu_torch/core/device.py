"""Where the port runs, and the constant tensors it keeps there.

`resolve_device` is every entry point's `device` argument: the card
unless the caller names another, and an error, never a silent CPU run,
when the card is asked for and absent.

`upload` moves a host array to a device without waiting for the stream
(through pinned memory on a CUDA device), for the per-frame host
geometry of the Map2D engines.

`device_const` keeps tensors that never change (pad indices, pattern
tables, fixed matrices), made once per (key, device): a host->device copy
of a freshly made tensor waits for the stream, so making them per frame
would stall the frame loop.
"""
from __future__ import annotations

import numpy as np
import torch

_CACHE: dict = {}


def resolve_device(device=None) -> torch.device:
    """`cuda` unless `device` names another. Raises when CUDA is asked for
    (or defaulted to) and there is none."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "pislamfusion_tpu_torch runs on a CUDA device by default and "
            "none is available; pass device='cpu' to run the plain "
            "PyTorch versions on the CPU")
    return dev


def device_const(key, device, make):
    """The tensor `make()` (built on the CPU) on `device`, made and
    uploaded on first use of (key, device) only."""
    k = (key, str(device))
    t = _CACHE.get(k)
    if t is None:
        t = make().to(device)
        _CACHE[k] = t
    return t


def upload(a, device, dtype=None):
    """A host array (or a tensor) as a tensor on `device`, cast to `dtype`
    (None keeps its own). A host array bound for a CUDA device is cast on
    the host and copied through pinned memory, so the copy does not wait
    for the stream."""
    t = a if isinstance(a, torch.Tensor) else torch.from_numpy(np.array(a))
    if t.device.type != "cpu" or device.type != "cuda":
        return t.to(device=device, dtype=dtype)
    if dtype is not None:
        t = t.to(dtype)
    return t.contiguous().pin_memory().to(device, non_blocking=True)
