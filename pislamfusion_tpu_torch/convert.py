"""FastVO state across the two packages, as numpy.

The system has no weights. Its state is the canvas pyramid (`canvas_lap`,
`canvas_w`: one [H >> i, W >> i, 3] and one [H >> i, W >> i, 1] float32
array per band) and the track carry (previous frame's descriptors — ORB
[N, 256] uint8 bit-planes, SIFT [N, 128] float32 — valid mask [N] bool,
plane points [N, 3] float32, and the two poses [7] float32 that seed the
motion model). These functions turn
the JAX FastVO's arrays, fetched as numpy, into the port's tensors and
back, so both sides can start from the same canvas and carry.
"""
from __future__ import annotations

import numpy as np
import torch

from .core.device import resolve_device

# the dtypes of a carry (desc, valid, p3d, pose_prev2, pose_est) by detector
CARRY_DTYPES = {
    detector: (desc, torch.bool, torch.float32, torch.float32, torch.float32)
    for detector, desc in (("orb", torch.uint8), ("sift", torch.float32))}


def fastvo_state_from_numpy(canvas_lap, canvas_w, carry=None, device=None):
    """numpy canvas bands (+ optional 5-tuple carry) -> dict of tensors on
    `device` (None means `cuda`, see `resolve_device`): {"canvas_lap":
    [...], "canvas_w": [...], "carry": tuple or None}. The canvas is
    float32; each carry array keeps its own dtype."""
    device = resolve_device(device)

    def t(a, dtype=None):
        return torch.from_numpy(np.array(a, dtype)).to(device)
    return {
        "canvas_lap": [t(a, np.float32) for a in canvas_lap],
        "canvas_w": [t(a, np.float32) for a in canvas_w],
        "carry": None if carry is None else tuple(t(a) for a in carry),
    }


def fastvo_state_to_numpy(state):
    """The inverse of fastvo_state_from_numpy."""
    def n(x):
        return x.detach().cpu().numpy()
    carry = state.get("carry")
    return {
        "canvas_lap": [n(a) for a in state["canvas_lap"]],
        "canvas_w": [n(a) for a in state["canvas_w"]],
        "carry": None if carry is None else tuple(n(a) for a in carry),
    }


def load_fastvo_state(vo, state):
    """Copy a state dict's canvas into a port FastVO's canvas buffers (in
    place; shapes must match). Returns the state's carry on vo.device, to
    be passed as `vo.process(..., carry=...)`, or None."""
    with torch.no_grad():
        for dst, src in zip(vo.canvas_lap + vo.canvas_w,
                            state["canvas_lap"] + state["canvas_w"]):
            if dst.shape != src.shape:
                raise ValueError(f"canvas band {tuple(src.shape)} does not "
                                 f"fit {tuple(dst.shape)}")
            dst.copy_(src)
    carry = state.get("carry")
    if carry is None:
        return None
    want = CARRY_DTYPES[vo.detector]
    got = tuple(a.dtype for a in carry)
    if got != want:
        raise ValueError(f"a {vo.detector} FastVO's carry holds {want}, "
                         f"not {got}")
    return tuple(a.to(vo.device) for a in carry)
