"""K2: N fixed-size square patches around integer centers.

Replaces pislamfusion_tpu/ops/features/patchgather.py
`gather_patches_pallas` (its `pallas_call` at :148), which the ORB
descriptor tail calls on the packed pyramid (orb.py:978-980).

Function: out[n, i, j(, c)] = img[clamp(y_n - r + i), clamp(x_n - r + j)(, c)]
— an exact copy with edge clamp, G = 2r + 1.

On the H100 the copy is bound by bytes: at the main path's shapes
(1000 centers, r = 21, C = 1) it moves 7.4 MB out and at most as much in.
The TPU kernel DMA'd (8, 128)-aligned slabs and cut each patch out with
two one-hot MXU matmuls, because a TPU gathers on its scalar core; a GPU
gathers natively, so the kernel (`csrc/patchgather.cu`) is one thread per
output element: neighbouring threads write neighbouring output words and
read neighbouring pixels of one patch row (coalesced), and the source
rows of overlapping patches are shared through L2.
"""
from __future__ import annotations

import ctypes

import torch

from ... import _build


def gather_patches_plain(img, xy, radius: int):
    """Plain PyTorch version: two clamped index vectors, one gather."""
    r = radius
    G = 2 * r + 1
    H, W = img.shape[0], img.shape[1]
    ar = torch.arange(G, device=img.device)
    xy = xy.to(torch.int64)
    iy = (xy[:, 1:2] - r + ar[None, :]).clamp(0, H - 1)        # [N, G]
    ix = (xy[:, 0:1] - r + ar[None, :]).clamp(0, W - 1)
    return img[iy[:, :, None], ix[:, None, :]]


def gather_patches(img, xy, radius: int):
    """img: [H, W] or [H, W, C] float32; xy: [N, 2] int32 patch centers.
    Returns [N, G, G(, C)] float32 equal to the edge-padded windows
    img[y-r:y+r+1, x-r:x+r+1]. CPU tensors take the plain version; CUDA
    tensors launch the kernel."""
    if img.device.type == "cpu":
        return gather_patches_plain(img, xy, radius)
    if img.device.type != "cuda":
        raise ValueError(f"gather_patches: unsupported device {img.device}")
    if img.dtype != torch.float32 or img.ndim not in (2, 3):
        raise ValueError("gather_patches: img must be float32 [H, W(, C)]")
    if xy.device != img.device or xy.ndim != 2 or xy.shape[1] != 2:
        raise ValueError("gather_patches: xy must be [N, 2] on img's device")
    img = img.contiguous()
    xy = xy.to(torch.int32).contiguous()
    H, W = img.shape[0], img.shape[1]
    C = img.shape[2] if img.ndim == 3 else 1
    N = xy.shape[0]
    G = 2 * radius + 1
    out = torch.empty((N, G, G) + img.shape[2:], dtype=torch.float32,
                      device=img.device)
    if N == 0:
        return out
    lib = _build.load("patchgather")
    fn = lib.patchgather_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
    with torch.cuda.device(img.device):
        stream = torch.cuda.current_stream(img.device).cuda_stream
        err = fn(img.data_ptr(), H, W, C, xy.data_ptr(), N, radius,
                 out.data_ptr(), stream)
    _build.check(err, "patchgather")
    gather_patches.launches += 1
    return out


gather_patches.launches = 0
