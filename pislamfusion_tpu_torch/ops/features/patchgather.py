"""K2: N fixed-size square patches around integer centers; K6: bilinear
samples on scattered sub-pixel grids around integer centers.

K2 replaces pislamfusion_tpu/ops/features/patchgather.py
`gather_patches_pallas` (its `pallas_call` at :148), which the ORB
descriptor tail calls on the packed pyramid (orb.py:978-980).

Function: out[n, i, j(, c)] = img[clamp(y_n - r + i), clamp(x_n - r + j)(, c)]
— an exact copy with edge clamp, G = 2r + 1.

On the H100 the copy is bound by bytes: at the main path's shapes
(1000 centers, r = 21, C = 1) it moves 7.4 MB out and at most as much in.
The TPU kernel DMA'd (8, 128)-aligned slabs and cut each patch out with
two one-hot MXU matmuls, because a TPU gathers on its scalar core; a GPU
gathers natively, so the kernel (`csrc/patchgather.cu`) gives each patch
one block, which reads its centre once. It takes ORB's shape only (r =
21, C = 1: a compile-time instantiation; the wrapper raises on others,
which nothing in the port asks for): a warp reads a source row at a time
into shared memory, and the patch's 1849-word span goes out as 16-byte
stores between scalar head and tail words (`store_split`).

K6 replaces `bilinear_grid_pallas` (its `pallas_call` at :282), which
SIFT's orientation and descriptor stages call on the packed gradient
image (sift.py:264-273). Its function is the kernel's, not
image.bilinear_sample's: the image is zero-padded by R + 2, a sample
sits at centre + rel in f32, the two rows are interpolated first, then
the two columns (`(1-fy)*v[y0] + fy*v[y0+1]`, then
`(1-fx)*A[x0] + fx*A[x0+1]`), with the kernel's slab clips (which never
act for |rel| < R). The TPU kernel's one-hot `dot_general`s carry no
precision, so on a TPU they round to bf16; the port computes the f32
function the Pallas interpreter computes. On the H100 K6 is bound by
bytes: 1000 keypoints x 256 samples x 2 channels write 2 MB and read the
pixels the grids cover. The TPU kernel DMA'd an aligned slab per keypoint
and evaluated samples as one-hot MXU products because a TPU cannot
gather; the CUDA kernel (`csrc/bilineargrid.cu`) gives each keypoint
four warps (its geometry computed by one lane of each and broadcast) and
each thread 2 samples, their offsets read as float2 and each tap's two
channels as one float2, from L2 where grids overlap, rounding each
product and sum on its own so that it equals the plain version. It takes
SIFT's shapes only (C 2, M even); the wrapper raises on others.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from ... import _build


@functools.lru_cache(maxsize=1)
def _gather_fn():
    fn = _build.load("patchgather").patchgather_launch
    fn.restype = ctypes.c_int
    P, I = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [P, I, I, P, I, P, P]
    return fn


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


KERNEL_RADIUS = 21       # the kernel's patches: G = 43 (orb._GATHER_R)


def store_split(n: int, words: int):
    """How the kernel stores patch n of `words` floats at ORB's shape, the
    output being 16-byte aligned: (head, vectors, tail), scalar words
    before the first 16-byte boundary, 16-byte stores, scalar words
    after."""
    head = -(n * words) % 4
    vec = (words - head) // 4
    return head, vec, words - head - 4 * vec


def gather_patches(img, xy, radius: int):
    """img: [H, W] or [H, W, C] float32; xy: [N, 2] int32 patch centers.
    Returns [N, G, G(, C)] float32 equal to the edge-padded windows
    img[y-r:y+r+1, x-r:x+r+1]. CPU tensors take the plain version; CUDA
    tensors launch the kernel, which takes ORB's shape only (KERNEL_RADIUS,
    C = 1)."""
    if img.device.type == "cpu":
        return gather_patches_plain(img, xy, radius)
    if radius != KERNEL_RADIUS or img.ndim != 2:
        raise ValueError(f"gather_patches: the kernel takes radius "
                         f"{KERNEL_RADIUS} and one channel (ORB's patches), "
                         f"not radius {radius}, shape {tuple(img.shape)}")
    if img.device.type != "cuda":
        raise ValueError(f"gather_patches: unsupported device {img.device}")
    if img.dtype != torch.float32:
        raise ValueError("gather_patches: img must be float32 [H, W]")
    if xy.device != img.device or xy.ndim != 2 or xy.shape[1] != 2:
        raise ValueError("gather_patches: xy must be [N, 2] on img's device")
    img = img.contiguous()
    xy = xy.to(torch.int32).contiguous()
    H, W = img.shape
    N = xy.shape[0]
    G = 2 * radius + 1
    out = torch.empty((N, G, G), dtype=torch.float32, device=img.device)
    if N == 0:
        return out
    with torch.cuda.device(img.device):
        stream = torch.cuda.current_stream(img.device).cuda_stream
        err = _gather_fn()(img.data_ptr(), H, W, xy.data_ptr(), N,
                           out.data_ptr(), stream)
    _build.check(err, "patchgather")
    gather_patches.launches += 1
    return out


gather_patches.launches = 0


# ---------------------------------------------------------------------------
# K6: bilinear samples at scattered sub-pixel offsets from integer centres
# ---------------------------------------------------------------------------

def _ceil_to(x: int, m: int) -> int:
    return -(-x // m) * m


def _slab_dims(C: int, R: int):
    """The TPU kernel's slab (patchgather.py:184-186): height WH, lane
    alignment XA in pixels, width WWpx in pixels."""
    XA = 128 // C
    return _ceil_to(2 * R + 2 + 8, 8), XA, _ceil_to(XA + 2 * R + 2, XA)


def _grid_geometry(centers, C: int, R: int):
    """The slab dims, and per centre the slab origin (ya, xa) in the image
    padded by R + 2 and the centre's offset (dy0, dx0) inside its slab
    (patchgather.py:204-209). Samples are interpolated at rel + (dy0, dx0)
    of the slab, so the arithmetic (and its rounding) is the kernel's."""
    WH, XA, WWpx = _slab_dims(C, R)
    cy = centers[:, 1].to(torch.int64) + (R + 2)
    cx = centers[:, 0].to(torch.int64) + (R + 2)
    ya = torch.div(cy - R, 8, rounding_mode="floor") * 8
    xa = torch.div(cx - R, XA, rounding_mode="floor") * XA
    return WH, XA, WWpx, ya, xa, cy - ya, cx - xa


def bilinear_grid_plain(img, centers, rel, radius: int = 16):
    """Plain PyTorch version: the four taps of each sample read with zero
    fill, rows interpolated first, then columns."""
    H, W, C = img.shape
    R = radius
    WH, _, WWpx, ya, xa, dy0, dx0 = _grid_geometry(centers, C, R)
    ry = rel[:, 1] + dy0.to(torch.float32)[:, None]
    rx = rel[:, 0] + dx0.to(torch.float32)[:, None]
    y0 = torch.floor(ry).clamp(0, WH - 2)
    fy = (ry - y0).clamp(0.0, 1.0)[..., None]
    x0 = torch.floor(rx).clamp(0, WWpx - 2)
    fx = (rx - x0).clamp(0.0, 1.0)[..., None]
    iy = ya[:, None] + y0.to(torch.int64) - (R + 2)            # image rows
    ix = xa[:, None] + x0.to(torch.int64) - (R + 2)

    def tap(yy, xx):
        inside = (yy >= 0) & (yy < H) & (xx >= 0) & (xx < W)
        v = img[yy.clamp(0, H - 1), xx.clamp(0, W - 1)]
        return torch.where(inside[..., None], v, torch.zeros_like(v))
    a0 = (1.0 - fy) * tap(iy, ix) + fy * tap(iy + 1, ix)
    a1 = (1.0 - fy) * tap(iy, ix + 1) + fy * tap(iy + 1, ix + 1)
    return (1.0 - fx) * a0 + fx * a1


def _aligned(t, nbytes: int):
    """t, or a fresh copy of it where its data does not start on an
    `nbytes` boundary (the kernel's vector loads need it)."""
    return t if t.data_ptr() % nbytes == 0 else t.clone()


def bilinear_grid(img, centers, rel, radius: int = 16):
    """img: [H, W, C] float32; centers: [K, 2] int32 (x, y) image points;
    rel: [K, 2, M] float32 sample offsets (dx, dy rows) from the centre,
    |offset| < radius. Returns [K, M, C] float32 bilinear samples with zero
    fill outside the image. CPU tensors take the plain version; CUDA
    tensors launch the kernel."""
    if img.device.type == "cpu":
        return bilinear_grid_plain(img, centers, rel, radius)
    if img.device.type != "cuda":
        raise ValueError(f"bilinear_grid: unsupported device {img.device}")
    if img.dtype != torch.float32 or img.ndim != 3:
        raise ValueError("bilinear_grid: img must be float32 [H, W, C]")
    if (centers.device != img.device or rel.device != img.device
            or centers.ndim != 2 or centers.shape[1] != 2 or rel.ndim != 3
            or rel.shape[:2] != (centers.shape[0], 2)
            or rel.dtype != torch.float32):
        raise ValueError("bilinear_grid: centers must be [K, 2] and rel "
                         "float32 [K, 2, M] on img's device")
    H, W, C = img.shape
    K, _, M = rel.shape
    if C != 2 or M % 2:
        raise ValueError(f"bilinear_grid: the kernel takes C == 2 and M "
                         f"even (SIFT's grids), not C {C}, M {M}")
    img = _aligned(img.contiguous(), 8)
    centers = _aligned(centers.to(torch.int32).contiguous(), 8)
    rel = _aligned(rel.contiguous(), 8)
    WH, _, WWpx = _slab_dims(C, radius)
    out = torch.empty((K, M, C), dtype=torch.float32, device=img.device)
    if K == 0 or M == 0:
        return out
    lib = _build.load("bilineargrid")
    fn = lib.bilineargrid_launch
    fn.restype = ctypes.c_int
    V, I = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [V, I, I, V, V, I, I, I, I, I, V, V]
    with torch.cuda.device(img.device):
        stream = torch.cuda.current_stream(img.device).cuda_stream
        err = fn(img.data_ptr(), H, W, centers.data_ptr(), rel.data_ptr(),
                 K, M, radius, WH, WWpx, out.data_ptr(), stream)
    _build.check(err, "bilineargrid")
    bilinear_grid.launches += 1
    return out


bilinear_grid.launches = 0
