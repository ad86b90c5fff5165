"""Image ops on [..., H, W, C] float32 tensors: OpenCV-compatible
pyrDown/pyrUp, Laplacian pyramids, bilinear resize, homography grids.

Port of pislamfusion_tpu/ops/image.py (:86-94, :304, :352-498, :548-567,
:603). The reference has two formulations of each stencil: banded MXU
matmuls (on the TPU) and f32 shift-and-add slices (on every other
backend). The port follows the f32 shift-and-add semantics and the exact
`[::2, ::2]` of `decimate2`; the banded-MXU and bf16-chain branches were
TPU layout devices and are not carried over. The numpy matrix builders
are the port's own copies (`_blur_matrix` feeds K5's tables).
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from ..core.device import device_const

# OpenCV's 5-tap pyramid kernel [1,4,6,4,1]/16
_PYR_K = np.array([1.0, 4.0, 6.0, 4.0, 1.0], np.float32) / 16.0


def _reflect_idx(q: int, n: int, mode: str) -> int:
    """Map an out-of-range index into [0, n) per the pad mode (np.pad
    'reflect' = edge not repeated; 'edge' = clamp)."""
    if mode == "edge" or n == 1:
        return min(max(q, 0), n - 1)
    while q < 0 or q >= n:
        if q < 0:
            q = -q
        if q >= n:
            q = 2 * (n - 1) - q
    return q


def _pad_axis(x, axis: int, before: int, after: int, mode: str):
    """np.pad along one axis ('reflect' or 'edge') as one index_select."""
    n = x.shape[axis]
    idx = device_const(
        ("pad", n, before, after, mode), x.device,
        lambda: torch.tensor([_reflect_idx(q, n, mode)
                              for q in range(-before, n + after)]))
    return x.index_select(axis, idx)


def gaussian_kernel1d(sigma: float, radius: int | None = None) -> np.ndarray:
    if radius is None:
        radius = max(1, int(np.ceil(3.0 * sigma)))
    x = np.arange(-radius, radius + 1, dtype=np.float32)
    k = np.exp(-(x * x) / (2.0 * sigma * sigma))
    return k / k.sum()


def _sep_conv(img, k, border: str = "reflect"):
    """Separable 2D convolution along (-3, -2) with a 1D kernel `k`, as
    shift-and-add over one padded buffer per axis (f32)."""
    kv = [float(v) for v in np.asarray(k)]
    r = (len(kv) - 1) // 2
    mode = "reflect" if border == "reflect" else "edge"
    x = img
    for ax in (img.ndim - 3, img.ndim - 2):
        n = x.shape[ax]
        xp = _pad_axis(x, ax, r, r, mode)
        acc = None
        for i, w in enumerate(kv):
            t = xp.narrow(ax, i, n) * w
            acc = t if acc is None else acc + t
        x = acc
    return x


def gaussian_blur(img, sigma: float, radius: int | None = None):
    return _sep_conv(img, gaussian_kernel1d(sigma, radius))


@functools.lru_cache(maxsize=None)
def _blur_matrix(n: int, taps: tuple, mode: str) -> np.ndarray:
    """[n, n] float32 banded matrix: row j = the kernel centred at j, the
    border taps folded in by `mode` (summed in float32, tap order)."""
    r = (len(taps) - 1) // 2
    m = np.zeros((n, n), np.float32)
    for j in range(n):
        for i, w in enumerate(taps):
            m[j, _reflect_idx(j + i - r, n, mode)] += w
    return m


def decimate2(img):
    """2x nearest decimation, `img[::2, ::2]`, of [H, W] or [H, W, C] (a
    strided view)."""
    return img[::2, ::2]


def pyr_down(img):
    """cv::pyrDown: 5-tap blur then decimate by 2 (ceil sizes); only the
    even rows/cols are ever computed."""
    kv = [float(v) for v in _PYR_K]
    r = 2
    x = img
    for ax in (img.ndim - 3, img.ndim - 2):
        n = x.shape[ax]
        on = (n + 1) // 2
        xp = _pad_axis(x, ax, r, r + 1, "reflect")
        acc = None
        for i, w in enumerate(kv):
            sl = [slice(None)] * x.ndim
            sl[ax] = slice(i, i + 2 * on - 1, 2)
            t = xp[tuple(sl)] * w
            acc = t if acc is None else acc + t
        x = acc
    return x


def pyr_up(img, out_hw=None):
    """cv::pyrUp: zero-upsample by 2 then 5-tap blur with 4x gain."""
    lead = img.shape[:-3]
    H, W, C = img.shape[-3:]
    oh, ow = out_hw if out_hw is not None else (2 * H, 2 * W)
    x = img.reshape((-1, H, W, C))
    x = torch.stack([x, torch.zeros_like(x)], 2).reshape(-1, 2 * H, W, C)
    x = torch.stack([x, torch.zeros_like(x)], 3).reshape(-1, 2 * H, 2 * W,
                                                         C)
    up = _sep_conv(x, _PYR_K * 2.0)
    return up.reshape(lead + (2 * H, 2 * W, C))[..., :oh, :ow, :]


def build_gaussian_pyramid(img, levels: int):
    pyr = [img]
    for _ in range(levels - 1):
        pyr.append(pyr_down(pyr[-1]))
    return pyr


def build_laplacian_pyramid(img, bands: int):
    """cv::detail::createLaplacePyr semantics: `bands` difference levels
    plus the residual low-pass — a list of length bands+1."""
    pyr = build_gaussian_pyramid(img, bands + 1)
    lap = []
    for i in range(bands):
        hw = tuple(pyr[i].shape[-3:-1])
        lap.append(pyr[i] - pyr_up(pyr[i + 1], hw))
    lap.append(pyr[bands])
    return lap


def restore_from_laplacian(lap):
    """cv::detail::restoreImageFromLaplacePyr inverse."""
    img = lap[-1]
    for lvl in reversed(lap[:-1]):
        img = lvl + pyr_up(img, tuple(lvl.shape[-3:-1]))
    return img


@functools.lru_cache(maxsize=None)
def _resize_matrix(n: int, on: int) -> np.ndarray:
    """[on, n] bilinear interpolation matrix (align_corners=False: src =
    (j+0.5)*n/on - 0.5, edge-clamped). Two nonzeros per row."""
    m = np.zeros((on, n), np.float32)
    for j in range(on):
        s = (j + 0.5) * n / on - 0.5
        i0 = int(np.floor(s))
        f = s - i0
        m[j, min(max(i0, 0), n - 1)] += 1.0 - f
        m[j, min(max(i0 + 1, 0), n - 1)] += f
    return m


def resize_bilinear(img, out_hw):
    """Bilinear resize (align_corners=False, cv::resize INTER_LINEAR with
    no antialias widening) of [..., H, W, C] as two f32 matrix products."""
    H, W = img.shape[-3], img.shape[-2]
    oh, ow = out_hw
    mh = device_const(("resize", H, oh), img.device,
                      lambda: torch.from_numpy(_resize_matrix(H, oh)))
    mw = device_const(("resize", W, ow), img.device,
                      lambda: torch.from_numpy(_resize_matrix(W, ow)))
    y = torch.einsum("rh,...hwc->...rwc", mh, img)
    return torch.einsum("sw,...rwc->...rsc", mw, y)


def homography_grid(h_mat, out_hw, offset=(0.0, 0.0)):
    """Source-coordinate grid [Ho, Wo, 2] for a dst->src homography: h_mat
    maps destination pixel (x+ox, y+oy, 1) to source homogeneous coords."""
    oh, ow = out_hw
    dev = h_mat.device
    ys = (torch.arange(oh, dtype=torch.float32, device=dev)
          + offset[1])[:, None]
    xs = (torch.arange(ow, dtype=torch.float32, device=dev)
          + offset[0])[None, :]
    h = h_mat
    qx = h[0, 0] * xs + h[0, 1] * ys + h[0, 2]
    qy = h[1, 0] * xs + h[1, 1] * ys + h[1, 2]
    qz = h[2, 0] * xs + h[2, 1] * ys + h[2, 2]
    qz = torch.where(qz.abs() < 1e-12, torch.full_like(qz, 1e-12), qz)
    return torch.stack([qx / qz, qy / qz], -1)


def rgb_to_gray(img):
    """BT.601 luma of (R, G, B) channels."""
    w = device_const(("luma", img.dtype), img.device,
                     lambda: torch.tensor([0.299, 0.587, 0.114],
                                          dtype=img.dtype))
    return torch.einsum("...c,c->...", img[..., :3], w)
