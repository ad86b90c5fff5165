"""Image ops on [..., H, W, C] float32 tensors: OpenCV-compatible
pyrDown/pyrUp, Laplacian pyramids, bilinear resize, bilinear sampling and
homography warps.

Port of pislamfusion_tpu/ops/image.py (:86-126, :304, :352-581, :603,
:616-624).
The reference has two formulations of each separable stencil: banded
matrix products (`_matmul_sep`, on the TPU, whose fused form is the
banded-sandwich kernel) and f32 shift-and-add slices (on every other
backend).

- `pyr_down` and `pyr_up` take the banded-matrix form on the reference's
  own matrices (`_dec_matrix`, `_up_matrix`) through K8
  (`stencil.banded_sandwich`: the CUDA kernel on the card, its plain
  span-by-span version on the CPU), and with them the Laplacian pyramid
  build and restore.
- `gaussian_blur` keeps the f32 shift-and-add; `decimate2` the exact
  `[::2, ::2]`; `resize_bilinear` two f32 products with the reference's
  interpolation matrices. SIFT's parity rests on these, and K5 serves its
  octave stacks.
- `bilinear_sample` and `warp_perspective` are the reference's gather
  warps, in plain PyTorch (the reference has no kernel for them).

The numpy matrix builders are the port's own copies (`_blur_matrix` feeds
K5's tables, `_dec_matrix` and `_up_matrix` K8's).
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from ..core.device import device_const
from . import stencil

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


def _dec_matrix(n: int, taps: tuple, mode: str) -> np.ndarray:
    """[ceil(n/2), n] banded matrix: row j = kernel centered at 2j, the
    fused blur+decimate of cv::pyrDown (reference image.py:97-109)."""
    r = (len(taps) - 1) // 2
    on = (n + 1) // 2
    m = np.zeros((on, n), np.float32)
    for j in range(on):
        for i, w in enumerate(taps):
            m[j, _reflect_idx(2 * j + i - r, n, mode)] += w
    return m


def _up_matrix(n: int, oh: int, taps: tuple) -> np.ndarray:
    """[oh, n] banded matrix reproducing cv::pyrUp's zero-stuff + 2x-gain
    blur: row p sums 2*k[i] over stuffed indices q = p+i-r with q even,
    reflect-folded on the 2n buffer (reference image.py:112-126)."""
    r = (len(taps) - 1) // 2
    m = np.zeros((oh, n), np.float32)
    for p in range(oh):
        for i, w in enumerate(taps):
            q = _reflect_idx(p + i - r, 2 * n, "reflect")
            if q % 2 == 0:
                m[p, q // 2] += 2.0 * w
    return m


@functools.lru_cache(maxsize=None)
def pyr_tables(kind: str, h: int, w: int, oh: int, ow: int):
    """K8's tables of pyrDown ("down", [h, w] -> [ceil(h/2), ceil(w/2)])
    or pyrUp ("up", [h, w] -> [oh, ow]) on the reference's matrices."""
    taps = tuple(float(v) for v in _PYR_K)
    if kind == "down":
        mh = _dec_matrix(h, taps, "reflect")
        mw = _dec_matrix(w, taps, "reflect")
    else:
        mh, mw = _up_matrix(h, oh, taps), _up_matrix(w, ow, taps)
    return stencil.sandwich_tables(("pyr", kind, h, w, oh, ow), mh, mw)


def pyr_down(img):
    """cv::pyrDown: 5-tap blur then decimate by 2 (ceil sizes), as the
    banded sandwich of `_dec_matrix` on both axes (K8)."""
    H, W = img.shape[-3], img.shape[-2]
    return stencil.banded_sandwich(
        img, pyr_tables("down", H, W, (H + 1) // 2, (W + 1) // 2))


def pyr_up(img, out_hw=None):
    """cv::pyrUp: zero-upsample by 2 then 5-tap blur with 4x gain, as the
    banded sandwich of `_up_matrix` on both axes (K8)."""
    H, W = img.shape[-3], img.shape[-2]
    oh, ow = out_hw if out_hw is not None else (2 * H, 2 * W)
    return stencil.banded_sandwich(img, pyr_tables("up", H, W, oh, ow))


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


def _reflect101(x, n):
    """BORDER_REFLECT_101 fold of float coordinates into [0, n-1]."""
    period = 2.0 * (n - 1.0)
    xm = torch.remainder(x.abs(), period)
    return torch.minimum(xm, period - xm)


def bilinear_sample(img, xy, fill: float = 0.0, border: str = "constant"):
    """Sample img [H, W, C] at subpixel xy [..., 2] (reference
    image.py:507-546). border: "constant" (outside -> fill), "replicate"
    (clamp) or "reflect" (BORDER_REFLECT_101, the reference mosaic warp's,
    MultiBandMap2DCPU.cpp:451). Returns (values [..., C], valid [...]):
    valid marks in-image samples whatever the border mode."""
    H, W, C = img.shape
    x, y = xy[..., 0], xy[..., 1]
    if border == "reflect":
        x = _reflect101(x, W)
        y = _reflect101(y, H)
    valid = ((xy[..., 0] >= 0) & (xy[..., 0] <= W - 1)
             & (xy[..., 1] >= 0) & (xy[..., 1] <= H - 1))
    # one flat index per tap; (x0, y0) clamped to (W-2, H-2) keeps every
    # +1/+W neighbour in range, and fx/fy clamp so edge taps interpolate
    x0i = torch.clamp(torch.floor(x).to(torch.int64), 0, W - 2)
    y0i = torch.clamp(torch.floor(y).to(torch.int64), 0, H - 2)
    fx = torch.clamp(x[..., None] - x0i[..., None].to(x.dtype), 0.0, 1.0)
    fy = torch.clamp(y[..., None] - y0i[..., None].to(y.dtype), 0.0, 1.0)
    flat = img.reshape(H * W, C)
    base = (y0i * W + x0i).reshape(-1)
    shp = tuple(xy.shape[:-1]) + (C,)
    v00 = flat.index_select(0, base).reshape(shp)
    v01 = flat.index_select(0, base + 1).reshape(shp)
    v10 = flat.index_select(0, base + W).reshape(shp)
    v11 = flat.index_select(0, base + W + 1).reshape(shp)
    v = (v00 * (1 - fx) * (1 - fy) + v01 * fx * (1 - fy)
         + v10 * (1 - fx) * fy + v11 * fx * fy)
    if border == "constant":
        v = torch.where(valid[..., None], v, torch.full_like(v, fill))
    return v, valid


def warp_perspective(img, h_dst2src, out_hw, offset=(0.0, 0.0),
                     fill: float = 0.0, border: str = "constant"):
    """Warp img [H, W, C] into an [Ho, Wo, C] image (reference
    image.py:569-581): `h_dst2src` maps destination pixels (shifted by
    `offset`) to source pixels. Returns (warped, valid)."""
    grid = homography_grid(h_dst2src, out_hw, offset)
    return bilinear_sample(img, grid, fill, border)


def rgb_to_gray(img):
    """BT.601 luma of (R, G, B) channels."""
    w = device_const(("luma", img.dtype), img.device,
                     lambda: torch.tensor([0.299, 0.587, 0.114],
                                          dtype=img.dtype))
    return torch.einsum("...c,c->...", img[..., :3], w)


def remap(img, map_xy):
    """Dense remap (cv::remap / Undistorter::undistortFast; reference
    image.py:616-624): out[y, x] = bilinear(img, map_xy[y, x]) with border
    replication. img: [H, W] or [H, W, C] float; map_xy: [Ho, Wo, 2]
    source coords."""
    squeeze = img.ndim == 2
    if squeeze:
        img = img[..., None]
    out = bilinear_sample(img, map_xy, 0.0, "replicate")[0]
    return out[..., 0] if squeeze else out
