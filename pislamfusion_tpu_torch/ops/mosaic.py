"""Orthomosaic feed: canvas->image homography, analytic radial weights,
shear warp + Laplacian pyramid of a frame, max-weight composite into the
canvas pyramid.

Port of the parts of pislamfusion_tpu/ops/mosaic.py on FastVO's path
(:41, :103-116, :134-201, the warp="shear" half-res branch of
`patch_pyramids` :226-282, `composite_patch` :313-337, `reconstruct_canvas`
and `alloc_canvas` :502-516) — MultiBandMap2DCPU::renderFrame
(MultiBandMap2DCPU.cpp:311-558). The gather-warp branches are not ported.

The canvas is a list of per-band tensors that `composite_patch` updates
IN PLACE (the reference returned new arrays). Patch origins may be
device tensors: the composite indexes with them, so a frame's feed never
waits on the host.
"""
from __future__ import annotations

from typing import List

import numpy as np
import torch

from ..core.device import device_const, resolve_device
from . import image as im
from . import lie
from . import shearwarp

ELE_PIXELS = 256  # canvas tile size, reference Map2D.h:35


def _diag(a: float, b: float, dtype, device):
    """diag(a, b, 1) as a constant of `device`."""
    return device_const(("diag", a, b, dtype), device, lambda: torch.diag(
        torch.tensor([a, b, 1.0], dtype=dtype)))


def homography_canvas_to_image(pose_c2w, fx, fy, cx, cy, origin_xy,
                               length_pixel):
    """3x3 H mapping canvas pixel (u, v) -> source image pixel: canvas px
    -> plane point origin + (u, v) * length_pixel -> pinhole projection
    of R^T (p - t)."""
    t = pose_c2w[:3]
    Rt = lie.quat_to_matrix(pose_c2w[3:7]).T
    dev, dt = pose_c2w.device, pose_c2w.dtype
    K = device_const(("K", fx, fy, cx, cy, dt), dev, lambda: torch.tensor(
        [[fx, 0.0, cx], [0.0, fy, cy], [0.0, 0.0, 1.0]], dtype=dt))
    Hpi = K @ torch.stack([Rt[:, 0], Rt[:, 1], -Rt @ t], 1)
    A = _diag(length_pixel, length_pixel, dt, dev)
    A = torch.cat([A[:, :2], torch.cat([origin_xy.to(dt),
                                        A.new_ones(1)])[:, None]], 1)
    return Hpi @ A


def radial_weight(src_xy, width: int, height: int, valid,
                  weight_type: int = 0):
    """1 - r/r_max at the source pixel, clamped to 1e-5, squared when
    weight_type != 0 (renderFrame:396-425); zero outside the image."""
    cx, cy = width / 2.0, height / 2.0
    dmax = float(np.sqrt(np.float32(cx * cx + cy * cy)))
    d = torch.hypot(src_xy[..., 0] - cx, src_xy[..., 1] - cy)
    w = 1.0 - d / dmax
    if weight_type != 0:
        w = w * w
    w = torch.clamp(w, min=1e-5)
    return torch.where(valid, w, torch.zeros_like(w))


def analytic_weight_pyramid(h_patch2img, img_hw, patch_hw, bands: int,
                            weight_type: int = 0, live=None):
    """Radial-weight pyramid evaluated per level (homography scaled by
    2^i). live: optional [nty, ntx] tile liveness — dead tiles weigh 0."""
    H, W = img_hw
    ph, pw = patch_hw
    pyr = []
    scale = _diag(2.0, 2.0, h_patch2img.dtype, h_patch2img.device)
    h = h_patch2img
    for i in range(bands + 1):
        hw_i = (max(1, ph >> i), max(1, pw >> i))
        grid = im.homography_grid(h, hw_i)
        valid = ((grid[..., 0] >= 0) & (grid[..., 0] <= W - 1)
                 & (grid[..., 1] >= 0) & (grid[..., 1] <= H - 1))
        w = radial_weight(grid, W, H, valid, weight_type)
        if live is not None and hw_i[0] >= live.shape[0] \
                and hw_i[0] % live.shape[0] == 0:
            nty, ntx = live.shape
            ty, tx = hw_i[0] // nty, hw_i[1] // ntx
            lv = live[:, None, :, None].to(w.dtype).expand(
                nty, ty, ntx, tx).reshape(hw_i)
            w = w * lv
        pyr.append(w[..., None])
        h = h @ scale
    return pyr


def patch_pyramids(img, h_patch2img, patch_hw, bands: int,
                   weight_type: int = 0):
    """(patch Laplacian pyramid [bands+1], weight pyramid [bands+1]) of one
    frame through the shear warp at half resolution (the reference's
    warp="shear", half_res=True branch): the pyrDown'd source is warped
    into a half-size patch (K3), band 0's Laplacian is exactly zero, and
    band 0's weight is the pyrUp of the analytic half-res weight."""
    if (patch_hw[0] // 2) % shearwarp.TILE or \
            (patch_hw[1] // 2) % shearwarp.TILE:
        raise ValueError(f"patch {patch_hw}: the half-res shear warp needs "
                         f"halves that are multiples of {shearwarp.TILE}")
    rgb = img if img.ndim == 3 else img[..., None]
    dt, dev = h_patch2img.dtype, h_patch2img.device
    src_half = im.pyr_down(rgb.to(torch.float32))
    sh = _diag(0.5, 0.5, dt, dev)
    s2 = _diag(2.0, 2.0, dt, dev)
    h_hs = sh @ h_patch2img @ s2          # half-patch px -> half-src px
    half_hw = (patch_hw[0] // 2, patch_hw[1] // 2)
    warped, live, _fit = shearwarp.warp_patch(src_half, h_hs, half_hw)
    sub = im.build_laplacian_pyramid(warped, bands - 1) \
        if bands > 1 else [warped]
    p_lap = [torch.zeros(patch_hw + (rgb.shape[-1],), dtype=torch.float32,
                         device=dev)] + sub
    w_half = analytic_weight_pyramid(h_patch2img @ s2,
                                     (img.shape[0], img.shape[1]), half_hw,
                                     0, weight_type, live)[0]
    p_w = [im.pyr_up(w_half, patch_hw)]
    for _ in range(bands):
        p_w.append(im.pyr_down(p_w[-1]))
    return p_lap, p_w


def composite_patch(canvas_lap: List[torch.Tensor],
                    canvas_w: List[torch.Tensor],
                    patch_lap: List[torch.Tensor],
                    patch_w: List[torch.Tensor], origin_yx):
    """Max-weight composite of a patch pyramid into the canvas pyramid, in
    place. origin_yx: [2] int tensor, the patch origin in band-0 canvas
    pixels (tile aligned, so origin >> i is exact for every band).
    Matches `if (srcW >= dstW) {dstL = srcL; dstW = srcW;}` per band
    (MultiBandMap2DCPU.cpp:496-553)."""
    oyx = origin_yx.to(torch.int64)
    for i in range(len(canvas_lap)):
        ph, pw = patch_lap[i].shape[0], patch_lap[i].shape[1]
        iy = (oyx[0] >> i) + torch.arange(ph, device=oyx.device)
        ix = (oyx[1] >> i) + torch.arange(pw, device=oyx.device)
        sel = (iy[:, None], ix[None, :])
        cur_l = canvas_lap[i][sel]
        cur_w = canvas_w[i][sel]
        take = patch_w[i] >= cur_w
        canvas_lap[i][sel] = torch.where(take, patch_lap[i], cur_l)
        canvas_w[i][sel] = torch.where(take, patch_w[i], cur_w)
    return canvas_lap, canvas_w


def reconstruct_canvas(canvas_lap, canvas_w, bg: float = 255.0):
    """Blend result: restore from the Laplacian pyramid, `bg` where nothing
    was composited (MultiBandMap2DCPU::save:779-847). Returns (image
    [H, W, 3], covered [H, W] bool)."""
    img = im.restore_from_laplacian(canvas_lap)
    covered = canvas_w[0] > 0
    out = torch.where(covered, img, torch.full_like(img, bg))
    return torch.clamp(out, 0, 255), covered[..., 0]


def alloc_canvas(h_tiles: int, w_tiles: int, bands: int, device=None,
                 dtype=torch.float32):
    """Fresh canvas pyramid: band i is [H >> i, W >> i] with
    H = 256 * h_tiles, on `device` (None means `cuda`, see
    `resolve_device`)."""
    device = resolve_device(device)
    H, W = h_tiles * ELE_PIXELS, w_tiles * ELE_PIXELS
    lap = [torch.zeros((H >> i, W >> i, 3), dtype=dtype, device=device)
           for i in range(bands + 1)]
    w = [torch.zeros((H >> i, W >> i, 1), dtype=dtype, device=device)
         for i in range(bands + 1)]
    return lap, w
