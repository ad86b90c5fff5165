"""Orthomosaic ops: plane-projection geometry, radial weights, the warp
of a frame into a canvas patch, its Laplacian and weight pyramids, the
max-weight composite into the canvas pyramid, seam masks, canvas growth
and reconstruction.

Port of pislamfusion_tpu/ops/mosaic.py:41-531 (MultiBandMap2DCPU::
renderFrame, MultiBandMap2DCPU.cpp:311-558; UtilGPU.cu:311-461).

- `patch_pyramids` has the reference's four branches: warp="shear" (K3,
  `shearwarp.warp_patch`) at full or half resolution, and warp="gather"
  (`image.bilinear_sample`) at full or half resolution, plus the seam
  pass's `w0_mask`. Every pyrDown and pyrUp of the pyramids goes through
  K8 (`image.pyr_down` / `pyr_up`).
- The canvas is a list of per-band tensors that `composite_patch` updates
  IN PLACE (the reference returned new arrays). A patch origin is either
  a device tensor (FastVO: the composite indexes with it, so a frame's
  feed never waits on the host) or a pair of Python ints (the Map2D
  engines, whose origins are host geometry: plain slices).
- `composite_frames_batch(_seamed)` are Python loops over the batch (the
  reference's `lax.scan`); padding slots with `weights_on` 0 are
  composited with zero weight, as there.
- `mark(stage)`, where a function takes it, is called as each stage is
  enqueued ("warp", "pyramids", "composite"), for stage timing.
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


# ---------------------------------------------------------------------------
# host-side geometry (numpy float64, tiny per-frame work)
# ---------------------------------------------------------------------------

def plane_corners_np(pose_c2w: np.ndarray, cam, corners_px=None):
    """Project image corners through a pose onto the plane z=0. Returns
    (pts [4, 2] plane xy, ok); ok False when the down-look check fails
    (renderFrame:330-340)."""
    t = np.asarray(pose_c2w[:3], np.float64)
    q = np.asarray(pose_c2w[3:7], np.float64)
    if corners_px is None:
        corners_px = np.array([[0, 0], [cam.width, 0],
                               [0, cam.height], [cam.width, cam.height]],
                              np.float64)
    rays = np.stack([(corners_px[:, 0] - cam.cx) / cam.fx,
                     (corners_px[:, 1] - cam.cy) / cam.fy,
                     np.ones(len(corners_px))], -1)
    v, w = q[:3], q[3]
    tt = 2.0 * np.cross(v, rays)
    axis = rays + w * tt + np.cross(v, tt)
    down = -1.0 if t[2] >= 0 else 1.0
    if np.any(axis[:, 2] * down < 0.4):
        return None, False
    pts = t[None, :] - axis * (t[2] / axis[:, 2])[:, None]
    return pts[:, :2], True


def homography_canvas_to_image_np(pose_c2w: np.ndarray, cam, origin_xy,
                                  length_pixel: float) -> np.ndarray:
    """3x3 H (float64) mapping canvas pixel (u, v) -> source image pixel:
    canvas px -> plane point origin + (u, v) * length_pixel -> pinhole
    projection of R^T (p - t) (renderFrame:437-439, in closed form)."""
    t = np.asarray(pose_c2w[:3], np.float64)
    x, y, z, w = np.asarray(pose_c2w[3:7], np.float64)
    R = np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])
    Rt = R.T
    K = np.array([[cam.fx, 0, cam.cx], [0, cam.fy, cam.cy], [0, 0, 1.0]])
    Hpi = K @ np.stack([Rt[:, 0], Rt[:, 1], -Rt @ t], axis=1)
    A = np.array([[length_pixel, 0, origin_xy[0]],
                  [0, length_pixel, origin_xy[1]],
                  [0, 0, 1.0]])
    return Hpi @ A


def auto_resolution(cam, max_height: float, scale: float):
    """(ground length per canvas pixel, footprint radius) of a camera at
    `max_height` (Data::prepare:222-237)."""
    corner0 = np.array([(0 - cam.cx) / cam.fx, (0 - cam.cy) / cam.fy])
    corner1 = np.array([(cam.width - cam.cx) / cam.fx,
                        (cam.height - cam.cy) / cam.fy])
    line = corner1 - corner0
    radius = 0.5 * max_height * np.hypot(line[0], line[1])
    diag_px = np.hypot(cam.width, cam.height)
    return (2.0 * radius / diag_px) / scale, radius


# ---------------------------------------------------------------------------
# device ops
# ---------------------------------------------------------------------------

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


def _in_image(grid, H: int, W: int):
    """Samples inside an H x W image."""
    return ((grid[..., 0] >= 0) & (grid[..., 0] <= W - 1)
            & (grid[..., 1] >= 0) & (grid[..., 1] <= H - 1))


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
        w = radial_weight(grid, W, H, _in_image(grid, H, W), weight_type)
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


def _mark(mark, stage: str):
    if mark is not None:
        mark(stage)


def default_warp_mode(device) -> str:
    """'shear' (K3) on a CUDA device, 'gather' elsewhere: the reference's
    rule (shearwarp.py:520-525, the shear kernel on its accelerator)."""
    return "shear" if torch.device(device).type == "cuda" else "gather"


def warp_frame_to_patch(img, h_patch2img, patch_hw, weight_type: int = 0):
    """Gather-warp a frame [H, W, 3] into a canvas patch (reflect border)
    and evaluate its analytic weight. Returns (warped [Ph, Pw, 3], weight
    [Ph, Pw, 1])."""
    grid = im.homography_grid(h_patch2img, patch_hw)
    warped, valid = im.bilinear_sample(img, grid, border="reflect")
    w = radial_weight(grid, img.shape[1], img.shape[0], valid, weight_type)
    return warped, w[..., None]


def patch_pyramids(img, h_patch2img, patch_hw, bands: int,
                   weight_type: int = 0, half_res: bool = False,
                   warp: str = "gather", w0_mask=None, mark=None):
    """(patch Laplacian pyramid [bands+1], weight pyramid [bands+1]) of one
    frame, the mosaic feed's per-frame work (reference mosaic.py:150-310).

    warp="shear": the content through the shear warp (K3). With half_res
    (and patch halves that are multiples of its 128-px tile) the pyrDown'd
    source is warped into a half-size patch, band 0's Laplacian is exactly
    zero and band 0's weight is the pyrUp of the analytic half-res weight;
    otherwise the full-res patch is warped. Weights are analytic at band 0
    (zero on dead tiles), coarser bands pyrDown'd.
    warp="gather": projective bilinear sampling (reflect border) at full
    resolution, or with half_res at half resolution with band 0's
    Laplacian zero; band 0's weight is exact full-res analytic.
    w0_mask, when given, multiplies band 0's weight (the seam pass's
    ownership masks)."""
    H, W = img.shape[0], img.shape[1]
    dt, dev = h_patch2img.dtype, h_patch2img.device
    s2 = _diag(2.0, 2.0, dt, dev)
    if warp == "shear":
        rgb = (img if img.ndim == 3 else img[..., None]).to(torch.float32)
        half_ok = half_res and (patch_hw[0] // 2) % shearwarp.TILE == 0 \
            and (patch_hw[1] // 2) % shearwarp.TILE == 0
        half_hw = (patch_hw[0] // 2, patch_hw[1] // 2)
        if half_ok:
            src_half = im.pyr_down(rgb)
            h_hs = _diag(0.5, 0.5, dt, dev) @ h_patch2img @ s2
            warped, live, _fit = shearwarp.warp_patch(src_half, h_hs,
                                                      half_hw)
            _mark(mark, "warp")
            sub = im.build_laplacian_pyramid(warped, bands - 1) \
                if bands > 1 else [warped]
            p_lap = [torch.zeros(patch_hw + (rgb.shape[-1],),
                                 dtype=torch.float32, device=dev)] + sub
        else:
            warped, live, _fit = shearwarp.warp_patch(rgb, h_patch2img,
                                                      patch_hw)
            _mark(mark, "warp")
            p_lap = im.build_laplacian_pyramid(warped, bands)
        if half_ok and w0_mask is None:
            w_half = analytic_weight_pyramid(h_patch2img @ s2, (H, W),
                                             half_hw, 0, weight_type,
                                             live)[0]
            p_w = [im.pyr_up(w_half, patch_hw)]
        else:
            p_w = analytic_weight_pyramid(h_patch2img, (H, W), patch_hw, 0,
                                          weight_type, live)
            if w0_mask is not None:
                p_w[0] = p_w[0] * w0_mask
    elif not half_res:
        warped, w = warp_frame_to_patch(img, h_patch2img, patch_hw,
                                        weight_type)
        _mark(mark, "warp")
        p_lap = im.build_laplacian_pyramid(warped, bands)
        p_w = [w if w0_mask is None else w * w0_mask]
    else:
        half_hw = (patch_hw[0] // 2, patch_hw[1] // 2)
        grid = im.homography_grid(h_patch2img @ s2, half_hw)
        warped_h, _ = im.bilinear_sample(img, grid, border="reflect")
        _mark(mark, "warp")
        grid_full = im.homography_grid(h_patch2img, patch_hw)
        w0 = radial_weight(grid_full, W, H, _in_image(grid_full, H, W),
                           weight_type)[..., None]
        sub = im.build_laplacian_pyramid(warped_h, bands - 1) \
            if bands > 1 else [warped_h]
        p_lap = [torch.zeros(patch_hw + (img.shape[-1],), dtype=img.dtype,
                             device=dev)] + sub
        p_w = [w0 if w0_mask is None else w0 * w0_mask]
    for _ in range(bands):
        p_w.append(im.pyr_down(p_w[-1]))
    _mark(mark, "pyramids")
    return p_lap, p_w


def composite_patch(canvas_lap: List[torch.Tensor],
                    canvas_w: List[torch.Tensor],
                    patch_lap: List[torch.Tensor],
                    patch_w: List[torch.Tensor], origin_yx):
    """Max-weight composite of a patch pyramid into the canvas pyramid, in
    place. origin_yx: the patch origin in band-0 canvas pixels (tile
    aligned, so origin >> i is exact for every band), as a [2] int tensor
    or a pair of Python ints. Matches `if (srcW >= dstW) {dstL = srcL;
    dstW = srcW;}` per band (MultiBandMap2DCPU.cpp:496-553)."""
    if isinstance(origin_yx, torch.Tensor):
        oyx = origin_yx.to(torch.int64)
    for i in range(len(canvas_lap)):
        ph, pw = patch_lap[i].shape[0], patch_lap[i].shape[1]
        if isinstance(origin_yx, torch.Tensor):
            iy = (oyx[0] >> i) + torch.arange(ph, device=oyx.device)
            ix = (oyx[1] >> i) + torch.arange(pw, device=oyx.device)
            sel = (iy[:, None], ix[None, :])
        else:
            y0, x0 = int(origin_yx[0]) >> i, int(origin_yx[1]) >> i
            sel = (slice(y0, y0 + ph), slice(x0, x0 + pw))
        cur_l = canvas_lap[i][sel]
        cur_w = canvas_w[i][sel]
        take = patch_w[i] >= cur_w
        canvas_lap[i][sel] = torch.where(take, patch_lap[i], cur_l)
        canvas_w[i][sel] = torch.where(take, patch_w[i], cur_w)
    return canvas_lap, canvas_w


def composite_frame(canvas_lap, canvas_w, img, h_patch2img, origin_yx,
                    bands: int, patch_hw, weight_type: int = 0,
                    half_res: bool = False, warp: str = "gather",
                    mark=None):
    """One feed step: warp + pyramids + max-weight composite, in place.
    img: [H, W, 3] float32 (0..255); h_patch2img maps patch pixels
    (relative to the origin) to image pixels; origin_yx tile aligned."""
    p_lap, p_w = patch_pyramids(img, h_patch2img, patch_hw, bands,
                                weight_type, half_res, warp, mark=mark)
    composite_patch(canvas_lap, canvas_w, p_lap, p_w, origin_yx)
    _mark(mark, "composite")
    return canvas_lap, canvas_w


def composite_frames_batch(canvas_lap, canvas_w, imgs, hs, origins_yx,
                           weights_on, bands: int, patch_hw,
                           weight_type: int = 0, half_res: bool = False,
                           warp: str = "gather", seam_masks=None,
                           mark=None):
    """Composite a batch of frames in order (the reference's lax.scan, the
    Map2DRender `renderFrames` analogue), in place. imgs: [K, H, W, 3];
    hs: [K, 3, 3]; origins_yx: K (y, x) pairs; weights_on: K floats, 0
    for a padding slot (its weights are zero). seam_masks [K, ph, pw, 1],
    when given, multiply band 0's weights (composite_frames_batch_seamed)."""
    for k in range(imgs.shape[0]):
        won = float(weights_on[k])
        if seam_masks is None:
            p_lap, p_w = patch_pyramids(imgs[k], hs[k], patch_hw, bands,
                                        weight_type, half_res, warp,
                                        mark=mark)
            p_w = [w * won for w in p_w]
        else:
            p_lap, p_w = patch_pyramids(imgs[k], hs[k], patch_hw, bands,
                                        weight_type, half_res, warp,
                                        w0_mask=seam_masks[k] * won,
                                        mark=mark)
        composite_patch(canvas_lap, canvas_w, p_lap, p_w, origins_yx[k])
        _mark(mark, "composite")
    return canvas_lap, canvas_w


def composite_frames_batch_seamed(canvas_lap, canvas_w, imgs, hs,
                                  origins_yx, weights_on, seam_masks,
                                  bands: int, patch_hw,
                                  weight_type: int = 0,
                                  half_res: bool = False,
                                  warp: str = "gather", mark=None):
    """composite_frames_batch with per-frame seam ownership masks
    (`seam_masks_batch`) multiplied into band 0 before the weight chain."""
    return composite_frames_batch(canvas_lap, canvas_w, imgs, hs,
                                  origins_yx, weights_on, bands, patch_hw,
                                  weight_type, half_res, warp, seam_masks,
                                  mark)


def seam_masks_batch(hs, origins_yx, weights_on, img_hw, patch_hw,
                     canvas_hw, weight_type: int = 0,
                     smooth_sigma: float = 3.0):
    """Seam ownership for a batch of frames (Map2DRender `EnableSeam`
    analogue, reference mosaic.py:406-486): each frame's band-0 analytic
    weight is scattered onto a canvas padded by one patch, the per-pixel
    argmax owner is regularized by a Gaussian majority vote over the
    labels (a running argmax of each label's blurred indicator), and each
    frame gets the mask of the covered pixels it owns. hs: [K, 3, 3];
    origins_yx: K (y, x) Python int pairs; weights_on: K floats. Returns
    [K, ph, pw, 1] float32 {0, 1} masks (patch-local)."""
    K = hs.shape[0]
    ph, pw = patch_hw
    Hc, Wc = canvas_hw[0] + ph, canvas_hw[1] + pw
    dev = hs.device
    best_w = torch.zeros((Hc, Wc), dtype=torch.float32, device=dev)
    best_k = torch.full((Hc, Wc), -1, dtype=torch.int32, device=dev)
    for k in range(K):
        w0 = analytic_weight_pyramid(hs[k], img_hw, patch_hw, 0,
                                     weight_type)[0][..., 0] \
            * float(weights_on[k])
        y0, x0 = int(origins_yx[k][0]), int(origins_yx[k][1])
        reg = (slice(y0, y0 + ph), slice(x0, x0 + pw))
        win = w0 > best_w[reg]
        best_w[reg] = torch.where(win, w0, best_w[reg])
        best_k[reg] = torch.where(win, torch.full_like(best_k[reg], k),
                                  best_k[reg])
    best_v = torch.full((Hc, Wc), -1.0, dtype=torch.float32, device=dev)
    labels = torch.zeros((Hc, Wc), dtype=torch.int32, device=dev)
    for k in range(K):
        v = im.gaussian_blur((best_k == k).to(torch.float32)[..., None],
                             smooth_sigma)[..., 0]
        win = v > best_v
        best_v = torch.where(win, v, best_v)
        labels = torch.where(win, torch.full_like(labels, k), labels)
    covered = best_w > 0
    masks = []
    for k in range(K):
        y0, x0 = int(origins_yx[k][0]), int(origins_yx[k][1])
        reg = (slice(y0, y0 + ph), slice(x0, x0 + pw))
        masks.append(((labels[reg] == k) & covered[reg]).to(torch.float32))
    return torch.stack(masks)[..., None]


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


def grow_canvas(canvas_lap, canvas_w, new_h_tiles: int, new_w_tiles: int,
                shift_tiles_yx):
    """spreadMap equivalent (MultiBandMap2DCPU.cpp:561-604): a larger
    canvas on the same device with the old content shifted by whole
    tiles. Returns the new (lap, w) band lists."""
    bands = len(canvas_lap) - 1
    new_lap, new_w = alloc_canvas(new_h_tiles, new_w_tiles, bands,
                                  canvas_lap[0].device, canvas_lap[0].dtype)
    sy, sx = shift_tiles_yx
    for i in range(bands + 1):
        y0, x0 = (sy * ELE_PIXELS) >> i, (sx * ELE_PIXELS) >> i
        for new, old in ((new_lap[i], canvas_lap[i]),
                         (new_w[i], canvas_w[i])):
            new[y0:y0 + old.shape[0], x0:x0 + old.shape[1]] = old
    return new_lap, new_w
