"""K3: the tiled shear-decomposed homography warp of the mosaic feed.

Replaces pislamfusion_tpu/ops/shearwarp.py `warp_patch_pallas` (its
`pallas_call` at :505), called by mosaic.patch_pyramids (mosaic.py:244-252).

The function is the TPU kernel's, kept as its contract: the patch is cut
into 128-px tiles; each tile fits an affine to the homography at its
corners (`tile_params`, with the kernel's window `_pallas_window_hw` and
(8, 128) window alignment) and resamples in two 1-D passes, each an
integer shear plus a 3-tap linear resample (Catmull-Smith):

    I[v, x]   = sum_j w1_j(v, x) * win[(m1(v) + j + n1(x)) mod WH, x]
    out[v, u] = sum_i w2_i(v, u) * I[v, (m2(u) + i + n2(v)) mod WW]

with the phases of `_pass_phases` and the tent weights of `_tap_weights`
(m clipped to [0, W-3], shears wrapped around the window as the kernel's
roll network does). Maps closer to 90 degrees than to 0 warp from the
transposed source. Dead tiles are exactly zero; `live` and `max_fit_err`
come back with the patch. This is not projective bilinear sampling: it
interpolates along each destination row's preimage line, up to ~0.3 gray
away from bilinear on smoothed noise.

On the H100 the warp is bound by bytes: a half-res 768^2 x 3 patch from a
540x960x3 source moves ~13 MB and does ~0.06 GFLOP. The TPU kernel
spelled the shears as log-depth roll networks and the resamples as
one-hot MXU matmuls because a TPU cannot gather; a GPU can. The CUDA
kernel (`csrc/shearwarp.cu`) gives each block a strip of `STRIP_ROWS`
output rows of one tile: a dead tile's strip writes its zeros with
16-byte stores; in a live one every thread computes the tile's constants
and the strip's limits (no barrier waits on them), each pass-1 value
I[v, x] its outputs read is computed once into shared memory (the source
read along its rows in both orientations: the transposed one stages the
source-row segments its rows read in shared memory), then pass 2 reads
I and writes 16-byte stores. The wraps around the window take a
compare-and-add where the strip's limits prove them within one period. All in f32 (the TPU's bf16 hi/lo split was an MXU
device, not part of the function), in the plain version's order of
operations. The transpose decision is read on the device, so a frame's
feed never waits on the host.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Tuple

import numpy as np
import torch

from .. import _build
from ..core.device import device_const

TILE = 128
STRIP_ROWS = 4          # output rows a block (csrc/shearwarp.cu R)
_MAX_C = 4              # channels the kernel is instantiated for


class TileParams(NamedTuple):
    """Per-destination-tile warp parameters (all [nt, ...] tensors)."""
    affine: torch.Tensor     # [nt, 6] a00, a01, tx, a10, a11, ty (window px)
    window: torch.Tensor     # [nt, 2] (wy, wx) window origin, int32
    live: torch.Tensor       # [nt] bool
    max_fit_err: torch.Tensor  # [] worst corner residual of the affine fit


def _homography_apply(h, uv):
    """uv [..., 2] dst px -> src px under 3x3 h."""
    u, v = uv[..., 0], uv[..., 1]
    qx = h[0, 0] * u + h[0, 1] * v + h[0, 2]
    qy = h[1, 0] * u + h[1, 1] * v + h[1, 2]
    qz = h[2, 0] * u + h[2, 1] * v + h[2, 2]
    qz = torch.where(qz.abs() < 1e-12, torch.full_like(qz, 1e-12), qz)
    return torch.stack([qx / qz, qy / qz], -1)


def _floor_to(x, a: int):
    return torch.div(x, a, rounding_mode="floor") * a


def tile_params(h_patch2img, patch_hw: Tuple[int, int],
                src_hw: Tuple[int, int], win_hw: Tuple[int, int],
                tile: int = TILE, transpose: bool = False,
                align: Tuple[int, int] = (1, 1)) -> TileParams:
    """Fit the per-tile affines and choose source windows.
    transpose=True computes them for the transposed source."""
    ph, pw = patch_hw
    nty, ntx = ph // tile, pw // tile
    t = float(tile)
    dev = h_patch2img.device
    ty, tx = torch.meshgrid(
        torch.arange(nty, dtype=torch.float32, device=dev) * t,
        torch.arange(ntx, dtype=torch.float32, device=dev) * t,
        indexing="ij")
    org = torch.stack([tx.reshape(-1), ty.reshape(-1)], -1)      # [nt, 2]
    offs = device_const(("corners", t), dev, lambda: torch.tensor(
        [[0.0, 0.0], [t, 0.0], [0.0, t], [t, t]]))
    p = _homography_apply(h_patch2img, org[:, None, :] + offs[None])
    if transpose:
        p = p.flip(-1)
    p00, p10, p01, p11 = p[:, 0], p[:, 1], p[:, 2], p[:, 3]
    a_col = ((p10 - p00) + (p11 - p01)) / (2.0 * t)              # d/du
    a_row = ((p01 - p00) + (p11 - p10)) / (2.0 * t)              # d/dv
    center = 0.25 * (p00 + p10 + p01 + p11)
    trans = center - a_col * (t / 2.0) - a_row * (t / 2.0)
    twist = 0.25 * (p00 + p11 - p10 - p01)
    max_fit_err = twist.abs().amax()
    sh, sw = (src_hw[1], src_hw[0]) if transpose else src_hw
    wh, ww = win_hw
    ay, ax = align
    xmin = p[..., 0].amin(1) - 1.0
    ymin = p[..., 1].amin(1) - 1.0
    wx = _floor_to(torch.floor(xmin).to(torch.int32), ax).clamp(
        0, (max(sw - ww, 0) // ax) * ax)
    wy = _floor_to(torch.floor(ymin).to(torch.int32), ay).clamp(
        0, (max(sh - wh, 0) // ay) * ay)
    xmax = p[..., 0].amax(1)
    ymax = p[..., 1].amax(1)
    live = (xmax >= 0) & (xmin <= sw) & (ymax >= 0) & (ymin <= sh)
    # a tile whose extent exceeds the provisioned window is dead, not
    # rendered from clamped content
    a00, a10 = a_col[:, 0], a_col[:, 1]
    safe = torch.where(a00.abs() < 1e-6, torch.full_like(a00, 1e-6), a00)
    beta = (a00 * a_row[:, 1] - a_row[:, 0] * a10) / safe
    fits = ((ymax - ymin + 4.0 < wh) & (xmax - xmin + 4.0 < ww)
            & (beta.abs() * t + 4.0 < wh) & (a00.abs() * t + 4.0 < ww))
    live = live & fits
    affine = torch.stack([a_col[:, 0], a_row[:, 0],
                          trans[:, 0] - wx.to(torch.float32),
                          a_col[:, 1], a_row[:, 1],
                          trans[:, 1] - wy.to(torch.float32)], -1)
    return TileParams(affine, torch.stack([wy, wx], -1), live, max_fit_err)


def _pass_coeffs(a00, a01, tx, a10, a11, ty):
    """Two-pass coefficients: pass 1 samples src row alpha*x + beta*v +
    gamma, pass 2 src col a00*u + a01*v + tx."""
    safe = torch.where(a00.abs() < 1e-6, torch.full_like(a00, 1e-6), a00)
    alpha = a10 / safe
    beta = (a00 * a11 - a01 * a10) / safe
    gamma = ty - alpha * tx
    return alpha, beta, gamma


def _tap_weights(gf):
    """3-tap tent weights at summed fraction gf in [0, 2)."""
    w0 = torch.clamp(1.0 - gf, min=0.0)
    w1 = 1.0 - (gf - 1.0).abs()
    w2 = torch.clamp(gf - 1.0, min=0.0)
    return w0, w1, w2


def _pass_phases(slope_shear, offset_shear, slope_resample, n_out: int,
                 n_axis: int):
    """Shear/resample phases of one pass, batched over tiles ([nt]
    slopes). Positions along the contracted axis are slope_shear*x +
    offset_shear (per contracted index x) plus slope_resample*v (per
    output index v); a bias keeps m(v) >= 0 for negative slopes.
    Returns (n [nt, n_axis] int, f, m [nt, n_out] int, g)."""
    dev = slope_shear.device
    xs = torch.arange(n_axis, dtype=torch.float32, device=dev)
    vs = torch.arange(n_out, dtype=torch.float32, device=dev)
    pv = slope_resample[:, None] * vs[None, :]
    bias = torch.ceil(torch.clamp(-pv.amin(1, keepdim=True), min=0.0))
    m = torch.floor(pv) + bias
    g = pv - torch.floor(pv)
    sx = slope_shear[:, None] * xs[None, :] + offset_shear[:, None] - bias
    n = torch.floor(sx)
    f = sx - n
    return n.to(torch.int64), f, m.to(torch.int64), g


def _choose_transpose(h):
    """True (as a 0-d tensor) when the map is closer to a 90-degree
    rotation: |dy/du| > |dx/du|."""
    return h[1, 0].abs() > h[0, 0].abs()


def _pallas_window_hw(max_scale: float, tile: int) -> Tuple[int, int]:
    """The TPU kernel's window: the tile's own source bbox
    (sqrt(2)*scale*tile) plus the (8, 128) alignment slack."""
    e = 1.42 * max_scale * tile + 6
    wh = int(np.ceil((e + 8) / 8.0)) * 8
    ww = int(np.ceil((e + 128) / 128.0)) * 128
    return wh, ww


def _params(img, h_patch2img, patch_hw, tile, max_scale):
    """Both orientations' tile params, selected on the device by the
    transpose test. Returns (transpose [] bool, TileParams, win_hw)."""
    win = _pallas_window_hw(max_scale, tile)
    src_hw = (img.shape[0], img.shape[1])
    tr = _choose_transpose(h_patch2img)
    pn = tile_params(h_patch2img, patch_hw, src_hw, win, tile, False,
                     align=(8, 128))
    pt = tile_params(h_patch2img, patch_hw, src_hw, win, tile, True,
                     align=(8, 128))
    prm = TileParams(*[torch.where(tr, b, a) for a, b in zip(pn, pt)])
    return tr, prm, win


def strip_extents(img, h_patch2img, patch_hw: Tuple[int, int],
                  tile: int = TILE, max_scale: float = 2.2) -> dict:
    """The kernel's buffer needs for each (tile, strip of STRIP_ROWS rows),
    by its formulas (a host check, not on the frame path): `span` [nt,
    strips], the window columns a row's pass 1 writes into I, at most the
    window's width WW; `staged`, the floats a transposed strip needs: I
    at its span and, for each of its window columns, its window rows L
    times C at an odd pitch, its run's start and its phase (staged where
    at most SMEM_FLOATS); with `live`
    [nt, strips], `transpose` and the window `win`."""
    tr, prm, win = _params(img, h_patch2img.to(torch.float32), patch_hw,
                           tile, max_scale)
    WH, WW = win
    C = img.shape[2]
    a00, a01, tx, a10, a11, ty = prm.affine.unbind(-1)
    _, beta, _ = _pass_coeffs(a00, a01, tx, a10, a11, ty)
    tm1 = float(tile - 1)

    def bias(slope):
        return torch.ceil(torch.clamp(-torch.clamp(slope * tm1, max=0.0),
                                      min=0.0))

    def ends(slope, idx, n):
        pv = slope[:, None] * idx.to(torch.float32)
        return torch.clamp(torch.floor(pv) + bias(slope)[:, None], 0, n - 3)
    dev = a00.device
    m2 = ends(a00, torch.tensor([[0, tile - 1]], device=dev), WW)
    span = (m2[:, 1] - m2[:, 0]).abs() + 3
    v0 = torch.arange(0, tile, STRIP_ROWS, device=dev)[None]
    v1 = v0 + STRIP_ROWS - 1
    m1a, m1b = ends(beta, v0, WH), ends(beta, v1, WH)
    b2 = bias(a00)[:, None]
    n2a = torch.floor(a01[:, None] * v0.to(torch.float32) + tx[:, None] - b2)
    n2b = torch.floor(a01[:, None] * v1.to(torch.float32) + tx[:, None] - b2)
    xlen = span[:, None] + (n2a - n2b).abs()
    seg = (m1b - m1a).abs() + 3
    pitch = torch.bitwise_or((seg * C).to(torch.int64), 1)
    strips = v0.numel()
    return {"transpose": bool(tr), "win": win,
            "live": prm.live[:, None].expand(-1, strips),
            "span": span[:, None].expand(-1, strips).to(torch.int64),
            "staged": (STRIP_ROWS * C * (span + torch.div(
                span, 32, rounding_mode="floor") + 1))[:, None].to(
                torch.int64) + xlen.to(torch.int64) * (pitch + 2)}


def warp_patch_plain(img, h_patch2img, patch_hw: Tuple[int, int],
                     tile: int = TILE, max_scale: float = 2.2):
    """Plain PyTorch version: the two passes evaluated for each output
    pixel, as the kernel does: pass 2's three window columns, and at each
    the pass-1 value from three window rows."""
    ph, pw = patch_hw
    nty, ntx = ph // tile, pw // tile
    H, W, C = img.shape
    tr, prm, (WH, WW) = _params(img, h_patch2img, patch_hw, tile,
                                max_scale)
    a00, a01, tx, a10, a11, ty = prm.affine.unbind(-1)
    alpha, beta, gamma = _pass_coeffs(a00, a01, tx, a10, a11, ty)
    n1, f1, m1, g1 = _pass_phases(alpha, gamma, beta, tile, WW)
    n2, f2, m2, g2 = _pass_phases(a01, tx, a00, tile, tile)
    m1 = m1.clamp(0, WH - 3)
    m2 = m2.clamp(0, WW - 3)
    # source row/col extents of the (possibly transposed) image
    sh = torch.where(tr, W, H)
    sw = torch.where(tr, H, W)
    wy = prm.window[:, 0].to(torch.int64)[:, None, None]
    wx = prm.window[:, 1].to(torch.int64)[:, None, None]
    flat = img.reshape(H * W, C)
    w2 = _tap_weights(f2[:, :, None] + g2[:, None, :])           # [nt,T,T]
    out = None
    for i in range(3):
        # the window column pass 2 reads for output (v, u), and its phase
        x = torch.remainder(m2[:, None, :] + i + n2[:, :, None], WW)
        w1 = _tap_weights(g1[:, :, None] + torch.gather(f1, 1, x.flatten(
            1)).view_as(x))
        n1x = torch.gather(n1, 1, x.flatten(1)).view_as(x)
        c = torch.minimum(wx + x, sw - 1)
        iv = None
        for j in range(3):
            r = torch.remainder(m1[:, :, None] + j + n1x, WH)
            row = torch.minimum(wy + r, sh - 1)
            idx = torch.where(tr, c * W + row, row * W + c)
            t = w1[j][..., None] * flat.index_select(
                0, idx.reshape(-1)).view(idx.shape + (C,))       # [nt,T,T,C]
            iv = t if iv is None else iv + t
        t = w2[i][..., None] * iv
        out = t if out is None else out + t
    out = torch.where(prm.live[:, None, None, None], out,
                      torch.zeros_like(out))
    patch = out.reshape(nty, ntx, tile, tile, C).permute(0, 2, 1, 3, 4)
    return (patch.reshape(ph, pw, C), prm.live.reshape(nty, ntx),
            prm.max_fit_err)


def warp_patch(img, h_patch2img, patch_hw: Tuple[int, int],
               tile: int = TILE, max_scale: float = 2.2):
    """Tiled shear warp. img: [H, W, C] float32; h_patch2img: [3, 3]
    patch px -> image px (float32, on img's device). Returns (patch
    [ph, pw, C], live [nty, ntx] bool, max_fit_err []). Composite with a
    weight that is zero outside the source image and on dead tiles.
    CPU tensors take the plain version; CUDA tensors launch the kernel."""
    ph, pw = patch_hw
    if ph % tile or pw % tile:
        raise ValueError(f"warp_patch: patch {patch_hw} is not a multiple "
                         f"of the tile {tile}")
    if img.device.type == "cpu":
        return warp_patch_plain(img, h_patch2img, patch_hw, tile, max_scale)
    if img.device.type != "cuda":
        raise ValueError(f"warp_patch: unsupported device {img.device}")
    if img.dtype != torch.float32 or img.ndim != 3 \
            or not 1 <= img.shape[2] <= _MAX_C:
        raise ValueError(f"warp_patch: img must be float32 [H, W, C] with "
                         f"C <= {_MAX_C}")
    if img.numel() >= 2 ** 31:
        raise ValueError("warp_patch: the kernel indexes the image with "
                         "32-bit offsets")
    if tile % STRIP_ROWS or tile % 4:
        raise ValueError(f"warp_patch: the tile {tile} is not a multiple "
                         f"of {STRIP_ROWS} rows")
    if h_patch2img.device != img.device or h_patch2img.shape != (3, 3):
        raise ValueError("warp_patch: homography must be [3, 3] on img's "
                         "device")
    img = img.contiguous()
    tr, prm, win = _params(img, h_patch2img.to(torch.float32), patch_hw,
                           tile, max_scale)
    smem_bytes(win, img.shape[2])            # raises where I cannot fit
    out = launch_kernel(img, tr, prm, patch_hw, tile, win)
    return out, prm.live.reshape(ph // tile, pw // tile), prm.max_fit_err


SMEM_FLOATS = 13824     # shared memory a block (csrc/shearwarp.cu SMEM)


def smem_bytes(win_hw, C: int) -> int:
    """Dynamic shared memory of a block (csrc/shearwarp.cu
    shearwarp_smem): SMEM_FLOATS, which must hold I of STRIP_ROWS rows x
    C channels at the window's padded width; beside I at a strip's own
    span, the transposed path stages its source segments."""
    WW = win_hw[1]
    if STRIP_ROWS * C * (WW + (WW >> 5) + 1) > SMEM_FLOATS:
        raise ValueError(f"warp_patch: a {WW}-column window does not fit "
                         f"the kernel's shared memory at C={C}")
    return SMEM_FLOATS * 4


def _lib():
    """The kernel library (`_build.load`'s, which a sweep may swap), with
    its launch signatures set once."""
    lib = _build.load("shearwarp")
    if not getattr(lib, "signatures_set", False):
        P, I = ctypes.c_void_p, ctypes.c_int
        lib.shearwarp_launch.restype = I
        lib.shearwarp_launch.argtypes = [P, I, I, I, P, P, P, P, I, I, I, I,
                                         I, P, P]
        for fn in (lib.shearwarp_occupancy, lib.shearwarp_smem):
            fn.restype = I
            fn.argtypes = [I, I]
        lib.signatures_set = True
    return lib


def occupancy(C: int, win_hw, device) -> int:
    """The kernel's resident blocks an SM on `device` for C channels and
    the window (registers included)."""
    lib = _lib()
    if lib.shearwarp_smem(C, win_hw[1]) != smem_bytes(win_hw, C):
        raise RuntimeError("shearwarp: host and kernel disagree on the "
                           "shared memory a block")
    with torch.cuda.device(device):
        return lib.shearwarp_occupancy(C, win_hw[1])


def launch_kernel(img, tr, prm: TileParams, patch_hw, tile: int, win_hw):
    """Launch csrc/shearwarp.cu on prepared tile parameters (what
    warp_patch does after `_params`). img: contiguous float32 [H, W, C] on
    a CUDA device. Returns the patch [ph, pw, C]."""
    H, W, C = img.shape
    ph, pw = patch_hw
    WH, WW = win_hw
    aff = prm.affine.contiguous()
    window = prm.window.to(torch.int32).contiguous()
    live = prm.live.to(torch.int32).contiguous()
    trf = tr.to(torch.int32).reshape(1)
    out = torch.empty((ph, pw, C), dtype=torch.float32, device=img.device)
    with torch.cuda.device(img.device):
        stream = torch.cuda.current_stream(img.device).cuda_stream
        err = _lib().shearwarp_launch(
            img.data_ptr(), H, W, C, trf.data_ptr(), aff.data_ptr(),
            window.data_ptr(), live.data_ptr(), ph, pw, tile, WH, WW,
            out.data_ptr(), stream)
    _build.check(err, "shearwarp")
    warp_patch.launches += 1
    return out


warp_patch.launches = 0
