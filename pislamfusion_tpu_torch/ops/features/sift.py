"""SIFT extraction on tensors: Gaussian octave stacks (K5), DoG extrema
with contrast and edge tests, per-cell selection, then orientation and
128-d descriptors sampled from one packed gradient image (K6).

Port of pislamfusion_tpu/ops/features/sift.py (`SiftParams` ...
`root_sift`) on the reference's TPU path: each octave's stack is one K5
call where the reference takes `banded_stack_pallas` (min(h, w) >= 256
and `stencil.stack_fusable`), else the chain of f32 blurs; the grids are
sampled by K6, `bilinear_grid_pallas`'s function, and masked by each
keypoint's own octave region. `decimate2` is the exact `[::2, ::2]`.
Every `lax.top_k` is `orb._topk` (ties to the lower index) and the final
order a stable argsort.

The detector runs in three stages, each a function here, so a caller can
time them apart: `build_stacks` (base blur, K5 octave stacks, decimation),
`select_octaves` (DoG, extrema, per-cell then global top-k) and
`describe` (`pack_gradients`: the gradients packed one octave under the
next; then K6 orientation and descriptor grids, strongest-first order).
"""
from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np
import torch
import torch.nn.functional as F

from ...core.device import device_const
from .. import image as im
from .. import stencil
from .orb import _topk
from .patchgather import bilinear_grid

# rows of zeros between two octaves of the packed gradient image, so a
# grid never reads the next octave (sift.py:404-409)
MARGIN = 48
GRID_RADIUS = 16      # K6's radius: |offset| <= 4.5 * sigma_max (3.2) + 1


@dataclasses.dataclass(frozen=True)
class SiftParams:
    n_features: int = 1000
    n_octaves: int = 4
    scales_per_octave: int = 3          # "S": 3 DoG scales are searched
    sigma0: float = 1.6
    contrast_threshold: float = 0.02
    edge_threshold: float = 10.0
    ori_bins: int = 36
    desc_grid: int = 4                  # 4x4 spatial bins
    desc_ori_bins: int = 8


def _gradients(img):
    """Central-difference gradient maps (dx, dy), wrapping at the border."""
    dy = 0.5 * (torch.roll(img, -1, 0) - torch.roll(img, 1, 0))
    dx = 0.5 * (torch.roll(img, -1, 1) - torch.roll(img, 1, 1))
    return dx, dy


def _chain_sigmas(params: SiftParams):
    S = params.scales_per_octave
    k = 2.0 ** (1.0 / S)
    out = []
    sigma_prev = params.sigma0
    for i in range(1, S + 3):
        sigma_total = params.sigma0 * k ** i
        out.append(float(np.sqrt(max(sigma_total ** 2 - sigma_prev ** 2,
                                     1e-6))))
        sigma_prev = sigma_total
    return out


@functools.lru_cache(maxsize=32)
def _stack_tables(h: int, w: int, params: SiftParams):
    """K5's tables of the composed chain blurs of one octave, or None when
    a band does not stay narrow (sift._stack_matrices)."""
    taps = tuple(tuple(float(v) for v in im.gaussian_kernel1d(s))
                 for s in _chain_sigmas(params))
    tabs = stencil.chain_tables(h, w, taps)
    return tabs if stencil.stack_fusable(tabs) else None


def _octave_stack(img, params: SiftParams):
    """[S+3, h, w] Gaussian stack of one octave: one K5 call where the
    reference's TPU path takes its stack kernel, else the blur chain."""
    h, w = img.shape
    if min(h, w) >= 2 * 128:
        tabs = _stack_tables(h, w, params)
        if tabs is not None:
            return torch.cat([img[None], stencil.banded_stack(img, tabs)], 0)
    imgs = [img]
    for s in _chain_sigmas(params):
        imgs.append(im.gaussian_blur(imgs[-1][..., None], s)[..., 0])
    return torch.stack(imgs)


def _extrema_response(dog, params: SiftParams):
    """|DoG| where the pixel is a 3x3x3 extremum passing the contrast and
    edge tests, 0 elsewhere. dog: [S+2, H, W] -> [S, H, W]."""
    S = params.scales_per_octave
    H, W = dog.shape[1:]
    # 3x3 max / min of every level ("SAME" windows, -inf / +inf padding)
    m3 = F.max_pool2d(dog[:, None], 3, 1, 1)[:, 0]
    n3 = -F.max_pool2d(-dog[:, None], 3, 1, 1)[:, 0]
    shifts = [(-1, -1), (-1, 0), (-1, 1), (0, -1), (0, 1),
              (1, -1), (1, 0), (1, 1)]
    dev = dog.device
    ys = torch.arange(H, device=dev)[:, None]
    xs = torch.arange(W, device=dev)[None, :]
    border = (ys >= 5) & (ys < H - 5) & (xs >= 5) & (xs < W - 5)
    r = params.edge_threshold
    resp = []
    for s in range(1, S + 1):
        c = dog[s]
        ring = torch.stack([torch.roll(c, sh, (0, 1)) for sh in shifts])
        nmax = torch.maximum(torch.maximum(m3[s - 1], m3[s + 1]),
                             ring.amax(0))
        nmin = torch.minimum(torch.minimum(n3[s - 1], n3[s + 1]),
                             ring.amin(0))
        contrast = c.abs() > params.contrast_threshold
        # 2x2 spatial Hessian edge test (Lowe): tr^2 / det < (r + 1)^2 / r
        dxx = torch.roll(c, -1, 1) + torch.roll(c, 1, 1) - 2 * c
        dyy = torch.roll(c, -1, 0) + torch.roll(c, 1, 0) - 2 * c
        dxy = 0.25 * (torch.roll(c, (-1, -1), (0, 1))
                      + torch.roll(c, (1, 1), (0, 1))
                      - torch.roll(c, (-1, 1), (0, 1))
                      - torch.roll(c, (1, -1), (0, 1)))
        tr = dxx + dyy
        det = dxx * dyy - dxy * dxy
        edge_ok = (det > 0) & (tr * tr * r < (r + 1) ** 2 * det)
        ok = ((c > nmax) | (c < nmin)) & contrast & edge_ok & border
        resp.append(torch.where(ok, c.abs(), torch.zeros_like(c)))
    return torch.stack(resp)


def _select_topk(resp, k: int, cell: int = 64):
    """resp [S, H, W] -> (s, y, x, value) of the k strongest responses:
    per-cell top-k over `cell`-px tiles of each scale map, then a global
    top-k over the survivors."""
    S, H, W = resp.shape
    dev = resp.device
    ncy, ncx = -(-H // cell), -(-W // cell)
    sp = F.pad(resp, (0, ncx * cell - W, 0, ncy * cell - H))
    per_cell = max(1, min(cell * cell, int(np.ceil(2.0 * k / (ncy * ncx)))))
    Wp = sp.shape[2]
    if per_cell == 1:
        # the cell max, and the first row-major position holding it
        cells = sp.reshape(S, ncy, cell, ncx, cell)
        cv = cells.amax((2, 4))                                # [S, ncy, ncx]
        up = cv[:, :, None, :, None].expand(S, ncy, cell, ncx, cell)
        lin = (torch.arange(ncy * cell, device=dev)[:, None] * Wp
               + torch.arange(Wp, device=dev)[None, :]).reshape(
                   ncy, cell, ncx, cell)
        big = torch.full_like(lin, ncy * cell * Wp)
        ci = torch.where(cells == up, lin, big).amin((2, 4))
        flat_v = cv.reshape(-1)
        scales = torch.arange(S, device=dev)[:, None, None].expand(
            cv.shape).reshape(-1)
        flat_y = (ci // Wp).reshape(-1)
        flat_x = (ci % Wp).reshape(-1)
        v, idx = _topk(flat_v, min(k, flat_v.shape[0]))
        s, y, x = scales[idx], flat_y[idx], flat_x[idx]
    else:
        cells = sp.reshape(S, ncy, cell, ncx, cell).permute(0, 1, 3, 2, 4)
        cells = cells.reshape(S * ncy * ncx, cell * cell)
        cv, ci = _topk(cells, per_cell, dim=1)       # [S * ncells, per_cell]
        cidx = torch.arange(S * ncy * ncx, device=dev)[:, None]
        s_c = cidx // (ncy * ncx)
        gy = ((cidx % (ncy * ncx)) // ncx) * cell + ci // cell
        gx = ((cidx % (ncy * ncx)) % ncx) * cell + ci % cell
        v, idx = _topk(cv.reshape(-1), min(k, cv.numel()))
        s = s_c.expand(gy.shape).reshape(-1)[idx]
        y = gy.reshape(-1)[idx]
        x = gx.reshape(-1)[idx]
    if v.shape[0] < k:
        pad = k - v.shape[0]
        v, s, y, x = (F.pad(a, (0, pad)) for a in (v, s, y, x))
    return s, y, x, v


def _grid_offsets(n: int, device):
    """(gu, gv) [1, n*n]: an n x n grid over (-1, 1), x fastest."""
    def make():
        lin = (torch.arange(n, dtype=torch.float32) + 0.5) / n * 2.0 - 1.0
        gv, gu = torch.meshgrid(lin, lin, indexing="ij")
        return torch.stack([gu.reshape(1, -1), gv.reshape(1, -1)])
    g = device_const(("sift_grid", n), device, make)
    return g[0], g[1]


def _grid_points(cx, cy, angle, sigma, n: int, radius_sigmas: float,
                 bounds):
    """The n x n grid rotated by `angle` and scaled by radius_sigmas *
    sigma around each keypoint, as K6 takes it. Returns (centers [K, 2]
    int32, rel [K, 2, n*n] offsets from them, gu, gv [1, n*n] grid
    coordinates, valid [K, n*n]: the samples inside the keypoint's own
    octave region, bounds = (x_hi, y_lo, y_hi) [K])."""
    gu, gv = _grid_offsets(n, cx.device)
    rad = (radius_sigmas * sigma)[:, None]
    ca = torch.cos(angle)[:, None]
    sa = torch.sin(angle)[:, None]
    px = cx[:, None] + rad * (ca * gu - sa * gv)
    py = cy[:, None] + rad * (sa * gu + ca * gv)
    x_hi, y_lo, y_hi = bounds
    valid = ((px >= 0) & (px <= x_hi[:, None])
             & (py >= y_lo[:, None]) & (py <= y_hi[:, None]))
    centers = torch.stack([cx, cy], -1).to(torch.int32)
    cf = centers.to(torch.float32)
    rel = torch.stack([px - cf[:, 0:1], py - cf[:, 1:2]], 1)   # [K, 2, M]
    return centers, rel, gu, gv, valid


def _sample_grid(grad, cx, cy, angle, sigma, n: int, radius_sigmas: float,
                 bounds):
    """K6-sample the packed gradient image grad [Hp, W, 2] on the grids of
    `_grid_points`. Returns (gx, gy, gu, gv, valid), [K, n*n] samples."""
    centers, rel, gu, gv, valid = _grid_points(cx, cy, angle, sigma, n,
                                               radius_sigmas, bounds)
    vals = bilinear_grid(grad, centers, rel, radius=GRID_RADIUS)
    return vals[..., 0], vals[..., 1], gu, gv, valid


def _orientations(grad, cx, cy, sigma, params: SiftParams, bounds):
    """Dominant gradient orientation per keypoint (36-bin histogram,
    Gaussian weighted, smoothed twice, parabolic peak refinement)."""
    gx, gy, gu, gv, valid = _sample_grid(grad, cx, cy, torch.zeros_like(cx),
                                         sigma, 16, 4.5, bounds)
    mag = torch.hypot(gx, gy) * valid
    w = torch.exp(-(gu ** 2 + gv ** 2) * 2.0)     # sigma = 0.5 of the window
    theta = torch.atan2(gy, gx)
    B = params.ori_bins
    b = torch.remainder(theta / (2 * math.pi) * B, B)
    b0 = torch.floor(b)
    fb = b - b0
    b0 = b0.to(torch.int64) % B
    b1 = (b0 + 1) % B
    bins = torch.arange(B, device=grad.device)
    soft = ((b0[..., None] == bins) * (1 - fb)[..., None]
            + (b1[..., None] == bins) * fb[..., None])      # [K, M, B]
    hist = torch.bmm((mag * w)[:, None, :], soft)[:, 0]     # [K, B]
    for _ in range(2):
        hist = (torch.roll(hist, 1, -1) + hist
                + torch.roll(hist, -1, -1)) / 3.0
    peak = torch.argmax(hist, -1)
    hp = torch.gather(hist, 1, peak[:, None])[:, 0]
    hl = torch.gather(hist, 1, ((peak - 1) % B)[:, None])[:, 0]
    hr = torch.gather(hist, 1, ((peak + 1) % B)[:, None])[:, 0]
    denom = hl - 2 * hp + hr
    off = torch.where(denom.abs() > 1e-9, 0.5 * (hl - hr) / denom,
                      torch.zeros_like(denom))
    return (peak + off) * (2 * math.pi / B)


def _soft_bins(coord, size: int, wrap: bool):
    """Linear soft binning: (bin0, bin1, weight0, weight1)."""
    c0 = torch.floor(coord)
    f = coord - c0
    c0i = c0.to(torch.int64)
    if wrap:
        return c0i % size, (c0i + 1) % size, 1 - f, f
    ok0 = (c0i >= 0) & (c0i < size)
    ok1 = (c0i + 1 >= 0) & (c0i + 1 < size)
    return (c0i.clamp(0, size - 1), (c0i + 1).clamp(0, size - 1),
            (1 - f) * ok0, f * ok1)


def _descriptors(grad, cx, cy, angle, sigma, params: SiftParams, bounds):
    """128-d descriptors from a 16x16 rotated sample grid with soft 4x4x8
    binning, normalised, clipped at 0.2 and renormalised (Lowe)."""
    G = params.desc_grid
    OB = params.desc_ori_bins
    gx, gy, gu, gv, valid = _sample_grid(grad, cx, cy, angle, sigma, 16,
                                         1.5 * G / 2.0, bounds)
    mag = torch.hypot(gx, gy) * valid
    w = torch.exp(-(gu ** 2 + gv ** 2) * 1.0)
    theta = torch.atan2(gy, gx) - angle[:, None]
    ub = (gu + 1.0) * 0.5 * G - 0.5
    vb = (gv + 1.0) * 0.5 * G - 0.5
    ob = torch.remainder(theta / (2 * math.pi) * OB, OB)
    u0, u1, wu0, wu1 = _soft_bins(ub, G, False)
    v0, v1, wv0, wv1 = _soft_bins(vb, G, False)
    o0, o1, wo0, wo1 = _soft_bins(ob, OB, True)
    K = cx.shape[0]
    dev = grad.device
    gbins = torch.arange(G, device=dev)
    obins = torch.arange(OB, device=dev)
    su = ((u0[..., None] == gbins) * wu0[..., None]
          + (u1[..., None] == gbins) * wu1[..., None])      # [K, M, G]
    sv = ((v0[..., None] == gbins) * wv0[..., None]
          + (v1[..., None] == gbins) * wv1[..., None])
    so = ((o0[..., None] == obins) * wo0[..., None]
          + (o1[..., None] == obins) * wo1[..., None])      # [K, M, OB]
    # "km,kmu,kmv,kmo->kvuo" in two steps: a [K, M, G*G] spatial weight,
    # then one batched product over the samples
    vu = ((mag * w)[..., None, None] * sv[..., :, None]
          * su[..., None, :]).reshape(K, -1, G * G)
    desc = torch.bmm(vu.transpose(1, 2), so).reshape(K, G * G * OB)
    desc = desc / torch.linalg.vector_norm(desc, dim=-1,
                                           keepdim=True).clamp_min(1e-9)
    desc = torch.minimum(desc, torch.full_like(desc, 0.2))
    return desc / torch.linalg.vector_norm(desc, dim=-1,
                                           keepdim=True).clamp_min(1e-9)


def _octave_count(H: int, W: int, params: SiftParams) -> int:
    return min(params.n_octaves,
               int(np.log2(max(min(H, W) / 16.0, 2.0))))


def _quotas(n_oct: int, params: SiftParams):
    """Per-octave keypoint budgets, the finest octaves getting the most."""
    quotas = []
    rem = params.n_features
    for o in range(n_oct):
        q = max(16, int(round(params.n_features * 0.5 ** o * 0.55)))
        q = min(q, rem)
        quotas.append(q)
        rem -= q
    quotas[0] += rem
    return quotas


# ---------------------------------------------------------------------------
# the detector, in three stages
# ---------------------------------------------------------------------------

def build_stacks(img, params: SiftParams):
    """Stage 1. img [H, W] (0..255) -> the [S+3, h, w] Gaussian stack of
    every octave (K5 where the reference takes its stack kernel)."""
    img = img.to(torch.float32) / 255.0
    H, W = img.shape
    S = params.scales_per_octave
    oct_img = im.gaussian_blur(img[..., None], float(np.sqrt(max(
        params.sigma0 ** 2 - 0.25, 0.01))))[..., 0]
    stacks = []
    for _ in range(_octave_count(H, W, params)):
        stacks.append(_octave_stack(oct_img, params))
        oct_img = im.decimate2(stacks[-1][S])
    return stacks


def select_octaves(stacks, params: SiftParams):
    """Stage 2: DoG, extrema response and top-k per octave. Returns per
    octave (scale index, y, x, response) of its quota."""
    quotas = _quotas(len(stacks), params)
    out = []
    for stack, kq in zip(stacks, quotas):
        out.append(_select_topk(_extrema_response(stack[1:] - stack[:-1],
                                                  params), kq))
    return out


def pack_gradients(stacks, picks, shape, params: SiftParams):
    """Every octave's gradients packed one under the next (MARGIN zero rows
    between) into grad [Hp, W, 2], and the keypoints in that image.
    Returns (grad, (cx, cy, sigma, bounds) of every keypoint, feats: xy,
    response, octave, size and valid in frame coordinates)."""
    H, W = shape
    S = params.scales_per_octave
    k = 2.0 ** (1.0 / S)
    dev = stacks[0].device
    rows = sum(st.shape[1] + MARGIN for st in stacks)
    grad = torch.zeros((rows, W, 2), dtype=torch.float32, device=dev)
    feats = {kk: [] for kk in ("xy", "response", "octave", "size", "valid")}
    cxs, cys, sigs, xhi, ylo, yhi = [], [], [], [], [], []
    row = 0
    for o, (stack, (s_idx, y, x, v)) in enumerate(zip(stacks, picks)):
        dxm, dym = _gradients(stack[S // 2 + 1])
        h, w = dxm.shape
        grad[row:row + h, :w] = torch.stack([dxm, dym], -1)
        kq = v.shape[0]
        sigma_of_s = params.sigma0 * k ** (s_idx.to(torch.float32) + 1.0)
        cx = x.to(torch.float32)
        cy = y.to(torch.float32)
        cxs.append(cx)
        cys.append(cy + float(row))
        sigs.append(sigma_of_s)
        for lst, val in ((xhi, w - 1), (ylo, row), (yhi, row + h - 1)):
            lst.append(torch.full((kq,), float(val), device=dev))
        scale = float(2 ** o)
        feats["xy"].append(torch.stack([cx, cy], -1) * scale)
        feats["response"].append(v)
        feats["octave"].append(torch.full((kq,), o, dtype=torch.int32,
                                          device=dev))
        feats["size"].append(sigma_of_s * scale)
        feats["valid"].append(v > 0)
        row += h + MARGIN
    feats = {kk: torch.cat(vv, 0) for kk, vv in feats.items()}
    bounds = (torch.cat(xhi), torch.cat(ylo), torch.cat(yhi))
    return grad, (torch.cat(cxs), torch.cat(cys), torch.cat(sigs),
                  bounds), feats


def describe(stacks, picks, shape, params: SiftParams):
    """Stage 3: the packed gradient image, orientation and descriptor grids
    by K6, then the strongest n_features first. shape: (H, W) of the
    frame."""
    grad, (cx, cy, sig, bounds), feats = pack_gradients(stacks, picks, shape,
                                                        params)
    feats["angle"] = _orientations(grad, cx, cy, sig, params, bounds)
    feats["desc"] = _descriptors(grad, cx, cy, feats["angle"], sig, params,
                                 bounds)
    key = torch.where(feats["valid"], -feats["response"],
                      torch.full_like(feats["response"], float("inf")))
    keep = torch.argsort(key, stable=True)[:params.n_features]
    return {kk: vv[keep] for kk, vv in feats.items()}


def sift_detect(img, params: SiftParams = SiftParams()):
    """Full extractor. img: [H, W] grayscale (0..255) on the device the
    caller chose.

    Returns a dict with N = params.n_features rows (the per-octave quotas
    sum to N): xy [N, 2] float32 full-resolution pixels, response,
    angle (rad), octave int32, size (sigma in full-resolution pixels),
    desc [N, 128] float32 (L2-normalised), valid bool."""
    stacks = build_stacks(img, params)
    picks = select_octaves(stacks, params)
    return describe(stacks, picks, tuple(img.shape), params)


def root_sift(desc):
    """RootSIFT: sqrt of the L1-normalised descriptor (DIYSLAM.cpp:286-338)."""
    l1 = desc.abs().sum(-1, keepdim=True)
    return torch.sqrt(desc / l1.clamp_min(1e-9))
