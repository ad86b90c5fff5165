"""ORB extraction on tensors: pyramid, FAST-16, 3x3 NMS, per-cell
selection, intensity-centroid angle, patch blur, steered BRIEF (rotation
binned, or continuous with `angle_bins=0`).

Port of pislamfusion_tpu/ops/features/orb.py `orb_detect` (:719-852) and
its helpers: both pyramid front ends (the flat pyramid K1, :741-752, and
the serial packed pyramid K7, :753-770), the resize chain (:771-787) for
shapes neither kernel takes, and the fused FAST+NMS+select kernel K4
(:790-811) where every level keeps one keypoint a cell. The reference
picks its front end with process-wide gates (PISLAM_ORB_FLAT,
PISLAM_PALLAS_EXTRACT); here the pyramid is the `pyramid` argument, and
K4 takes the selection wherever it applies (`fused_select_ok`). The
tables (the umax mask, the BRIEF pattern, `_flat_plan`, `_flat_matrices`,
`_binned_tap_indices`; FAST's `_CIRCLE` in fastselect.py) are the port's
own copies.

FAST scores and the patch blur run in f32, as the reference computes
them off the TPU (its bf16 casts at orb.py:182-183 and :548-549 exist
only for the TPU's vector unit), and as its K4 computes them by default.
`orb_detect_batch`, `_detect_flat` and `_brief_binned_dot` are off by
default in the reference and are not ported.

The detector runs in three stages, each a function here, so a caller
can time them apart: `build_pyramid` (K1 or K7), `select_levels` (FAST +
NMS + selection, K4) and `descriptor_tail` (K2 + angle + BRIEF +
truncation).
"""
from __future__ import annotations

import dataclasses
import functools
import math
import os

import numpy as np
import torch

from ...core.device import device_const
from .. import image as im
from . import fastselect, flatpyr, packedpyr
from .fastselect import fast_score_map
from .patchgather import gather_patches

PATCH_SIZE = 31        # FeatureDetectorORB.cpp:106
HALF_PATCH = 15
EDGE_THRESHOLD = 16
_BLUR_R = 3            # BRIEF's pre-blur radius (7x7)
# 18 covers the rotated BRIEF offsets; +_BLUR_R so a gathered raw patch
# carries enough context to blur in-patch
_GATHER_R = 18 + _BLUR_R
_GATHER = 2 * _GATHER_R + 1

_PATTERN = np.load(os.path.join(os.path.dirname(__file__), "orb_pattern.npy"))


def _umax_mask() -> np.ndarray:
    """Circular patch mask with the reference's umax quantization
    (FeatureDetectorORB.cpp:528-545)."""
    hp = HALF_PATCH
    umax = np.zeros(hp + 1, np.int32)
    vmax = int(np.floor(hp * np.sqrt(2.0) / 2 + 1))
    vmin = int(np.ceil(hp * np.sqrt(2.0) / 2))
    for v in range(vmax + 1):
        umax[v] = int(round(np.sqrt(hp * hp - v * v)))
    v0 = 0
    for v in range(hp, vmin - 1, -1):
        while umax[v0] == umax[v0 + 1]:
            v0 += 1
        umax[v] = v0
        v0 += 1
    mask = np.zeros((PATCH_SIZE, PATCH_SIZE), bool)
    for v in range(-hp, hp + 1):
        u_lim = umax[abs(v)]
        mask[v + hp, hp - u_lim:hp + u_lim + 1] = True
    return mask


_CIRC_MASK = _umax_mask()
_IC_U = (np.arange(PATCH_SIZE) - HALF_PATCH)[None, :] * _CIRC_MASK
_IC_V = (np.arange(PATCH_SIZE) - HALF_PATCH)[:, None] * _CIRC_MASK


@dataclasses.dataclass(frozen=True)
class OrbParams:
    n_features: int = 1000
    n_levels: int = 8          # FeatureDetectorORB defaults
    scale_factor: float = 1.2
    ini_threshold: float = 20.0
    min_threshold: float = 7.0
    cell: int = 32             # selection grid cell (px)
    # BRIEF rotation quantized to `angle_bins` steps (30 = 12 degrees);
    # 0 rotates each keypoint's pattern by its own angle
    angle_bins: int = 30

    def features_per_level(self):
        """Geometric allocation (FeatureDetectorORB.cpp:497-516)."""
        inv = 1.0 / self.scale_factor
        n = self.n_features * (1 - inv) / (1 - inv ** self.n_levels)
        out = []
        acc = 0
        for i in range(self.n_levels - 1):
            k = int(round(n * inv ** i))
            out.append(k)
            acc += k
        out.append(max(self.n_features - acc, 0))
        return out


# ---------------------------------------------------------------------------
# FAST + NMS + selection
# ---------------------------------------------------------------------------

def _per_cell_quota(shape, k: int, cell: int) -> int:
    ncy, ncx = -(-shape[0] // cell), -(-shape[1] // cell)
    return max(1, min(cell * cell, int(np.ceil(2.0 * k / (ncy * ncx)))))


def _topk(v, k: int, dim: int = -1):
    """lax.top_k's order: descending, ties by lower index (a stable sort)."""
    vals, idx = torch.sort(v, dim=dim, descending=True, stable=True)
    return vals.narrow(dim, 0, k), idx.narrow(dim, 0, k)


def _topk_flat(flat_v, flat_y, flat_x, k: int):
    v, idx = _topk(flat_v, min(k, flat_v.shape[0]))
    y = flat_y[idx]
    x = flat_x[idx]
    valid = v > 0
    if v.shape[0] < k:
        pad = k - v.shape[0]
        v = torch.nn.functional.pad(v, (0, pad))
        y = torch.nn.functional.pad(y, (0, pad))
        x = torch.nn.functional.pad(x, (0, pad))
        valid = torch.nn.functional.pad(valid, (0, pad))
    return torch.stack([x, y], -1).to(torch.int32), v, valid


def select_keypoints(score, k: int, cell: int, min_threshold: float,
                     border: int = EDGE_THRESHOLD):
    """Per-cell top-k then global top-k over a dense score map.
    Returns (xy [k, 2] int32, response [k], valid [k])."""
    H, W = score.shape
    dev = score.device
    s = fastselect.suppress(score, min_threshold, border)
    ncy, ncx = -(-H // cell), -(-W // cell)
    per_cell = _per_cell_quota((H, W), k, cell)
    if per_cell == 1:
        return _topk_winners(*fastselect.cell_winners(s, cell), cell, k)
    sp = torch.nn.functional.pad(s, (0, ncx * cell - W, 0, ncy * cell - H))
    cells = sp.reshape(ncy, cell, ncx, cell).permute(0, 2, 1, 3)
    cells = cells.reshape(ncy * ncx, cell * cell)
    cv, ci = _topk(cells, per_cell, dim=1)             # [ncells, per_cell]
    cid = torch.arange(ncy * ncx, device=dev)[:, None]
    gy = (cid // ncx) * cell + ci // cell
    gx = (cid % ncx) * cell + ci % cell
    return _topk_flat(cv.reshape(-1), gy.reshape(-1), gx.reshape(-1), k)


def _topk_winners(cv2d, ci2d, cell: int, k: int):
    """The global top-k of per-cell winners (orb.py:806-811)."""
    wp = ci2d.shape[1] * cell
    return _topk_flat(cv2d.reshape(-1), (ci2d // wp).reshape(-1),
                      (ci2d % wp).reshape(-1), k)


# ---------------------------------------------------------------------------
# the flat pyramid layout (a copy of the reference's plan and matrices)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class _FlatPlan:
    shapes: tuple          # ((lh, lw), ...) per level
    bases: tuple           # packed row base of each level block
    block_rows: tuple      # rows per level block (cell multiples)
    wp: int                # packed lane count
    cell: int              # selection cell == top row pad
    pad_left: int          # lane pad before each level's interior
    total_rows: int


def _ceil_to(x: int, m: int) -> int:
    return -(-x // m) * m


@functools.lru_cache(maxsize=16)
def _flat_plan(h: int, w: int, n_levels: int, scale_factor: float,
               cell: int) -> _FlatPlan | None:
    """Packed layout: each level block is [cell + ceil(lh+r, align), wp]
    with the level's pixels at rows [base+cell, base+cell+lh), lanes
    [pad_left, pad_left+lw), surrounded by >= _GATHER_R edge-clamped
    context."""
    if cell < _GATHER_R or cell % 8:
        return None
    shapes = []
    for lvl in range(n_levels):
        s = scale_factor ** lvl
        shapes.append((max(1, int(round(h / s))) if lvl else h,
                       max(1, int(round(w / s))) if lvl else w))
    align = 128 if 128 % cell == 0 else cell
    pad_left = 128 if align == 128 else cell
    wp = _ceil_to(pad_left + w + _GATHER_R, align)
    bases, blocks, rows = [], [], 0
    for lh, lw in shapes:
        blocks.append(_ceil_to(cell + lh + _GATHER_R, align))
        bases.append(rows)
        rows += blocks[-1]
    return _FlatPlan(tuple(shapes), tuple(bases), tuple(blocks), wp,
                     cell, pad_left, rows)


@functools.lru_cache(maxsize=16)
def _flat_matrices(h: int, w: int, n_levels: int, scale_factor: float,
                   cell: int):
    """Per-level (row [block_rows_l, h], col [wp, w]) float32 matrices: the
    float64-composed bilinear chain with the block's edge-clamp pad folded
    in. Level 0 is None (a plain edge pad is exact)."""
    plan = _flat_plan(h, w, n_levels, scale_factor, cell)
    rowacc = np.eye(h, dtype=np.float64)
    colacc = np.eye(w, dtype=np.float64)
    mats = [None]
    for lvl in range(1, n_levels):
        (ph, pw), (lh, lw) = plan.shapes[lvl - 1], plan.shapes[lvl]
        rowacc = np.asarray(im._resize_matrix(ph, lh), np.float64) @ rowacc
        colacc = np.asarray(im._resize_matrix(pw, lw), np.float64) @ colacc
        mr = np.zeros((plan.block_rows[lvl], h), np.float64)
        for t in range(plan.block_rows[lvl]):
            mr[t] = rowacc[min(max(t - cell, 0), lh - 1)]
        mc = np.zeros((plan.wp, w), np.float64)
        for t in range(plan.pad_left + lw + _GATHER_R):
            mc[t] = colacc[min(max(t - plan.pad_left, 0), lw - 1)]
        mats.append((mr.astype(np.float32), mc.astype(np.float32)))
    return tuple(mats)


# ---------------------------------------------------------------------------
# descriptors
# ---------------------------------------------------------------------------

def ic_angle(patches31):
    """Intensity-centroid orientation over the umax circle
    (FeatureDetectorORB.cpp:155-183). patches31: [N, 31, 31]."""
    dev = patches31.device
    u = device_const("ic_u", dev,
                     lambda: torch.from_numpy(_IC_U.astype(np.float32)))
    v = device_const("ic_v", dev,
                     lambda: torch.from_numpy(_IC_V.astype(np.float32)))
    m10 = torch.sum(patches31 * u, (-2, -1))
    m01 = torch.sum(patches31 * v, (-2, -1))
    return torch.atan2(m01, m10)


def _blur_patches(patches):
    """7-tap separable Gaussian (sigma 2) over gathered [N, G, G] patches
    with edge padding — the in-patch equivalent of the reference's
    pre-BRIEF level blur (FeatureDetectorORB.cpp:733-740), in f32."""
    taps = [float(v) for v in im.gaussian_kernel1d(2.0, _BLUR_R)]
    x = patches
    for ax in (1, 2):
        g = x.shape[ax]
        xp = im._pad_axis(x, ax, _BLUR_R, _BLUR_R, "edge")
        acc = None
        for i, w in enumerate(taps):
            t = w * xp.narrow(ax, i, g)
            acc = t if acc is None else acc + t
        x = acc
    return x


@functools.lru_cache(maxsize=8)
def _binned_tap_indices(bins: int) -> np.ndarray:
    """[bins, 512] flat patch indices: the reference's rounded rotated
    pattern offsets evaluated at each bin's center angle."""
    out = np.zeros((bins, 512), np.int32)
    for bi in range(bins):
        th = 2.0 * np.pi * bi / bins
        a, b = np.cos(th), np.sin(th)
        px = np.concatenate([_PATTERN[:, 0], _PATTERN[:, 2]]).astype(
            np.float64)
        py = np.concatenate([_PATTERN[:, 1], _PATTERN[:, 3]]).astype(
            np.float64)
        x = np.round(px * a - py * b).astype(np.int32) + _GATHER_R
        y = np.round(px * b + py * a).astype(np.int32) + _GATHER_R
        out[bi] = y * _GATHER + x
    return out


def _brief_binned_select(patches, angles, bins: int):
    """Each keypoint's 512 taps at its angle bin's rotated pattern, read
    from the blurred patch rounded to bf16 (the reference's one-hot
    matmuls select exactly those bf16 values, orb.py:676-694)."""
    n = patches.shape[0]
    flat = patches.reshape(n, _GATHER * _GATHER).to(torch.bfloat16)
    bi = torch.remainder(
        torch.round(angles * (bins / (2.0 * math.pi))).to(torch.int32),
        bins)
    taps_idx = device_const(
        ("brief_taps", bins), patches.device,
        lambda: torch.from_numpy(_binned_tap_indices(bins)).to(torch.int64))
    taps = torch.gather(flat, 1, taps_idx[bi.to(torch.int64)])
    return (taps[:, :256] < taps[:, 256:]).to(torch.uint8)


def _brief_continuous(patches, angles):
    """Each keypoint's taps at its own angle: the reference's exact
    round-rotated offsets x' = round(px*a - py*b), y' = round(px*b +
    py*a), a = cos, b = sin, in f32 (orb.py:580-594), read from the f32
    blurred patch by a gather."""
    n = patches.shape[0]
    pat = device_const("brief_pattern", patches.device,
                       lambda: torch.from_numpy(_PATTERN.astype(np.float32)))
    a = torch.cos(angles)[:, None]
    b = torch.sin(angles)[:, None]
    px = torch.cat([pat[:, 0], pat[:, 2]])[None]
    py = torch.cat([pat[:, 1], pat[:, 3]])[None]
    x = torch.round(px * a - py * b).to(torch.int64) + _GATHER_R
    y = torch.round(px * b + py * a).to(torch.int64) + _GATHER_R
    flat = patches.reshape(n, _GATHER * _GATHER)
    taps = torch.gather(flat, 1, y * _GATHER + x)
    return (taps[:, :256] < taps[:, 256:]).to(torch.uint8)


def brief_descriptors(patches, angles, angle_bins: int = 30):
    """Rotated 256-bit BRIEF (computeOrbDescriptor,
    FeatureDetectorORB.cpp:186-226): with angle_bins > 0 the rotation is
    quantized to that many steps, with 0 every keypoint's pattern is
    rotated by its own angle. patches: [N, G, G] blurred patches; angles:
    [N] radians. Returns [N, 256] uint8 in {0, 1}."""
    if angle_bins <= 0:
        return _brief_continuous(patches, angles)
    return _brief_binned_select(patches, angles, angle_bins)


def pack_bits(desc_bits):
    """[N, 256] {0,1} -> [N, 32] uint8 (bit j of byte i is pair 8*i+j)."""
    n = desc_bits.shape[0]
    b = desc_bits.reshape(n, 32, 8).to(torch.int32)
    w = (2 ** torch.arange(8, device=desc_bits.device)).to(torch.int32)
    return torch.sum(b * w, -1).to(torch.uint8)


# ---------------------------------------------------------------------------
# the detector, in three stages
# ---------------------------------------------------------------------------

PYRAMIDS = ("flat", "packed")


def fused_select_ok(shapes, params: OrbParams) -> bool:
    """The reference's `fused_ok` (orb.py:790-793): K4 takes the selection
    where every level keeps one keypoint a cell."""
    return params.cell % 8 == 0 and all(
        _per_cell_quota(shape, max(q, 1), params.cell) == 1
        for shape, q in zip(shapes, params.features_per_level()))


def build_pyramid(img, params: OrbParams, pyramid: str = "flat"):
    """Stage 1. Returns (packed [R, Wp] f32, level views, per-level
    packed-coordinate offsets (dx, dy) of each level's pixel (0, 0)).

    pyramid "flat": K1, every level from level 0 (the reference's default
    front end); "packed": K7, level l from level l-1 (the reference with
    PISLAM_ORB_FLAT=0 and the extraction kernels on). Either takes the
    resize chain for shapes outside its kernel's regime."""
    if pyramid not in PYRAMIDS:
        raise ValueError(f"pyramid must be one of {PYRAMIDS}, not "
                         f"{pyramid!r}")
    H, W = img.shape
    n_levels, sf, cell = params.n_levels, params.scale_factor, params.cell
    r = _GATHER_R
    if pyramid == "flat" and flatpyr.flat_pyramid_available(
            H, W, n_levels, sf, cell):
        plan = _flat_plan(H, W, n_levels, sf, cell)
        packed = flatpyr.build_flat_pyramid(img, n_levels, sf, cell)
        pl_ = plan.pad_left
        views = [packed[b + cell:b + cell + lh, pl_:pl_ + lw]
                 for b, (lh, lw) in zip(plan.bases, plan.shapes)]
        offs = [(pl_, b + cell) for b in plan.bases]
        return packed, views, offs
    if pyramid == "packed" and packedpyr.pyramid_available(
            H, W, n_levels, sf, r):
        plan = packedpyr.pyramid_plan(H, W, n_levels, sf, r)
        packed = packedpyr.build_packed_pyramid(img, n_levels, sf, r)
        views = [packed[b + r:b + r + lh, r:r + lw]
                 for b, (lh, lw) in zip(plan.bases, plan.shapes)]
        offs = [(r, b + r) for b in plan.bases]
        return packed, views, offs
    # resize chain (shapes outside the kernels' regimes): level l from
    # level l-1, each level edge-padded by the gather radius into one tall
    # buffer
    views = [img]
    for lvl in range(1, n_levels):
        s = sf ** lvl
        lh, lw = max(1, int(round(H / s))), max(1, int(round(W / s)))
        views.append(im.resize_bilinear(views[-1][..., None],
                                        (lh, lw))[..., 0])
    blocks, offs, row_off = [], [], 0
    for v in views:
        blk = im._pad_axis(im._pad_axis(v, 0, r, r, "edge"), 1, r, r, "edge")
        blk = torch.nn.functional.pad(blk, (0, W + 2 * r - blk.shape[1]))
        blocks.append(blk)
        offs.append((r, row_off + r))
        row_off += blk.shape[0]
    return torch.cat(blocks, 0), views, offs


def select_levels(packed, views, offs, params: OrbParams):
    """Stage 2: FAST + NMS + per-cell selection on every level of
    `build_pyramid`'s output. Returns per-level (xy [k, 2] int32 level
    coords, response, valid).

    Where `fused_select_ok`, one K4 launch finds every level's cell
    winners in place in the packed buffer and the reference's tail takes
    each level's top k (orb.py:790-811); elsewhere each level goes through
    fast_score_map and select_keypoints. The two give the same keypoints."""
    quotas = [max(q, 1) for q in params.features_per_level()]
    shapes = [tuple(v.shape) for v in views]
    if fused_select_ok(shapes, params):
        winners = fastselect.fast_cell_winners(
            packed, offs, shapes, params.cell, params.min_threshold,
            EDGE_THRESHOLD)
        return [_topk_winners(cv2d, ci2d, params.cell, k)
                for (cv2d, ci2d), k in zip(winners, quotas)]
    return [select_keypoints(fast_score_map(view), k, params.cell,
                             params.min_threshold)
            for view, k in zip(views, quotas)]


def descriptor_tail(picks, packed, offs, params: OrbParams):
    """Stage 3: patch gather over the packed pyramid (K2), IC angle, blur
    + BRIEF, strongest-first truncation to n_features."""
    dev = packed.device
    feats = {k: [] for k in ("xy", "response", "octave", "size", "valid")}
    pxy = []
    for lvl, ((xy, resp, valid), off) in enumerate(zip(picks, offs)):
        scale = params.scale_factor ** lvl
        k = xy.shape[0]
        pxy.append(xy + device_const(
            ("level_off", off), dev,
            lambda: torch.tensor([off], dtype=torch.int32)))
        feats["xy"].append(xy.to(torch.float32) * scale)
        feats["response"].append(resp)
        feats["octave"].append(torch.full((k,), lvl, dtype=torch.int32,
                                          device=dev))
        feats["size"].append(torch.full((k,), PATCH_SIZE * scale,
                                        dtype=torch.float32, device=dev))
        feats["valid"].append(valid)
    feats = {kk: torch.cat(v, 0) for kk, v in feats.items()}
    r = _GATHER_R
    pat = gather_patches(packed, torch.cat(pxy, 0), r)      # [N0, G, G]
    d = r - HALF_PATCH
    feats["angle"] = ic_angle(pat[:, d:d + PATCH_SIZE, d:d + PATCH_SIZE])
    feats["desc"] = brief_descriptors(_blur_patches(pat), feats["angle"],
                                      params.angle_bins)
    key = torch.where(feats["valid"], -feats["response"],
                      torch.full_like(feats["response"], float("inf")))
    keep = torch.argsort(key, stable=True)[:params.n_features]
    return {kk: v[keep] for kk, v in feats.items()}


def orb_detect(img, params: OrbParams = OrbParams(), pyramid: str = "flat"):
    """Full extractor. img: [H, W] grayscale float32 (0..255) on the
    device the caller chose. pyramid: "flat" (K1) or "packed" (K7), see
    `build_pyramid`; the selection takes K4 where it applies, see
    `select_levels`.

    Returns a dict with N = params.n_features rows: xy [N, 2] float32
    level-0 pixel coords; response [N]; angle [N] rad; octave [N] int32;
    size [N]; desc [N, 256] uint8 bit-planes; valid [N] bool."""
    img = img.to(torch.float32)
    packed, views, offs = build_pyramid(img, params, pyramid)
    picks = select_levels(packed, views, offs, params)
    return descriptor_tail(picks, packed, offs, params)
