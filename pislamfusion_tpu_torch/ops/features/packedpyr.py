"""K7: the packed serial ORB pyramid, level l from level l-1.

Replaces pislamfusion_tpu/ops/features/pyramid_pallas.py
`build_packed_pyramid` (its `pallas_call` at :279), which orb_detect runs
when the flat pyramid is off and the extraction kernels are on
(orb.py:753-760); the port takes it with `orb_detect(...,
pyramid="packed")`.

Function: one [total_rows, wpl] float32 buffer (`pyramid_plan`; the
layout, the plan and `pyramid_available` are copies of the reference's
`_level_shapes`, `_make_plan` and `_tables`). Level 0's block is the image
edge-padded by r; each level l >= 1 is the bilinear resize of level l-1
(`image._resize_matrix`), edge-padded by r, that is the product
mrow_l @ src @ mlane_l^T of the pad-clamp matrices (`_pad_clamp_matrix`)
with level l-1's raw pixels. Everything outside each level's (lh + 2r,
lw + 2r) block is 0 (the TPU kernel leaves stale tile contents there,
which nothing reads).

On the H100 the function is bound by bytes: at 1080p with 8 levels and
r = 21 it reads an 8.3 MB image and writes a 48.2 MB buffer (>= 17 us at
3.35 TB/s), against ~4 multiply-adds an output pixel. The TPU kernel runs
dense 128x384 band blocks through the matrix unit; the matrices have at
most two nonzeros a row, so the CUDA kernel (`csrc/packedpyr.cu`) gives
each output pixel one thread that sums its row taps, then its column
taps, from host tables of each row's nonzero span (the float64 matrices
cast to float32, as the reference's `_tables` casts them), one launch a
level since level l reads level l-1.

The taps are summed in order as a chain of fused multiply-adds, each
rounded once: that is how the reference's dense products contract their
rows (a zero weight adds exactly 0), and the port's function equals the
interpreted TPU kernel's bit for bit with it (separately rounded
products and sums were ~6 ulps away by level 3, enough to move a
near-tie FAST keypoint). The kernel uses `__fmaf_rn`; the plain version
computes each fused multiply-add exactly in float64 (`_fma`), so the two
are equal.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools

import numpy as np
import torch

from ... import _build
from .. import image as im

_BLK = 128
_RKL = 384      # the TPU kernel's source window (pyramid_pallas.py:41-46)
_NJMAX = 16


def _ceil_to(x: int, m: int) -> int:
    return -(-x // m) * m


@dataclasses.dataclass(frozen=True)
class PyrPlan:
    shapes: tuple          # ((lh, lw), ...) per level
    r: int                 # gather radius (edge pad)
    wpl: int               # packed lane count
    bases: tuple           # packed row base per level (128-mult)
    blk_rows: tuple        # padded rows per level block
    total_rows: int
    nj: tuple              # lane tiles per level (levels >= 1)
    ntiles: tuple          # row tiles per level (levels >= 1)


def _level_shapes(h: int, w: int, n_levels: int, scale_factor: float):
    out = []
    for lvl in range(n_levels):
        s = scale_factor ** lvl
        out.append((max(1, int(round(h / s))) if lvl else h,
                    max(1, int(round(w / s))) if lvl else w))
    return tuple(out)


@functools.lru_cache(maxsize=16)
def _make_plan(h: int, w: int, n_levels: int, scale_factor: float,
               r: int) -> PyrPlan | None:
    shapes = _level_shapes(h, w, n_levels, scale_factor)
    wpl = _ceil_to(w + 2 * r, _BLK)
    if (wpl < _RKL or _ceil_to(h + 2 * r, _BLK) < _RKL
            or scale_factor > 1.9):
        return None
    bases, blk_rows, row = [], [], 0
    for lh, lw in shapes:
        bases.append(row)
        blk_rows.append(_ceil_to(lh + 2 * r, _BLK))
        row += blk_rows[-1]
    nj = tuple(-(-(lw + 2 * r) // _BLK) for lh, lw in shapes[1:])
    ntiles = tuple(blk_rows[i + 1] // _BLK for i in range(n_levels - 1))
    if max(nj) > _NJMAX:
        return None
    row = max(row, bases[n_levels - 2] + _RKL)
    return PyrPlan(shapes, r, wpl, tuple(bases), tuple(blk_rows), row,
                   nj, ntiles)


def _pad_clamp_matrix(resize: np.ndarray, out_len: int, r: int,
                      src_off: int, src_cols: int) -> np.ndarray:
    """[out_len + 2r, src_cols]: out row t -> resize row clip(t - r, 0,
    out_len - 1), source col q -> q + src_off."""
    on, n = resize.shape
    assert on == out_len
    rows = out_len + 2 * r
    m = np.zeros((rows, src_cols), np.float64)
    for t in range(rows):
        c = min(max(t - r, 0), out_len - 1)
        m[t, src_off:src_off + n] = resize[c]
    return m


def _fits_windows(m: np.ndarray, n_blocks: int, src_padded: int) -> bool:
    """The reference's `_tile_blocks` check: every 128-row tile's nonzero
    columns fit one _RKL window starting at a 128-aligned column."""
    mp = np.zeros((n_blocks * _BLK, max(src_padded, _RKL)), np.float64)
    mp[:m.shape[0], :m.shape[1]] = m
    for i in range(n_blocks):
        nz = np.nonzero(mp[i * _BLK:(i + 1) * _BLK].any(0))[0]
        if nz.size:
            s = min(max((nz[0] // _BLK) * _BLK, 0),
                    max(src_padded - _RKL, 0))
            if nz[-1] >= s + _RKL:
                return False
    return True


def _spans(m: np.ndarray, off: int):
    """Per row of a [R, n] float64 matrix: (start - off, length) of its
    nonzero span and the span's weights cast to float32, [R, k]."""
    nzm = m != 0
    any_ = nzm.any(1)
    start = np.where(any_, nzm.argmax(1), 0)
    last = np.where(any_, m.shape[1] - 1 - nzm[:, ::-1].argmax(1), -1)
    length = (last - start + 1).clip(0)
    k = int(length.max())
    wts = np.zeros((m.shape[0], k), np.float32)
    for j in range(k):
        rows = np.nonzero(j < length)[0]
        wts[rows, j] = m[rows, start[rows] + j]
    return ((start - off).clip(0).astype(np.int32), length.astype(np.int32),
            wts)


@dataclasses.dataclass(frozen=True)
class PackedTables:
    """Per level l >= 1 (index l - 1): the spans of its pad-clamp
    matrices in level l-1's raw pixel coordinates. row_*[l-1] has lh + 2r
    rows, col_*[l-1] lw + 2r."""
    plan: PyrPlan
    row_start: tuple
    row_len: tuple
    row_w: tuple
    col_start: tuple
    col_len: tuple
    col_w: tuple


@functools.lru_cache(maxsize=16)
def packed_tables(h, w, n_levels, scale_factor, r) -> PackedTables | None:
    """The plan and the spans, or None where the reference has no plan
    (a tile's band outside its window included)."""
    plan = _make_plan(h, w, n_levels, scale_factor, r)
    if plan is None:
        return None
    rows, cols = [], []
    for l in range(1, n_levels):
        (ph, pw), (lh, lw) = plan.shapes[l - 1], plan.shapes[l]
        mrow = _pad_clamp_matrix(np.asarray(im._resize_matrix(ph, lh),
                                            np.float64), lh, r, r,
                                 plan.blk_rows[l - 1])
        mlane = _pad_clamp_matrix(np.asarray(im._resize_matrix(pw, lw),
                                             np.float64), lw, r, r,
                                  plan.wpl)
        if not (_fits_windows(mrow, plan.blk_rows[l] // _BLK,
                              plan.blk_rows[l - 1])
                and _fits_windows(mlane, plan.nj[l - 1], plan.wpl)):
            return None
        rows.append(_spans(mrow, r))
        cols.append(_spans(mlane, r))
    return PackedTables(plan, *(tuple(t[i] for t in rows) for i in range(3)),
                        *(tuple(t[i] for t in cols) for i in range(3)))


def pyramid_available(h: int, w: int, n_levels: int, scale_factor: float,
                      r: int) -> bool:
    """The reference's regime (pyramid_pallas.py:173): a plan exists and
    every tile's band fits its window."""
    if n_levels < 2:
        return False
    return packed_tables(h, w, n_levels, scale_factor, r) is not None


def pyramid_plan(h: int, w: int, n_levels: int, scale_factor: float,
                 r: int) -> PyrPlan:
    return packed_tables(h, w, n_levels, scale_factor, r).plan


@functools.lru_cache(maxsize=8)
def _device_tables(h, w, n_levels, scale_factor, r, device: str):
    """The spans, uploaded once per shape and device: per level l >= 1,
    {name: tensor}."""
    t = packed_tables(h, w, n_levels, scale_factor, r)
    names = ("row_start", "row_len", "row_w", "col_start", "col_len",
             "col_w")
    return [{k: torch.from_numpy(np.ascontiguousarray(getattr(t, k)[i]))
             .to(device) for k in names} for i in range(n_levels - 1)]


def _fma(a, b, c):
    """a * b + c of float32 tensors rounded once to float32, as
    `__fmaf_rn` rounds it. The product is exact in float64; the sum is
    rounded to odd in float64 (TwoSum gives its exact error), from which
    the rounding to float32 is correct."""
    p = a.double() * b.double()
    c = c.double()
    s = c + p
    v = s - c
    err = (c - (s - v)) + (p - v)
    even = (s.view(torch.int64) & 1) == 0
    toward = torch.where(err > 0, torch.full_like(s, float("inf")),
                         torch.full_like(s, float("-inf")))
    s = torch.where((err != 0) & even, torch.nextafter(s, toward), s)
    return s.float()


def _tap_sum(w, start, src, axis: int):
    """sum_k w[:, k] * src[start + k] along `axis` of src: a chain of
    fused multiply-adds over the taps in order, from 0. Taps past a span
    have weight 0 and add exactly 0."""
    n = src.shape[axis]
    acc = None
    for k in range(w.shape[1]):
        idx = (start + k).clamp(max=n - 1).to(torch.int64)
        if axis == 0:
            wk, xk = w[:, k:k + 1], src[idx, :]
        else:
            wk, xk = w[:, k][None, :], src[:, idx]
        acc = _fma(wk, xk, torch.zeros_like(xk) if acc is None else acc)
    return acc


def build_packed_pyramid_plain(img, n_levels: int, scale_factor: float,
                               r: int):
    """Plain PyTorch version: per level the row taps, then the column
    taps, each a chain of fused multiply-adds, as the kernel sums them."""
    h, w = img.shape
    t = packed_tables(h, w, n_levels, scale_factor, r)
    plan = t.plan
    out = torch.zeros((plan.total_rows, plan.wpl), dtype=torch.float32,
                      device=img.device)
    iy = (torch.arange(h + 2 * r, device=img.device) - r).clamp(0, h - 1)
    ix = (torch.arange(w + 2 * r, device=img.device) - r).clamp(0, w - 1)
    out[:h + 2 * r, :w + 2 * r] = img[iy[:, None], ix[None, :]]
    src = img
    for l, d in enumerate(_device_tables(h, w, n_levels, scale_factor, r,
                                         str(img.device)), 1):
        lh, lw = plan.shapes[l]
        t1 = _tap_sum(d["row_w"], d["row_start"], src, 0)
        blk = _tap_sum(d["col_w"], d["col_start"], t1, 1)
        b = plan.bases[l]
        out[b:b + lh + 2 * r, :lw + 2 * r] = blk
        src = blk[r:r + lh, r:r + lw]
    return out


def build_packed_pyramid(img, n_levels: int, scale_factor: float, r: int):
    """img: [H, W] float32. Returns the packed [plan.total_rows, plan.wpl]
    float32 buffer of `pyramid_plan`. Check pyramid_available first. CPU
    tensors take the plain version; CUDA tensors launch the kernel once a
    level l >= 1 (the first launch also writes level 0's block)."""
    if img.device.type == "cpu":
        return build_packed_pyramid_plain(img, n_levels, scale_factor, r)
    if img.device.type != "cuda":
        raise ValueError(f"build_packed_pyramid: unsupported device "
                         f"{img.device}")
    if img.dtype != torch.float32 or img.ndim != 2:
        raise ValueError("build_packed_pyramid: img must be float32 [H, W]")
    h, w = img.shape
    if not pyramid_available(h, w, n_levels, scale_factor, r):
        raise ValueError(f"build_packed_pyramid: {h}x{w} with {n_levels} "
                         "levels is outside the kernel's regime")
    img = img.contiguous()
    t = packed_tables(h, w, n_levels, scale_factor, r)
    plan = t.plan
    tabs = _device_tables(h, w, n_levels, scale_factor, r, str(img.device))
    out = torch.empty((plan.total_rows, plan.wpl), dtype=torch.float32,
                      device=img.device)
    lib = _build.load("packedpyr")
    fn = lib.packedpyr_level
    fn.restype = ctypes.c_int
    P, I = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [P, I, P, P, P, I, P, P, P, I, I, I, I, P, I, I, I, I, I,
                   I, I, I, P]
    wpl, fsize = plan.wpl, out.element_size()
    tail = sum(plan.blk_rows)
    with torch.cuda.device(img.device):
        stream = torch.cuda.current_stream(img.device).cuda_stream
        for l, d in enumerate(tabs, 1):
            lh, lw = plan.shapes[l]
            if l == 1:
                src, ld = img.data_ptr(), w
            else:
                src = out.data_ptr() + ((plan.bases[l - 1] + r) * wpl
                                        + r) * fsize
                ld = wpl
            err = fn(src, ld, d["row_start"].data_ptr(),
                     d["row_len"].data_ptr(), d["row_w"].data_ptr(),
                     d["row_w"].shape[1],
                     d["col_start"].data_ptr(), d["col_len"].data_ptr(),
                     d["col_w"].data_ptr(), d["col_w"].shape[1], lh, lw, r,
                     out.data_ptr(), wpl, plan.bases[l], plan.blk_rows[l],
                     # the first launch also writes level 0's block and
                     # the zero rows after the last block
                     plan.blk_rows[0] if l == 1 else 0, h, w,
                     tail if l == 1 else plan.total_rows,
                     plan.total_rows, stream)
            _build.check(err, "packedpyr")
            build_packed_pyramid.launches += 1
    return out


build_packed_pyramid.launches = 0
