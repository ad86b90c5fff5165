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
3.35 TB/s), 42 % of it the zeros around the blocks, against ~4
multiply-adds an output pixel. The TPU kernel runs dense 128x384 band
blocks through the matrix unit, a grid step a level; the matrices have at
most two nonzeros a row, so the CUDA kernel (`csrc/packedpyr.cu`) walks
host tables of each row's nonzero span (the float64 matrices cast to
float32, as the reference's `_tables` casts them). One launch writes the
whole buffer (`kernel_plan`): a persistent grid claims, in the plan's
order, level tiles (a band of output rows by a run of columns: the
source window and span tables staged in shared memory, each row-pass
value t1 computed once there, then the column chains), bands of level
0's edge pad and rectangles of zeros. A tile waits on counters of the
tiles whose pixels it reads, so the levels overlap; from level
K7_FUSE_FROM on, a tile computes the level-(l-1) window it reads from
level l-2 on the way (depth 2), which shortens the chain of dependent
levels.

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
from ..stencil import SM_BLOCK_RESERVED, SM_SMEM, SM_THREADS

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


# ---------------------------------------------------------------------------
# the kernel's launch plan
# ---------------------------------------------------------------------------

K7_THREADS = 256
K7_BLOCKS = 6                   # resident blocks an SM (csrc BLOCKS)
K7_SMEM = SM_SMEM // K7_BLOCKS - SM_BLOCK_RESERVED
K7_TILES = ((8, 256), (8, 128), (4, 128))      # rows x columns, levels 1-2
K7_FUSED_TILES = ((8, 128), (4, 128))          # levels from K7_FUSE_FROM
K7_FUSE_FROM = 5                # levels that compute from level l-2
K7_FILL_BYTES = 32 << 10        # about what a pad or zero item writes
K7_MAX_LEVELS = 16
K7_TAPS = 2                     # taps a span holds at most (bilinear)
K7_RECORD = 20                  # int32 an item: five int4
KIND_ZERO, KIND_PAD, KIND_TILE = 0, 1, 2


@dataclasses.dataclass(frozen=True)
class K7Plan:
    """K7's launch plan for one shape.

    records: [n_items, K7_RECORD] int32 in ticket order, five int4 an item:
      zero   (0, 0, first packed row, rows), (first column, columns, 0, 0)
      pad    (1, 0, first packed row, rows), (0, columns, 0, 0)
      tile   (2, level l, first output row t0, rows),
             (first column u0, columns, raw column sc0, columns sc),
             (raw row sr0, rows sr, own counter or 0, depth),
             (first counter waited on, its bands, its runs, runs a band),
             (raw row, rows, raw column, columns of level l-2)
    A tile of depth 1 reads level l-1's raw pixels [sr0, sr0 + sr) x
    [sc0, sc0 + sc); one of depth 2 computes those in shared memory from
    level l-2's raw window in its fifth int4 (the same arithmetic as the
    level-(l-1) tiles, so the same bits) and waits on level l-2's tiles.
    Columns of pad and zero items are multiples of 4 from a multiple of
    4; a tile's columns past lw + 2r (up to a multiple of 4) are 0.
    levels: [K7_MAX_LEVELS, 8] int32, per level l >= 1: first packed row,
    lh + 2r, lw + 2r, first row in rtab, first column in ctab, packed row
    and column of level l-1's raw pixel (0, 0).
    rtab / ctab: [rows / columns, 4] int32, a span's start, length and
    two weights' bits (0 past the length). counters: 2 + one a tile
    (ticket, blocks done, then every level's tiles band by band, run by
    run, from `bands[l - 1]` = (first counter, bands, runs a band, tile
    rows, tile columns, depth)): a tile counts its own to 1 when it is
    done, unless no tile waits on its level (own counter 0).
    tile / fused: the tiles of depth 1 and 2; pitch / pitch_f: the floats
    a row of their shared buffers (`_buffers`); rows_a: the rows of a
    depth-2 tile's first buffer; lgcg: log2 of the 128-column groups of
    the column passes (depth 1, depth 2, the step in between); tables:
    the float offset of the staged span tables in shared memory and their
    row entries (the column entries follow)."""
    tile: tuple
    fused: tuple
    pitch: int
    pitch_f: int
    rows_a: int
    lgcg: tuple
    tables: tuple
    smem: int
    levels: np.ndarray
    rtab: np.ndarray
    ctab: np.ndarray
    records: np.ndarray
    bands: tuple
    n_counters: int

    @property
    def blocks_per_sm(self) -> int:
        return min(SM_THREADS // K7_THREADS,
                   SM_SMEM // (self.smem + SM_BLOCK_RESERVED))


def _span_table(start, length, wts) -> np.ndarray:
    tab = np.zeros((start.size, 4), np.int32)
    tab[:, 0], tab[:, 1] = start, length
    tab[:, 2:2 + wts.shape[1]] = np.ascontiguousarray(wts).view(np.int32)
    return tab


def _fills(kind: int, row0: int, rows: int, col0: int, cols: int):
    """A rectangle cut by rows into records of about K7_FILL_BYTES."""
    if rows <= 0 or cols <= 0:
        return []
    step = max(1, K7_FILL_BYTES // (4 * cols))
    return [[kind, 0, row0 + a, min(step, rows - a), col0, cols]
            + [0] * (K7_RECORD - 6) for a in range(0, rows, step)]


def _window(t: PackedTables, l: int, t0: int, nr: int, u0: int, nu: int):
    """(sr0, sr, sc0, sc): the raw pixels of level l-1 that level l's rows
    [t0, t0 + nr) and columns [u0, u0 + nu) (those below lw + 2r) read."""
    rs, rl = t.row_start[l - 1][t0:t0 + nr], t.row_len[l - 1][t0:t0 + nr]
    cs, cl = t.col_start[l - 1][u0:u0 + nu], t.col_len[l - 1][u0:u0 + nu]
    sr0, sc0 = int(rs.min()), int(cs.min())
    return sr0, int((rs + rl).max()) - sr0, sc0, int((cs + cl).max()) - sc0


def _level_tiles(t: PackedTables, l: int, tr: int, tc: int, depth: int):
    """Level l's tr x tc tiles, band by band, run by run: (t0, nr, u0, nu,
    band, run, level-(l-1) window, level-(l-2) window or None)."""
    r = t.plan.r
    lh2 = t.row_start[l - 1].size
    lwa = _ceil_to(t.col_start[l - 1].size, 4)
    out = []
    for b, t0 in enumerate(range(0, lh2, tr)):
        for c, u0 in enumerate(range(0, lwa, tc)):
            nr, nu = min(tr, lh2 - t0), min(tc, lwa - u0)
            win = _window(t, l, t0, nr, u0, nu)
            inner = (_window(t, l - 1, win[0] + r, win[1], win[2] + r,
                             win[3]) if depth == 2 else None)
            out.append((t0, nr, u0, nu, b, c, win, inner))
    return out


def _ticket_order(tiles: list, fills: list) -> list:
    """The items in ticket order: the level tiles level by level (so every
    tile comes after the tiles it waits on), the pad and zero items, which
    wait on nothing, spread evenly among them, where they fill the slots
    that the chain's tiles cannot use yet."""
    order = list(tiles)
    step = len(tiles) / max(len(fills), 1)
    for i, f in enumerate(fills):
        order.insert(int(i * step) + i, f)
    return order


def _buffers(xs: list, depth: int, tr: int):
    """(pitch, rows, rows) of the two shared buffers that the tiles xs
    (`_level_tiles`) of a depth and tr rows need: at depth 1 t1, then the
    staged window; at depth 2 A (level l-2's window, then level l-1's)
    and t1 (each step's row pass). (0, 0, 0) for no tiles."""
    if not xs:
        return 0, 0, 0
    if depth == 1:
        return (max(_ceil_to(3 + x[6][3], 4) for x in xs), tr,
                max(x[6][1] for x in xs))
    return (max(max(_ceil_to(3 + x[7][3], 4), _ceil_to(x[6][3], 4))
                for x in xs),
            max(max(x[7][1], x[6][1]) for x in xs),
            max(max(x[6][1], x[1]) for x in xs))


def _lg(n: int) -> int:
    """log2 of the 128-column groups a column pass of n columns takes."""
    return max(0, (-(-n // 128) - 1).bit_length())


@functools.lru_cache(maxsize=16)
def kernel_plan(h: int, w: int, n_levels: int, scale_factor: float,
                r: int) -> K7Plan:
    """K7's launch plan for a shape that `pyramid_available` accepts:
    levels 1 to K7_FUSE_FROM - 1 in tiles of depth 1, the rest of depth 2
    (each kind the largest tile of its list whose shared memory keeps
    K7_BLOCKS blocks an SM), the pad and zero items, the span tables and
    the items' ticket order (`_ticket_order`). Raises ValueError where the
    kernel cannot take the shape (none that pyramid_available accepts)."""
    t = packed_tables(h, w, n_levels, scale_factor, r)
    if t is None:
        raise ValueError(f"build_packed_pyramid: {h}x{w} with {n_levels} "
                         "levels is outside the kernel's regime")
    plan = t.plan
    if n_levels > K7_MAX_LEVELS:
        raise ValueError(f"build_packed_pyramid: the kernel takes at most "
                         f"{K7_MAX_LEVELS} levels, not {n_levels}")
    lens = np.concatenate(t.row_len + t.col_len)
    if lens.min() < 1 or lens.max() > K7_TAPS:
        raise ValueError("build_packed_pyramid: a span of "
                         f"{lens.min()}-{lens.max()} taps")
    deep = range(max(2, K7_FUSE_FROM), n_levels)

    def cut(lvls, tiles_, depth):
        """The largest tile of tiles_ whose shared memory keeps K7_BLOCKS
        blocks an SM, the levels' tiles cut with it and their buffers."""
        for tr, tc in tiles_:
            cut_ = {l: _level_tiles(t, l, tr, tc, depth) for l in lvls}
            buf = _buffers([x for tl in cut_.values() for x in tl], depth,
                           tr)
            if 4 * buf[0] * (buf[1] + buf[2]) <= K7_SMEM:
                return (tr, tc), cut_, buf
        raise ValueError("build_packed_pyramid: no tile fits "
                         f"{K7_SMEM} bytes of shared memory")

    tile, plain, (pitch, _, _) = cut(range(1, min(K7_FUSE_FROM, n_levels)),
                                     K7_TILES, 1)
    fused, deep_cut, (pitch_f, rows_a, _) = cut(deep, K7_FUSED_TILES, 2)
    cuts = {**plain, **deep_cut}
    xs = [x for tl in deep_cut.values() for x in tl]
    lgcg = (_lg(tile[1]), _lg(fused[1]),
            max((_lg(x[6][3]) for x in xs), default=0))
    # the staged span tables after the buffers: a tile's rows and columns
    # (and at depth 2 its level-(l-1) window's), 16 bytes each
    tab_off = max(4 * b[0] * (b[1] + b[2]) for b in (
        _buffers([x for tl in plain.values() for x in tl], 1, tile[0]),
        _buffers(xs, 2, fused[0])))
    tab_rows = max([tile[0]] + [x[1] + x[6][1] for x in xs])
    tab_cols = max([tile[1]] + [x[3] + x[6][3] for x in xs])
    smem = tab_off + 16 * (tab_rows + tab_cols)
    # one counter a tile, level by level, band by band, run by run, from 2
    bands, first = [], 2
    for l in range(1, n_levels):
        tl = cuts[l]
        nb, runs = tl[-1][4] + 1, tl[-1][5] + 1
        tr, tc = tile if l < K7_FUSE_FROM else fused
        bands.append((first, nb, runs, tr, tc, 1 if l < K7_FUSE_FROM else 2))
        first += len(tl)
    # the levels whose tiles some tile waits on: the rest publish nothing
    read = {l - (1 if l < K7_FUSE_FROM else 2) for l in range(2, n_levels)}
    items = []
    for l in range(1, n_levels):
        own, _, runs, _, _, depth = bands[l - 1]
        for j, (t0, nr, u0, nu, b, c, win, inner) in enumerate(cuts[l]):
            rec = [KIND_TILE, l, t0, nr, u0, nu, win[2], win[3], win[0],
                   win[1], own + j if l in read else 0, depth] + [0] * 8
            src, lsrc = (inner, l - 2) if depth == 2 else (win, l - 1)
            if depth == 2:
                rec[16:20] = inner
            if lsrc >= 1:   # the tiles of level lsrc whose pixels it reads
                pf, _, pruns, ptr, ptc, _ = bands[lsrc - 1]
                lo, hi = (src[0] + r) // ptr, (src[0] + src[1] - 1 + r) // ptr
                clo = (src[2] + r) // ptc
                chi = (src[2] + src[3] - 1 + r) // ptc
                rec[12:16] = (pf + lo * pruns + clo, hi - lo + 1,
                              chi - clo + 1, pruns)
            items.append(rec)
    wpl, bases, blk = plan.wpl, plan.bases, plan.blk_rows
    lwa = [_ceil_to(lw + 2 * r, 4) for _, lw in plan.shapes]
    lh2 = [lh + 2 * r for lh, _ in plan.shapes]
    fills = _fills(KIND_PAD, 0, lh2[0], 0, lwa[0])
    for l in range(n_levels):
        fills += _fills(KIND_ZERO, bases[l], lh2[l], lwa[l], wpl - lwa[l])
        fills += _fills(KIND_ZERO, bases[l] + lh2[l], blk[l] - lh2[l], 0,
                        wpl)
    end = bases[-1] + blk[-1]
    fills += _fills(KIND_ZERO, end, plan.total_rows - end, 0, wpl)
    records = np.asarray(_ticket_order(items, fills), np.int32)
    levels = np.zeros((K7_MAX_LEVELS, 8), np.int32)
    rt = ct = 0
    for l in range(1, n_levels):
        lh, lw = plan.shapes[l]
        levels[l] = (bases[l], lh + 2 * r, lw + 2 * r, rt, ct,
                     bases[l - 1] + r, r, 0)
        rt += lh + 2 * r
        ct += lw + 2 * r
    rtab = np.concatenate([_span_table(*x) for x in zip(
        t.row_start, t.row_len, t.row_w)])
    ctab = np.concatenate([_span_table(*x) for x in zip(
        t.col_start, t.col_len, t.col_w)])
    return K7Plan(tile, fused, pitch, pitch_f, rows_a, lgcg,
                  (tab_off // 4, tab_rows), smem, levels, rtab, ctab,
                  records, tuple(bands), first)


@functools.lru_cache(maxsize=8)
def _device_plan(h, w, n_levels, scale_factor, r, device: str):
    """The plan's tables and the kernel's counters (zeros), on the device
    once per shape, and the grid: resident blocks an SM x SMs."""
    kp = kernel_plan(h, w, n_levels, scale_factor, r)
    d = {k: torch.from_numpy(np.ascontiguousarray(getattr(kp, k))).to(
        device) for k in ("rtab", "ctab", "records")}
    d["counters"] = torch.zeros(kp.n_counters, dtype=torch.int32,
                                device=device)
    d["geo"] = np.asarray((kp.tile[0], kp.pitch, kp.pitch_f, kp.rows_a)
                          + kp.lgcg + kp.tables, np.int32)
    dev = torch.device(device)
    d["grid"] = min(kp.records.shape[0], occupancy(kp, dev)
                    * torch.cuda.get_device_properties(dev)
                    .multi_processor_count)
    return d


def occupancy(kp: K7Plan, device) -> int:
    """The kernel's resident blocks an SM on `device` with the plan's
    shared memory (registers included)."""
    fn = _build.load("packedpyr").packedpyr_occupancy
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int]
    with torch.cuda.device(device):
        blocks = fn(kp.smem)
    if blocks < 1:
        raise RuntimeError(f"packedpyr: no block of {kp.smem} bytes of "
                           "shared memory fits an SM")
    return blocks


@functools.lru_cache(maxsize=1)
def _launch_fn():
    fn = _build.load("packedpyr").packedpyr_launch
    fn.restype = ctypes.c_int
    P, I = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [P, I, I, I, P, I, I, P, P, P, P, P, I, P, I, I, I, P]
    return fn


# the stream of each device's last call outside a graph capture
_LAST_STREAM: dict = {}


def _order_streams(device) -> None:
    """The kernel's counters are one buffer a shape and device, so two
    calls must not run at once. A call on another stream than the last
    one first waits for that stream. Inside a graph capture nothing is
    waited for: `torch.cuda.graph` synchronises the device before it
    captures, and a replay runs on the stream that replays it, which must
    not run another call of the same shape beside it."""
    if torch.cuda.is_current_stream_capturing():
        return
    cur = torch.cuda.current_stream(device)
    last = _LAST_STREAM.get(device)
    if last is not None and last != cur:
        cur.wait_stream(last)
    _LAST_STREAM[device] = cur


def launch_records(img, out, shape, records) -> None:
    """Launch the kernel on img [h, w] into the packed buffer `out` for the
    items of `records` (a device tensor of kernel_plan(...).records rows,
    in ticket order; all of them for the whole buffer) under `shape` =
    (n_levels, scale_factor, r). Counts no launch: `build_packed_pyramid`
    is the wrapper."""
    h, w = img.shape
    n_levels, scale_factor, r = shape
    plan = pyramid_plan(h, w, n_levels, scale_factor, r)
    kp = kernel_plan(h, w, n_levels, scale_factor, r)
    d = _device_plan(h, w, n_levels, scale_factor, r, str(img.device))
    vec1 = int(w % 4 == 0 and img.data_ptr() % 16 == 0)
    with torch.cuda.device(img.device):
        _order_streams(img.device)
        stream = torch.cuda.current_stream(img.device).cuda_stream
        err = _launch_fn()(
            img.data_ptr(), h, w, vec1, out.data_ptr(), plan.wpl, r,
            kp.levels.ctypes.data, d["geo"].ctypes.data,
            d["rtab"].data_ptr(), d["ctab"].data_ptr(), records.data_ptr(),
            records.shape[0], d["counters"].data_ptr(), kp.n_counters,
            min(d["grid"], records.shape[0]), kp.smem, stream)
    _build.check(err, "packedpyr")


def build_packed_pyramid(img, n_levels: int, scale_factor: float, r: int):
    """img: [H, W] float32. Returns the packed [plan.total_rows, plan.wpl]
    float32 buffer of `pyramid_plan`. Check pyramid_available first. CPU
    tensors take the plain version; CUDA tensors launch the kernel once
    (one counter buffer a shape and device: see `_order_streams`)."""
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
    plan = pyramid_plan(h, w, n_levels, scale_factor, r)
    out = torch.empty((plan.total_rows, plan.wpl), dtype=torch.float32,
                      device=img.device)
    d = _device_plan(h, w, n_levels, scale_factor, r, str(img.device))
    launch_records(img, out, (n_levels, scale_factor, r), d["records"])
    build_packed_pyramid.launches += 1
    return out


build_packed_pyramid.launches = 0
