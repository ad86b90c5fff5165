"""K4: FAST-16 score, threshold and border masks, 3x3 NMS and the
per-cell winner, for every pyramid level in one launch.

Replaces pislamfusion_tpu/ops/features/fastselect.py `fast_cell_winners`
(its `pallas_call` in `_winners_kernel_call` at :191), which orb_detect
runs where every level keeps one keypoint a cell (orb.py:790-811).

Function, per level [lh, lw] with ncy x ncx cells of `cell` px: the FAST
score (`fast_score_map`), zeroed within `border` px of the level's edge
and where it is not > min_threshold, then 3x3 non-max suppressed
(`suppress`); over the cell-padded level, each cell's maximum `cv2d`
[ncy, ncx] float32 and the first row-major linear index `ci2d` [ncy, ncx]
int32 (y * ncx * cell + x) among the pixels that reach it, so a cell
with no corner indexes its first pixel (`cell_winners`). This is
`orb.select_keypoints`' one-per-cell branch, which calls the same
`suppress` and `cell_winners`.

On the H100 the function is bound by operations: the full score is ~180
f32 subtractions, minima and maxima a pixel, while only ~9 % of a survey
frame's pyramid pixels score above the threshold. The TPU kernel walks
32-row bands in series with double-buffered DMAs and lane rolls and
scores every pixel. The CUDA kernel (`csrc/fastselect.cu`) gives each
block a run of cells of one cell row, read in place from the packed
pyramid the ORB front end already built (K1's, K7's or the resize
chain's, at the level offsets `orb.build_pyramid` returns), so nothing is
re-packed. It stages the run's slab in shared memory, tests every pixel
of the cells and their NMS halo with an exact pretest (`fast_pretest`:
nine reads, no pixel whose score exceeds the threshold fails it),
compacts the pixels that pass into a shared list, scores only those, and
reduces the list's NMS survivors to each cell's (max, first index).
Subtractions, minima and maxima are exact in f32 in any order, so the
kernel equals its plain version bit for bit.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools

import numpy as np
import torch

from ... import _build

# FAST-16 circle offsets (dx, dy), OpenCV order
_CIRCLE = np.array([
    (0, -3), (1, -3), (2, -2), (3, -1), (3, 0), (3, 1), (2, 2), (1, 3),
    (0, 3), (-1, 3), (-2, 2), (-3, 1), (-3, 0), (-3, -1), (-2, -2), (-1, -3),
], np.int32)
_FAST_R = 3            # circle radius
_MAX_RUN = 4           # cells a block at most (csrc/fastselect.cu MAXRUN)
_SMEM_MAX = 227 * 1024  # dynamic shared memory a block can have
# the pretest's taps: A = circle indices {0, 4, 8, 12}, B = {2, 6, 10, 14},
# each as its two opposite pairs
_PRETEST_PAIRS = ((0, 8), (4, 12), (2, 10), (6, 14))


def fast_score_map(img):
    """Dense FAST-16 corner score (max t such that 9 contiguous circle
    pixels are all brighter/darker than the center by t). img: [H, W] f32.
    The 25 wrapped tap differences are stacked, so each level of the
    arc-minimum tree is one op (min/max are exact: any order gives the
    reference's values)."""
    d = torch.stack([torch.roll(img, (-int(dy), -int(dx)), (0, 1))
                     for dx, dy in _CIRCLE]) - img
    d = torch.cat([d, d[:9]])                          # wraparound arcs (25)

    def arc_min(x):
        m2 = torch.minimum(x[:-1], x[1:])
        m4 = torch.minimum(m2[:-2], m2[2:])
        m8 = torch.minimum(m4[:-4], m4[4:])
        return torch.minimum(m8[:16], x[8:24]).amax(0)

    score = torch.maximum(arc_min(d), arc_min(-d))
    H, W = img.shape
    ys = torch.arange(H, device=img.device)[:, None]
    xs = torch.arange(W, device=img.device)[None, :]
    edge = ((ys >= _FAST_R) & (ys < H - _FAST_R)
            & (xs >= _FAST_R) & (xs < W - _FAST_R))
    return torch.where(edge, score, torch.zeros_like(score))


def fast_pretest(img, thr: float, border: int):
    """The kernel's exact pretest, bool [H, W]: the pixels >= `border` px
    inside img whose FAST score can exceed thr. A score > thr needs 9
    consecutive circle pixels all brighter than the centre by more than
    thr (or all darker), and any 9 consecutive of the 16 hold two
    cyclically adjacent members of {0, 4, 8, 12} and two of {2, 6, 10,
    14}; two adjacent members of {0, 4, 8, 12} are brighter exactly when
    max(v0, v8) and max(v4, v12) both are. Rounding v - c is monotone in
    v, so the min / max of the raw taps less c equals the min / max of
    the rounded differences: a pixel that fails has a score <= thr."""
    tap = [torch.roll(img, (-int(_CIRCLE[k][1]), -int(_CIRCLE[k][0])),
                      (0, 1)) for k in range(16)]
    hi = lo = None
    for a, b in _PRETEST_PAIRS:
        h, l = torch.maximum(tap[a], tap[b]), torch.minimum(tap[a], tap[b])
        hi = h if hi is None else torch.minimum(hi, h)
        lo = l if lo is None else torch.maximum(lo, l)
    H, W = img.shape
    ys = torch.arange(H, device=img.device)[:, None]
    xs = torch.arange(W, device=img.device)[None, :]
    ok = ((ys >= border) & (ys < H - border)
          & (xs >= border) & (xs < W - border))
    return ok & ((hi - img > thr) | (lo - img < -thr))


def _nms3(score):
    """3x3 non-max suppression as the max of 8 wrapped shifts."""
    m = torch.stack([torch.roll(score, (dy, dx), (0, 1))
                     for dy in (-1, 0, 1) for dx in (-1, 0, 1)
                     if dy or dx]).amax(0)
    return torch.where(score >= m, score, torch.zeros_like(score))


def suppress(score, min_threshold: float, border: int):
    """The score where it is > min_threshold and >= border px inside the
    image, else 0, then 3x3 non-max suppressed."""
    H, W = score.shape
    dev = score.device
    ys = torch.arange(H, device=dev)[:, None]
    xs = torch.arange(W, device=dev)[None, :]
    ok = ((ys >= border) & (ys < H - border)
          & (xs >= border) & (xs < W - border))
    return _nms3(torch.where(ok & (score > min_threshold), score,
                             torch.zeros_like(score)))


def cell_winners(s, cell: int):
    """Per-cell (max [ncy, ncx], first row-major linear index among ties
    [ncy, ncx] int32) of a suppressed score map, over the map zero-padded
    to whole cells; the index counts in the padded map's width."""
    H, W = s.shape
    ncy, ncx = -(-H // cell), -(-W // cell)
    sp = torch.nn.functional.pad(s, (0, ncx * cell - W, 0, ncy * cell - H))
    cells4 = sp.reshape(ncy, cell, ncx, cell)
    cv2d = cells4.amax((1, 3))
    up = cv2d[:, None, :, None].expand(ncy, cell, ncx, cell).reshape(
        sp.shape)
    lin = torch.arange(sp.numel(), device=s.device,
                       dtype=torch.int64).reshape(sp.shape)
    idx2d = torch.where(sp == up, lin, torch.full_like(lin, sp.numel()))
    ci2d = idx2d.reshape(ncy, cell, ncx, cell).amin((1, 3))
    return cv2d, ci2d.to(torch.int32)


def fast_cell_winners_plain(levels, cell: int, min_threshold: float,
                            border: int):
    """Plain PyTorch version: per level image [lh, lw] f32, (cv2d, ci2d)."""
    return [cell_winners(suppress(fast_score_map(lv), min_threshold,
                                  border), cell)
            for lv in levels]


def block_run(cell: int) -> int:
    """Cells a block: the most of 4, 2 and 1 whose score tile is at most
    256 px wide (the candidate list packs a column into 8 bits) and whose
    slab, score tile and list fit in a block's shared memory; 0 where
    none does."""
    for run in (_MAX_RUN, 2, 1):
        if run * cell + 2 <= 256 and smem_bytes(cell, run) <= _SMEM_MAX:
            return run
    return 0


def smem_bytes(cell: int, run: int) -> int:
    """Dynamic shared memory of a block (csrc/fastselect.cu
    fastselect_smem): the f32 slab (rounded up to whole float4s) and
    score tile at the slab's pitch, and a 16-bit candidate list as long
    as the score tile."""
    tw, th = run * cell + 2, cell + 2
    sw, sh = tw + 2 * _FAST_R, th + 2 * _FAST_R
    return (((sh * sw + 3) & ~3) + th * sw) * 4 + ((th * tw * 2 + 3) & ~3)


@dataclasses.dataclass(frozen=True)
class WinnerPlan:
    """Host tables of one (shapes, offsets, cell): per level (oy, ox, lh,
    lw, ncx, first cell of the level in the output) and per block
    (level, cell row, first cell of its run of `run` cells)."""
    levels: np.ndarray      # [L, 6] int32
    blocks: np.ndarray      # [n_blocks, 3] int32
    grids: tuple            # ((ncy, ncx), ...) per level
    n_cells: int
    run: int                # cells a block
    smem: int               # dynamic shared memory a block, bytes


@functools.lru_cache(maxsize=16)
def winner_plan(shapes: tuple, offs: tuple, cell: int,
                run: int = 0) -> WinnerPlan:
    """The plan at `run` cells a block (0: `block_run`'s)."""
    run = run or block_run(cell)
    if not run or run * cell + 2 > 256 or run > _MAX_RUN \
            or smem_bytes(cell, run) > _SMEM_MAX:
        raise ValueError(f"fast_cell_winners: cell {cell} does not fit a "
                         "block")
    levels, blocks, grids, first = [], [], [], 0
    for lvl, ((lh, lw), (ox, oy)) in enumerate(zip(shapes, offs)):
        ncy, ncx = -(-lh // cell), -(-lw // cell)
        levels.append((oy, ox, lh, lw, ncx, first))
        blocks.extend((lvl, cy, cx0) for cy in range(ncy)
                      for cx0 in range(0, ncx, run))
        grids.append((ncy, ncx))
        first += ncy * ncx
    return WinnerPlan(np.asarray(levels, np.int32),
                      np.asarray(blocks, np.int32), tuple(grids), first,
                      run, smem_bytes(cell, run))


@functools.lru_cache(maxsize=16)
def _device_plan(shapes, offs, cell, device: str, run: int = 0):
    p = winner_plan(shapes, offs, cell, run)
    return (torch.from_numpy(p.levels).to(device),
            torch.from_numpy(p.blocks).to(device))


def _lib():
    """The kernel library (`_build.load`'s, which a sweep may swap), with
    its launch signatures set once."""
    lib = _build.load("fastselect")
    if not getattr(lib, "signatures_set", False):
        P, I = ctypes.c_void_p, ctypes.c_int
        lib.fastselect_launch.restype = I
        lib.fastselect_launch.argtypes = [P, I, P, P, I, I, I,
                                          ctypes.c_float, I, P, P, P]
        for fn in (lib.fastselect_occupancy, lib.fastselect_smem):
            fn.restype = I
            fn.argtypes = [I, I]
        lib.signatures_set = True
    return lib


def occupancy(plan: WinnerPlan, cell: int, device) -> int:
    """The kernel's resident blocks an SM on `device` at the plan's shared
    memory (registers included)."""
    lib = _lib()
    if lib.fastselect_smem(cell, plan.run) != plan.smem:
        raise RuntimeError("fastselect: host and kernel disagree on the "
                           "shared memory a block")
    with torch.cuda.device(device):
        return lib.fastselect_occupancy(cell, plan.run)


def fast_cell_winners(packed, offs, shapes, cell: int, min_threshold: float,
                      border: int):
    """Per level, (cv2d [ncy, ncx] f32, ci2d [ncy, ncx] int32) of the
    level whose pixel (x, y) sits at packed[offs[l][1] + y, offs[l][0] +
    x] (`orb.build_pyramid`'s packed buffer and offsets), shapes[l] =
    (lh, lw). CPU tensors take the plain version; CUDA tensors launch the
    kernel, once for every level."""
    shapes = tuple((int(h), int(w)) for h, w in shapes)
    offs = tuple((int(x), int(y)) for x, y in offs)
    if packed.device.type == "cpu":
        return fast_cell_winners_plain(
            [packed[oy:oy + lh, ox:ox + lw]
             for (lh, lw), (ox, oy) in zip(shapes, offs)],
            cell, min_threshold, border)
    if packed.device.type != "cuda":
        raise ValueError(f"fast_cell_winners: unsupported device "
                         f"{packed.device}")
    if packed.dtype != torch.float32 or packed.ndim != 2 \
            or packed.stride(1) != 1:
        raise ValueError("fast_cell_winners: packed must be float32 "
                         "[R, Wp] with unit lane stride")
    if cell % 8 or border < _FAST_R or not min_threshold >= 0:
        raise ValueError("fast_cell_winners: needs cell % 8 == 0, a "
                         f"border >= {_FAST_R} and min_threshold >= 0")
    for (lh, lw), (ox, oy) in zip(shapes, offs):
        if ox < 0 or oy < 0 or oy + lh > packed.shape[0] \
                or ox + lw > packed.shape[1]:
            raise ValueError("fast_cell_winners: a level lies outside "
                             "the packed buffer")
    plan = winner_plan(shapes, offs, cell)
    levels, blocks = _device_plan(shapes, offs, cell, str(packed.device))
    cv = torch.empty(plan.n_cells, dtype=torch.float32, device=packed.device)
    ci = torch.empty(plan.n_cells, dtype=torch.int32, device=packed.device)
    with torch.cuda.device(packed.device):
        stream = torch.cuda.current_stream(packed.device).cuda_stream
        err = _lib().fastselect_launch(
            packed.data_ptr(), packed.stride(0), levels.data_ptr(),
            blocks.data_ptr(), plan.blocks.shape[0], cell, plan.run,
            float(min_threshold), border, cv.data_ptr(), ci.data_ptr(),
            stream)
    _build.check(err, "fastselect")
    fast_cell_winners.launches += 1
    out, first = [], 0
    for ncy, ncx in plan.grids:
        n = ncy * ncx
        out.append((cv[first:first + n].view(ncy, ncx),
                    ci[first:first + n].view(ncy, ncx)))
        first += n
    return out


fast_cell_winners.launches = 0
