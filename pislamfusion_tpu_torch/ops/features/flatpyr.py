"""K1: the flat ORB pyramid — every level straight from level 0.

Replaces pislamfusion_tpu/ops/features/flatpyr_pallas.py
`build_flat_pyramid` (its `pallas_call` at :227), called by orb_detect
(orb.py:741-752).

Function, per level l >= 1, with the composed bilinear matrices
(mr_l [block_rows_l, h], mc_l [wp, w]) of `orb._flat_matrices`:

    t1    = bf16(bf16(mr_l) @ bf16(img))        f32 accumulation
    out_l = t1 @ bf16(mc_l)^T                    f32 accumulation

written into the packed f32 buffer of `orb._flat_plan` at bases[l];
level 0 is the exact f32 edge pad. Those are the TPU kernel's rounding
points (flatpyr_pallas.py:145-159, :186-199), kept so that parity with it
is tight.

On the H100 the function is bound by bytes: at 1080p with 8 levels it
reads an 8.3 MB image and writes a 51 MB packed buffer, >= 18 us at
3.35 TB/s, while the banded products are ~0.1 GFLOP. The TPU kernel ran
dense 128x640 MXU tiles; the matrices are banded (a composed chain of
2-tap resizes, at most ~14 nonzeros per row), so the CUDA kernel
(`csrc/flatpyr.cu`) walks each row's nonzero span from host-built
(start, length, weights) tables instead: a row pass writes t1 to a bf16
scratch, a column pass writes every packed row (level 0's edge pad
included). Skipping the zeros changes only the summation order.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools

import numpy as np
import torch

from ... import _build

_BLK = 128
_RK = 640      # the TPU kernel's source window (rows and lanes per tile)


def _nz_span(rows: np.ndarray):
    """Per-row (start, length) of the nonzero span of a [R, n] matrix."""
    nzm = rows != 0
    any_ = nzm.any(1)
    start = np.where(any_, nzm.argmax(1), 0)
    last = np.where(any_, rows.shape[1] - 1 - nzm[:, ::-1].argmax(1), -1)
    return start.astype(np.int32), (last - start + 1).clip(0).astype(
        np.int32)


def _bf16(x: np.ndarray) -> np.ndarray:
    """float32 values rounded to bfloat16 (nearest even), kept as f32."""
    return torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(
        torch.bfloat16).float().numpy()


@functools.lru_cache(maxsize=16)
def flat_pyramid_available(h: int, w: int, n_levels: int,
                           scale_factor: float, cell: int) -> bool:
    """The TPU kernel's regime (flatpyr_pallas._tables): a 128-aligned
    plan, a level-0 block of >= 640 rows and lanes, and every 128-row /
    128-lane output tile's source span inside one 640 window. Outside it
    orb_detect takes the resize chain, as the reference does."""
    from . import orb
    plan = orb._flat_plan(h, w, n_levels, scale_factor, cell)
    if plan is None or plan.wp % _BLK:
        return False
    if any(b % _BLK for b in plan.block_rows):
        return False
    src_rows = plan.block_rows[0]
    if src_rows < _RK or plan.wp < _RK:
        return False
    mats = orb._flat_matrices(h, w, n_levels, scale_factor, cell)
    for mr, mc in mats[1:]:
        for m, off, limit in ((mr, cell, src_rows), (mc, plan.pad_left,
                                                     plan.wp)):
            for t in range(m.shape[0] // _BLK):
                nz = np.nonzero(m[t * _BLK:(t + 1) * _BLK].any(0))[0]
                if nz.size:
                    s0 = min(max(((nz[0] + off) // _BLK) * _BLK, 0),
                             limit - _RK)
                    if nz[-1] + off >= s0 + _RK:
                        return False
    return True


@dataclasses.dataclass(frozen=True)
class FlatTables:
    """Host tables of one (h, w, n_levels, scale, cell) shape."""
    plan: object
    row_start: np.ndarray   # [R1] int32  (R1 = rows of levels 1..L-1)
    row_len: np.ndarray     # [R1] int32
    row_w: np.ndarray       # [R1, KR] f32, bf16-exact
    row_level: np.ndarray   # [R1] int32  level - 1 of each t1 row
    col_start: np.ndarray   # [L-1, wp] int32
    col_len: np.ndarray     # [L-1, wp] int32
    col_w: np.ndarray       # [L-1, wp, KC] f32, bf16-exact
    mats16: tuple           # per level >= 1: (mr, mc) bf16-exact f32


@functools.lru_cache(maxsize=8)
def flat_tables(h: int, w: int, n_levels: int, scale_factor: float,
                cell: int) -> FlatTables:
    from . import orb
    plan = orb._flat_plan(h, w, n_levels, scale_factor, cell)
    mats = orb._flat_matrices(h, w, n_levels, scale_factor, cell)
    mats16 = tuple((_bf16(mr), _bf16(mc)) for mr, mc in mats[1:])
    rs, rl, rw, rlev, cs, cl, cw = [], [], [], [], [], [], []
    for lvl, (mr, mc) in enumerate(mats16):
        s, n = _nz_span(mr)
        rs.append(s)
        rl.append(n)
        rw.append((mr, s, n))
        rlev.append(np.full(mr.shape[0], lvl, np.int32))
        s, n = _nz_span(mc)
        cs.append(s)
        cl.append(n)
        cw.append((mc, s, n))
    kr = max(int(n.max()) for n in rl)
    kc = max(int(n.max()) for n in cl)

    def pack(items, k):
        out = []
        for m, s, n in items:
            wts = np.zeros((m.shape[0], k), np.float32)
            for j in range(k):
                sel = j < n
                rows = np.nonzero(sel)[0]
                wts[rows, j] = m[rows, s[rows] + j]
            out.append(wts)
        return out

    return FlatTables(plan, np.concatenate(rs), np.concatenate(rl),
                      np.concatenate(pack(rw, kr)), np.concatenate(rlev),
                      np.stack(cs), np.stack(cl), np.stack(pack(cw, kc)),
                      mats16)


@functools.lru_cache(maxsize=8)
def _device_tables(h, w, n_levels, scale_factor, cell, device: str):
    """The kernel's tables, uploaded once per shape and device."""
    t = flat_tables(h, w, n_levels, scale_factor, cell)

    def up(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)
    return {k: up(getattr(t, k)) for k in
            ("row_start", "row_len", "row_w", "row_level", "col_start",
             "col_len", "col_w")}


@functools.lru_cache(maxsize=8)
def _device_mats16(h, w, n_levels, scale_factor, cell, device: str):
    """The plain version's dense bf16-valued resize matrices (as float32),
    uploaded once per shape and device."""
    t = flat_tables(h, w, n_levels, scale_factor, cell)
    return [(torch.from_numpy(mr).to(device), torch.from_numpy(mc).to(device))
            for mr, mc in t.mats16]


def _edge_pad0(img, plan):
    """Level 0's block: the exact f32 edge pad of the image."""
    h, w = img.shape
    iy = (torch.arange(plan.block_rows[0], device=img.device)
          - plan.cell).clamp(0, h - 1)
    ix = (torch.arange(plan.wp, device=img.device)
          - plan.pad_left).clamp(0, w - 1)
    return img[iy[:, None], ix[None, :]]


def build_flat_pyramid_plain(img, n_levels: int, scale_factor: float,
                             cell: int):
    """Plain PyTorch version: dense f32 products of bf16-rounded operands,
    rounded to bf16 between the two passes."""
    h, w = img.shape
    t = flat_tables(h, w, n_levels, scale_factor, cell)
    src16 = img.to(torch.bfloat16).float()
    blocks = [_edge_pad0(img, t.plan)]
    for mr, mc in _device_mats16(h, w, n_levels, scale_factor, cell,
                                 str(img.device)):
        t1 = (mr @ src16).to(torch.bfloat16).float()
        blocks.append(t1 @ mc.T)
    return torch.cat(blocks, 0)


def build_flat_pyramid(img, n_levels: int, scale_factor: float,
                       cell: int):
    """img: [H, W] float32. Returns the packed [plan.total_rows, plan.wp]
    float32 buffer of orb._flat_plan. Check flat_pyramid_available
    first. CPU tensors take the plain version; CUDA tensors launch the
    kernel."""
    if img.device.type == "cpu":
        return build_flat_pyramid_plain(img, n_levels, scale_factor, cell)
    if img.device.type != "cuda":
        raise ValueError(f"build_flat_pyramid: unsupported device "
                         f"{img.device}")
    if img.dtype != torch.float32 or img.ndim != 2:
        raise ValueError("build_flat_pyramid: img must be float32 [H, W]")
    h, w = img.shape
    if not flat_pyramid_available(h, w, n_levels, scale_factor, cell):
        raise ValueError(f"build_flat_pyramid: {h}x{w} with {n_levels} "
                         "levels is outside the kernel's regime")
    img = img.contiguous()
    t = flat_tables(h, w, n_levels, scale_factor, cell)
    plan = t.plan
    d = _device_tables(h, w, n_levels, scale_factor, cell, str(img.device))
    r1 = t.row_start.shape[0]
    t1 = torch.empty((r1, w), dtype=torch.bfloat16, device=img.device)
    out = torch.empty((plan.total_rows, plan.wp), dtype=torch.float32,
                      device=img.device)
    lib = _build.load("flatpyr")
    fn = lib.flatpyr_launch
    fn.restype = ctypes.c_int
    P, I = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [P, I, I, P, P, P, I, P, I, P, P, P, I, I, I, I, I, I,
                   P, P, P]
    with torch.cuda.device(img.device):
        stream = torch.cuda.current_stream(img.device).cuda_stream
        err = fn(img.data_ptr(), h, w,
                 d["row_start"].data_ptr(), d["row_len"].data_ptr(),
                 d["row_w"].data_ptr(), t.row_w.shape[1],
                 d["row_level"].data_ptr(), r1,
                 d["col_start"].data_ptr(), d["col_len"].data_ptr(),
                 d["col_w"].data_ptr(), t.col_w.shape[2],
                 plan.wp, plan.block_rows[0], plan.total_rows, plan.cell,
                 plan.pad_left, t1.data_ptr(), out.data_ptr(), stream)
    _build.check(err, "flatpyr")
    build_flat_pyramid.launches += 1
    return out


build_flat_pyramid.launches = 0
