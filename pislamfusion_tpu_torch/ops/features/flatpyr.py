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
2-tap resizes, at most ~18 nonzeros per row), so the host keeps each
row's nonzero span (start, length, weights) and the CUDA kernel
(`csrc/flatpyr.cu`) walks only those. One launch writes the whole packed
buffer (`kernel_plan`): a block takes an output tile of one level, whose
size the plan picks per level so that three blocks fit an SM (32 x 256
outputs at level 1, 8 x 128 at level 7, where a tile reads ~3.6x its
extent), stages its bf16-rounded source window (as bf16) and both span
tables, re-laid per tile, in shared memory, runs the row pass into a bf16
t1 tile there and the column pass out to the buffer; other blocks copy
level 0's edge pad. t1 never reaches global memory. Skipping the zeros
changes only the summation order.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools

import numpy as np
import torch

from ... import _build
from ..stencil import SM_BLOCK_RESERVED, SM_SMEM, SM_THREADS

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
    rs, rl, rw, cs, cl, cw = [], [], [], [], [], []
    for lvl, (mr, mc) in enumerate(mats16):
        s, n = _nz_span(mr)
        rs.append(s)
        rl.append(n)
        rw.append((mr, s, n))
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
                      np.concatenate(pack(rw, kr)),
                      np.stack(cs), np.stack(cl), np.stack(pack(cw, kc)),
                      mats16)


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


# the kernel (csrc/flatpyr.cu) and its launch plan
K1_THREADS = 256
K1_BLOCKS = 3                   # resident blocks an SM a tile must allow
                                # (3 measured at or under 4 on an H100,
                                # scripts/torch_k5_k1_sweep.py)
K1_SMEM = SM_SMEM // K1_BLOCKS - SM_BLOCK_RESERVED
K1_TAPS = (4, 8, 12, 20)        # its instantiations' tap bounds
K1_MAX_LEVELS = 16
# output tiles (rows, columns), tried largest first for each level
K1_TILES = ((32, 256), (32, 128), (16, 256), (16, 128), (32, 64), (8, 256),
            (8, 128), (16, 64), (8, 64), (16, 32), (8, 32))
K1_COPY_ROWS = 8                # packed rows of a level-0 item


def _round4(n: int) -> int:
    return -(-n // 4) * 4


def _meta(start, length, w, first, tile: int, K: int, lead: int):
    """One tile's span table, int32 [(2 + K) * tile] rounded up to 4
    words: each output's span offset from the staged window (`first` is
    the window's first input, `lead` floats of alignment before it), its
    length, then weight k of output i at word (2 + k) * tile + i (float32
    bits). Outputs past the end have length 0."""
    n = start.shape[0]
    meta = np.zeros(_round4((2 + K) * tile), np.int32)
    meta[:n] = np.where(length > 0, start - first + lead, 0)
    meta[tile:tile + n] = length
    wk = np.zeros((tile, K), np.float32)
    k = min(K, w.shape[1])
    if (w[:, k:] != 0).any():
        raise ValueError("build_flat_pyramid: a span is longer than its "
                         "level's tap bound")
    wk[:n, :k] = w[:, :k]
    meta[2 * tile:(2 + K) * tile] = wk.T.reshape(-1).view(np.int32)
    return meta


@dataclasses.dataclass(frozen=True)
class FlatKernelPlan:
    """How the K1 kernel cuts the packed buffer: one item a block. An item
    of level l >= 1 is an output tile of `tiles[l - 1]` (rows, columns)
    with tap bound `taps[l - 1]`: it stages the bf16-rounded source window
    of its tile row (`trow`) and tile column (`tcol`) and both span
    tables in shared memory, runs the row pass into a bf16 t1 tile in
    shared memory and the column pass out to the buffer. A level-0 item
    copies K1_COPY_ROWS packed rows of the edge pad."""
    tiles: tuple             # per level >= 1: (tile rows, tile columns)
    taps: tuple              # per level >= 1: tap bound (K1_TAPS)
    trow: np.ndarray         # [tile rows, 4] int32: first source row,
                             # source rows, rmeta offset, first output row
    tcol: np.ndarray         # [tile columns, 4] int32: first source
                             # column (a multiple of 4), staged floats a
                             # row (0: every column of the tile is 0),
                             # cmeta offset, first output column
    rmeta: np.ndarray        # int32 row span tables (_meta)
    cmeta: np.ndarray        # int32 column span tables
    items: np.ndarray        # [n_items, 4] int32: level, trow, tcol,
                             # output columns it writes (an item of dead
                             # columns, pitch 0, writes zeros to the
                             # row's end); level 0: 0, first row, rows, 0
    records: np.ndarray      # [n_items, 8] int32, what the kernel reads of
                             # an item: level, first source row, source
                             # rows, rmeta offset, first source column (a
                             # zero item: its columns), pitch, cmeta
                             # offset, first output row << 16 | first
                             # output column (level 0: 0, first row,
                             # rows, 0...)
    smem: int                # bytes of dynamic shared memory a block
    blocks_per_sm: int       # by shared memory and threads


def _level_tiles(rs, rl, rw, cs, cl, cw, rows: int, wp: int, tr: int,
                 tc: int, K: int):
    """The tile rows and columns of one level cut into tr x tc output
    tiles: per tile row (first source row, rows, rmeta), per tile column
    (first source column, staged floats a row, cmeta), and the bytes of
    shared memory its largest tile needs."""
    trows, tcols = [], []
    for r0 in range(0, rows, tr):
        s, n = rs[r0:r0 + tr], rl[r0:r0 + tr]
        first = int(s.min())
        count = int((s + n).max()) - first
        trows.append((first, count, r0,
                      _meta(s, n, rw[r0:r0 + tr], first, tr, K, 0)))
    for c0 in range(0, wp, tc):
        s, n = cs[c0:c0 + tc], cl[c0:c0 + tc]
        live = n > 0
        if live.any():
            first = int(s[live].min())
            lead = first & 3
            pitch = _round4(lead + int((s + n)[live].max()) - first)
            first -= lead
        else:
            first = lead = pitch = 0
        tcols.append((first, pitch, c0,
                      _meta(s, n, cw[c0:c0 + tc], first + lead, tc, K,
                            lead)))
    rn = max(t[1] for t in trows)
    pitch = max(t[1] for t in tcols)
    if pitch > 4 * K1_THREADS:
        raise ValueError(f"build_flat_pyramid: a {tc}-column tile reads "
                         f"{pitch} source columns, more than 4 a thread")
    # the bf16 source window and t1, then the two span tables
    smem = 2 * (rn + tr) * pitch + 4 * (_round4((2 + K) * tr)
                                        + _round4((2 + K) * tc))
    return trows, tcols, smem


@functools.lru_cache(maxsize=8)
def kernel_plan(h: int, w: int, n_levels: int, scale_factor: float,
                cell: int) -> FlatKernelPlan:
    """K1's launch plan: for each level >= 1 the largest tile of
    K1_TILES whose shared memory keeps K1_BLOCKS blocks an SM, and its
    span tables re-laid per tile. Raises ValueError where the kernel
    cannot take the shape: a span longer than its largest tap bound, more
    than K1_MAX_LEVELS levels, or a level that no tile fits."""
    t = flat_tables(h, w, n_levels, scale_factor, cell)
    plan = t.plan
    if n_levels > K1_MAX_LEVELS:
        raise ValueError(f"build_flat_pyramid: the kernel takes at most "
                         f"{K1_MAX_LEVELS} levels, not {n_levels}")
    tiles, taps, trow, tcol, rmeta, cmeta, items = ([] for _ in range(7))
    smem = 0
    r_off = 0
    for lvl in range(1, n_levels):
        rows = plan.block_rows[lvl]
        rs = t.row_start[r_off:r_off + rows]
        rl = t.row_len[r_off:r_off + rows]
        rw = t.row_w[r_off:r_off + rows]
        r_off += rows
        cs, cl, cw = (t.col_start[lvl - 1], t.col_len[lvl - 1],
                      t.col_w[lvl - 1])
        kmax = max(int(rl.max()), int(cl.max()))
        K = next((k for k in K1_TAPS if k >= kmax), None)
        if K is None:
            raise ValueError(f"build_flat_pyramid: level {lvl} has spans of "
                             f"{kmax} taps, more than the kernel's "
                             f"{K1_TAPS[-1]}")
        for tr, tc in K1_TILES:
            cut = _level_tiles(rs, rl, rw, cs, cl, cw, rows, plan.wp, tr,
                               tc, K)
            if cut[2] <= K1_SMEM:
                break
        else:
            raise ValueError(f"build_flat_pyramid: no tile of level {lvl} "
                             f"fits {K1_SMEM} bytes of shared memory")
        trows, tcols, need = cut
        smem = max(smem, need)
        tiles.append((tr, tc))
        taps.append(K)
        i_r, i_c = len(trow), len(tcol)
        for first, count, r0, meta in trows:
            trow.append((first, count, sum(m.size for m in rmeta), r0))
            rmeta.append(meta)
        for first, pitch, c0, meta in tcols:
            tcol.append((first, pitch, sum(m.size for m in cmeta), c0))
            cmeta.append(meta)
        # the tile columns past the level's last live one (all 0) are one
        # zero-fill item a tile row
        live = [b for b, col in enumerate(tcols) if col[1] > 0]
        dead = len(live)
        if any(col[1] > 0 for col in tcols[dead:]):
            raise ValueError(f"build_flat_pyramid: level {lvl}'s dead "
                             "columns are not all at its right")
        for a in range(len(trows)):
            items += [(lvl, i_r + a, i_c + b, min(tc, plan.wp - tcols[b][2]))
                      for b in live]
            if dead < len(tcols):
                items.append((lvl, i_r + a, i_c + dead,
                              plan.wp - tcols[dead][2]))
    # the deepest levels (the most work an output) first, level 0's copies
    # spread evenly among them, so that its streaming overlaps their work
    copies = [(0, r0, min(K1_COPY_ROWS, plan.block_rows[0] - r0), 0)
              for r0 in range(0, plan.block_rows[0], K1_COPY_ROWS)]
    items = items[::-1]
    step = len(items) / len(copies)
    for i, c in enumerate(copies):
        items.insert(int(i * step) + i, c)
    items = np.asarray(items, np.int32)
    trow = np.asarray(trow, np.int32)
    tcol = np.asarray(tcol, np.int32)
    records = np.zeros((items.shape[0], 8), np.int32)
    lv = items[:, 0] > 0
    records[:, 0] = items[:, 0]
    records[~lv, 1:3] = items[~lv, 1:3]
    tr_, tc_ = trow[items[lv, 1]], tcol[items[lv, 2]]
    records[lv, 1:4] = tr_[:, :3]
    records[lv, 4:7] = tc_[:, :3]
    records[lv, 7] = (tr_[:, 3] << 16) | tc_[:, 3]
    zero = lv.copy()
    zero[lv] = tc_[:, 1] == 0
    records[zero, 4] = items[zero, 3]
    return FlatKernelPlan(
        tuple(tiles), tuple(taps), trow, tcol, np.concatenate(rmeta),
        np.concatenate(cmeta), items, records, smem,
        min(SM_THREADS // K1_THREADS,
            SM_SMEM // (smem + SM_BLOCK_RESERVED)))


@functools.lru_cache(maxsize=8)
def _device_plan(h, w, n_levels, scale_factor, cell, device: str):
    """The kernel plan's tables, uploaded once per shape and device."""
    kp = kernel_plan(h, w, n_levels, scale_factor, cell)
    return {k: torch.from_numpy(np.ascontiguousarray(getattr(kp, k))).to(
        device) for k in ("rmeta", "cmeta", "records")}


def occupancy(kp: FlatKernelPlan, device) -> int:
    """The kernel's resident blocks an SM on `device` with the plan's
    shared memory (registers included)."""
    fn = _build.load("flatpyr").flatpyr_occupancy
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int]
    with torch.cuda.device(device):
        return fn(kp.smem)


def _level_desc(kp: FlatKernelPlan, plan) -> np.ndarray:
    """Per level (K1_MAX_LEVELS of them, level 0 unused): tile rows, tile
    columns, log2 of tile columns, tap bound, first packed row, rows."""
    desc = np.zeros((K1_MAX_LEVELS, 6), np.int32)
    for lvl, ((tr, tc), K) in enumerate(zip(kp.tiles, kp.taps), 1):
        desc[lvl] = (tr, tc, tc.bit_length() - 1, K, plan.bases[lvl],
                     plan.block_rows[lvl])
    return desc


def launch_records(img, out, shape, records):
    """Launch the kernel on img [h, w] into the packed buffer `out` for
    the items of `records` (a device tensor of kernel_plan(...).records
    rows; all of them for the whole buffer) under `shape` = (n_levels,
    scale_factor, cell). Counts no launch: `build_flat_pyramid` is the
    wrapper."""
    h, w = img.shape
    n_levels, scale_factor, cell = shape
    plan = flat_tables(h, w, n_levels, scale_factor, cell).plan
    kp = kernel_plan(h, w, n_levels, scale_factor, cell)
    d = _device_plan(h, w, n_levels, scale_factor, cell, str(img.device))
    desc = _level_desc(kp, plan)
    fn = _build.load("flatpyr").flatpyr_launch
    fn.restype = ctypes.c_int
    P, I = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [P, I, I, P, I, I, I, P, P, P, I, I, P, P]
    with torch.cuda.device(img.device):
        stream = torch.cuda.current_stream(img.device).cuda_stream
        err = fn(img.data_ptr(), h, w, desc.ctypes.data, plan.wp,
                 plan.cell, plan.pad_left, d["rmeta"].data_ptr(),
                 d["cmeta"].data_ptr(), records.data_ptr(),
                 records.shape[0], kp.smem, out.data_ptr(), stream)
    _build.check(err, "flatpyr")


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
    plan = flat_tables(h, w, n_levels, scale_factor, cell).plan
    out = torch.empty((plan.total_rows, plan.wp), dtype=torch.float32,
                      device=img.device)
    d = _device_plan(h, w, n_levels, scale_factor, cell, str(img.device))
    launch_records(img, out, (n_levels, scale_factor, cell), d["records"])
    build_flat_pyramid.launches += 1
    return out


build_flat_pyramid.launches = 0
