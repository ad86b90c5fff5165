"""The banded-stencil kernels: K5, a stack of banded sandwiches of one
image, out[p] = mhs[p] @ x @ mws[p]^T, and K8, one banded sandwich per
channel, out[..., c] = mh @ x[..., c] @ mw^T.

K5 replaces pislamfusion_tpu/ops/stencil_pallas.py `banded_stack_pallas`
(its `pallas_call` in `_stack_call` at :338), which SIFT's octave stack
calls (sift.py:99-105) for every octave with min(h, w) >= 256 whose bands
fit `stack_fusable`.

Function: for the P composed chain-blur operators of one octave,
M_p = B_p @ ... @ B_1 (B_i the reflect-folded blur matrix of the i-th
chain sigma, composed in float64 and cast to float32, as
sift._stack_matrices builds them),

    out[p] = mhs[p] @ x @ mws[p]^T        (the row product first, all f32)

On the H100 the stack is bound by operations: at 1080p the default SIFT
chain (5 scales, composed half-widths 4, 9, 15, 23 and 33) is ~1.43 GFLOP
of f32 multiply-adds for octave 0 against ~50 MB of traffic. The TPU kernel
ran dense 128-row MXU tiles over a static union window; here the host
keeps, per output row of each operator, only its nonzero span (start,
length, weights: every span is contiguous because the reflect folds stay
inside [0, n)), and records each scale's interior: away from the folds,
on [r, n - r), every span is one weight vector shifted, bit for bit
(`chain_tables` checks it and raises otherwise). The CUDA kernel
(`csrc/bandedstack.cu`) splits the work into items of one scale and one
tile (16 or 32 output rows by 32-224 columns), the widest scale first, on
a persistent grid (`stack_plan`: the largest tiles that still give every
SM four blocks' worth of items). An item's row pass computes t1 over its
columns and a halo into shared memory, a thread 16 rows of one column;
its column pass gives a thread 8 outputs of one row. Interior groups of
rows or columns multiply by the scale's vector, which the kernel takes in
its parameters; edge groups by a dense block of their outputs' weights
that the item stages in shared memory. The kernel is instantiated for
SIFT's five half-widths and the plan raises on any other chain. Summing
over spans instead of the dense product changes only the f32 summation
order. TF32 is not used: the TPU kernel ran at Precision.HIGHEST.

The host tables are built without any dense n^3 product: each banded blur
matrix is applied in turn to a band of half-width sum(r_i) in float64.

K8 replaces `banded_sandwich_pallas` (its `pallas_call` in `_sandwich_call`
at :178), the fused form of ops/image.py's `_matmul_sep`. The port routes
every pyrDown and pyrUp through it (image.pyr_down / pyr_up, on the
reference's own `_dec_matrix` / `_up_matrix`), for any size: the
reference's `can_fuse` was the TPU's VMEM budget and is not carried.
`SandwichTables` keep each matrix row's nonzero span; the plain version
(`banded_sandwich_plain`) gathers the span tap by tap and sums in tap
order, rows first, and the kernel (`csrc/bandedsandwich.cu`) does the
same arithmetic in the same order, so the two are equal. Neither forms a
dense [n, n] product. `sandwich_plan` is the kernel's launch plan, all
that the host computes for it: the tile shape, each tile's input window,
the per-tile span tables it stages, the tap bound and the shared memory.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools

import numpy as np
import torch

from .. import _build
from ..core.device import device_const
from . import image as im

_BLK = 128          # the TPU kernel's tile, for the fusability verdict

# Hopper: 228 KB of shared memory an SM, of which a block may use 227 KB
# and the runtime reserves 1 KB a block; 2048 threads an SM.
SMEM_LIMIT = 232448
SM_SMEM = 233472
SM_BLOCK_RESERVED = 1024
SM_THREADS = 2048


@dataclasses.dataclass(frozen=True)
class StackTables:
    """Host tables of P banded [n, n] operators per axis of an h x w image:
    per output row (or column) the start, length and float32 weights of
    its nonzero span, and per scale its interior: the outputs [lo, hi)
    whose spans are the same vector shifted (start y - r, length 2r + 1,
    r the scale's composed half-width), and that vector."""
    key: tuple               # (h, w, taps of each chain step)
    row_start: np.ndarray    # [P, h] int32
    row_len: np.ndarray      # [P, h] int32
    row_w: np.ndarray        # [P, h, KR] float32
    col_start: np.ndarray    # [P, w] int32
    col_len: np.ndarray      # [P, w] int32
    col_w: np.ndarray        # [P, w, KC] float32
    radius: np.ndarray       # [P] int32 composed half-width r of each scale
    row_lo: np.ndarray       # [P] int32 first interior row (r)
    row_hi: np.ndarray       # [P] int32 one past the last (max(r, h - r))
    row_iw: np.ndarray       # [P, KR] float32 interior weights, 0 past 2r + 1
    col_lo: np.ndarray       # [P] int32
    col_hi: np.ndarray       # [P] int32
    col_iw: np.ndarray       # [P, KC] float32

    @property
    def shape(self):
        return self.row_start.shape[1], self.col_start.shape[1]

    @property
    def scales(self) -> int:
        return self.row_start.shape[0]


def _compose_chain(n: int, taps_list) -> tuple:
    """Spans of M_p = B_p @ ... @ B_1 (B_i = im._blur_matrix(n, taps_i,
    "reflect")), composed in float64 on a band of half-width sum(r_i) and
    cast to float32. Returns (start [P, n], len [P, n], weights [P, n, K])."""
    rtot = sum((len(t) - 1) // 2 for t in taps_list)
    nb = 2 * rtot + 1
    j = np.arange(n)
    band = np.zeros((n, nb), np.float64)   # band[j, t] = M[j, j - rtot + t]
    band[:, rtot] = 1.0
    t = np.arange(nb)
    starts, lens, wts = [], [], []
    for taps in taps_list:
        b = im._blur_matrix(n, tuple(taps), "reflect")
        rows, cols = np.nonzero(b)             # row-major: rows ascending
        cnt = np.bincount(rows, minlength=n)
        slot = np.arange(rows.size) - np.repeat(np.cumsum(cnt) - cnt, cnt)
        q = np.tile(j[:, None], (1, cnt.max()))
        v = np.zeros(q.shape, np.float64)
        q[rows, slot] = cols
        v[rows, slot] = b[rows, cols]
        r = (len(taps) - 1) // 2
        padded = np.pad(band, ((0, 0), (r, r)))
        new = np.zeros_like(band)
        for s in range(q.shape[1]):
            # M_new[j, c] += B[j, q] * M[q, c], c = j - rtot + t, read from
            # row q of the band at t + (j - q) (|j - q| <= r)
            new += v[:, s:s + 1] * padded[q[:, s:s + 1],
                                          t[None, :] + (j - q[:, s])[:, None]
                                          + r]
        band = new
        f32 = band.astype(np.float32)
        nz = f32 != 0
        first = nz.argmax(1)
        last = nb - 1 - nz[:, ::-1].argmax(1)
        starts.append(j - rtot + first)
        lens.append(last - first + 1)
        wts.append((f32, first))
    kmax = max(int(ln.max()) for ln in lens)
    out_w = []
    for (f32, first), ln in zip(wts, lens):
        k = np.arange(kmax)
        idx = np.minimum(first[:, None] + k[None, :], nb - 1)
        w = np.take_along_axis(f32, idx, 1)
        out_w.append(np.where(k[None, :] < ln[:, None], w, 0.0))
    return (np.stack(starts).astype(np.int32), np.stack(lens).astype(np.int32),
            np.stack(out_w).astype(np.float32))


def _interior(start, length, weights, radius):
    """Per scale p of radius r: (lo, hi, vector) with lo = r, hi = max(r,
    n - r) and the weights of output lo, after checking bit for bit that
    every output y in [lo, hi) has start y - r, length 2r + 1 and those
    weights. Raises ValueError where one does not."""
    P, n, k = weights.shape
    lo = np.asarray(radius, np.int32)
    hi = np.maximum(lo, n - lo).astype(np.int32)
    vec = np.zeros((P, k), np.float32)
    for p, r in enumerate(radius):
        ys = np.arange(lo[p], hi[p])
        if ys.size == 0:
            continue
        vec[p] = weights[p, ys[0]]
        if not ((start[p, ys] == ys - r).all()
                and (length[p, ys] == 2 * r + 1).all()
                and (weights[p, ys] == vec[p]).all()):
            raise ValueError(f"chain_tables: scale {p} (half-width {r}) is "
                             f"not translation-invariant on [{lo[p]}, "
                             f"{hi[p]}) of {n}")
    return lo, hi, vec


@functools.lru_cache(maxsize=16)
def chain_tables(h: int, w: int, taps_list: tuple) -> StackTables:
    """The tables of the composed chain blurs of `taps_list` (one tuple of
    taps per chain step) on an h x w image."""
    rs, rl, rw = _compose_chain(h, taps_list)
    cs, cl, cw = _compose_chain(w, taps_list)
    radius = np.cumsum([(len(t) - 1) // 2 for t in taps_list]).astype(
        np.int32)
    return StackTables((h, w, taps_list), rs, rl, rw, cs, cl, cw, radius,
                       *_interior(rs, rl, rw, radius),
                       *_interior(cs, cl, cw, radius))


def dense(start, length, weights) -> np.ndarray:
    """The [P, n, n] float32 matrices of a set of spans."""
    P, n, k = weights.shape
    m = np.zeros((P, n, n), np.float32)
    kk = np.arange(k)
    live = kk[None, None, :] < length[:, :, None]
    p, r, c = np.nonzero(live)
    m[p, r, start[p, r] + c] = weights[p, r, c]
    return m


# ---------------------------------------------------------------------------
# fusability: the reference's verdict (stencil_pallas.py:263-287), on spans
# ---------------------------------------------------------------------------

def _min_kb(start, length) -> int:
    """stencil_pallas._min_kb of one [n_out, n_in] operator: the 128-block
    window a 128-row output tile needs, at most over the tiles."""
    kb = 1
    for i in range(0, start.shape[0], _BLK):
        ln = length[i:i + _BLK]
        live = ln > 0
        if live.any():
            s = start[i:i + _BLK][live]
            first, last = int(s.min()), int((s + ln[live] - 1).max())
            s0 = (first // _BLK) * _BLK
            kb = max(kb, -(-(last + 1 - s0) // _BLK))
    return kb


def _lane_union_kb(start, length, n_in: int) -> int:
    """The 128-block width of stencil_pallas._lane_union_windows' union
    window over every scale's column spans (that function gives up when it
    exceeds min(max_kb, ceil(n_in / 128)))."""
    nj = -(-start.shape[1] // _BLK)
    nk = -(-n_in // _BLK)
    lo = np.full(nj, n_in, np.int64)
    hi = np.zeros(nj, np.int64)
    for s_p, l_p in zip(start, length):
        for j in range(nj):
            ln = l_p[j * _BLK:(j + 1) * _BLK]
            live = ln > 0
            if live.any():
                s = s_p[j * _BLK:(j + 1) * _BLK][live]
                lo[j] = min(lo[j], int(s.min()))
                hi[j] = max(hi[j], int((s + ln[live] - 1).max()))
    w0 = (np.minimum(lo, nk * _BLK) // _BLK) * _BLK
    kb = 1
    for j in range(nj):
        if hi[j] >= lo[j]:
            kb = max(kb, -(-int(hi[j] + 1 - w0[j]) // _BLK))
    return kb


def stack_fusable(tabs: StackTables, max_kb: int = 4) -> bool:
    """stencil_pallas.stack_fusable: every scale's row band fits a narrow
    fixed window and the column bands a narrow union window. The octave
    stack takes K5 exactly where the reference does."""
    h, w = tabs.shape
    kbr = max(_min_kb(s, ln) for s, ln in zip(tabs.row_start, tabs.row_len))
    kbc = _lane_union_kb(tabs.col_start, tabs.col_len, w)
    return (kbr <= min(max_kb, -(-h // _BLK))
            and kbc <= min(max_kb, -(-w // _BLK)))


# ---------------------------------------------------------------------------
# the plain version and the kernel's wrapper
# ---------------------------------------------------------------------------

def _dense_on(tabs: StackTables, device):
    return (device_const(("bandedstack_mh", tabs.key), device, lambda:
                         torch.from_numpy(dense(tabs.row_start, tabs.row_len,
                                                tabs.row_w))),
            device_const(("bandedstack_mw", tabs.key), device, lambda:
                         torch.from_numpy(dense(tabs.col_start, tabs.col_len,
                                                tabs.col_w))))


def banded_stack_plain(x, tabs: StackTables):
    """Plain PyTorch version: two dense f32 products a scale, the row
    product first."""
    mhs, mws = _dense_on(tabs, x.device)
    return torch.matmul(torch.matmul(mhs, x), mws.transpose(1, 2))


# K5's kernel (csrc/bandedstack.cu) and its launch plan
K5_THREADS = 256
K5_BLOCKS = 4                  # resident blocks an SM the plan aims to fill
K5_HALF_WIDTHS = (4, 9, 15, 23, 33)   # its instantiations: SIFT's chain
K5_OFFSETS = {4: 0, 9: 9, 15: 28, 23: 59, 33: 106}   # in its weight arrays
K5_NW = 173                    # floats of each weight array
K5_ROWS = 16                   # output rows of a row group (a thread's)
K5_COLS = 8                    # output columns of a column group
# (tile rows, t1 columns at most), tried largest first
K5_TILES = ((32, 256), (16, 224), (16, 160))


def _round32(n: int) -> int:
    return -(-n // 32) * 32


def _groups(start, length, weights, lo: int, hi: int, r: int, n: int,
            R: int):
    """The groups of R consecutive outputs along one axis of one scale of
    half-width r: each group's window start, and for each edge group (one
    with an output outside the interior [lo, hi)) the dense [R + 2r, R]
    block of its outputs' weights over the window, 0 past each output's
    span and for outputs past n. An interior group's window starts at its
    first output less r. Raises ValueError where a window would leave
    [0, n) or miss a span."""
    L = R + 2 * r
    if n < L:
        raise ValueError(f"banded_stack: {n} outputs are fewer than a "
                         f"group's window of {L}")
    G = -(-n // R)
    ws = np.empty(G, np.int32)
    blocks = {}
    for g in range(G):
        y0 = g * R
        if y0 >= lo and y0 + R <= hi:
            ws[g] = y0 - r
            continue
        s = min(max(y0 - r, 0), n - L)
        ws[g] = s
        d = np.zeros((L, R), np.float32)
        for i in range(min(R, n - y0)):
            a, m = int(start[y0 + i]), int(length[y0 + i])
            if a < s or a + m > s + L:
                raise ValueError(f"banded_stack: output {y0 + i}'s span "
                                 f"[{a}, {a + m}) leaves its group's "
                                 f"window [{s}, {s + L})")
            d[a - s:a - s + m, i] = weights[y0 + i, :m]
        blocks[g] = d
    return ws, blocks


@dataclasses.dataclass(frozen=True)
class StackPlan:
    """How the K5 kernel cuts one octave stack. A work item is one scale
    and one tile of `th` output rows by `tw[s]` output columns; items go
    scale by scale, the widest first (`order`: the scale of each slot s).
    An item's row pass computes `cw[s]` t1 columns from its tile column's
    first input column (`tx_t0`), a row group (16 output rows) a thread;
    its column pass a column group (8 output columns) a thread. An
    interior group takes its scale's vector (`wr`, `wc`: the kernel's
    parameters, at K5_OFFSETS of its half-width); an edge group a dense
    block of weights (`d_row` [16 + 2r, 16], `d_col` [8 + 2r, 8]) that
    the item stages in shared memory: the row blocks of its row groups
    and the column blocks of its tile column in `tx_slots`' slots."""
    th: int                  # output rows a tile (16 or 32)
    cmax: int                # t1 columns an item computes at most
    pitch: int               # floats a t1 row (cmax + 1: rows a bank apart)
    order: tuple             # scale of each slot
    rh: tuple                # half-width of each slot's scale
    tw: tuple                # output columns a tile (a multiple of 32)
    cw: tuple                # t1 columns an item computes (<= cmax)
    ntx: tuple               # tiles across
    nty: int                 # tiles down
    item0: tuple             # first item of each slot, then the item count
    rg0: tuple               # offset of each slot's row groups
    cg0: tuple               # offset of each slot's column groups
    tx0: tuple               # offset of each slot's tile columns
    rg_ws: np.ndarray        # int32 window start row of each row group
    rg_e: np.ndarray         # int32 its block's offset in d_row, -1 interior
    cg_ws: np.ndarray        # int32 window start column of a column group
    cg_e: np.ndarray         # int32 its block's offset in d_col, -1 interior
    cg_slot: np.ndarray      # int32 its slot in its tile column, -1 interior
    tx_t0: np.ndarray        # int32 first t1 column of each tile column
    tx_slots: np.ndarray     # [tile columns, nslot] int32 d_col offsets
    d_row: np.ndarray        # float32 edge row blocks
    d_col: np.ndarray        # float32 edge column blocks
    rslot: int               # floats of a row block slot in shared memory
    cslot: int               # floats of a column block slot
    nslot: int               # column block slots
    wr: np.ndarray           # [K5_NW] float32 interior row vectors
    wc: np.ndarray           # [K5_NW] float32 interior column vectors
    smem: int                # bytes of dynamic shared memory a block
    blocks_per_sm: int       # by shared memory and threads (the card's
                             # count, registers too: bandedstack_occupancy)

    @property
    def n_items(self) -> int:
        return self.item0[-1]


def _tile_widths(radius, cmax: int, w: int):
    """Each scale's tile width under `cmax` t1 columns: the widest multiple
    of 32 whose row pass (tw + 2r, rounded up to 32) fits, no wider than
    the image rounded up; None where a scale fits no 32."""
    tws = []
    for r in radius:
        tw = 32 * ((cmax - 2 * r) // 32)
        if tw < 32:
            return None
        tws.append(min(tw, _round32(w)))
    return tws


def stack_plan(tabs: StackTables, slots: int | None = None,
               tiles=None) -> StackPlan:
    """K5's launch plan for `tabs`: the tiles of the first (tile rows, t1
    columns) of K5_TILES whose items number at least `slots` (the card's
    resident blocks; None takes the first that fits), else of the last
    that fits; `tiles` = (tile rows, each scale's tile width) forces a
    cut (a multiple of 32 wide; scripts/torch_k5_k1_sweep.py). Raises
    ValueError where the kernel cannot take the stack: a scale's
    half-width outside K5_HALF_WIDTHS or repeated, or an image smaller
    than a group's window."""
    h, w = tabs.shape
    P = tabs.scales
    radius = [int(r) for r in tabs.radius]
    if (P > len(K5_HALF_WIDTHS) or len(set(radius)) != P
            or any(r not in K5_HALF_WIDTHS for r in radius)):
        raise ValueError(f"banded_stack: the kernel takes distinct "
                         f"half-widths of {K5_HALF_WIDTHS}, not {radius}")
    order = sorted(range(P), key=lambda p: -radius[p])
    rs = [radius[p] for p in order]
    if tiles is None:
        for th, cmax in K5_TILES:
            tws = _tile_widths(rs, cmax, w)
            if tws is None:
                continue
            tiles = (th, tws)
            items = -(-h // th) * sum(-(-w // tw) for tw in tws)
            if slots is None or items >= slots:
                break
        if tiles is None:
            raise ValueError(f"banded_stack: no tile takes half-widths {rs}")
    th, tws = tiles[0], list(tiles[1])
    if th not in (16, 32) or any(tw % 32 or tw < 32 for tw in tws):
        raise ValueError(f"banded_stack: tiles {tiles}")
    nty = -(-h // th)
    item0, rg0, cg0, tx0 = [0], [], [], []
    rg_ws, rg_e, cg_ws, cg_e, cg_slot, tx_t0, lists = ([] for _ in range(7))
    d_row, d_col = [], []
    n_row = n_col = 0
    for s, p in enumerate(order):
        r, tw = rs[s], tws[s]
        ntx = -(-w // tw)
        item0.append(item0[-1] + nty * ntx)
        rg0.append(sum(a.size for a in rg_ws))
        cg0.append(sum(a.size for a in cg_ws))
        tx0.append(len(tx_t0))
        ws, blocks = _groups(tabs.row_start[p], tabs.row_len[p],
                             tabs.row_w[p], int(tabs.row_lo[p]),
                             int(tabs.row_hi[p]), r, h, K5_ROWS)
        e = np.full(ws.size, -1, np.int32)
        for g, d in blocks.items():
            e[g] = n_row
            d_row.append(d.ravel())
            n_row += d.size
        rg_ws.append(ws)
        rg_e.append(e)
        ws, blocks = _groups(tabs.col_start[p], tabs.col_len[p],
                             tabs.col_w[p], int(tabs.col_lo[p]),
                             int(tabs.col_hi[p]), r, w, K5_COLS)
        e = np.full(ws.size, -1, np.int32)
        slot = np.full(ws.size, -1, np.int32)
        for g, d in blocks.items():
            e[g] = n_col
            d_col.append(d.ravel())
            n_col += d.size
        gpt = tw // K5_COLS
        cw = _round32(tw + 2 * r)
        for tx in range(ntx):
            gs = np.arange(tx * gpt, min((tx + 1) * gpt, ws.size))
            t0 = int(ws[gs].min())
            if int(ws[gs].max()) + K5_COLS + 2 * r - t0 > cw:
                raise ValueError(f"banded_stack: tile column {tx} of "
                                 f"half-width {r} needs more than {cw} "
                                 "t1 columns")
            edge = gs[e[gs] >= 0]
            slot[edge] = np.arange(edge.size)
            lists.append(e[edge])
            tx_t0.append(t0)
        cg_ws.append(ws)
        cg_e.append(e)
        cg_slot.append(slot)
    nslot = max(len(a) for a in lists)
    if max(tws) > 256 or nslot > 32:
        raise ValueError(f"banded_stack: tiles {tws} wider than 256 or "
                         f"{nslot} edge column groups in one")
    tx_slots = np.full((len(lists), max(nslot, 1)), -1, np.int32)
    for i, a in enumerate(lists):
        tx_slots[i, :len(a)] = a
    rslot = max(K5_ROWS + 2 * r for r in rs) * K5_ROWS
    cslot = max(K5_COLS + 2 * r for r in rs) * K5_COLS
    cws = [_round32(tw + 2 * r) for tw, r in zip(tws, rs)]
    cmax = max(cws)
    pitch = cmax + 1
    smem = 4 * (th * pitch + th // K5_ROWS * rslot + nslot * cslot)
    if smem > SMEM_LIMIT:
        raise ValueError(f"banded_stack: {smem} bytes of shared memory a "
                         "block")
    wr = np.zeros(K5_NW, np.float32)
    wc = np.zeros(K5_NW, np.float32)
    for p, r in enumerate(radius):
        o = K5_OFFSETS[r]
        wr[o:o + 2 * r + 1] = tabs.row_iw[p, :2 * r + 1]
        wc[o:o + 2 * r + 1] = tabs.col_iw[p, :2 * r + 1]
    cat = np.concatenate
    return StackPlan(
        th, cmax, pitch, tuple(order), tuple(rs), tuple(tws), tuple(cws),
        tuple(-(-w // tw) for tw in tws), nty, tuple(item0), tuple(rg0),
        tuple(cg0), tuple(tx0), cat(rg_ws), cat(rg_e), cat(cg_ws),
        cat(cg_e), cat(cg_slot), np.asarray(tx_t0, np.int32), tx_slots,
        cat(d_row), cat(d_col), rslot, cslot, nslot, wr, wc, smem,
        min(SM_THREADS // K5_THREADS,
            SM_SMEM // (smem + SM_BLOCK_RESERVED)))


def stack_plan_on_device(plan: StackPlan, device):
    """(plan, its tables on `device`, the kernel's resident blocks an SM
    there, the device's SM count): what `launch_stack` takes."""
    d = {name: torch.from_numpy(np.ascontiguousarray(getattr(plan, name)))
         .to(device)
         for name in ("rg_ws", "rg_e", "cg_ws", "cg_slot", "tx_t0",
                      "tx_slots", "d_row", "d_col")}
    fn = _build.load("bandedstack").bandedstack_occupancy
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int]
    with torch.cuda.device(device):
        occ = fn(plan.smem)
    if occ < 1:
        raise RuntimeError(f"banded_stack: the kernel fits no block with "
                           f"{plan.smem} bytes of shared memory (occupancy "
                           f"{occ})")
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return plan, d, occ, sms


_STACK_PLANS: dict = {}


def _stack_on(tabs: StackTables, device):
    """stack_plan_on_device(stack_plan(tabs, K5_BLOCKS x the SM count),
    device), made on first use."""
    device = torch.device(device)
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    key = (tabs.key, index)
    if key not in _STACK_PLANS:
        sms = torch.cuda.get_device_properties(index).multi_processor_count
        _STACK_PLANS[key] = stack_plan_on_device(
            stack_plan(tabs, K5_BLOCKS * sms), device)
    return _STACK_PLANS[key]


def _stack_desc(plan: StackPlan) -> np.ndarray:
    """The kernel's integer parameters (csrc/bandedstack.cu `Params`):
    the item count, tile rows, pitch, slots and slot sizes, then per slot
    (five; unused ones start at the item count) its scale, half-width,
    tile width, t1 columns, tiles across, first item and table offsets."""
    n = len(K5_HALF_WIDTHS)
    head = [plan.n_items, plan.th, plan.pitch, plan.nslot, plan.rslot,
            plan.cslot, len(plan.order)]
    per = []
    for s in range(n):
        if s < len(plan.order):
            per.append([plan.order[s], plan.rh[s], plan.tw[s], plan.cw[s],
                        plan.ntx[s], plan.item0[s], plan.rg0[s],
                        plan.cg0[s], plan.tx0[s]])
        else:
            per.append([0, 0, 32, 32, 1, plan.n_items, 0, 0, 0])
    return np.asarray(head + [v for row in per for v in row], np.int32)


def launch_stack(x, out, on_device):
    """Launch the kernel on x [h, w] into out [P, h, w] (both contiguous
    float32 on the card) under `on_device` (stack_plan_on_device's
    tuple). Counts no launch: `banded_stack` is the wrapper."""
    plan, d, occ, sms = on_device
    h, w = x.shape
    desc = _stack_desc(plan)
    fn = _build.load("bandedstack").bandedstack_launch
    fn.restype = ctypes.c_int
    V, I = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [V, V, I, I, V, V, V] + [V] * 8 + [I, I, V]
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), out.data_ptr(), h, w, desc.ctypes.data,
                 plan.wr.ctypes.data, plan.wc.ctypes.data,
                 *(d[k].data_ptr() for k in (
                     "rg_ws", "rg_e", "cg_ws", "cg_slot", "tx_t0",
                     "tx_slots", "d_row", "d_col")),
                 plan.smem, min(plan.n_items, occ * sms), stream)
    _build.check(err, "bandedstack")


def banded_stack(x, tabs: StackTables):
    """x: [h, w] float32. Returns [P, h, w] float32, out[p] = mhs[p] @ x @
    mws[p]^T for the operators of `tabs`. CPU tensors take the plain
    version; CUDA tensors launch the kernel (stack_plan raises on a chain
    it cannot take)."""
    if x.device.type == "cpu":
        return banded_stack_plain(x, tabs)
    if x.device.type != "cuda":
        raise ValueError(f"banded_stack: unsupported device {x.device}")
    if x.dtype != torch.float32 or tuple(x.shape) != tabs.shape:
        raise ValueError(f"banded_stack: x must be float32 {tabs.shape}")
    x = x.contiguous()
    h, w = tabs.shape
    out = torch.empty((tabs.scales, h, w), dtype=torch.float32,
                      device=x.device)
    launch_stack(x, out, _stack_on(tabs, x.device))
    banded_stack.launches += 1
    return out


banded_stack.launches = 0


# ---------------------------------------------------------------------------
# K8: one banded sandwich per channel
# ---------------------------------------------------------------------------

def row_spans(m: np.ndarray):
    """Each row's nonzero span of a banded [n_out, n_in] matrix: (start
    [n_out] int32, length [n_out] int32, weights [n_out, K] float32, the
    span's entries, zero past its length; K the longest span). Zeros
    inside a span are kept as taps."""
    nz = m != 0
    live = nz.any(1)
    n = m.shape[1]
    first = np.where(live, nz.argmax(1), 0)
    last = np.where(live, n - 1 - nz[:, ::-1].argmax(1), -1)
    length = last - first + 1
    k = np.arange(max(1, int(length.max())))
    w = np.take_along_axis(m, np.minimum(first[:, None] + k, n - 1), 1)
    w = np.where(k[None, :] < length[:, None], w, 0.0)
    return (first.astype(np.int32), length.astype(np.int32),
            w.astype(np.float32))


@dataclasses.dataclass(frozen=True)
class SandwichTables:
    """Host tables of one sandwich mh [Ho, H], mw [Wo, W]: each row's
    nonzero span per matrix."""
    key: tuple
    in_shape: tuple          # (H, W)
    row_start: np.ndarray    # [Ho] int32
    row_len: np.ndarray      # [Ho] int32
    row_w: np.ndarray        # [Ho, KR] float32
    col_start: np.ndarray    # [Wo] int32
    col_len: np.ndarray      # [Wo] int32
    col_w: np.ndarray        # [Wo, KC] float32

    @property
    def out_shape(self):
        return self.row_start.shape[0], self.col_start.shape[0]


def sandwich_tables(key, mh: np.ndarray, mw: np.ndarray) -> SandwichTables:
    """The tables of mh @ x @ mw^T; `key` names the pair (device copies of
    the tables and the kernel's plans are cached under it)."""
    return SandwichTables(key, (mh.shape[1], mw.shape[1]),
                          *row_spans(mh), *row_spans(mw))


def _span_taps(start, length, k: int) -> np.ndarray:
    """[k, n_out] int64: the input index of each output's j-th tap, held
    at the span's last index past its length (where the weight is 0)."""
    j = np.arange(k)[:, None]
    return np.minimum(start[None, :] + j,
                      start[None, :] + np.maximum(length[None, :], 1) - 1
                      ).astype(np.int64)


def _span_apply(x, axis: int, taps, w):
    """out = m @ x along `axis` (negative) from m's spans: one gather of
    every output's k-th tap at a time, summed in tap order from the first
    product (f32, each product and sum rounded on its own)."""
    acc = None
    shape = [1] * x.ndim
    shape[axis] = taps.shape[1]
    for k in range(taps.shape[0]):
        t = x.index_select(axis, taps[k]) * w[:, k].reshape(shape)
        acc = t if acc is None else acc + t
    return acc


def _sandwich_device(tabs: SandwichTables, device):
    def up(name, a):
        return device_const(("sandwich", name, tabs.key), device,
                            lambda: torch.from_numpy(np.ascontiguousarray(a)))
    return {
        "row_w": up("row_w", tabs.row_w),
        "col_w": up("col_w", tabs.col_w),
        "row_taps": up("row_taps", _span_taps(
            tabs.row_start, tabs.row_len, tabs.row_w.shape[1])),
        "col_taps": up("col_taps", _span_taps(
            tabs.col_start, tabs.col_len, tabs.col_w.shape[1])),
    }


def banded_sandwich_plain(x, tabs: SandwichTables):
    """Plain PyTorch version: x [..., H, W, C] float32 -> [..., Ho, Wo, C],
    the row matrix's spans first, then the column matrix's."""
    d = _sandwich_device(tabs, x.device)
    t = _span_apply(x, -3, d["row_taps"], d["row_w"])
    return _span_apply(t, -2, d["col_taps"], d["col_w"])


# The K8 kernel's launch plan (Hopper's limits are at the top).
K8_THREADS = 256                 # csrc/bandedsandwich.cu THREADS
K8_BLOCKS = 4                    # resident blocks an SM the plan keeps
# csrc/bandedsandwich.cu's instantiations, (C, tap bound): the tile
# height of each (pyrDown spans are 5 taps, pyrUp spans 3)
K8_TILE_ROWS = {(1, 3): 32, (3, 3): 16, (1, 5): 16, (3, 5): 8}


def _ceil_log2(n: int) -> int:
    return max(0, int(n - 1).bit_length())


def _round4(n: int) -> int:
    return -(-n // 4) * 4


def _windows(start, length, tile: int):
    """Per tile of `tile` consecutive outputs: (first input index, count)
    of the union of its outputs' nonzero spans; (0, 0) where it has none."""
    n = start.shape[0]
    nt = -(-n // tile)
    pad = nt * tile - n
    live = length > 0
    big = np.iinfo(np.int64).max
    start = start.astype(np.int64)
    lo = np.pad(np.where(live, start, big), (0, pad),
                constant_values=big).reshape(nt, tile).min(1)
    hi = np.pad(np.where(live, start + length, -1), (0, pad),
                constant_values=-1).reshape(nt, tile).max(1)
    empty = hi < 0
    return (np.where(empty, 0, lo).astype(np.int32),
            np.where(empty, 0, hi - lo).astype(np.int32))


def _span_meta(start, length, w, first, tile: int, K: int, scale: int):
    """[n_tiles, words] int32, one row a tile, 16-byte aligned: the offset
    of each output's span from the tile's first input index (times
    `scale`: floats a column), its length, then its K weights (float32
    bits), weight k of output i at word (2 + k) * tile + i. Outputs past
    the end have length 0."""
    nt = first.shape[0]
    pad = nt * tile - start.shape[0]
    st = np.pad(start, (0, pad)).reshape(nt, tile).astype(np.int64)
    ln = np.pad(length, (0, pad)).reshape(nt, tile)
    wk = np.zeros((nt * tile, K), np.float32)
    wk[:w.shape[0], :w.shape[1]] = w
    meta = np.zeros((nt, _round4((2 + K) * tile)), np.int32)
    meta[:, :tile] = np.where(ln > 0, (st - first[:, None]) * scale, 0)
    meta[:, tile:2 * tile] = ln
    meta[:, 2 * tile:(2 + K) * tile] = (
        wk.reshape(nt, tile, K).transpose(0, 2, 1).reshape(nt, K * tile)
        .view(np.int32))
    return meta


@dataclasses.dataclass(frozen=True)
class SandwichPlan:
    """How the K8 kernel cuts one sandwich of C channels: tiles of `tr`
    output rows by `tc` output columns, each staging its input window
    (`sr` rows at most, `pitch` floats a row: the window's columns times C
    plus up to 3 floats of alignment lead) and its span tables (`rmeta`,
    `cmeta`) twice, plus the row-pass result (`tr` x `pitch`)."""
    C: int
    K: int                   # tap bound: every span is at most K long
    tr: int
    tc: int
    tile_r0: np.ndarray      # [ntr] int32 first input row of a tile row
    tile_rn: np.ndarray      # [ntr] int32 input rows it reads
    tile_c0: np.ndarray      # [ntc] int32 first input column
    tile_cn: np.ndarray      # [ntc] int32 input columns it reads
    rmeta: np.ndarray        # [ntr, rm] int32 (_span_meta)
    cmeta: np.ndarray        # [ntc, cm] int32
    sr: int
    pitch: int
    lgr: int                 # log2 of the row pass's threads a row
    lgw: int                 # log2 of the column pass's warps a row
    smem: int                # bytes of dynamic shared memory a block
    blocks_per_sm: int       # resident blocks an SM by shared memory and
                             # threads (the card's count, registers too,
                             # comes from bandedsandwich_occupancy)

    @property
    def tiles(self):
        return self.tile_r0.shape[0], self.tile_c0.shape[0]


def tap_bound(tabs: SandwichTables, C: int) -> int:
    """The kernel's compile-time tap bound for `tabs` on C channels (3 or
    5). Raises ValueError where no instantiation takes them."""
    kmax = max(int(tabs.row_len.max()), int(tabs.col_len.max()), 1)
    K = 3 if kmax <= 3 else 5
    if (C, K) not in K8_TILE_ROWS or kmax > K:
        raise ValueError(f"banded_sandwich: the kernel takes C 1 or 3 and "
                         f"spans of at most 5 taps, not C {C} and "
                         f"{kmax} taps")
    return K


def tile_plan(tabs: SandwichTables, C: int, K: int, tr: int, tc: int):
    """The plan of tr x tc output tiles for `tabs` on C channels under tap
    bound K, or None where a block's shared memory would exceed
    SMEM_LIMIT."""
    r0, rn = _windows(tabs.row_start, tabs.row_len, tr)
    c0, cn = _windows(tabs.col_start, tabs.col_len, tc)
    sr = int(rn.max())
    pitch = _round4(3 + int(cn.max()) * C)
    smem = 4 * (2 * (sr * pitch + _round4((2 + K) * tr)
                     + _round4((2 + K) * tc)) + tr * pitch)
    if smem > SMEM_LIMIT:
        return None
    return SandwichPlan(
        C, K, tr, tc, r0, rn, c0, cn,
        _span_meta(tabs.row_start, tabs.row_len, tabs.row_w, r0, tr, K, 1),
        _span_meta(tabs.col_start, tabs.col_len, tabs.col_w, c0, tc, K, C),
        sr, pitch, min(8, _ceil_log2(pitch // 4)),
        min(3, _ceil_log2(-(-tc * C // 32))), smem,
        min(SM_THREADS // K8_THREADS, SM_SMEM // (smem + SM_BLOCK_RESERVED)))


def sandwich_plan(tabs: SandwichTables, C: int) -> SandwichPlan:
    """The K8 kernel's launch plan for `tabs` on C channels. The tile
    height is K8_TILE_ROWS's. The tile width (a multiple of 4 output
    columns, no wider than the output) is the widest that keeps K8_BLOCKS
    blocks an SM in shared memory, narrowed until its slab row is at most
    a power of two of float4s, so that no lane of the row pass idles: the
    widest tile leaves up to half of them idle, and on an NVIDIA H100
    that costs more than the narrower tile's wider halo
    (scripts/torch_k8_plan_sweep.py). Raises ValueError where the kernel
    cannot take the sandwich (C, a span longer than 5 taps)."""
    K = tap_bound(tabs, C)
    tr = K8_TILE_ROWS[(C, K)]
    fits = []
    for tc in range(4, _round4(tabs.out_shape[1]) + 1, 4):
        plan = tile_plan(tabs, C, K, tr, tc)
        if plan is None or plan.blocks_per_sm < K8_BLOCKS:
            break
        fits.append(plan)
    if not fits:
        raise ValueError(f"banded_sandwich: no {tr}-row tile keeps "
                         f"{K8_BLOCKS} blocks an SM")
    lanes = 1 << ((fits[-1].pitch // 4).bit_length() - 1)
    return next(p for p in reversed(fits) if p.pitch // 4 <= lanes)


def plan_on_device(plan: SandwichPlan, device):
    """(plan, its tables on `device`, the kernel's resident blocks an SM
    there, the device's SM count): what `launch_plan` takes."""
    d = {name: torch.from_numpy(np.ascontiguousarray(a)).to(device)
         for name, a in (("tile_r0", plan.tile_r0), ("tile_rn", plan.tile_rn),
                         ("tile_c0", plan.tile_c0), ("tile_cn", plan.tile_cn),
                         ("rmeta", plan.rmeta), ("cmeta", plan.cmeta))}
    fn = _build.load("bandedsandwich").bandedsandwich_occupancy
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int] * 3
    with torch.cuda.device(device):
        occ = fn(plan.C, plan.K, plan.smem)
    if occ < 1:
        raise RuntimeError(f"banded_sandwich: the kernel fits no block with "
                           f"{plan.smem} bytes of shared memory (occupancy "
                           f"{occ})")
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return plan, d, occ, sms


_PLANS: dict = {}


def _plan_on(tabs: SandwichTables, C: int, device):
    """plan_on_device(sandwich_plan(tabs, C), device), made on first use."""
    device = torch.device(device)
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    key = (tabs.key, C, index)
    if key not in _PLANS:
        _PLANS[key] = plan_on_device(sandwich_plan(tabs, C), device)
    return _PLANS[key]


def launch_plan(xb, out, on_device):
    """Launch the kernel on xb [B, H, W, C] into out [B, Ho, Wo, C] (both
    contiguous float32 on the card) under `on_device` (plan_on_device's
    tuple). Counts no launch: `banded_sandwich` is the wrapper."""
    plan, d, occ, sms = on_device
    B, H, W, C = xb.shape
    _, Ho, Wo, _ = out.shape
    ntr, ntc = plan.tiles
    vec = int(W * C % 4 == 0 and xb.data_ptr() % 16 == 0)
    fn = _build.load("bandedsandwich").bandedsandwich_launch
    fn.restype = ctypes.c_int
    V, I = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [V] + [I] * 18 + [V] * 6 + [I, I, V, V]
    with torch.cuda.device(xb.device):
        stream = torch.cuda.current_stream(xb.device).cuda_stream
        err = fn(xb.data_ptr(), B, H, W, C, plan.K, Ho, Wo, ntr, ntc,
                 plan.tr, plan.tc, plan.sr, plan.pitch,
                 plan.rmeta.shape[1], plan.cmeta.shape[1], plan.lgr,
                 plan.lgw, vec, d["tile_r0"].data_ptr(),
                 d["tile_rn"].data_ptr(), d["tile_c0"].data_ptr(),
                 d["tile_cn"].data_ptr(), d["rmeta"].data_ptr(),
                 d["cmeta"].data_ptr(), plan.smem,
                 min(B * ntr * ntc, occ * sms), out.data_ptr(), stream)
    _build.check(err, "bandedsandwich")


def banded_sandwich(x, tabs: SandwichTables):
    """x: [..., H, W, C] float32. Returns [..., Ho, Wo, C] float32, mh @ x
    @ mw^T per channel for the matrices of `tabs`. CPU tensors take the
    plain version; CUDA tensors launch the kernel (one launch for all
    leading dimensions)."""
    if x.device.type == "cpu":
        return banded_sandwich_plain(x, tabs)
    if x.device.type != "cuda":
        raise ValueError(f"banded_sandwich: unsupported device {x.device}")
    if x.dtype != torch.float32 or x.ndim < 3 \
            or tuple(x.shape[-3:-1]) != tabs.in_shape:
        raise ValueError(f"banded_sandwich: x must be float32 [..., "
                         f"{tabs.in_shape[0]}, {tabs.in_shape[1]}, C], not "
                         f"{x.dtype} {tuple(x.shape)}")
    lead = tuple(x.shape[:-3])
    H, W, C = x.shape[-3:]
    Ho, Wo = tabs.out_shape
    xb = x.reshape((-1, H, W, C)).contiguous()
    B = xb.shape[0]
    out = torch.empty((B, Ho, Wo, C), dtype=torch.float32, device=x.device)
    if out.numel() == 0:
        return out.reshape(lead + (Ho, Wo, C))
    launch_plan(xb, out, _plan_on(tabs, C, x.device))
    banded_sandwich.launches += 1
    return out.reshape(lead + (Ho, Wo, C))


banded_sandwich.launches = 0
