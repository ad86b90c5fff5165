"""The port's kernels (their plain PyTorch versions, which a CPU tensor
takes) against the JAX package's Pallas kernels run through the Pallas
interpreter on the CPU.

K1 flat pyramid: within 1e-3 of the interpreted kernel over the whole
packed buffer (both round the source, the matrices and the row-pass
result to bf16 at the same points; only f32 summation order differs) and
within 2 gray of the exact f64 product (the cost of those bf16 roundings);
its launch plan writes every packed output once, its re-laid span tables
rebuild the matrices, and the kernel's arithmetic emulated on the plan's
records meets the card's gate against the plain version, without JAX.
K2 patch gather: bit-exact; the kernel's head, 16-byte body and tail
stores cover each patch word once for every n mod 4, and off the CPU the
wrapper refuses shapes other than ORB's. K3 shear warp: equal tile liveness, dead
tiles exactly zero, within 5e-3 gray on live pixels whose source point is
>= 2 px inside the image (the kernel's "high" bf16 hi/lo split keeps ~16
mantissa bits of the image; the port computes in f32).
K5 banded stack: within 2e-5 on a 0..1 image (both f32; the kernel's
dense 128-row tiles and the port's products sum in other orders), its
composed matrices within 1 f32 ulp of sift._stack_matrices (both cast the
same float64 products, summed in other orders), and the reference's
fusability verdict at every octave size of a 1080p frame; each scale's
recorded interior and vector reproduce its spans bit for bit, the launch
plan covers every (scale, output) once with windows and edge blocks that
hold every span, and the kernel's arithmetic emulated on the plan is
within 2e-5 of the plain version, without JAX. K6 bilinear
grid: within 1e-4 on +-128 samples (the same f32 function, the
interpreter's one-hot products summing in another order).
K8 banded sandwich: within 2e-5 of the output's largest magnitude (about
5e-3 gray at 255) on 0..255 images, for the reference's pyrDown, pyrUp,
blur and resize matrices (the interpreter's dense 128-blocks and the
port's spans sum in other orders: 2 f32 ulps, ~3e-5 gray, measured); its
spans rebuild each matrix exactly; its launch plan (tile windows, staged
span tables, tap bound, shared memory) holds at every K8 shape of the
paths, without JAX.
K4 fused FAST+NMS+select: equal (0 differing cells in cv2d and ci2d) to
the interpreted kernel on tests/test_fastselect.py's cases (two levels,
integer ties, no corners, cell 16); through a packed buffer and level
offsets, equal to the per-level plain version. Its exact pretest keeps
every pixel whose masked score is > 0 (noise, a strip frame, flat
regions, a step edge, integers; thresholds 0, 7 and 20); the kernel's
passes emulated on its plan's blocks (pretest, candidates scored alone,
NMS survivors reduced a cell) equal the plain version bit for bit on
chip_smoke.py's three pyramid layouts at a small size; every cell
belongs to one block's run.
K3 shear warp, the kernel's strips emulated in numpy f32 (the strip's
limits and wrap proof, pass 1 once per (v, x), the transposed source
staged by segments or read in place, pass 2 from I): equal to the plain
version bit for bit in both orientations and at |a00| near the largest
the window admits; every live strip's rows fit I, and a transposed strip
within the window's provisioned scale fits its staged segments.
K7 packed pyramid: the reference's plan, regime and every level's (lh +
2r, lw + 2r) block equal to the interpreted kernel (both sum the taps as
one fused multiply-add chain), zeros elsewhere; its launch plan writes
every element once, every tile waits on the tiles whose pixels it reads
and comes after them in ticket order, and its tiles emulated in torch in
ticket order (t1 once per row and window column, depth-2 tiles through
their level-(l-1) window) equal the plain version.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pislamfusion_tpu.ops import image as jim
from pislamfusion_tpu.ops import shearwarp as jsw
from pislamfusion_tpu.ops.features import flatpyr_pallas as jfpp
from pislamfusion_tpu.ops.features import pyramid_pallas as jpp
from pislamfusion_tpu.ops.features.fastselect import fast_cell_winners
from pislamfusion_tpu.ops.features import orb as jorb
from pislamfusion_tpu.ops.features import sift as jsift
from pislamfusion_tpu.ops.features.patchgather import (bilinear_grid_pallas,
                                                       gather_patches_pallas)
from pislamfusion_tpu.ops.stencil_pallas import (banded_sandwich_pallas,
                                                 banded_stack_pallas,
                                                 can_fuse)
from pislamfusion_tpu_torch.ops import image as tim
from pislamfusion_tpu_torch.ops import shearwarp as tsw
from pislamfusion_tpu_torch.ops import stencil as tst
from pislamfusion_tpu_torch.ops.features import fastselect as tfs
from pislamfusion_tpu_torch.ops.features import flatpyr as tfp
from pislamfusion_tpu_torch.ops.features import orb as torb
from pislamfusion_tpu_torch.ops.features import packedpyr as tpp
from pislamfusion_tpu_torch.ops.features import patchgather as tpg
from pislamfusion_tpu_torch.ops.features import sift as tsift
from torch_port_reference import torch_one_thread  # noqa: F401

H1, W1, L1 = 600, 640, 4      # about the smallest frame K1 takes


@pytest.mark.parametrize("h, w, levels", [
    (600, 640, 4), (1080, 1920, 8), (480, 640, 4), (288, 416, 3),
    (720, 1280, 8), (600, 640, 8),
])
def test_flatpyr_regime_and_tables_match_reference(h, w, levels):
    assert (tfp.flat_pyramid_available(h, w, levels, 1.2, 32)
            == jfpp.flat_pyramid_available(h, w, levels, 1.2, 32))
    assert torb._flat_plan(h, w, levels, 1.2, 32).__dict__ \
        == jorb._flat_plan(h, w, levels, 1.2, 32).__dict__


def test_flatpyr_matrices_match_reference():
    tm = torb._flat_matrices(H1, W1, L1, 1.2, 32)
    jm = jorb._flat_matrices(H1, W1, L1, 1.2, 32)
    assert tm[0] is None and jm[0] is None
    for (tr, tc), (jr, jc) in zip(tm[1:], jm[1:]):
        np.testing.assert_array_equal(tr, jr)
        np.testing.assert_array_equal(tc, jc)


def test_flatpyr_plain_matches_interpreted_kernel():
    rng = np.random.default_rng(10)
    img = rng.uniform(0, 255, (H1, W1)).astype(np.float32)
    assert jfpp.flat_pyramid_available(H1, W1, L1, 1.2, 32)
    ref = np.asarray(jfpp.build_flat_pyramid(jnp.asarray(img), L1, 1.2, 32,
                                             interpret=True))
    got = tfp.build_flat_pyramid(torch.from_numpy(img), L1, 1.2, 32).numpy()
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() <= 1e-3
    # the exact product of the same composed matrices, in float64
    plan = jorb._flat_plan(H1, W1, L1, 1.2, 32)
    mats = jorb._flat_matrices(H1, W1, L1, 1.2, 32)
    b0 = plan.block_rows[0]
    np.testing.assert_array_equal(got[:b0], ref[:b0])   # exact edge pad
    for lvl in range(1, L1):
        mr, mc = (m.astype(np.float64) for m in mats[lvl])
        exact = mr @ img.astype(np.float64) @ mc.T
        blk = got[plan.bases[lvl]:plan.bases[lvl] + plan.block_rows[lvl]]
        assert np.abs(blk - exact).max() <= 2.0


def test_flatpyr_wrapper_refuses_other_devices():
    img = torch.empty((H1, W1), device="meta")
    with pytest.raises(ValueError):
        tfp.build_flat_pyramid(img, L1, 1.2, 32)


def _emulate_flatpyr(img, kp, plan):
    """The K1 kernel's arithmetic, item by item from the records it reads,
    in numpy: each level item stages its bf16-rounded source window, runs
    the row pass through its row table into a bf16 t1 tile and the column
    pass through its column table; level-0 items copy the edge pad.
    Returns the packed buffer and how often each entry was written."""
    h, w = img.shape
    bf = lambda a: tfp._bf16(a.astype(np.float32))  # noqa: E731
    out = np.zeros((plan.total_rows, plan.wp), np.float32)
    hits = np.zeros(out.shape, np.int32)
    for lvl, rin0, rn, rmo, cin0, pitch, cmo, corner in kp.records:
        if lvl == 0:
            rows = np.arange(rin0, rin0 + rn)
            iy = np.clip(rows - plan.cell, 0, h - 1)
            ix = np.clip(np.arange(plan.wp) - plan.pad_left, 0, w - 1)
            out[rows] = img[iy[:, None], ix[None, :]]
            hits[rows] += 1
            continue
        tr, tc = kp.tiles[lvl - 1]
        K = kp.taps[lvl - 1]
        r0, c0 = corner >> 16, corner & 0xffff
        nr = min(tr, plan.block_rows[lvl] - r0)
        nc = min(tc, plan.wp - c0) if pitch else cin0
        base = plan.bases[lvl] + r0
        if pitch:
            src = np.zeros((rn, pitch), np.float32)
            cols = np.arange(cin0, min(cin0 + pitch, w))
            src[:, :cols.size] = bf(img[rin0:rin0 + rn, cols])
            rm = kp.rmeta[rmo:rmo + (2 + K) * tr]
            cm = kp.cmeta[cmo:cmo + (2 + K) * tc]
            rw = rm[2 * tr:].view(np.float32).reshape(K, tr)
            cw = cm[2 * tc:].view(np.float32).reshape(K, tc)
            t1 = np.zeros((tr, pitch), np.float32)
            for r in range(nr):
                for k in range(rm[tr + r]):
                    t1[r] += rw[k, r] * src[rm[r] + k]
            t1 = bf(t1)
            for c in range(nc):
                acc = np.zeros(nr, np.float32)
                for k in range(cm[tc + c]):
                    acc += t1[:nr, cm[c] + k] * cw[k, c]
                out[base:base + nr, c0 + c] = acc
        hits[base:base + nr, c0:c0 + nc] += 1
    return out, hits


@pytest.mark.parametrize("h, w, levels", [(600, 640, 4), (1080, 1920, 8)])
def test_flatpyr_plan_tiles_every_output_once(h, w, levels):
    """K1's launch plan: its items write every packed row and column
    exactly once, each level's tiles stay within its block, every tile's
    shared memory keeps K1_BLOCKS blocks an SM, and its re-laid span tables,
    densified, rebuild flat_tables(...).mats16."""
    kp = tfp.kernel_plan(h, w, levels, 1.2, 32)
    t = tfp.flat_tables(h, w, levels, 1.2, 32)
    plan = t.plan
    assert kp.smem <= tfp.K1_SMEM and kp.blocks_per_sm >= tfp.K1_BLOCKS
    hits = np.zeros((plan.total_rows, plan.wp), np.int32)
    mats = [(np.zeros_like(mr), np.zeros_like(mc)) for mr, mc in t.mats16]
    levels = {}          # trow / tcol index -> level
    for lvl, a, b, cols in kp.items:
        if lvl == 0:
            hits[a:a + b] += 1
            continue
        tr, tc = kp.tiles[lvl - 1]
        r0, c0 = kp.trow[a, 3], kp.tcol[b, 3]
        base = plan.bases[lvl] + r0
        nr = min(tr, plan.block_rows[lvl] - r0)
        hits[base:base + nr, c0:c0 + cols] += 1
        levels[("r", a)] = levels[("c", b)] = lvl
    for (axis, i), lvl in levels.items():
        tr, tc = kp.tiles[lvl - 1]
        K = kp.taps[lvl - 1]
        tile, table, meta = ((tr, kp.trow, kp.rmeta) if axis == "r"
                             else (tc, kp.tcol, kp.cmeta))
        first, count, mo, o0 = table[i]
        m = meta[mo:mo + (2 + K) * tile]
        n_out = (plan.block_rows[lvl] if axis == "r" else plan.wp) - o0
        idx = np.arange(min(tile, n_out))
        off, n = m[idx], m[tile + idx]
        assert (n == 0).all() if count == 0 else (
            (off >= 0) & (off + n <= count)).all()
        if axis == "c":
            assert first % 4 == 0 and count % 4 == 0
        wts = m[2 * tile:].view(np.float32).reshape(K, tile)[:, idx]
        dst = mats[lvl - 1][0 if axis == "r" else 1]
        k = np.arange(K)[:, None]
        live = k < n[None, :]
        rows = np.broadcast_to(o0 + idx[None, :], live.shape)[live]
        cols = (first + off[None, :] + k)[live]
        dst[rows, cols] = wts[live]
    np.testing.assert_array_equal(hits, 1)
    for (gr, gc), (mr, mc) in zip(mats, t.mats16):
        np.testing.assert_array_equal(gr, mr)
        np.testing.assert_array_equal(gc, mc)


def test_flatpyr_plan_computes_the_plain_version():
    """The K1 kernel's arithmetic on its plan (emulated in numpy, item by
    item) against the plain version: the same bf16 roundings, f32 sums in
    another order."""
    rng = np.random.default_rng(10)
    img = rng.uniform(0, 255, (H1, W1)).astype(np.float32)
    kp = tfp.kernel_plan(H1, W1, L1, 1.2, 32)
    plan = tfp.flat_tables(H1, W1, L1, 1.2, 32).plan
    got, hits = _emulate_flatpyr(img, kp, plan)
    ref = tfp.build_flat_pyramid_plain(torch.from_numpy(img), L1, 1.2,
                                       32).numpy()
    np.testing.assert_array_equal(hits, 1)
    d = np.abs(got - ref)
    assert (d <= 1e-3).mean() >= 0.9999 and d.max() <= 1.0


def test_flatpyr_plan_refuses_what_the_kernel_cannot_take():
    with pytest.raises(ValueError):          # level 5's window fits no tile
        tfp.kernel_plan(1080, 1920, 8, 1.5, 32)
    with pytest.raises(ValueError):          # more levels than the kernel's
        tfp.kernel_plan(600, 640, 17, 1.05, 32)


@pytest.mark.parametrize("channels", [1, 2])
def test_patchgather_plain_matches_interpreted_kernel(channels):
    """Centers anywhere inside the image, edges included (the ORB tail's
    centers always lie inside the packed buffer)."""
    rng = np.random.default_rng(11 + channels)
    shape = (300, 260) if channels == 1 else (120, 150, 2)
    img = rng.uniform(0, 255, shape).astype(np.float32)
    n = 200
    xy = np.stack([rng.integers(0, shape[1], n),
                   rng.integers(0, shape[0], n)], -1).astype(np.int32)
    xy[:4] = [[0, 0], [shape[1] - 1, shape[0] - 1], [0, shape[0] - 1],
              [shape[1] - 1, 0]]
    ref = np.asarray(gather_patches_pallas(jnp.asarray(img), jnp.asarray(xy),
                                           21, interpret=True))
    got = tpg.gather_patches(torch.from_numpy(img), torch.from_numpy(xy),
                             21).numpy()
    np.testing.assert_array_equal(got, ref)


def test_patchgather_wrapper_refuses_other_devices():
    with pytest.raises(ValueError):
        tpg.gather_patches(torch.empty((64, 64), device="meta"),
                           torch.zeros((3, 2), dtype=torch.int32), 21)


@pytest.mark.parametrize("shape, radius", [((64, 64), 20), ((64, 64, 2), 21),
                                           ((64, 64, 1), 21)])
def test_patchgather_kernel_refuses_other_shapes(shape, radius):
    """The kernel takes ORB's patches only (radius 21, one channel, [H, W]);
    off the CPU the wrapper raises on others before it looks at the
    device. On the CPU the plain version takes every shape."""
    xy = torch.zeros((3, 2), dtype=torch.int32)
    with pytest.raises(ValueError, match="radius"):
        tpg.gather_patches(torch.empty(shape, device="meta"), xy, radius)
    got = tpg.gather_patches(torch.zeros(shape), xy, radius)
    assert got.shape == (3, 2 * radius + 1, 2 * radius + 1) + shape[2:]


def _smooth_src(seed):
    rng = np.random.default_rng(seed)
    img = rng.uniform(0, 255, (240, 320, 3)).astype(np.float32)
    return np.array(jim.gaussian_blur(jnp.asarray(img), 2.0))


def _homography(theta_deg, scale, t, persp=(1e-5, -2e-5)):
    th = np.deg2rad(theta_deg)
    h = np.eye(3, dtype=np.float32)
    h[:2, :2] = scale * np.array([[np.cos(th), -np.sin(th)],
                                  [np.sin(th), np.cos(th)]])
    h[:2, 2] = t
    h[2, :2] = persp
    return h


# (rotation, scale, translation): a mild survey map, one closer to 90
# degrees than to 0 (the transposed path), and one whose left tiles fall
# off the source (dead tiles)
_WARPS = {
    "plain": (10.0, 0.8, (40.0, 30.0)),
    "transposed": (100.0, 0.9, (200.0, 60.0)),
    "dead_tile": (-5.0, 1.1, (-230.0, 30.0)),
}


@pytest.mark.parametrize("case", sorted(_WARPS))
def test_shearwarp_plain_matches_interpreted_kernel(case):
    src = _smooth_src(12)
    h = _homography(*_WARPS[case])
    patch_hw = (256, 256)
    ref, ref_live, ref_err = (np.asarray(a) for a in jsw.warp_patch_pallas(
        jnp.asarray(src), jnp.asarray(h), patch_hw, interpret=True))
    got, live, err = tsw.warp_patch(torch.from_numpy(src),
                                    torch.from_numpy(h), patch_hw)
    got, live = got.numpy(), live.numpy()
    np.testing.assert_array_equal(live, ref_live)
    assert abs(float(err) - float(ref_err)) <= 1e-5
    assert bool(tsw._choose_transpose(torch.from_numpy(h))) \
        == (case == "transposed")
    tile = tsw.TILE
    lv = np.kron(live, np.ones((tile, tile), bool))
    if case == "dead_tile":
        assert not live.all() and live.any()
    assert np.all(got[~lv] == 0.0)
    grid = np.asarray(jim.homography_grid(jnp.asarray(h), patch_hw))
    inside = ((grid[..., 0] >= 2) & (grid[..., 0] <= src.shape[1] - 3)
              & (grid[..., 1] >= 2) & (grid[..., 1] <= src.shape[0] - 3))
    sel = lv & inside
    assert sel.sum() > 10000
    assert np.abs(got - ref)[sel].max() <= 5e-3


@pytest.mark.parametrize("transpose", [False, True])
def test_shearwarp_tile_params_match_reference(transpose):
    h = _homography(30.0, 1.7, (100.0, -20.0))
    win = tsw._pallas_window_hw(2.2, 128)
    assert win == jsw._pallas_window_hw(2.2, 128)
    j = jsw.tile_params(jnp.asarray(h), (512, 384), (240, 320), win, 128,
                        transpose, align=(8, 128))
    t = tsw.tile_params(torch.from_numpy(h), (512, 384), (240, 320), win,
                        128, transpose, align=(8, 128))
    np.testing.assert_allclose(t.affine.numpy(), np.asarray(j.affine),
                               rtol=1e-6, atol=1e-4)
    np.testing.assert_array_equal(t.window.numpy(), np.asarray(j.window))
    np.testing.assert_array_equal(t.live.numpy(), np.asarray(j.live))


def test_shearwarp_wrapper_refuses_other_devices():
    with pytest.raises(ValueError):
        tsw.warp_patch(torch.empty((240, 320, 3), device="meta"),
                       torch.empty((3, 3), device="meta"), (256, 256))


def _f32(x):
    return np.float32(x)


def _tent(gf):
    one = np.float32(1.0)
    return (np.maximum(np.float32(0.0), one - gf),
            one - np.abs(gf - one), np.maximum(np.float32(0.0), gf - one))


def _resample_m(slope, bias, i, n):
    pv = slope * np.asarray(i, np.float32)
    g = pv - np.floor(pv)
    return np.clip((np.floor(pv) + bias).astype(np.int64), 0, n - 3), g


def _shear_n(slope, off, bias, i):
    sx = (slope * np.asarray(i, np.float32) + off) - bias
    fl = np.floor(sx)
    return fl.astype(np.int64), sx - fl


def _wrap(a, n, near):
    """The kernel's wraps: the compare-and-add one only where proven."""
    if near:
        assert (a >= -n).all() and (a < 2 * n).all()
        return np.where(a < 0, a + n, np.where(a >= n, a - n, a))
    return np.mod(a, n)


def _emulate_shearwarp(img, h, patch_hw, tile=128, staged=True):
    """csrc/shearwarp.cu in numpy f32, strip by strip: the tile's
    constants, the strip's limits and wrap proof (the columns within a
    period of the window, n1's run ends bound the rows), pass 1 once per (v, x) into I (the transposed
    orientation through the per-warp source-row segments, unless
    `staged` is False or the segment does not fit in a warp), then pass 2
    from I."""
    src = np.asarray(img, np.float32)
    tr_t, prm, (WH, WW) = tsw._params(torch.from_numpy(src),
                                      torch.from_numpy(h), patch_hw, tile,
                                      2.2)
    tr = bool(tr_t)
    aff, win = prm.affine.numpy(), prm.window.numpy()
    live = prm.live.numpy()
    H, W, C = src.shape
    sh, sw = (W, H) if tr else (H, W)
    R, T = tsw.STRIP_ROWS, tile
    ph, pw = patch_hw
    ntx = pw // T
    out = np.zeros((ph, pw, C), np.float32)
    paths = set()

    def pix(r_, c_):      # source pixels [..., C] at window-space (row, col)
        return src[c_, r_] if tr else src[r_, c_]
    for t in np.nonzero(live)[0]:
        a00, a01, tx, a10, a11, ty = (np.float32(v) for v in aff[t])
        wy, wx = (int(v) for v in win[t])
        safe = a00 if abs(a00) >= 1e-6 else np.float32(1e-6)
        alpha = a10 / safe
        beta = (a00 * a11 - a01 * a10) / safe
        gamma = ty - alpha * tx
        tm1 = np.float32(T - 1)
        z = np.float32(0.0)
        bias1 = np.ceil(max(z, -min(z, beta * tm1)))
        bias2 = np.ceil(max(z, -min(z, a00 * tm1)))
        m2, g2 = _resample_m(a00, bias2, np.arange(T), WW)
        m2lo, span = int(m2.min()), int(m2.max() - m2.min()) + 3
        assert m2lo == min(m2[0], m2[-1])           # monotone
        for v0 in range(0, T, R):
            v = np.arange(v0, v0 + R)
            n2, f2 = _shear_n(a01, tx, bias2, v)
            m1, g1 = _resample_m(beta, bias1, v, WH)
            assert span <= WW
            xmin = m2lo + int(min(n2[0], n2[-1]))
            xlen = m2lo + span - 1 + int(max(n2[0], n2[-1])) - xmin + 1
            m1lo, m1hi = int(min(m1[0], m1[-1])), int(max(m1[0], m1[-1]))
            # the wraps' proof: the columns within one period of the
            # window, and n1 at the ends of each unwrapped run of them
            # bounds the rows
            near = False
            if xmin >= -WW and xmin + xlen - 1 < 2 * WW:
                if xlen >= WW:
                    xe = [0, WW - 1]
                else:
                    xe = [int(_wrap(np.array([v]), WW, True)[0])
                          for v in (xmin, xmin + xlen - 1)]
                    if xe[1] < xe[0]:
                        xe += [0, WW - 1]
                ne = _shear_n(alpha, gamma, bias1, np.array(xe))[0]
                near = (m1lo + int(ne.min()) >= -WH
                        and m1hi + 2 + int(ne.max()) < 2 * WH)
            col_near = row_near = near

            def phases(x):
                return _shear_n(alpha, gamma, bias1, x)
            xlo = m2lo + n2
            I = np.full((R, span, C), np.nan, np.float32)
            L = m1hi - m1lo + 3
            need = R * C * (span + span // 32 + 1) \
                + xlen * (((L * C) | 1) + 2)
            if staged and tr and need <= tsw.SMEM_FLOATS:
                paths.add("staged")
                X = xmin + np.arange(xlen)
                x = _wrap(X, WW, col_near)
                n1, f1 = phases(x)
                scol = np.minimum(wx + x, sw - 1)
                rows = _wrap(m1lo + n1[:, None] + np.arange(L), WH,
                             row_near)
                seg = pix(np.minimum(wy + rows, sh - 1), scol[:, None])
                for r in range(R):
                    k = X - xlo[r]
                    sel = (k >= 0) & (k < span)
                    w1 = _tent(g1[r] + f1[sel])
                    e0 = m1[r] - m1lo
                    iv = np.zeros((int(sel.sum()), C), np.float32)
                    for j in range(3):
                        iv = iv + w1[j][:, None] * seg[sel, e0 + j]
                    I[r, k[sel]] = iv
            else:
                paths.add("direct")
                for r in range(R):
                    x = _wrap(xlo[r] + np.arange(span), WW, col_near)
                    n1, f1 = phases(x)
                    w1 = _tent(g1[r] + f1)
                    scol = np.minimum(wx + x, sw - 1)
                    iv = np.zeros((span, C), np.float32)
                    for j in range(3):
                        rr = _wrap(m1[r] + j + n1, WH, row_near)
                        iv = iv + w1[j][:, None] * pix(
                            np.minimum(wy + rr, sh - 1), scol)
                    I[r] = iv
            assert not np.isnan(I).any()
            ty_, tx_ = divmod(int(t), ntx)
            for r in range(R):
                w2 = _tent(f2[r] + g2)
                acc = np.zeros((T, C), np.float32)
                for i in range(3):
                    acc = acc + w2[i][:, None] * I[r, m2 - m2lo + i]
                out[ty_ * T + v0 + r, tx_ * T:(tx_ + 1) * T] = acc
    return out, live, paths


# (rotation, scale x, scale y, translation): _WARPS, and a map stretched
# along x near the largest |a00| the window admits (|a00| * 128 + 4 < 640)
_STRIP_WARPS = dict(
    {k: (th, s, s, t) for k, (th, s, t) in _WARPS.items()},
    stretched=(2.0, 4.85, 1.0, (10.0, 40.0)),
    stretched_transposed=(92.0, 4.85, 1.0, (330.0, 10.0)))


def _strip_homography(case):
    th, sx, sy, t = _STRIP_WARPS[case]
    h = _homography(th, 1.0, t)
    h[:2, :2] = h[:2, :2] @ np.diag([sx, sy]).astype(np.float32)
    return h


@pytest.mark.parametrize("case, staged", [
    ("plain", True), ("transposed", True), ("transposed", False),
    ("dead_tile", True), ("stretched", True),
    ("stretched_transposed", True)])
def test_shearwarp_staged_passes_compute_the_plain_version(case, staged):
    src = _smooth_src(12)
    if case.startswith("stretched"):
        src = np.tile(src, (3, 3, 1))[:700, :700]
    h = _strip_homography(case)
    patch_hw = (256, 128) if case.startswith("stretched") else (256, 256)
    got, live, paths = _emulate_shearwarp(src, h, patch_hw, staged=staged)
    ref, ref_live, _ = tsw.warp_patch_plain(
        torch.from_numpy(src), torch.from_numpy(h), patch_hw)
    assert live.any() and np.array_equal(live, ref_live.numpy().ravel())
    tr = bool(tsw._choose_transpose(torch.from_numpy(h)))
    # beyond the window's provisioned scale the segments outgrow their
    # buffer and the transposed strips take the untransposed path
    fits = staged and case != "stretched_transposed"
    assert paths == ({"staged"} if tr and fits else {"direct"})
    np.testing.assert_array_equal(got, ref.numpy())
    if case.startswith("stretched"):
        aff = tsw._params(torch.from_numpy(src), torch.from_numpy(h),
                          patch_hw, tsw.TILE, 2.2)[1].affine
        assert float(aff[:, 0].abs().max()) > 4.5 and live.all()


def test_shearwarp_buffer_holds_every_live_tile():
    """Every live strip's rows fit the kernel's I buffer (<= WW columns),
    for the cases above and random maps; and every transposed live strip
    of a map within the window's provisioned scale (2.2, any rotation and
    a mild perspective) fits its staged segments (`strip_extents`, which
    follows the kernel's limits); others take the untransposed path."""
    rng = np.random.default_rng(5)
    hs = [_strip_homography(c) for c in _STRIP_WARPS]
    for _ in range(40):
        th = rng.uniform(-180, 180)
        s = rng.uniform(0.3, 3.4, 2).astype(np.float32)
        h = _homography(th, 1.0, rng.uniform(-100, 400, 2), persp=(
            rng.uniform(-4e-5, 4e-5), rng.uniform(-4e-5, 4e-5)))
        h[:2, :2] = h[:2, :2] @ np.diag(s)
        hs.append(h)
    src = torch.zeros((700, 700, 3))
    n_live = n_staged = 0
    for h in hs:
        ext = tsw.strip_extents(src, torch.from_numpy(h), (256, 256))
        live = ext["live"]
        n_live += int(live.sum())
        assert bool((ext["span"][live] <= ext["win"][1]).all())
    for th in np.arange(45.0, 136.0, 5.0):
        for sc in (1.0, 1.6, 2.2):
            h = _homography(th, sc, (500.0, 100.0))
            ext = tsw.strip_extents(torch.zeros((900, 900, 3)),
                                    torch.from_numpy(h), (256, 256))
            live = ext["live"]
            if ext["transpose"] and bool(live.any()):
                assert bool((ext["staged"][live] <= tsw.SMEM_FLOATS).all()), \
                    (th, sc)
                n_staged += int(live.sum())
    assert n_live > 200 and n_staged > 100


# the size of tests/test_stencil_pallas.py's stack test
HS, WS = 256, 320


def test_bandedstack_plain_matches_interpreted_kernel():
    rng = np.random.default_rng(13)
    img = rng.uniform(0, 1, (HS, WS)).astype(np.float32)
    mats = jsift._stack_matrices(HS, WS, jsift.SiftParams())
    ref = np.asarray(banded_stack_pallas(jnp.asarray(img), list(mats[0]),
                                         list(mats[1]), interpret=True))
    tabs = tsift._stack_tables(HS, WS, tsift.SiftParams())
    got = tst.banded_stack(torch.from_numpy(img), tabs).numpy()
    assert got.shape == ref.shape == (5, HS, WS)
    assert np.abs(got - ref).max() <= 2e-5


def test_bandedstack_tables_match_reference():
    """The spans, densified, are sift._stack_matrices: the same nonzeros,
    each within 1 f32 ulp."""
    mhs, mws = jsift._stack_matrices(HS, WS, jsift.SiftParams())
    tabs = tsift._stack_tables(HS, WS, tsift.SiftParams())
    for got, ref in ((tst.dense(tabs.row_start, tabs.row_len, tabs.row_w),
                      np.stack(mhs)),
                     (tst.dense(tabs.col_start, tabs.col_len, tabs.col_w),
                      np.stack(mws))):
        np.testing.assert_array_equal(got != 0, ref != 0)
        np.testing.assert_array_max_ulp(got, ref, maxulp=1)
    # the composed half-widths of the default chain: 4, 9, 15, 23, 33
    assert (tabs.row_len.max(1) == [9, 19, 31, 47, 67]).all()


@pytest.mark.parametrize("h, w, sigma0", [
    (1080, 1920, 1.6), (540, 960, 1.6), (270, 480, 1.6), (135, 240, 1.6),
    (256, 640, 12.0),      # bands too wide for the window: no K5
])
def test_stack_fusable_matches_reference(h, w, sigma0):
    fusable = tsift._stack_tables(h, w, tsift.SiftParams(sigma0=sigma0))
    ref = jsift._stack_matrices(h, w, jsift.SiftParams(sigma0=sigma0))
    assert (fusable is not None) == (ref is not None)
    assert (ref is not None) == (sigma0 == 1.6)


def test_bandedstack_wrapper_refuses_other_devices():
    tabs = tsift._stack_tables(HS, WS, tsift.SiftParams())
    with pytest.raises(ValueError):
        tst.banded_stack(torch.empty((HS, WS), device="meta"), tabs)


_OCTAVES = [(1080, 1920), (540, 960), (270, 480), (HS, WS)]


@pytest.mark.parametrize("h, w", _OCTAVES)
def test_bandedstack_interior_reproduces_the_spans(h, w):
    """Each scale's recorded interior [lo, hi) and vector: every output
    there has start y - r, length 2r + 1 and the vector's weights, bit for
    bit, and the interior is [r, n - r) for the default chain."""
    tabs = tsift._stack_tables(h, w, tsift.SiftParams())
    assert list(tabs.radius) == [4, 9, 15, 23, 33]
    for start, length, wts, lo, hi, iw, n in (
            (tabs.row_start, tabs.row_len, tabs.row_w, tabs.row_lo,
             tabs.row_hi, tabs.row_iw, h),
            (tabs.col_start, tabs.col_len, tabs.col_w, tabs.col_lo,
             tabs.col_hi, tabs.col_iw, w)):
        for p, r in enumerate(tabs.radius):
            assert (lo[p], hi[p]) == (r, n - r)
            ys = np.arange(lo[p], hi[p])
            np.testing.assert_array_equal(start[p, ys], ys - r)
            np.testing.assert_array_equal(length[p, ys], 2 * r + 1)
            np.testing.assert_array_equal(
                wts[p, ys].view(np.int32),
                np.broadcast_to(iw[p].view(np.int32), wts[p, ys].shape))
            assert (iw[p, 2 * r + 1:] == 0).all()


def _stack_items(plan):
    """(slot, scale, tile row, tile column) of each of the plan's items."""
    for item in range(plan.n_items):
        s = max(i for i in range(len(plan.order)) if plan.item0[i] <= item)
        ty, tx = divmod(item - plan.item0[s], plan.ntx[s])
        yield s, plan.order[s], ty, tx


def _toeplitz(vec, r: int, R: int):
    """The [R + 2r, R] block of an interior group: column i holds the
    vector from row i."""
    d = np.zeros((R + 2 * r, R), np.float32)
    for i in range(R):
        d[i:i + 2 * r + 1, i] = vec[:2 * r + 1]
    return d


def _emulate_stack(x, tabs, plan):
    """The K5 kernel's arithmetic, item by item, in numpy (float64 sums):
    each row group from its window's block (the scale's vector shifted,
    or its staged edge block), each column group likewise from t1.
    Returns the [P, h, w] output and how often each entry was written."""
    h, w = x.shape
    out = np.zeros((tabs.scales, h, w))
    hits = np.zeros(out.shape, np.int32)
    nrg = plan.th // tst.K5_ROWS
    for s, p, ty, tx in _stack_items(plan):
        r, tw, cw = plan.rh[s], plan.tw[s], plan.cw[s]
        o = tst.K5_OFFSETS[r]
        lr, lc = tst.K5_ROWS + 2 * r, tst.K5_COLS + 2 * r
        tile = plan.tx0[s] + tx
        t0 = plan.tx_t0[tile]
        cols = np.minimum(t0 + np.arange(cw), w - 1)
        t1 = np.zeros((plan.th, cw))
        for k in range(nrg):
            g = ty * nrg + k
            if g * tst.K5_ROWS >= h:
                continue
            ws, e = plan.rg_ws[plan.rg0[s] + g], plan.rg_e[plan.rg0[s] + g]
            d = (_toeplitz(plan.wr[o:], r, tst.K5_ROWS) if e < 0 else
                 plan.d_row[e:e + lr * tst.K5_ROWS].reshape(lr, -1))
            t1[k * 16:(k + 1) * 16] = d.T.astype(np.float64) @ x[
                ws:ws + lr][:, cols]
        for gl in range(tw // tst.K5_COLS):
            xo = tx * tw + gl * tst.K5_COLS
            if xo >= w:
                continue
            g = plan.cg0[s] + tx * (tw // tst.K5_COLS) + gl
            ws, sl = plan.cg_ws[g], plan.cg_slot[g]
            d = (_toeplitz(plan.wc[o:], r, tst.K5_COLS) if sl < 0 else
                 plan.d_col[plan.tx_slots[tile, sl]:][:lc * tst.K5_COLS]
                 .reshape(lc, -1))
            res = t1[:, ws - t0:ws - t0 + lc] @ d.astype(np.float64)
            y0 = ty * plan.th
            ny, nx = min(plan.th, h - y0), min(tst.K5_COLS, w - xo)
            out[p, y0:y0 + ny, xo:xo + nx] = res[:ny, :nx]
            hits[p, y0:y0 + ny, xo:xo + nx] += 1
    return out, hits


@pytest.mark.parametrize("h, w", _OCTAVES)
def test_bandedstack_plan_covers_every_output_once(h, w):
    """K5's launch plan at each octave shape: items cover every (scale,
    output) exactly once, the widest scale first; every group's window
    stays in the image and inside its tile column's t1 columns, and each
    edge block holds its outputs' spans; the shared memory fits 4 blocks
    an SM, and enough items fill 4 blocks on each of 132 SMs."""
    tabs = tsift._stack_tables(h, w, tsift.SiftParams())
    plan = tst.stack_plan(tabs, tst.K5_BLOCKS * 132)
    assert plan.rh == tuple(sorted(plan.rh, reverse=True))
    assert plan.n_items >= tst.K5_BLOCKS * 132 or plan.th == 16
    assert plan.blocks_per_sm >= tst.K5_BLOCKS
    assert plan.pitch % 32 == 1 and max(plan.cw) <= plan.cmax
    hits = np.zeros((tabs.scales, h, w), np.int32)
    for s, p, ty, tx in _stack_items(plan):
        y0, x0 = ty * plan.th, tx * plan.tw[s]
        hits[p, y0:y0 + plan.th, x0:x0 + plan.tw[s]] += 1
    np.testing.assert_array_equal(hits, 1)
    for s, p in enumerate(plan.order):
        r = plan.rh[s]
        for (start, length, wts, n, R, ws, e, blocks) in (
                (tabs.row_start[p], tabs.row_len[p], tabs.row_w[p], h,
                 tst.K5_ROWS, plan.rg_ws, plan.rg_e, plan.d_row),
                (tabs.col_start[p], tabs.col_len[p], tabs.col_w[p], w,
                 tst.K5_COLS, plan.cg_ws, plan.cg_e, plan.d_col)):
            g0 = (plan.rg0 if R == tst.K5_ROWS else plan.cg0)[s]
            L = R + 2 * r
            for g in range(-(-n // R)):
                a = ws[g0 + g]
                assert 0 <= a <= n - L
                ys = np.arange(g * R, min(g * R + R, n))
                dense = np.zeros((L, R), np.float32)
                for i, y in enumerate(ys):
                    lo = start[y] - a
                    assert 0 <= lo and lo + length[y] <= L
                    dense[lo:lo + length[y], i] = wts[y, :length[y]]
                if e[g0 + g] < 0:
                    assert a == g * R - r
                    vec = (plan.wr if R == tst.K5_ROWS else plan.wc)[
                        tst.K5_OFFSETS[r]:]
                    np.testing.assert_array_equal(dense,
                                                  _toeplitz(vec, r, R))
                else:
                    np.testing.assert_array_equal(
                        dense, blocks[e[g0 + g]:e[g0 + g] + L * R]
                        .reshape(L, R))
        for tx in range(plan.ntx[s]):
            tile = plan.tx0[s] + tx
            gpt = plan.tw[s] // tst.K5_COLS
            for gl in range(gpt):
                g = tx * gpt + gl
                if g * tst.K5_COLS >= w:
                    continue
                a = plan.cg_ws[plan.cg0[s] + g] - plan.tx_t0[tile]
                assert 0 <= a and a + tst.K5_COLS + 2 * r <= plan.cw[s]
                sl = plan.cg_slot[plan.cg0[s] + g]
                assert (sl < 0) == (plan.cg_e[plan.cg0[s] + g] < 0)
                if sl >= 0:
                    assert plan.tx_slots[tile, sl] == plan.cg_e[
                        plan.cg0[s] + g]


@pytest.mark.parametrize("slots", [None, 10 ** 6])
def test_bandedstack_plan_computes_the_plain_version(slots):
    """The K5 kernel's arithmetic on its plan (emulated in numpy, item by
    item) against the plain version at (HS, WS), under the largest tiles
    and under the smallest (the plan for many SMs)."""
    rng = np.random.default_rng(13)
    img = rng.uniform(0, 1, (HS, WS)).astype(np.float32)
    tabs = tsift._stack_tables(HS, WS, tsift.SiftParams())
    plan = tst.stack_plan(tabs, slots)
    th, cmax = tst.K5_TILES[0 if slots is None else -1]
    assert plan.th == th and plan.cmax <= cmax
    got, hits = _emulate_stack(img.astype(np.float64), tabs, plan)
    np.testing.assert_array_equal(hits, 1)
    ref = tst.banded_stack_plain(torch.from_numpy(img), tabs).numpy()
    assert np.abs(got - ref).max() <= 2e-5


def test_bandedstack_plan_refuses_what_the_kernel_cannot_take():
    # half-widths 7, 16, 27, 41 and 59: no instantiation
    tabs = tsift._stack_tables(HS, 2 * WS, tsift.SiftParams(sigma0=3.0))
    assert tabs is not None
    with pytest.raises(ValueError):
        tst.stack_plan(tabs)
    # an image narrower than a column group's window of 8 + 66
    taps = tsift._stack_tables(HS, WS, tsift.SiftParams()).key[2]
    small = tst.chain_tables(HS, 70, taps)
    with pytest.raises(ValueError):
        tst.stack_plan(small)


def test_bilineargrid_plain_matches_interpreted_kernel():
    """At the size of tests/test_patchgather.py's grid test, every sample
    (zero-filled ones beyond the border included)."""
    rng = np.random.default_rng(2)
    H, W, K, M = 240, 320, 37, 256
    img = rng.uniform(-128, 128, (H, W, 2)).astype(np.float32)
    centers = np.stack([rng.integers(2, W - 2, K), rng.integers(2, H - 2, K)],
                       -1).astype(np.int32)
    rel = rng.uniform(-14.5, 14.5, (K, 2, M)).astype(np.float32)
    assert np.abs(rel).max() < 16           # the kernel's radius
    ref = np.asarray(bilinear_grid_pallas(
        jnp.asarray(img), jnp.asarray(centers), jnp.asarray(rel), radius=16,
        interpret=True))
    got = tpg.bilinear_grid(torch.from_numpy(img), torch.from_numpy(centers),
                            torch.from_numpy(rel), radius=16).numpy()
    assert got.shape == ref.shape == (K, M, 2)
    assert np.abs(got - ref).max() <= 1e-4
    px = centers[:, 0:1] + rel[:, 0]
    assert (px < 0).any() and (got[px < -1] == 0).all()


def test_bilineargrid_wrapper_refuses_other_devices():
    with pytest.raises(ValueError):
        tpg.bilinear_grid(torch.empty((64, 64, 2), device="meta"),
                          torch.zeros((3, 2), dtype=torch.int32),
                          torch.zeros((3, 2, 16)), radius=16)


_PYR_TAPS = (0.0625, 0.25, 0.375, 0.25, 0.0625)
_BLUR_TAPS = tuple(float(v) for v in jim.gaussian_kernel1d(2.0, 3))
# (input shape, the matrix pair), as tests/test_stencil_pallas.py builds
# them, at smaller sizes
_SANDWICHES = {
    "pyrdown_c3": ((120, 136, 3), lambda: (
        jim._dec_matrix(120, _PYR_TAPS, "reflect"),
        jim._dec_matrix(136, _PYR_TAPS, "reflect"))),
    "pyrup_c1": ((60, 68, 1), lambda: (jim._up_matrix(60, 120, _PYR_TAPS),
                                       jim._up_matrix(68, 136, _PYR_TAPS))),
    "blur_c1": ((100, 130, 1), lambda: (
        jim._blur_matrix(100, _BLUR_TAPS, "reflect"),
        jim._blur_matrix(130, _BLUR_TAPS, "reflect"))),
    "resize_c1": ((120, 160, 1), lambda: (jim._resize_matrix(120, 100),
                                          jim._resize_matrix(160, 133))),
}


@pytest.mark.parametrize("case", sorted(_SANDWICHES))
def test_bandedsandwich_plain_matches_interpreted_kernel(case):
    shape, mats = _SANDWICHES[case]
    mh, mw = mats()
    x = np.random.default_rng(14).uniform(0, 255, shape).astype(np.float32)
    assert can_fuse(mh, mw, shape[2])
    ref = np.asarray(banded_sandwich_pallas(jnp.asarray(x), mh, mw,
                                            interpret=True))
    tabs = tst.sandwich_tables(("test", case), mh, mw)
    got = tst.banded_sandwich(torch.from_numpy(x), tabs).numpy()
    assert got.shape == ref.shape == (mh.shape[0], mw.shape[0], shape[2])
    assert np.abs(got - ref).max() <= 2e-5 * np.abs(ref).max()


@pytest.mark.parametrize("n, on", [(7, 4), (120, 60), (1536, 768),
                                   (768, 1536), (9, 17)])
def test_bandedsandwich_spans_rebuild_the_reference_matrices(n, on):
    """The port's pyrDown/pyrUp matrices are the reference's, and their
    spans densified are those matrices exactly."""
    if on < n:
        m = jim._dec_matrix(n, _PYR_TAPS, "reflect")
        np.testing.assert_array_equal(
            tim._dec_matrix(n, _PYR_TAPS, "reflect"), m)
        tabs = tim.pyr_tables("down", n, n, on, on)
    else:
        m = jim._up_matrix(n, on, _PYR_TAPS)
        np.testing.assert_array_equal(tim._up_matrix(n, on, _PYR_TAPS), m)
        tabs = tim.pyr_tables("up", n, n, on, on)
    for start, length, w in ((tabs.row_start, tabs.row_len, tabs.row_w),
                             (tabs.col_start, tabs.col_len, tabs.col_w)):
        got = np.zeros_like(m)
        for r in range(m.shape[0]):
            got[r, start[r]:start[r] + length[r]] = w[r, :length[r]]
        assert (w[np.arange(w.shape[1])[None, :] >= length[:, None]]
                == 0).all()
        np.testing.assert_array_equal(got, m)


def test_bandedsandwich_wrapper_refuses_other_devices():
    tabs = tim.pyr_tables("down", 64, 64, 32, 32)
    with pytest.raises(ValueError):
        tst.banded_sandwich(torch.empty((64, 64, 3), device="meta"), tabs)


def _pyr_ladder(h, w, levels, channels):
    """(kind, h, w, oh, ow, C) of a Laplacian pyramid's K8 calls: the
    pyrDowns of `levels` levels and the pyrUps back, per channel count."""
    sizes = [(h, w)]
    for _ in range(levels):
        sizes.append(((sizes[-1][0] + 1) // 2, (sizes[-1][1] + 1) // 2))
    calls = []
    for c in channels:
        for big, small in zip(sizes, sizes[1:]):
            calls += [("down", *big, *small, c), ("up", *small, *big, c)]
    return calls


# the K8 calls of every path (C 3 the image bands, C 1 the weights)
_K8_PATHS = {
    "fastvo_1080p": [("down", 1080, 1920, 540, 960, 3),
                     ("up", 768, 768, 1536, 1536, 1)]
    + _pyr_ladder(768, 768, 4, (3,)) + _pyr_ladder(1536, 1536, 5, (1,)),
    "map2d_1536": _pyr_ladder(1536, 1536, 5, (3, 1)),
    "canvas_3328x2304": _pyr_ladder(2304, 3328, 5, (3,)),
    "strip_600x640": [("down", 600, 640, 300, 320, 3)]
    + _pyr_ladder(600, 640, 5, (3, 1)),
}


@pytest.mark.parametrize("path", sorted(_K8_PATHS))
def test_bandedsandwich_plan_covers_every_span(path):
    """K8's launch plan at every shape of a path: each tile's staged
    window holds every span of its outputs (rows, and columns times C
    with the 16-byte alignment lead in the pitch), the span tables it
    stages rebuild the spans and weights, the tap bound holds (5 for
    pyrDown, 3 for pyrUp), the shared memory fits, and 4 blocks fit an
    SM."""
    for kind, h, w, oh, ow, C in _K8_PATHS[path]:
        tabs = tim.pyr_tables(kind, h, w, oh, ow)
        plan = tst.sandwich_plan(tabs, C)
        assert plan.K == (5 if kind == "down" else 3)
        assert max(tabs.row_len.max(), tabs.col_len.max()) <= plan.K
        ntr, ntc = plan.tiles
        assert (ntr, ntc) == (-(-oh // plan.tr), -(-ow // plan.tc))
        rm, cm = plan.rmeta.shape[1], plan.cmeta.shape[1]
        assert plan.smem == 4 * (2 * (plan.sr * plan.pitch + rm + cm)
                                 + plan.tr * plan.pitch) <= tst.SMEM_LIMIT
        assert plan.blocks_per_sm >= tst.K8_BLOCKS
        assert plan.pitch % 4 == 0 and rm % 4 == 0 and cm % 4 == 0
        assert plan.tile_cn.max() * C + 3 <= plan.pitch
        assert plan.tile_rn.max() == plan.sr
        for (start, length, wts, first, count, meta, tile, scale, n_in) in (
                (tabs.row_start, tabs.row_len, tabs.row_w, plan.tile_r0,
                 plan.tile_rn, plan.rmeta, plan.tr, 1, h),
                (tabs.col_start, tabs.col_len, tabs.col_w, plan.tile_c0,
                 plan.tile_cn, plan.cmeta, plan.tc, C, w)):
            t = np.arange(start.shape[0]) // tile
            assert (first[t] <= start).all()
            assert (start + length <= first[t] + count[t]).all()
            assert (first + count <= n_in).all()
            i = np.arange(start.shape[0]) % tile
            off = meta[t, i]
            np.testing.assert_array_equal(off, (start - first[t]) * scale)
            np.testing.assert_array_equal(meta[t, tile + i], length)
            got = meta[t[:, None], (2 + np.arange(plan.K))[None, :] * tile
                       + i[:, None]].view(np.float32)
            np.testing.assert_array_equal(got[:, :wts.shape[1]], wts)
            assert (got[:, wts.shape[1]:] == 0).all()
            # outputs past the end of the last tile take no taps
            pad = meta[-1, tile + start.shape[0] - (len(first) - 1) * tile:
                       2 * tile]
            assert (pad == 0).all()
        if kind == "down" and (h, w, C) == (1536, 1536, 3):
            assert (plan.tr, plan.tc) == (8, 40)


def test_bandedsandwich_plan_refuses_what_the_kernel_cannot_take():
    tabs = tim.pyr_tables("down", 64, 64, 32, 32)
    for C in (2, 4, 5):
        with pytest.raises(ValueError):
            tst.sandwich_plan(tabs, C)
    wide = tuple(float(v) for v in jim.gaussian_kernel1d(3.0, 5))
    blur = tst.sandwich_tables(("test", "blur11"),
                               jim._blur_matrix(40, wide, "reflect"),
                               jim._blur_matrix(48, wide, "reflect"))
    with pytest.raises(ValueError):
        tst.sandwich_plan(blur, 1)


# K4 cases of tests/test_fastselect.py: (levels, cell)
_WINNERS = {
    "two_levels": (lambda rng: [rng.uniform(0, 255, (240, 320)),
                                rng.uniform(0, 255, (200, 267))], 32),
    "integer_ties": (lambda rng: [rng.integers(0, 24, (160, 224))], 32),
    "no_corners": (lambda rng: [np.full((96, 128), 77.0)], 32),
    "cell16": (lambda rng: [rng.uniform(0, 255, (128, 160))], 16),
}


@pytest.mark.parametrize("case", sorted(_WINNERS))
def test_fastselect_plain_matches_interpreted_kernel(case):
    make, cell = _WINNERS[case]
    levels = [x.astype(np.float32) for x in make(np.random.default_rng(0))]
    ref = fast_cell_winners([jnp.asarray(x) for x in levels], cell, 7.0,
                            jorb.EDGE_THRESHOLD, use_bf16=False,
                            interpret=True)
    got = tfs.fast_cell_winners_plain([torch.from_numpy(x) for x in levels],
                                      cell, 7.0, torb.EDGE_THRESHOLD)
    for (cv, ci), (jcv, jci) in zip(got, ref):
        assert cv.dtype == torch.float32 and ci.dtype == torch.int32
        np.testing.assert_array_equal(cv.numpy(), np.asarray(jcv))
        np.testing.assert_array_equal(ci.numpy(), np.asarray(jci))
    if case == "no_corners":
        assert not (got[0][0] > 0).any()
    # the wrapper reads the levels in place from a packed buffer
    rows = sum(x.shape[0] + 8 for x in levels)
    packed = torch.zeros((rows, max(x.shape[1] for x in levels) + 9))
    offs, y = [], 3
    for x in levels:
        packed[y:y + x.shape[0], 5:5 + x.shape[1]] = torch.from_numpy(x)
        offs.append((5, y))
        y += x.shape[0] + 5
    wrapped = tfs.fast_cell_winners(packed, offs, [x.shape for x in levels],
                                    cell, 7.0, torb.EDGE_THRESHOLD)
    for (cv, ci), (wcv, wci) in zip(got, wrapped):
        assert torch.equal(cv, wcv) and torch.equal(ci, wci)


def test_fastselect_wrapper_refuses_other_devices():
    with pytest.raises(ValueError):
        tfs.fast_cell_winners(torch.empty((64, 64), device="meta"),
                              [(0, 0)], [(64, 64)], 32, 7.0, 16)


def _pretest_images():
    """(label, image [H, W] f32) for the pretest: noise, a survey strip
    frame, flat regions, a step edge."""
    from chip_smoke import render_strip
    rng = np.random.default_rng(21)
    noise = np.clip(rng.normal(128, 40, (96, 128)), 0, 255)
    strip = render_strip(1, 120, 160, 600.0, 0.24, 1024, "cpu")[0][0]
    flat = np.full((64, 96), 90.0)
    flat[20:44, 30:70] = 160.0
    flat[30:36, 40:48] = 20.0
    step = np.zeros((64, 96))
    step[:, 48:] = 200.0
    step[32:, :20] = 120.0
    gray = strip.to(torch.float32).mean(-1).numpy()
    return [("noise", noise), ("strip", gray), ("flat", flat),
            ("step", step), ("integer", rng.integers(0, 24, (64, 96)))]


@pytest.mark.parametrize("thr", [0.0, 7.0, 20.0])
def test_fastselect_pretest_keeps_every_corner(thr):
    for label, img in _pretest_images():
        x = torch.from_numpy(np.asarray(img, np.float32))
        score = tfs.fast_score_map(x)
        masked = torch.where(score > thr, score, 0.0)
        ok = tfs.fast_pretest(x, thr, torb.EDGE_THRESHOLD)
        inner = torch.zeros_like(ok)
        b = torb.EDGE_THRESHOLD
        inner[b:-b, b:-b] = True
        lost = (masked > 0) & inner & ~ok
        assert not bool(lost.any()), (label, int(lost.sum()))
        # the pretest is a cut, not a pass-through, on all but flat noise
        if label in ("strip", "step", "flat"):
            assert float(ok.float().mean()) < 0.5, label


def _fast16_at(slab, b, r, c):
    """The kernel's fast16 at slab[b, r, c] (the taps of csrc/fastselect.cu
    in OpenCV order, 3-tap minima and maxima, then the arcs)."""
    d = torch.stack([slab[b, r + int(dy), c + int(dx)]
                     for dx, dy in tfs._CIRCLE], -1) - slab[b, r, c][:, None]
    idx = torch.arange(16)
    mn3 = torch.minimum(torch.minimum(d, d[:, (idx + 1) % 16]),
                        d[:, (idx + 2) % 16])
    mx3 = torch.maximum(torch.maximum(d, d[:, (idx + 1) % 16]),
                        d[:, (idx + 2) % 16])
    pos = torch.minimum(torch.minimum(mn3, mn3[:, (idx + 3) % 16]),
                        mn3[:, (idx + 6) % 16]).amax(-1)
    neg = torch.maximum(torch.maximum(mx3, mx3[:, (idx + 3) % 16]),
                        mx3[:, (idx + 6) % 16]).amin(-1)
    return torch.maximum(pos, -neg)


def _emulate_fastselect(packed, offs, shapes, cell, thr, border):
    """csrc/fastselect.cu on its plan's blocks: each block's slab (zero
    outside its level), the pretest on its score tile, the candidates
    scored alone (0 elsewhere), the NMS survivors of its cells reduced to
    (max, first index). Returns [(cv2d, ci2d)] per level."""
    plan = tfs.winner_plan(tuple(shapes), tuple(offs), cell)
    run, FR = plan.run, tfs._FAST_R
    tw, th = run * cell + 2, cell + 2
    sw, sh = tw + 2 * FR, th + 2 * FR
    out = []
    for lvl, (oy, ox, lh, lw, ncx, _) in enumerate(plan.levels.tolist()):
        blk = torch.from_numpy(plan.blocks[plan.blocks[:, 0] == lvl]
                               ).long()
        nb = blk.shape[0]
        ys = blk[:, 1:2] * cell - 1 - FR + torch.arange(sh)
        xs = blk[:, 2:3] * cell - 1 - FR + torch.arange(sw)
        inside = (((ys >= 0) & (ys < lh))[:, :, None]
                  & ((xs >= 0) & (xs < lw))[:, None, :])
        vals = packed[(oy + ys.clamp(0, lh - 1))[:, :, None],
                      (ox + xs.clamp(0, lw - 1))[:, None, :]]
        slab = torch.where(inside, vals, torch.zeros_like(vals))
        # pass 1: the pretest at every tile position (r, c), slab (r+3, c+3)
        y = ys[:, FR:FR + th, None]
        x = xs[:, None, FR:FR + tw]
        ok = (y >= border) & (y < lh - border) & (x >= border) \
            & (x < lw - border)
        tap = [slab[:, FR + int(dy):FR + int(dy) + th,
                    FR + int(dx):FR + int(dx) + tw] for dx, dy in tfs._CIRCLE]
        ctr = slab[:, FR:FR + th, FR:FR + tw]
        hi = lo = None
        for a, b in tfs._PRETEST_PAIRS:
            h_, l_ = torch.maximum(tap[a], tap[b]), torch.minimum(tap[a],
                                                                  tap[b])
            hi = h_ if hi is None else torch.minimum(hi, h_)
            lo = l_ if lo is None else torch.maximum(lo, l_)
        cand = ok & ((hi - ctr > thr) | (lo - ctr < -thr))
        # pass 2: score the candidates alone
        b, r, c = cand.nonzero(as_tuple=True)
        sc = _fast16_at(slab, b, r + FR, c + FR)
        s = torch.zeros((nb, th, tw))
        s[b, r, c] = torch.where(sc > thr, sc, torch.zeros_like(sc))
        # pass 3: the candidates in the cells with a score > 0 that is >=
        # its 8 neighbours
        v = s[b, r, c]
        keep = (v > 0) & (r >= 1) & (r <= cell) & (c >= 1) & (c <= run * cell)
        b, r, c, v = b[keep], r[keep], c[keep], v[keep]
        m = torch.stack([s[b, r + dy, c + dx] for dy in (-1, 0, 1)
                         for dx in (-1, 0, 1) if dy or dx]).amax(0)
        keep = v >= m
        b, r, c, v = b[keep], r[keep], c[keep], v[keep]
        q = (c - 1) // cell
        wp = ncx * cell
        idx = (blk[b, 1] * cell + r - 1) * wp + blk[b, 2] * cell + c - 1
        grp = b * run + q
        best = torch.zeros(nb * run).scatter_reduce(0, grp, v, "amax")
        at = torch.full((nb * run,), 2 ** 31 - 1, dtype=torch.int64)
        at = at.scatter_reduce(0, grp[v == best[grp]], idx[v == best[grp]],
                               "amin")
        ncy = -(-lh // cell)
        k = torch.arange(nb * run)
        cy, cx = blk[k // run, 1], blk[k // run, 2] + k % run
        real = cx < ncx
        first = cy * cell * wp + cx * cell
        at = torch.where(at < 2 ** 31 - 1, at, first)
        cv = torch.full((ncy, ncx), -1.0)
        ci = torch.full((ncy, ncx), -1, dtype=torch.int32)
        cv[cy[real], cx[real]] = best[real]
        ci[cy[real], cx[real]] = at[real].to(torch.int32)
        out.append((cv, ci))
    return out


def _small_layouts():
    """chip_smoke.py's three K4 layouts at a small size: K1's flat
    pyramid and K7's packed pyramid of a 600x640 strip frame (4 levels),
    and K7's of a 240x320 one; (label, packed, offs, shapes)."""
    from chip_smoke import render_strip
    fr = render_strip(1, 600, 640, 600.0, 0.24, 1024, "cpu")[0][0]
    gray = tim.rgb_to_gray(fr.to(torch.float32))
    p = torb.OrbParams(n_features=256, n_levels=4)
    plan = torb._flat_plan(600, 640, 4, p.scale_factor, p.cell)
    flat = tfp.build_flat_pyramid_plain(gray, 4, p.scale_factor, p.cell)
    r = torb._GATHER_R
    out = [("K1 600x640", flat, [(plan.pad_left, b + plan.cell)
                                 for b in plan.bases], plan.shapes)]
    for h, w in ((600, 640), (240, 320)):
        g = gray[:h, :w].contiguous()
        pl7 = tpp.pyramid_plan(h, w, 4, p.scale_factor, r)
        out.append((f"K7 {h}x{w}", tpp.build_packed_pyramid_plain(
            g, 4, p.scale_factor, r), [(r, b + r) for b in pl7.bases],
            pl7.shapes))
    return out


def test_fastselect_candidates_compute_the_plain_version(torch_one_thread):
    p = torb.OrbParams(n_features=256, n_levels=4)
    for label, packed, offs, shapes in _small_layouts():
        for thr in (p.min_threshold, 0.0):
            got = _emulate_fastselect(packed, offs, shapes, p.cell, thr,
                                      torb.EDGE_THRESHOLD)
            ref = tfs.fast_cell_winners_plain(
                [packed[oy:oy + lh, ox:ox + lw]
                 for (lh, lw), (ox, oy) in zip(shapes, offs)],
                p.cell, thr, torb.EDGE_THRESHOLD)
            for (cv, ci), (rv, ri) in zip(got, ref):
                assert torch.equal(cv, rv) and torch.equal(ci, ri), label
            assert sum(int((rv > 0).sum()) for rv, _ in ref) > 100


def test_fastselect_plan_runs_fit_the_block():
    for cell in (8, 16, 32, 64, 120):
        run = tfs.block_run(cell)
        assert run in (1, 2, 4) and run * cell + 2 <= 256
        assert tfs.smem_bytes(cell, run) <= tfs._SMEM_MAX
        plan = tfs.winner_plan(((200, 300), (90, 120)), ((0, 0), (0, 210)),
                               cell)
        # every cell of every level belongs to exactly one block's run
        seen = set()
        for lvl, cy, cx0 in plan.blocks.tolist():
            for q in range(run):
                if cx0 + q < plan.grids[lvl][1]:
                    assert (lvl, cy, cx0 + q) not in seen
                    seen.add((lvl, cy, cx0 + q))
        assert len(seen) == plan.n_cells
    assert tfs.block_run(32) == 4
    with pytest.raises(ValueError):
        tfs.winner_plan(((64, 64),), ((0, 0),), 256)


@pytest.mark.parametrize("h, w, levels", [
    (240, 320, 4), (100, 120, 4), (600, 640, 4), (1080, 1920, 8),
    (480, 640, 8), (600, 640, 1),
])
def test_packedpyr_regime_and_plan_match_reference(h, w, levels):
    avail = jpp.pyramid_available(h, w, levels, 1.2, 21)
    assert tpp.pyramid_available(h, w, levels, 1.2, 21) == avail
    assert avail == ((h, w) not in ((100, 120),) and levels > 1)
    if avail:
        assert tpp.pyramid_plan(h, w, levels, 1.2, 21).__dict__ \
            == jpp.pyramid_plan(h, w, levels, 1.2, 21).__dict__


def test_packedpyr_plain_matches_interpreted_kernel():
    H, W, L, S, r = 240, 320, 4, 1.2, 21
    img = np.random.default_rng(15).uniform(0, 255, (H, W)).astype(
        np.float32)
    ref = np.asarray(jpp.build_packed_pyramid(jnp.asarray(img), L, S, r,
                                              interpret=True))
    got = tpp.build_packed_pyramid(torch.from_numpy(img), L, S, r).numpy()
    plan = tpp.pyramid_plan(H, W, L, S, r)
    assert got.shape == ref.shape == (plan.total_rows, plan.wpl)
    live = np.zeros(got.shape, bool)
    for lvl, (lh, lw) in enumerate(plan.shapes):
        b = plan.bases[lvl]
        live[b:b + lh + 2 * r, :lw + 2 * r] = True
        np.testing.assert_array_equal(got[b:b + lh + 2 * r, :lw + 2 * r],
                                      ref[b:b + lh + 2 * r, :lw + 2 * r])
    assert not got[~live].any()
    # level 0's block is the exact edge pad
    np.testing.assert_array_equal(got[:H + 2 * r, :W + 2 * r],
                                  np.pad(img, r, mode="edge"))


def test_packedpyr_wrapper_refuses_other_devices():
    with pytest.raises(ValueError):
        tpp.build_packed_pyramid(torch.empty((240, 320), device="meta"), 4,
                                 1.2, 21)


_K7_SHAPES = [(240, 320, 4), (100, 120, 4), (600, 640, 4), (1080, 1920, 8),
              (480, 640, 8), (600, 640, 1)]


def _k7_plan(h, w, levels):
    """K7's launch plan at 1.2 / r = 21, or None where the reference has
    no plan; there kernel_plan raises."""
    if not tpp.pyramid_available(h, w, levels, 1.2, 21):
        with pytest.raises(ValueError):
            tpp.kernel_plan(h, w, levels, 1.2, 21)
        return None
    return tpp.kernel_plan(h, w, levels, 1.2, 21)


@pytest.mark.parametrize("h, w, levels", _K7_SHAPES)
def test_packedpyr_plan_writes_every_element_once(h, w, levels):
    """K7's items write every element of the [total_rows, wpl] buffer
    exactly once: level tiles inside their level's block (their columns
    past lw + 2r at most to the next multiple of 4), pad and zero items
    on 16-byte columns; the shared memory keeps K7_BLOCKS blocks an SM."""
    kp = _k7_plan(h, w, levels)
    if kp is None:
        return
    plan = tpp.pyramid_plan(h, w, levels, 1.2, 21)
    r = plan.r
    assert kp.smem <= tpp.K7_SMEM and kp.blocks_per_sm >= tpp.K7_BLOCKS
    hits = np.zeros((plan.total_rows, plan.wpl), np.int32)
    for rec in kp.records:
        kind, lvl, a, n, c0, nc = rec[:6]
        if kind == tpp.KIND_TILE:
            base, lh2, lw2 = kp.levels[lvl][:3]
            tr, tc = kp.tile if rec[11] == 1 else kp.fused
            assert a + n <= lh2 and c0 + nc <= -(-lw2 // 4) * 4
            assert n <= tr and nc <= tc
            assert rec[11] == (1 if lvl < tpp.K7_FUSE_FROM else 2)
            hits[base + a:base + a + n, c0:c0 + nc] += 1
        else:
            assert c0 % 4 == 0 and nc % 4 == 0 and c0 + nc <= plan.wpl
            assert kind == tpp.KIND_ZERO or (c0 == 0 and a + n <= h + 2 * r)
            hits[a:a + n, c0:c0 + nc] += 1
    np.testing.assert_array_equal(hits, 1)


def _covers(t, lvl, t0, nr, u0, nu, win):
    """Whether the raw window (sr0, sr, sc0, sc) of level lvl-1 holds the
    spans of level lvl's rows [t0, t0 + nr) and columns [u0, u0 + nu)
    (those below lw + 2r); and the (rows, columns) of level lvl-1's block
    that those spans read."""
    r = t.plan.r
    rs = t.row_start[lvl - 1][t0:t0 + nr]
    rl = t.row_len[lvl - 1][t0:t0 + nr]
    cs = t.col_start[lvl - 1][u0:u0 + nu]
    cl = t.col_len[lvl - 1][u0:u0 + nu]
    sr0, sr, sc0, sc = win
    ok = (sr0 <= rs.min() and (rs + rl).max() <= sr0 + sr
          and sc0 <= cs.min() and (cs + cl).max() <= sc0 + sc)
    rows = {y + r for s, n in zip(rs, rl) for y in range(s, s + n)}
    cols = {x + r for s, n in zip(cs, cl) for x in range(s, s + n)}
    return ok, rows, cols


@pytest.mark.parametrize("h, w, levels", _K7_SHAPES)
def test_packedpyr_tiles_wait_on_the_tiles_they_read(h, w, levels):
    """A level-l tile of depth 1 waits on the counter of every level-(l-1)
    tile (band, run) whose output rows and columns its row and column
    spans read (row_start, row_len; col_start, col_len, shifted by r into
    the block), and its window holds those spans. One of depth 2 computes
    its window of level l-1 in shared memory from level l-2's window in
    its fifth int4, which holds the spans of that window's rows and
    columns, and waits on the level-(l-2) tiles those read. Level-1 tiles
    wait on nothing. Every tile of a level that some tile reads counts a
    counter of its own (the others 0), and in ticket order every tile
    comes after the tiles it waits on."""
    kp = _k7_plan(h, w, levels)
    if kp is None:
        return
    t = tpp.packed_tables(h, w, levels, 1.2, 21)
    r = t.plan.r
    done = set()                     # counters of the tiles so far
    for rec in kp.records:
        if rec[0] != tpp.KIND_TILE:
            continue
        _, lvl, t0, nr, u0, nu, sc0, sc, sr0, sr, own, depth = rec[:12]
        first, nb, nrun, stride = rec[12:16]
        ok, rows, cols = _covers(t, lvl, t0, nr, u0, nu, (sr0, sr, sc0, sc))
        assert ok
        if depth == 2:
            ok, rows, cols = _covers(t, lvl - 1, sr0 + r, sr, sc0 + r, sc,
                                     rec[16:20])
            assert ok
        b_first, bands, runs, tr, tc, d = kp.bands[lvl - 1]
        mine = b_first + (t0 // tr) * runs + u0 // tc
        waited = any(k - kp.bands[k - 1][5] == lvl
                     for k in range(lvl + 1, levels))
        assert d == depth and own == (mine if waited else 0)
        src = lvl - depth                # the level whose pixels it reads
        if src == 0:
            assert nb * nrun == 0
        else:
            p_first, _, p_runs, ptr, ptc, _ = kp.bands[src - 1]
            read = {p_first + (y // ptr) * p_runs + x // ptc
                    for y in rows for x in cols}
            waits = {first + b * stride + c for b in range(nb)
                     for c in range(nrun)}
            assert stride == p_runs and read <= waits <= done
        assert mine not in done
        done.add(mine)
    assert done == set(range(2, kp.n_counters))


def _k7_step(out, img, kp, lvl, t0, nr, u0, nu, win, stage):
    """One pass of a K7 tile in torch: level lvl's rows [t0, t0 + nr) and
    columns [u0, u0 + nu) from `stage`, the raw window win = (sr0, sr,
    sc0, sc) of level lvl-1: t1 once per (row, window column) as the chain
    fma(w1, s1, fma(w0, s0, 0)) with packedpyr._fma, then each column's
    chain from t1 (0 past lw + 2r)."""
    f32 = lambda a: torch.from_numpy(np.ascontiguousarray(a).view(  # noqa
        np.float32))
    sr0, sr, sc0, sc = (int(v) for v in win)
    _, lh2, lw2, rt, ct = (int(v) for v in kp.levels[lvl][:5])
    rows = kp.rtab[rt + t0:rt + t0 + nr]
    k0 = torch.from_numpy(rows[:, 0] - sr0).long()
    k1 = k0 + torch.from_numpy((rows[:, 1] > 1).astype(np.int64))
    w0, w1 = f32(rows[:, 2])[:, None], f32(rows[:, 3])[:, None]
    t1 = tpp._fma(w1, stage[k1], tpp._fma(w0, stage[k0], torch.zeros(nr,
                                                                    sc)))
    live = min(nu, lw2 - u0)
    cols = kp.ctab[ct + u0:ct + u0 + live]
    j0 = torch.from_numpy(cols[:, 0] - sc0).long()
    j1 = j0 + torch.from_numpy((cols[:, 1] > 1).astype(np.int64))
    v = tpp._fma(f32(cols[:, 3])[None, :], t1[:, j1],
                 tpp._fma(f32(cols[:, 2])[None, :], t1[:, j0],
                          torch.zeros(nr, live)))
    return torch.cat([v, torch.zeros(nr, nu - live)], 1)


def _k7_source(out, img, kp, lvl, win):
    """The raw window win of level lvl-1, from the image or the buffer
    (which must already hold it: the buffer starts as NaN)."""
    sr0, sr, sc0, sc = (int(v) for v in win)
    if lvl == 1:
        return img[sr0:sr0 + sr, sc0:sc0 + sc]
    srow, scol = (int(v) for v in kp.levels[lvl][5:7])
    src = out[srow + sr0:srow + sr0 + sr, scol + sc0:scol + sc0 + sc]
    assert not src.isnan().any()
    return src


def _emulate_packedpyr(img, kp, plan):
    """K7's items in ticket order, in torch (`_k7_step`): a tile of depth
    1 from level l-1's window in the buffer, one of depth 2 from level
    l-2's, through its level-(l-1) window computed on the way; pad and
    zero items as the kernel writes them."""
    h, w = img.shape
    r = plan.r
    out = torch.full((plan.total_rows, plan.wpl), float("nan"))
    for rec in kp.records:
        kind, lvl, a, n, c0, nc = (int(v) for v in rec[:6])
        if kind == tpp.KIND_ZERO:
            out[a:a + n, c0:c0 + nc] = 0.0
            continue
        if kind == tpp.KIND_PAD:
            iy = (torch.arange(a, a + n) - r).clamp(0, h - 1)
            u = torch.arange(nc)
            v = img[iy[:, None], (u - r).clamp(0, w - 1)[None, :]]
            out[a:a + n, :nc] = torch.where(u < w + 2 * r, v, 0.0)
            continue
        sc0, sc, sr0, sr = (int(v) for v in rec[6:10])
        win = (sr0, sr, sc0, sc)
        if rec[11] == 1:
            stage = _k7_source(out, img, kp, lvl, win)
        else:
            inner = rec[16:20]
            stage = _k7_step(out, img, kp, lvl - 1, sr0 + r, sr, sc0 + r,
                             sc, inner, _k7_source(out, img, kp, lvl - 1,
                                                   inner))
        base = int(kp.levels[lvl][0])
        out[base + a:base + a + n, c0:c0 + nc] = _k7_step(
            out, img, kp, lvl, a, n, c0, nc, win, stage)
    return out


@pytest.mark.parametrize("h, w, levels", [(240, 320, 4), (480, 640, 8)])
def test_packedpyr_tile_emulation_computes_the_plain_version(h, w, levels):
    """K7's tiles emulated in ticket order (`_emulate_packedpyr`: t1 once
    per (row, window column), then the column chains; a depth-2 tile
    through its level-(l-1) window) equal the plain version over the
    whole buffer, each source read after it was written."""
    img = torch.from_numpy(np.random.default_rng(16).uniform(
        0, 255, (h, w)).astype(np.float32))
    kp = tpp.kernel_plan(h, w, levels, 1.2, 21)
    plan = tpp.pyramid_plan(h, w, levels, 1.2, 21)
    got = _emulate_packedpyr(img, kp, plan)
    assert torch.equal(got, tpp.build_packed_pyramid_plain(img, levels, 1.2,
                                                           21))


@pytest.mark.parametrize("n", [0, 1, 2, 3])
def test_patchgather_store_split_covers_each_patch_word_once(n):
    """K2's stores of patch n (1849 words, so n mod 4 words past a 16-byte
    boundary): scalar head words up to a boundary, 16-byte body stores
    from it, scalar tail words; together every word exactly once."""
    words = 43 * 43
    head, vec, tail = tpg.store_split(n, words)
    assert 0 <= head < 4 and 0 <= tail < 4
    assert (n * words + head) % 4 == 0
    hits = np.zeros(words, np.int32)
    hits[:head] += 1
    for k in range(vec):
        hits[head + 4 * k:head + 4 * k + 4] += 1
    hits[head + 4 * vec:] += 1
    assert head + 4 * vec + tail == words
    np.testing.assert_array_equal(hits, 1)
