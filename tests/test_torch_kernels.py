"""The port's kernels (their plain PyTorch versions, which a CPU tensor
takes) against the JAX package's Pallas kernels run through the Pallas
interpreter on the CPU.

K1 flat pyramid: within 1e-3 of the interpreted kernel over the whole
packed buffer (both round the source, the matrices and the row-pass
result to bf16 at the same points; only f32 summation order differs) and
within 2 gray of the exact f64 product (the cost of those bf16 roundings).
K2 patch gather: bit-exact. K3 shear warp: equal tile liveness, dead
tiles exactly zero, within 5e-3 gray on live pixels whose source point is
>= 2 px inside the image (the kernel's "high" bf16 hi/lo split keeps ~16
mantissa bits of the image; the port computes in f32).
K5 banded stack: within 2e-5 on a 0..1 image (both f32; the kernel's
dense 128-row tiles and the port's products sum in other orders), its
composed matrices within 1 f32 ulp of sift._stack_matrices (both cast the
same float64 products, summed in other orders), and the reference's
fusability verdict at every octave size of a 1080p frame. K6 bilinear
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
offsets, equal to the per-level plain version.
K7 packed pyramid: the reference's plan, regime and every level's (lh +
2r, lw + 2r) block equal to the interpreted kernel (both sum the taps as
one fused multiply-add chain), zeros elsewhere.
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
