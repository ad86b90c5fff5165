"""The port's three kernels (their plain PyTorch versions, which a CPU
tensor takes) against the JAX package's Pallas kernels run through the
Pallas interpreter on the CPU.

K1 flat pyramid: within 1e-3 of the interpreted kernel over the whole
packed buffer (both round the source, the matrices and the row-pass
result to bf16 at the same points; only f32 summation order differs) and
within 2 gray of the exact f64 product (the cost of those bf16 roundings).
K2 patch gather: bit-exact. K3 shear warp: equal tile liveness, dead
tiles exactly zero, within 5e-3 gray on live pixels whose source point is
>= 2 px inside the image (the kernel's "high" bf16 hi/lo split keeps ~16
mantissa bits of the image; the port computes in f32).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pislamfusion_tpu.ops import image as jim
from pislamfusion_tpu.ops import shearwarp as jsw
from pislamfusion_tpu.ops.features import flatpyr_pallas as jfpp
from pislamfusion_tpu.ops.features import orb as jorb
from pislamfusion_tpu.ops.features.patchgather import gather_patches_pallas
from pislamfusion_tpu_torch.ops import shearwarp as tsw
from pislamfusion_tpu_torch.ops.features import flatpyr as tfp
from pislamfusion_tpu_torch.ops.features import orb as torb
from pislamfusion_tpu_torch.ops.features import patchgather as tpg

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
