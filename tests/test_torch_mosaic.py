"""The port's mosaic feed against the JAX package's.

`patch_pyramids` on the half-resolution shear path is held against the
JAX function with its K3 Pallas kernel run through the interpreter: every
Laplacian band and every weight band within 1e-2 (gray, and weight units)
on the pixels of live tiles. The pieces around it are held on the same
inputs: homographies and weights to 1e-5 relative (f32, another operation
order), the composite exactly (a select), the reconstruction to 1e-3.
"""
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import chip_smoke
from pislamfusion_tpu.ops import mosaic as jm
from pislamfusion_tpu_torch.ops import mosaic as tm
from torch_port_reference import (forced_tpu_path,  # noqa: F401
                                  torch_one_thread)

H, W, FX = 600, 640, 600.0


def _pose(yaw_deg=7.0):
    th = np.deg2rad(yaw_deg) / 2.0
    # nadir camera (180 deg about x) turned by yaw about the vertical
    q_yaw = np.array([0.0, 0.0, np.sin(th), np.cos(th)])
    x, y, z, w = q_yaw
    q = np.array([w, z, -y, -x])        # q_yaw * (1, 0, 0, 0)
    return np.concatenate([[92.0, 121.0, 120.0], q]).astype(np.float32)


def _hc2i(origin=(-150.0, -180.0), lp=0.4):
    return np.array(jm.homography_canvas_to_image(
        jnp.asarray(_pose()), FX, FX, W / 2, H / 2,
        jnp.asarray(np.array(origin, np.float32) + np.array([92.0, 121.0],
                                                            np.float32)),
        lp), np.float32)


def test_homography_canvas_to_image():
    pose = _pose()
    origin = np.array([-60.5, 13.25], np.float32)
    j = jm.homography_canvas_to_image(jnp.asarray(pose), FX, FX, W / 2,
                                      H / 2, jnp.asarray(origin), 0.4)
    t = tm.homography_canvas_to_image(torch.from_numpy(pose), FX, FX,
                                      W / 2, H / 2, torch.from_numpy(origin),
                                      0.4)
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("weight_type", [0, 1])
def test_analytic_weight_pyramid(weight_type):
    h = _hc2i()
    live = np.array([[True, False, True], [True, True, False],
                     [False, True, True]])
    # the reference jitted: one compile, not an eager one per operation
    j = jax.jit(jm.analytic_weight_pyramid, static_argnums=(1, 2, 3, 4))(
        jnp.asarray(h), (H, W), (384, 384), 3, weight_type,
        jnp.asarray(live))
    t = tm.analytic_weight_pyramid(torch.from_numpy(h), (H, W), (384, 384),
                                   3, weight_type, torch.from_numpy(live))
    assert len(t) == len(j) == 4
    for a, b in zip(t, j):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-5)


def test_patch_pyramids_shear_half_res(monkeypatch):
    frames, _ = chip_smoke.render_strip(1, H, W, FX, 0.24, 1024, "cpu")
    rgb = frames[0].numpy().astype(np.float32)
    h = _hc2i()
    patch_hw, bands = (768, 768), 3
    # one jit of the reference instead of an eager compile per operation
    feed = jax.jit(functools.partial(jm.patch_pyramids, patch_hw=patch_hw,
                                     bands=bands, half_res=True,
                                     warp="shear"))
    with forced_tpu_path(monkeypatch):
        jl, jw = feed(jnp.asarray(rgb), jnp.asarray(h))
        jl = [np.asarray(a) for a in jl]
        jw = [np.asarray(a) for a in jw]
    tl, tw = tm.patch_pyramids(torch.from_numpy(rgb), torch.from_numpy(h),
                               patch_hw, bands, half_res=True, warp="shear")
    assert len(tl) == len(jl) == len(tw) == len(jw) == bands + 1
    assert np.all(tl[0].numpy() == 0) and np.all(jl[0] == 0)
    # live tiles of the half-res warp, at each band's resolution
    live = (jw[1][..., 0] > 0) | (np.abs(jl[1]).sum(-1) > 0)
    assert 0.2 < live.mean() < 1.0
    for i in range(bands + 1):
        t_l, t_w = tl[i].numpy(), tw[i].numpy()
        assert t_l.shape == jl[i].shape and t_w.shape == jw[i].shape
        n, nl = t_w.shape[0], live.shape[0]
        m = np.kron(live, np.ones((2, 2), bool)) if n > nl else \
            live[::nl // n, ::nl // n]
        assert np.abs(t_w - jw[i])[m].max() <= 1e-2
        assert np.abs(t_l - jl[i])[m].max() <= 1e-2


def test_composite_alloc_and_reconstruct():
    rng = np.random.default_rng(40)
    bands = 3
    j_lap, j_w = jm.alloc_canvas(4, 4, bands)
    t_lap, t_w = tm.alloc_canvas(4, 4, bands, "cpu")
    assert [tuple(a.shape) for a in t_lap] == [a.shape for a in j_lap]
    assert [tuple(a.shape) for a in t_w] == [a.shape for a in j_w]
    for oyx in ([256, 0], [0, 256], [256, 256]):
        p_lap = [rng.normal(0, 20, (512 >> i, 512 >> i, 3)).astype(
            np.float32) for i in range(bands + 1)]
        p_w = [rng.uniform(0, 1, (512 >> i, 512 >> i, 1)).astype(np.float32)
               for i in range(bands + 1)]
        p_lap[-1] += 128.0
        j_lap, j_w = jax.jit(jm.composite_patch)(
            j_lap, j_w, [jnp.asarray(a) for a in p_lap],
            [jnp.asarray(a) for a in p_w], jnp.asarray(oyx, jnp.int32))
        tm.composite_patch(t_lap, t_w, [torch.from_numpy(a) for a in p_lap],
                           [torch.from_numpy(a) for a in p_w],
                           torch.tensor(oyx, dtype=torch.int32))
    for a, b in zip(t_lap + t_w, j_lap + j_w):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    ti, tc = tm.reconstruct_canvas(t_lap, t_w)
    ji, jc = jax.jit(jm.reconstruct_canvas)(list(j_lap), list(j_w))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_allclose(ti.numpy(), np.asarray(ji), atol=1e-3)
