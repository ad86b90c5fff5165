"""The port's image ops against the JAX package's, on the CPU.

The JAX package runs its f32 shift-and-add stencils there (the banded
matrix spelling is for the TPU only). The port's blur follows that
spelling; its pyrDown and pyrUp take the banded one through K8's plain
version (the reference's matrices, each row's span summed in tap order).
Tolerance 1e-4 gray on 0..255 images: the same f32 taps, summed in
another order (pyrDown/pyrUp measured 3.1e-5). The gather warps
(`bilinear_sample`, `warp_perspective`) within 1e-3 gray: the same f32
formula, whose sample fractions the two frameworks may round apart.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pislamfusion_tpu.ops import image as jim
from pislamfusion_tpu_torch.ops import image as tim
from torch_port_reference import torch_one_thread  # noqa: F401

ATOL = 1e-4


def _img(seed, shape):
    return np.random.default_rng(seed).uniform(0, 255, shape).astype(
        np.float32)


def _close(t, j, atol=ATOL):
    j = np.asarray(j)
    t = t.numpy()
    assert t.shape == j.shape
    np.testing.assert_allclose(t, j, atol=atol, rtol=0)


def test_rgb_to_gray():
    x = _img(20, (37, 41, 3))
    _close(tim.rgb_to_gray(torch.from_numpy(x)), jim.rgb_to_gray(x))


@pytest.mark.parametrize("shape", [(64, 80, 3), (63, 81, 1), (2, 17, 9, 3)])
def test_pyr_down(shape):
    x = _img(21, shape)
    _close(tim.pyr_down(torch.from_numpy(x)), jim.pyr_down(jnp.asarray(x)))


@pytest.mark.parametrize("shape, out_hw", [
    ((32, 40, 3), None), ((32, 41, 1), (63, 81)), ((2, 9, 7, 3), (17, 13)),
])
def test_pyr_up(shape, out_hw):
    x = _img(22, shape)
    _close(tim.pyr_up(torch.from_numpy(x), out_hw),
           jim.pyr_up(jnp.asarray(x), out_hw))


@pytest.mark.parametrize("bands", [1, 3])
def test_laplacian_pyramid_and_restore(bands):
    x = _img(23, (96, 72, 3))
    tl = tim.build_laplacian_pyramid(torch.from_numpy(x), bands)
    # the reference jitted: one compile, not an eager one per operation
    jl = jax.jit(jim.build_laplacian_pyramid, static_argnums=1)(
        jnp.asarray(x), bands)
    assert len(tl) == len(jl) == bands + 1
    for t, j in zip(tl, jl):
        _close(t, j)
    _close(tim.restore_from_laplacian(tl),
           jax.jit(jim.restore_from_laplacian)(jl))


@pytest.mark.parametrize("shape, out_hw", [
    ((100, 120, 1), (83, 100)), ((64, 64, 3), (53, 53)),
    ((50, 70, 1), (70, 90)),
])
def test_resize_bilinear(shape, out_hw):
    """The port resizes with the reference's interpolation matrices (its
    TPU spelling): 1e-4 against that product in float64. The reference's
    CPU spelling, jax.image.resize, places its samples in f32 arithmetic,
    ~1e-5 px away, which on 0..255 noise is up to ~2e-3 gray: 5e-3."""
    x = _img(24, shape)
    t = tim.resize_bilinear(torch.from_numpy(x), out_hw)
    mh = jim._resize_matrix(shape[0], out_hw[0]).astype(np.float64)
    mw = jim._resize_matrix(shape[1], out_hw[1]).astype(np.float64)
    _close(t, np.einsum("rh,sw,hwc->rsc", mh, mw, x.astype(np.float64)))
    _close(t, jim.resize_bilinear(jnp.asarray(x), out_hw), atol=5e-3)


def test_resize_matrix_and_gaussian_kernel_tables():
    for n, on in ((1080, 900), (900, 750), (7, 13)):
        np.testing.assert_array_equal(tim._resize_matrix(n, on),
                                      jim._resize_matrix(n, on))
    for sigma, r in ((2.0, 3), (1.6, None)):
        np.testing.assert_array_equal(tim.gaussian_kernel1d(sigma, r),
                                      jim.gaussian_kernel1d(sigma, r))


def test_gaussian_blur():
    x = _img(25, (40, 50, 3))
    _close(tim.gaussian_blur(torch.from_numpy(x), 2.0, 3),
           jim.gaussian_blur(jnp.asarray(x), 2.0, 3))


@pytest.mark.parametrize("offset", [(0.0, 0.0), (12.5, -3.0)])
def test_homography_grid(offset):
    h = np.array([[0.9, -0.1, 20.0], [0.12, 1.05, -7.0],
                  [1e-4, -2e-4, 1.0]], np.float32)
    t = tim.homography_grid(torch.from_numpy(h), (48, 64), offset)
    j = jim.homography_grid(jnp.asarray(h), (48, 64), offset)
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-6,
                               atol=1e-4)


_H_WARP = np.array([[0.9, -0.1, 20.0], [0.12, 1.05, -7.0],
                    [1e-4, -2e-4, 1.0]], np.float32)


@pytest.mark.parametrize("border", ["constant", "replicate", "reflect"])
def test_bilinear_sample(border):
    rng = np.random.default_rng(26)
    x = _img(26, (40, 50, 3))
    xy = rng.uniform(-8, 58, (30, 20, 2)).astype(np.float32)
    fn = jax.jit(jim.bilinear_sample, static_argnums=(2, 3))
    jv, jok = fn(jnp.asarray(x), jnp.asarray(xy), 7.0, border)
    tv, tok = tim.bilinear_sample(torch.from_numpy(x), torch.from_numpy(xy),
                                  7.0, border)
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jok))
    assert 0.2 < tok.numpy().mean() < 0.95
    _close(tv, jv, atol=1e-3)


def test_warp_perspective():
    x = _img(27, (48, 64, 3))
    fn = jax.jit(jim.warp_perspective, static_argnums=(2, 3, 4, 5))
    jv, jok = fn(jnp.asarray(x), jnp.asarray(_H_WARP), (40, 56),
                 (3.0, -2.0), 0.0, "reflect")
    tv, tok = tim.warp_perspective(torch.from_numpy(x),
                                   torch.from_numpy(_H_WARP), (40, 56),
                                   (3.0, -2.0), 0.0, "reflect")
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jok))
    _close(tv, jv, atol=1e-3)
