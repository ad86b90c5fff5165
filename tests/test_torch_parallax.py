"""The port's Map2D engines on tests/test_parallax.py's hard fixtures, at
that file's bars.

synth_survey.make_world's ground plane with raised roof slabs and an
exposure gradient a frame (render_view_3d, 200x150, a 40-frame
lawnmower at 30 m): overlapping frames disagree at roof edges, so a
single-band average ghosts where the max-weight Laplacian composite keeps
one crisp source a band. The port's MultiBand (Type 3), Weighted (Type 1)
and Render with seams (Type 4) engines run on the CPU at Map2D.Scale 0.7
and 4 bands, and are held to the reference's own bars (its
test_multiband_beats_weighted_on_parallax, test_exposure_field_is_lowfreq
and test_render_seamed_on_parallax), which are against the orthophoto;
test_torch_map2d.py holds every type against the JAX engines.
"""
import numpy as np
import pytest
import torch

from pislamfusion_tpu_torch.core.camera import Camera
from pislamfusion_tpu_torch.core.svar import Svar
from pislamfusion_tpu_torch.models.map2d import (MultiBandMap2D,
                                                 RenderMap2D, WeightedMap2D)
from pislamfusion_tpu_torch.ops import image as im
from synth_survey import (GROUND_SCALE, exposure_field, lawnmower,
                          make_world, render_view_3d, true_ortho)
from torch_port_reference import torch_one_thread  # noqa: F401

CAM = (200, 150, 140.0, 140.0, 100.0, 75.0)


def psnr(a, b):
    mse = ((a.astype(np.float64) - b.astype(np.float64)) ** 2).mean()
    return 10 * np.log10(255.0 ** 2 / max(mse, 1e-12))


def _ortho_at_canvas(ortho, m, ys, xs):
    gx = (m.min_xy[0] + xs * m.length_pixel) / GROUND_SCALE
    gy = (m.min_xy[1] + ys * m.length_pixel) / GROUND_SCALE
    xy = torch.from_numpy(np.stack([gx, gy], -1).astype(np.float32))
    v, _ = im.bilinear_sample(torch.from_numpy(np.asarray(ortho,
                                                          np.float32)),
                              xy, border="replicate")
    return v.numpy()


def _blur(img):
    return im.gaussian_blur(torch.from_numpy(img.astype(np.float32)),
                            2.0).numpy()


@pytest.fixture(scope="module")
def hard_world():
    """test_parallax.py's fixture (seed 7): the world, the JAX camera's
    twin, the lawnmower poses and the rendered frames."""
    from pislamfusion_tpu.core.camera import Camera as JCamera
    rng = np.random.default_rng(7)
    world = make_world(rng, n=1024, rects=500, n_slabs=12,
                       heights=(3.0, 6.0), stamp_grid=160)
    poses = lawnmower(alt=30.0, y0=32.0, y1=70.0, dy=9.0,
                      x0=30.0, x1=72.0, dx=6.0)
    frames = [render_view_3d(world, JCamera(*CAM), p, k=k, illum=0.12)
              for k, p in enumerate(poses)]
    return world, Camera(*CAM), poses, frames


def _blend(engine_cls, cam, poses, frames, bands=4, **extra):
    cfg = Svar()
    cfg.set("Map2D.Scale", "0.7")
    cfg.set("Map2D.BandNumber", str(bands))
    for k, v in extra.items():
        cfg.set(k, str(v))
    m = engine_cls(cfg, device="cpu")
    plane = np.array([0, 0, 0, 0, 0, 0, 1.0])
    assert m.prepare(plane, cam, [(None, p) for p in poses])
    for img, p in zip(frames, poses):
        assert m.feed(img, p)
    out, covered = m.blended()
    return m, out, covered


@pytest.fixture(scope="module")
def multiband(hard_world):
    _, cam, poses, frames = hard_world
    return _blend(MultiBandMap2D, cam, poses, frames)


def _truth(world, m, shape):
    H, W = shape[:2]
    yy, xx = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    return _ortho_at_canvas(true_ortho(world), m, yy.ravel(),
                            xx.ravel()).reshape(H, W, 3)


def test_multiband_beats_weighted_on_parallax(hard_world, multiband):
    """The Laplacian max-weight composite keeps the scene's fine texture
    where the single-band weighted average ghost-blurs it (the reference's
    measured retention: MultiBand 0.96-0.97, Weighted 0.83-0.89)."""
    world, cam, poses, frames = hard_world
    mb, out_mb, cov_mb = multiband
    wt, out_wt, cov_wt = _blend(WeightedMap2D, cam, poses, frames)
    cov = cov_mb & cov_wt
    assert cov.sum() > 5000
    gt = _truth(world, mb, out_mb.shape)
    p_mb = psnr(out_mb[cov], gt[cov])
    p_wt = psnr(out_wt[cov], gt[cov])
    assert p_mb > 20.0, f"multiband degraded: {p_mb:.2f} dB"
    assert p_mb > p_wt - 1.0, (
        f"multiband {p_mb:.2f} dB far below weighted {p_wt:.2f} dB")

    def hp_energy(img):
        return np.abs((img - _blur(img))[cov]).mean()
    e_gt = hp_energy(gt)
    r_mb = hp_energy(out_mb) / e_gt
    r_wt = hp_energy(out_wt) / e_gt
    assert r_mb > 0.93, f"multiband texture retention {r_mb:.3f}"
    assert r_mb > r_wt + 0.04 and r_mb > 1.04 * r_wt, (
        f"multiband retention {r_mb:.3f} vs weighted {r_wt:.3f}")


def test_exposure_field_is_lowfreq():
    """The illumination model is smooth: gradient under 0.5 % a pixel,
    gain within [0.7, 1.3] (the fixture's stressor, for the port's
    camera as for the reference's)."""
    from pislamfusion_tpu.core.camera import Camera as JCamera
    for cam in (Camera(*CAM), JCamera(*CAM)):
        for k in (0, 3, 11):
            g = exposure_field(cam, k)[..., 0]
            assert 0.7 < g.min() and g.max() < 1.3
            assert np.abs(np.diff(g, axis=0)).max() < 0.005
            assert np.abs(np.diff(g, axis=1)).max() < 0.005


def test_render_seamed_on_parallax(hard_world, multiband):
    """Map2DRender with EnableSeam keeps the truth's fine texture at least
    0.9x as well as MultiBand's raw max-weight composite, within 2 dB of
    its PSNR."""
    world, cam, poses, frames = hard_world
    mb, out_mb, cov_mb = multiband
    rs, out_rs, cov_rs = _blend(RenderMap2D, cam, poses, frames,
                                **{"Map2DRender.EnableSeam": 1})
    cov = cov_mb & cov_rs
    assert cov.sum() > 5000
    gt = _truth(world, mb, out_mb.shape)
    g_hp = np.abs((gt - _blur(gt))[cov]).mean()

    def hp_ret(img):
        return np.abs((img - _blur(img))[cov]).mean() / g_hp
    r_mb, r_rs = hp_ret(out_mb), hp_ret(out_rs)
    p_rs = psnr(out_rs[cov], gt[cov])
    p_mb = psnr(out_mb[cov], gt[cov])
    assert r_rs > 0.9 * r_mb, (r_rs, r_mb)
    assert p_rs > p_mb - 2.0, (p_rs, p_mb)
