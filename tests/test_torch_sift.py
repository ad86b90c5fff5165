"""The port's SIFT extractor and SIFT FastVO slice against the JAX package's.

One JAX run holds the reference for this module: the JAX FastVO with
detector "sift" on its TPU path (K5 banded stack, K6 grid sampler and the
K3 shear warp in interpret mode) over K=3 frames of bench.py's synthetic
survey strip at 288x384 (SIFT-256, 3 bands; the smallest frame size that
tracks with n_match > 30 whose octave 0 still takes K5, min side >= 256),
from a seeded canvas. Its frame 0 features are read out of that run.

- `sift_detect` on frame 0's gray image, port on the CPU against those
  features: >= 98 % of the valid keypoints equal as (x, y, octave); on
  >= 98 % of the common ones the angle within 1e-3 rad (mod 2 pi) and the
  descriptor within 1e-3 in L2 (the stacks differ by f32 summation order,
  which can move a keypoint across the contrast or edge gate).
- The slice, port on the CPU from the same canvas sent through
  convert.py: n_match within 3 per frame, translation within 5e-3 m,
  quaternion within 1e-4, blended mosaic >= 40 dB PSNR over the pixels
  both cover, coverage equal on >= 99.9 % of the canvas.
- The stages on the same inputs: the selection exactly, the extrema
  response exactly, L2 distances to 1e-6.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import chip_smoke
from pislamfusion_tpu.ops import matching as jmatch
from pislamfusion_tpu.ops.features import sift as jsift
from pislamfusion_tpu_torch import convert
from pislamfusion_tpu_torch.ops import matching as tmatch
from pislamfusion_tpu_torch.ops import shearwarp as tsw
from pislamfusion_tpu_torch.ops import stencil as tst
from pislamfusion_tpu_torch.ops.features import patchgather as tpg
from pislamfusion_tpu_torch.ops.features import sift as tsift
from torch_port_reference import (jax_fastvo_run,  # noqa: F401
                                  once_per_session, seed_canvas,
                                  torch_one_thread)

H, W, FX, K = 288, 384, 384.0, 3
N, BANDS = 256, 3


@pytest.fixture(scope="module")
def strip():
    frames_t, poses = chip_smoke.render_strip(K, H, W, FX, 0.24, 1024, "cpu")
    canvas_tiles = chip_smoke.strip_geometry(H, W, FX, poses)[2]
    return (frames_t.numpy(), poses,
            seed_canvas(canvas_tiles, BANDS, np.random.default_rng(60)))


@pytest.fixture(scope="module")
def jax_run(strip, tmp_path_factory, worker_id):
    """The one JAX reference run of this module (of the test session)."""
    frames, poses, canvas = strip
    return once_per_session(
        "jax_sift_fastvo",
        lambda: jax_fastvo_run(frames, poses, FX, canvas, "sift", N, 8,
                               BANDS),
        tmp_path_factory, worker_id)


def test_sift_detect_matches_reference_tpu_path(jax_run):
    params = tsift.SiftParams(n_features=N)
    # octave 0 takes K5, octave 1 (144x192) the blur chain
    assert tsift._stack_tables(H, W, params) is not None
    assert min(H // 2, W // 2) < 256
    tst.banded_stack.launches = tpg.bilinear_grid.launches = 0
    ref = jax_run["feats0"]
    got = {k: v.numpy() for k, v in tsift.sift_detect(
        torch.from_numpy(jax_run["gray0"].copy()), params).items()}
    assert (tst.banded_stack.launches, tpg.bilinear_grid.launches) == (0, 0)
    assert set(got) == set(ref)
    for k in ref:
        assert got[k].shape == ref[k].shape and got[k].dtype == ref[k].dtype

    def keyed(d):
        return {(round(float(x), 3), round(float(y), 3), int(o)): i
                for i, ((x, y), o, v) in enumerate(
                    zip(d["xy"], d["octave"], d["valid"])) if v}
    kr, kg = keyed(ref), keyed(got)
    assert len(kr) > 150
    common = set(kr) & set(kg)
    assert len(common) >= 0.98 * max(len(kr), len(kg))
    ir = [kr[c] for c in common]
    ig = [kg[c] for c in common]
    dang = np.abs(np.angle(np.exp(1j * (got["angle"][ig]
                                        - ref["angle"][ir]))))
    ddesc = np.linalg.norm(got["desc"][ig] - ref["desc"][ir], axis=1)
    assert np.mean(dang <= 1e-3) >= 0.98
    assert np.mean(ddesc <= 1e-3) >= 0.98
    np.testing.assert_allclose(got["response"][ig], ref["response"][ir],
                               atol=1e-5)
    np.testing.assert_allclose(got["size"][ig], ref["size"][ir], rtol=1e-6)


def test_fastvo_sift_slice_matches_reference_tpu_path(strip, jax_run):
    frames, poses, (lap0, w0) = strip
    wrappers = (tst.banded_stack, tpg.bilinear_grid, tsw.warp_patch)
    for fn in wrappers:
        fn.launches = 0
    tvo = chip_smoke.make_fastvo(H, W, FX, poses, N, 8, BANDS, "cpu", "sift")
    assert convert.load_fastvo_state(
        tvo, convert.fastvo_state_from_numpy(lap0, w0, device="cpu")) is None
    p_t, n_t = tvo.process(frames, poses[0])
    img_t, cov_t = tvo.blended()
    # on the CPU every wrapper took its plain version
    assert tuple(fn.launches for fn in wrappers) == (0, 0, 0)

    p_j, n_j = jax_run["poses"], jax_run["n_match"]
    img_j, cov_j = jax_run["img"], jax_run["cov"]
    assert n_t.shape == (K,) and p_t.shape == (K, 7)
    assert np.abs(n_t - n_j).max() <= 3 and (n_t[1:] > 30).all()
    assert np.abs(p_t[:, :3] - p_j[:, :3]).max() <= 5e-3
    assert np.abs(p_t[:, 3:] - p_j[:, 3:]).max() <= 1e-4
    assert np.mean(cov_t == cov_j) >= 0.999
    both = cov_t & cov_j
    assert both.mean() > 0.3
    mse = float(np.mean((img_t - img_j)[both] ** 2))
    assert 10 * np.log10(255.0 ** 2 / max(mse, 1e-12)) >= 40.0


def test_sift_params_and_tables_match_reference():
    for kw in ({}, dict(n_features=256), dict(scales_per_octave=4,
                                                sigma0=1.2)):
        tp, jp = tsift.SiftParams(**kw), jsift.SiftParams(**kw)
        assert dataclasses.asdict(tp) == dataclasses.asdict(jp)
        assert tsift._chain_sigmas(tp) == jsift._chain_sigmas(jp)
    for shape in ((1080, 1920), (288, 384), (64, 96)):
        p = tsift.SiftParams()
        n_oct = tsift._octave_count(*shape, p)
        assert sum(tsift._quotas(n_oct, p)) == p.n_features
    assert tsift._quotas(4, tsift.SiftParams()) == [550, 275, 138, 37]


@pytest.fixture(scope="module")
def dog():
    """The DoG of octave 0 of a strip frame (through the port's K5 plain
    version), as float32 numpy."""
    frames, _ = chip_smoke.render_strip(1, H, W, FX, 0.24, 1024, "cpu")
    gray = frames[0].to(torch.float32) @ torch.tensor([0.299, 0.587, 0.114])
    stack = tsift.build_stacks(gray, tsift.SiftParams())[0]
    return (stack[1:] - stack[:-1]).numpy()


@pytest.fixture(scope="module")
def resp(dog):
    """The JAX extrema response of that DoG (one jit, not an eager compile
    per operation)."""
    return np.asarray(jax.jit(jsift._extrema_response, static_argnums=1)(
        jnp.asarray(dog), jsift.SiftParams()))


def test_extrema_response_exact(dog, resp):
    t = tsift._extrema_response(torch.from_numpy(dog),
                                tsift.SiftParams()).numpy()
    assert (t > 0).sum() > 100
    np.testing.assert_array_equal(t, resp)


@pytest.mark.parametrize("k", [10, 300])   # top-1 per cell, and top-k
def test_select_topk_exact(resp, k):
    ncells = -(-H // 64) * -(-W // 64)
    assert (int(np.ceil(2.0 * k / ncells)) <= 1) == (k == 10)
    t = tsift._select_topk(torch.from_numpy(resp.copy()), k)
    j = jax.jit(jsift._select_topk, static_argnums=1)(jnp.asarray(resp), k)
    for a, b in zip(t, j):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_sift_distance_matrix():
    rng = np.random.default_rng(61)
    a = rng.normal(size=(40, 128)).astype(np.float32)
    b = rng.normal(size=(50, 128)).astype(np.float32)
    a /= np.linalg.norm(a, axis=1, keepdims=True)
    b /= np.linalg.norm(b, axis=1, keepdims=True)
    b[:5] = a[:5]
    t = tmatch.distance_matrix(torch.from_numpy(a), torch.from_numpy(b),
                               "sift").numpy()
    j = np.asarray(jmatch.distance_matrix(jnp.asarray(a), jnp.asarray(b),
                                          "sift"))
    np.testing.assert_allclose(t, j, atol=1e-6)
    assert np.all(t[np.arange(5), np.arange(5)] <= 1e-3)


def test_root_sift():
    rng = np.random.default_rng(62)
    d = np.abs(rng.normal(size=(20, 128))).astype(np.float32)
    np.testing.assert_allclose(
        tsift.root_sift(torch.from_numpy(d)).numpy(),
        np.asarray(jsift.root_sift(jnp.asarray(d))), rtol=1e-6)
