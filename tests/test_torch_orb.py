"""The port's ORB extractor against the JAX package's, stage by stage.

The whole `orb_detect` is held against frame 0 of the JAX FastVO slice's
run on its TPU path (`test_torch_fastvo.py`, which shares that one JAX
run). Here the stages are held one by one on the same inputs, on a frame
of bench.py's synthetic survey strip at 600x640: the tables and the
integer-valued stages exactly, the angle and the blur to 1e-4.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import chip_smoke
from pislamfusion_tpu.ops.features import orb as jorb
from pislamfusion_tpu_torch.ops.features import fastselect as tfs
from pislamfusion_tpu_torch.ops.features import orb as torb
from torch_port_reference import torch_one_thread  # noqa: F401

H, W = 600, 640
PARAMS = dict(n_features=256, n_levels=4)


@pytest.fixture(scope="module")
def gray():
    frames, _ = chip_smoke.render_strip(1, H, W, 600.0, 0.24, 1024, "cpu")
    rgb = frames[0].numpy().astype(np.float32)
    return (rgb @ np.array([0.299, 0.587, 0.114], np.float32)).astype(
        np.float32)


def test_orb_tables_match_reference():
    np.testing.assert_array_equal(tfs._CIRCLE, jorb._CIRCLE)
    np.testing.assert_array_equal(torb._umax_mask(), jorb._umax_mask())
    np.testing.assert_array_equal(torb._IC_U, jorb._IC_U)
    np.testing.assert_array_equal(torb._IC_V, jorb._IC_V)
    np.testing.assert_array_equal(torb._PATTERN, jorb._PATTERN)
    np.testing.assert_array_equal(torb._binned_tap_indices(30),
                                  jorb._binned_tap_indices(30))
    assert (torb._GATHER_R, torb._GATHER, torb.PATCH_SIZE) == \
        (jorb._GATHER_R, jorb._GATHER, jorb.PATCH_SIZE)
    for kw in (PARAMS, {}, dict(n_features=2000, n_levels=6)):
        assert torb.OrbParams(**kw).features_per_level() == \
            jorb.OrbParams(**kw).features_per_level()
    for shape, k in (((600, 640), 80), ((1080, 1920), 300), ((64, 96), 40)):
        assert torb._per_cell_quota(shape, k, 32) == \
            jorb._per_cell_quota(shape, k, 32)


def test_fast_score_and_nms_exact(gray):
    t = tfs.fast_score_map(torch.from_numpy(gray))
    # the references jitted: one compile, not an eager one per operation
    j = jax.jit(jorb.fast_score_map)(jnp.asarray(gray))
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    np.testing.assert_array_equal(tfs._nms3(t).numpy(),
                                  np.asarray(jax.jit(jorb._nms3)(j)))


@pytest.mark.parametrize("k", [20, 900])   # top-1 per cell, and top-k
def test_select_keypoints_exact(gray, k):
    score = np.array(jax.jit(jorb.fast_score_map)(
        jnp.asarray(gray)))[:200, :256]
    per_cell = jorb._per_cell_quota(score.shape, k, 32)
    assert (per_cell == 1) == (k == 20)
    t = torb.select_keypoints(torch.from_numpy(score), k, 32, 7.0)
    j = jax.jit(jorb.select_keypoints, static_argnums=(1, 2, 3))(
        jnp.asarray(score), k, 32, 7.0)
    for a, b in zip(t, j):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_angle_blur_and_brief(gray):
    rng = np.random.default_rng(30)
    n = 300
    G, r = jorb._GATHER, jorb._GATHER_R
    ys = rng.integers(r, H - r, n)
    xs = rng.integers(r, W - r, n)
    pat = np.stack([gray[y - r:y + r + 1, x - r:x + r + 1]
                    for y, x in zip(ys, xs)]).astype(np.float32)
    assert pat.shape == (n, G, G)
    d = r - jorb.HALF_PATCH
    c31 = pat[:, d:d + 31, d:d + 31]
    ang_j = np.array(jax.jit(jorb.ic_angle)(jnp.asarray(c31)))
    ang_t = torb.ic_angle(torch.from_numpy(c31)).numpy()
    np.testing.assert_allclose(ang_t, ang_j, atol=1e-4)
    blur_j = np.array(jax.jit(jorb._blur_patches)(jnp.asarray(pat)))
    blur_t = torb._blur_patches(torch.from_numpy(pat)).numpy()
    np.testing.assert_allclose(blur_t, blur_j, atol=1e-4)
    # same blurred patches and angles on both sides: identical bits
    bits_j = np.asarray(jax.jit(jorb.brief_descriptors, static_argnums=2)(
        jnp.asarray(blur_j), jnp.asarray(ang_j), 30))
    bits_t = torb.brief_descriptors(torch.from_numpy(blur_j),
                                    torch.from_numpy(ang_j), 30).numpy()
    np.testing.assert_array_equal(bits_t, bits_j)
    np.testing.assert_array_equal(
        torb.pack_bits(torch.from_numpy(bits_t)).numpy(),
        np.asarray(jax.jit(jorb.pack_bits)(jnp.asarray(bits_j))))


def test_brief_continuous_angle_bit_equal():
    """angle_bins=0 (each keypoint's pattern rotated by its own angle, the
    reference's round-rotated tap formula in f32): the same bits as the
    reference's on the same blurred patches and angles, over 3000 random
    angles and patches of coarse values (many equal taps)."""
    rng = np.random.default_rng(31)
    n, G = 3000, jorb._GATHER
    ang = rng.uniform(-np.pi, np.pi, n).astype(np.float32)
    ang[:64] = np.linspace(-np.pi, np.pi, 64, dtype=np.float32)
    brief = jax.jit(jorb.brief_descriptors, static_argnums=2)
    for pat in (rng.uniform(0, 255, (n, G, G)).astype(np.float32),
                np.round(rng.uniform(0, 8, (n, G, G))).astype(np.float32)):
        bits_j = np.asarray(brief(jnp.asarray(pat), jnp.asarray(ang), 0))
        bits_t = torb.brief_descriptors(torch.from_numpy(pat),
                                        torch.from_numpy(ang), 0).numpy()
        np.testing.assert_array_equal(bits_t, bits_j)


def test_orb_detect_continuous_angle_matches_reference(gray,
                                                       monkeypatch):
    """orb_detect with OrbParams(angle_bins=0) against the reference's on
    its TPU path (K1, K2 in interpret mode) on the same frame, at the
    port's ORB bars (test_torch_fastvo.py): >= 98 % of the valid
    keypoints with the same (xy, octave), >= 99.9 % of their descriptor
    bits equal."""
    from test_torch_fastvo import _assert_features_match
    from torch_port_reference import forced_tpu_path
    with forced_tpu_path(monkeypatch):
        ref = {k: np.asarray(v) for k, v in jorb.orb_detect(
            jnp.asarray(gray), jorb.OrbParams(angle_bins=0,
                                              **PARAMS)).items()}
    got = {k: v.numpy() for k, v in torb.orb_detect(
        torch.from_numpy(gray), torb.OrbParams(angle_bins=0,
                                               **PARAMS)).items()}
    _assert_features_match(ref, got)
    binned = torb.orb_detect(torch.from_numpy(gray),
                             torb.OrbParams(**PARAMS))
    # the continuous pattern is another descriptor than the binned one
    assert (binned["desc"].numpy() != got["desc"]).mean() > 0.01
