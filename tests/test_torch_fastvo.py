"""The port's FastVO slice against the JAX package's, and the package's
boundaries.

The slice: K=3 frames of bench.py's synthetic survey strip at 600x640
(ORB-256, 4 levels, 3 bands) through the JAX FastVO on its TPU path (K1,
K2, K3 through the Pallas interpreter) and through the port on the CPU,
both starting from the same canvas, seeded through `convert.py`. Bounds:
n_match within 3 per frame, translation within 5e-3 m, quaternion within
1e-4, blended mosaic >= 40 dB PSNR against the JAX mosaic over the pixels
both cover, coverage masks equal on >= 99.9 % of the canvas.
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import chip_smoke
from pislamfusion_tpu.core.camera import Camera as JCamera
from pislamfusion_tpu.models.fastvo import FastVO as JFastVO
from pislamfusion_tpu_torch import convert
from pislamfusion_tpu_torch.ops import shearwarp as tsw
from pislamfusion_tpu_torch.ops.features import flatpyr as tfp
from pislamfusion_tpu_torch.ops.features import patchgather as tpg
from torch_port_reference import forced_tpu_path

H, W, FX, K = 600, 640, 600.0, 3
N, LEVELS, BANDS = 256, 4, 3
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _seed_canvas(canvas_tiles, rng):
    """A canvas that already holds a mosaic in its left third: Laplacian
    bands of smooth content, weights 0.3."""
    n = canvas_tiles * 256
    lap, w = [], []
    for i in range(BANDS + 1):
        s = n >> i
        a = np.zeros((s, s, 3), np.float32)
        b = np.zeros((s, s, 1), np.float32)
        a[:, :s // 3] = rng.normal(0, 4.0, (s, s // 3, 3))
        if i == BANDS:
            a[:, :s // 3] += 120.0
        b[:, :s // 3] = 0.3
        lap.append(a)
        w.append(b)
    return lap, w


def test_fastvo_slice_matches_reference_tpu_path(monkeypatch):
    frames_t, poses = chip_smoke.render_strip(K, H, W, FX, 0.24, 1024, "cpu")
    frames = frames_t.numpy()
    lp, patch_tiles, canvas_tiles, min_xy = chip_smoke.strip_geometry(
        H, W, FX, poses)
    lap0, w0 = _seed_canvas(canvas_tiles, np.random.default_rng(50))

    jvo = JFastVO(JCamera(W, H, FX, FX, W / 2.0, H / 2.0), min_xy,
                  canvas_tiles, lp, bands=BANDS, n_features=N,
                  n_levels=LEVELS, window_radius=60.0,
                  patch_tiles=patch_tiles, warp_mode="shear")
    jvo.canvas_lap = [jnp.asarray(a) for a in lap0]
    jvo.canvas_w = [jnp.asarray(a) for a in w0]
    with forced_tpu_path(monkeypatch):
        p_j, n_j = jvo.process(jnp.asarray(frames), poses[0])
        img_j, cov_j = jvo.blended()

    for fn in (tfp.build_flat_pyramid, tpg.gather_patches, tsw.warp_patch):
        fn.launches = 0
    tvo = chip_smoke.make_fastvo(H, W, FX, poses, N, LEVELS, BANDS, "cpu")
    assert convert.load_fastvo_state(
        tvo, convert.fastvo_state_from_numpy(lap0, w0, device="cpu")) is None
    p_t, n_t = tvo.process(frames, poses[0])
    img_t, cov_t = tvo.blended()
    # on the CPU every wrapper took its plain version
    assert (tfp.build_flat_pyramid.launches, tpg.gather_patches.launches,
            tsw.warp_patch.launches) == (0, 0, 0)

    assert n_t.shape == (K,) and p_t.shape == (K, 7)
    assert np.abs(n_t - n_j).max() <= 3 and (n_t[1:] > 50).all()
    assert np.abs(p_t[:, :3] - p_j[:, :3]).max() <= 5e-3
    assert np.abs(p_t[:, 3:] - p_j[:, 3:]).max() <= 1e-4
    assert np.mean(cov_t == cov_j) >= 0.999
    both = cov_t & cov_j
    assert both.mean() > 0.3
    mse = float(np.mean((img_t - img_j)[both] ** 2))
    assert 10 * np.log10(255.0 ** 2 / max(mse, 1e-12)) >= 40.0
    # the carried canvas, read back through convert.py
    state = convert.fastvo_state_to_numpy(
        {"canvas_lap": tvo.canvas_lap, "canvas_w": tvo.canvas_w})
    for a, b in zip(state["canvas_w"], jvo.canvas_w):
        assert np.mean(np.abs(a - np.asarray(b)) <= 1e-2) >= 0.999


def test_convert_round_trip():
    rng = np.random.default_rng(51)
    lap = [rng.normal(size=(8 >> i, 8 >> i, 3)).astype(np.float32)
           for i in range(3)]
    w = [rng.uniform(size=(8 >> i, 8 >> i, 1)).astype(np.float32)
         for i in range(3)]
    carry = ((rng.random((5, 256)) < 0.5).astype(np.uint8),
             rng.random(5) < 0.5, rng.normal(size=(5, 3)).astype(np.float32),
             rng.normal(size=7).astype(np.float32),
             rng.normal(size=7).astype(np.float32))
    state = convert.fastvo_state_from_numpy(lap, w, carry, device="cpu")
    assert state["carry"][0].dtype == torch.uint8
    assert state["carry"][1].dtype == torch.bool
    back = convert.fastvo_state_to_numpy(state)
    for a, b in zip(back["canvas_lap"] + back["canvas_w"] + list(
            back["carry"]), lap + w + list(carry)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_process_from_a_converted_state_matches_a_fresh_run():
    """A run seeded with frame 0's carry and the canvas, both carried to
    numpy and back through convert.py, is the run from frame 0."""
    frames, poses = chip_smoke.render_strip(2, H, W, FX, 0.24, 1024, "cpu")
    runs = []
    for seeded in (False, True):
        tvo = chip_smoke.make_fastvo(H, W, FX, poses, N, LEVELS, BANDS,
                                     "cpu")
        carry = None
        if seeded:
            state = convert.fastvo_state_to_numpy({
                "canvas_lap": tvo.canvas_lap, "canvas_w": tvo.canvas_w,
                "carry": tvo.initial_carry(frames[0],
                                           torch.from_numpy(poses[0]))})
            carry = convert.load_fastvo_state(
                tvo, convert.fastvo_state_from_numpy(
                    state["canvas_lap"], state["canvas_w"], state["carry"],
                    device="cpu"))
            assert len(carry) == 5
        runs.append(tvo.process(frames, poses[0], carry) + tvo.blended())
    for a, b in zip(*runs):
        np.testing.assert_array_equal(a, b)


def test_port_imports_neither_jax_nor_the_reference():
    """In a fresh interpreter (this one has JAX loaded by conftest)."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import pislamfusion_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'pislamfusion_tpu' or m.startswith('pislamfusion_tpu.')]\n"
        "assert len([m for m in sys.modules"
        " if m.startswith('pislamfusion_tpu_torch.')]) >= 15\n"
        "print(bad)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_fastvo_defaults_to_cuda_and_raises_without_it():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is usable")
    from pislamfusion_tpu_torch import Camera, FastVO, resolve_device
    cam = Camera(W, H, FX, FX, W / 2.0, H / 2.0)
    with pytest.raises(RuntimeError, match="CUDA"):
        FastVO(cam, (0.0, 0.0), 4, 0.5, bands=2)
    with pytest.raises(RuntimeError, match="CUDA"):
        FastVO(cam, (0.0, 0.0), 4, 0.5, bands=2, device="cuda")
    assert resolve_device("cpu").type == "cpu"


@pytest.mark.parametrize("entry", ["fastvo_state_from_numpy",
                                   "alloc_canvas"])
def test_entry_point_defaults_to_cuda_and_raises_without_it(entry):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is usable")
    from pislamfusion_tpu_torch.ops import mosaic as tm
    lap = [np.zeros((4, 4, 3), np.float32)]
    w = [np.zeros((4, 4, 1), np.float32)]
    call = {"fastvo_state_from_numpy":
            lambda **kw: convert.fastvo_state_from_numpy(lap, w, **kw),
            "alloc_canvas": lambda **kw: tm.alloc_canvas(1, 1, 1, **kw)}[entry]
    with pytest.raises(RuntimeError, match="CUDA"):
        call()
    with pytest.raises(RuntimeError, match="CUDA"):
        call(device="cuda")
    out = call(device="cpu")
    lap_t = out["canvas_lap"] if isinstance(out, dict) else out[0]
    assert lap_t[0].device.type == "cpu"
