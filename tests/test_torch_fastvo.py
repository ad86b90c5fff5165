"""The port's FastVO slice and ORB extractor against the JAX package's,
and the package's boundaries.

The slice: K=3 frames of bench.py's synthetic survey strip at 600x640
(ORB-256, 4 levels, 3 bands) through the JAX FastVO on its TPU path (K1,
K2, K3 in interpret mode) and through the port on the CPU, both starting
from the same canvas, seeded through `convert.py`. Bounds: n_match within
3 per frame, translation within 5e-3 m, quaternion within 1e-4, blended
mosaic >= 40 dB PSNR against the JAX mosaic over the pixels both cover,
coverage masks equal on >= 99.9 % of the canvas.

`orb_detect` is held against frame 0's features of that same JAX run (the
ones its initial carry is built from), on the same gray image: >= 98 % of
the valid keypoints with the same (xy, octave), and >= 99.9 % of the
descriptor bits equal over those (the two pyramids differ by f32
summation order, which can flip a near-tie FAST rank or BRIEF compare).

The same slice and the same `orb_detect` comparison hold for the other
ORB front end, `pyramid="packed"` (the serial packed pyramid K7 and the
fused FAST+NMS+select K4), against one JAX run with the reference's flat
gate off and its extraction gate on (`forced_tpu_path(flat=False,
extract=True)`; at 600x640 with 4 levels both kernels apply), and the
selection through K4 equals select_keypoints' exactly.

`fast_warp=False` (the reference's callers' setting) is held on one feed
against the JAX feed, both with warp_mode "" (the gather warp on the
CPU, at full resolution): canvas weights within 1e-5, Laplacian bands
within 1e-3 gray.
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import chip_smoke
from pislamfusion_tpu_torch import convert
from pislamfusion_tpu_torch.ops import shearwarp as tsw
from pislamfusion_tpu_torch.ops.features import fastselect as tfs
from pislamfusion_tpu_torch.ops.features import flatpyr as tfp
from pislamfusion_tpu_torch.ops.features import orb as torb
from pislamfusion_tpu_torch.ops.features import packedpyr as tpp
from pislamfusion_tpu_torch.ops.features import patchgather as tpg
from torch_port_reference import (jax_fastvo_run,  # noqa: F401
                                  once_per_session, seed_canvas,
                                  torch_one_thread)

H, W, FX, K = 600, 640, 600.0, 3
N, LEVELS, BANDS = 256, 4, 3
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def strip():
    frames_t, poses = chip_smoke.render_strip(K, H, W, FX, 0.24, 1024, "cpu")
    canvas_tiles = chip_smoke.strip_geometry(H, W, FX, poses)[2]
    return (frames_t.numpy(), poses,
            seed_canvas(canvas_tiles, BANDS, np.random.default_rng(50)))


@pytest.fixture(scope="module")
def jax_run(strip, tmp_path_factory, worker_id):
    """The one JAX reference run of this module (of the test session)."""
    frames, poses, canvas = strip
    return once_per_session(
        "jax_orb_fastvo",
        lambda: jax_fastvo_run(frames, poses, FX, canvas, "orb", N, LEVELS,
                               BANDS),
        tmp_path_factory, worker_id)


@pytest.fixture(scope="module")
def jax_run_packed(strip, tmp_path_factory, worker_id):
    """The one JAX reference run of the packed front end (K7 + K4)."""
    frames, poses, canvas = strip
    return once_per_session(
        "jax_orb_fastvo_packed",
        lambda: jax_fastvo_run(frames, poses, FX, canvas, "orb", N, LEVELS,
                               BANDS, flat=False, extract=True),
        tmp_path_factory, worker_id)


def test_orb_detect_matches_reference_tpu_path(jax_run):
    _assert_features_match(jax_run["feats0"], {
        k: v.numpy() for k, v in torb.orb_detect(
            torch.from_numpy(jax_run["gray0"].copy()),
            torb.OrbParams(n_features=N, n_levels=LEVELS)).items()})


def test_orb_detect_packed_matches_reference_extract_path(jax_run_packed):
    """pyramid="packed" against the reference with K7 and K4 on; the
    selection through K4 and the reference's tail equals select_keypoints'
    on every level."""
    gray = torch.from_numpy(jax_run_packed["gray0"].copy())
    params = torb.OrbParams(n_features=N, n_levels=LEVELS)
    assert tpp.pyramid_available(H, W, LEVELS, params.scale_factor,
                                 torb._GATHER_R)
    packed, views, offs = torb.build_pyramid(gray, params, "packed")
    assert torb.fused_select_ok([v.shape for v in views], params)
    fused = torb.select_levels(packed, views, offs, params)
    unfused = [torb.select_keypoints(tfs.fast_score_map(v), max(k, 1),
                                     params.cell, params.min_threshold)
               for v, k in zip(views, params.features_per_level())]
    for a, b in zip(fused, unfused):
        for x, y in zip(a, b):
            assert torch.equal(x, y)
    _assert_features_match(jax_run_packed["feats0"], {
        k: v.numpy() for k, v in torb.orb_detect(
            gray, params, pyramid="packed").items()})


def _assert_features_match(ref, got):
    assert set(got) == set(ref)
    for k in ref:
        assert got[k].shape == ref[k].shape and got[k].dtype == ref[k].dtype

    def keyed(d):
        return {(round(float(x), 3), round(float(y), 3), int(o)): i
                for i, ((x, y), o, v) in enumerate(
                    zip(d["xy"], d["octave"], d["valid"])) if v}
    kr, kg = keyed(ref), keyed(got)
    assert len(kr) > 200
    common = set(kr) & set(kg)
    assert len(common) >= 0.98 * len(kr)
    ir = [kr[c] for c in common]
    ig = [kg[c] for c in common]
    assert np.mean(got["desc"][ig] == ref["desc"][ir]) >= 0.999
    np.testing.assert_allclose(got["response"][ig], ref["response"][ir],
                               atol=1e-3)


def test_fastvo_slice_matches_reference_tpu_path(strip, jax_run):
    _assert_slice_matches(strip, jax_run, {})


def test_fastvo_packed_slice_matches_reference_extract_path(strip,
                                                            jax_run_packed):
    _assert_slice_matches(strip, jax_run_packed, {"pyramid": "packed"})


def _assert_slice_matches(strip, jax_run, kw):
    """The port's FastVO (constructor arguments `kw`) on the CPU from the
    seeded canvas against the JAX run."""
    frames, poses, (lap0, w0) = strip
    wrappers = (tfp.build_flat_pyramid, tpp.build_packed_pyramid,
                tfs.fast_cell_winners, tpg.gather_patches, tsw.warp_patch)
    for fn in wrappers:
        fn.launches = 0
    tvo = chip_smoke.make_fastvo(H, W, FX, poses, N, LEVELS, BANDS, "cpu",
                                 **kw)
    assert convert.load_fastvo_state(
        tvo, convert.fastvo_state_from_numpy(lap0, w0, device="cpu")) is None
    p_t, n_t = tvo.process(frames, poses[0])
    img_t, cov_t = tvo.blended()
    # on the CPU every wrapper took its plain version
    assert [fn.launches for fn in wrappers] == [0] * len(wrappers)

    p_j, n_j = jax_run["poses"], jax_run["n_match"]
    img_j, cov_j = jax_run["img"], jax_run["cov"]
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
    for a, b in zip(state["canvas_w"], jax_run["canvas_w"]):
        assert np.mean(np.abs(a - b) <= 1e-2) >= 0.999


def test_fast_warp_off_feed_matches_reference():
    """FastVO(fast_warp=False, warp_mode=""), as the reference's callers
    make it: on the CPU both packages resolve "" to the gather warp, at
    full resolution. One feed into a seeded canvas, held to the JAX
    feed."""
    import jax
    import jax.numpy as jnp
    from pislamfusion_tpu.core.camera import Camera as JCamera
    from pislamfusion_tpu.models.fastvo import FastVO as JFastVO
    h, w, fx, bands = 256, 320, 320.0, 2
    frames, poses = chip_smoke.render_strip(2, h, w, fx, 0.24, 1024, "cpu")
    lp, patch_tiles, canvas_tiles, min_xy = chip_smoke.strip_geometry(
        h, w, fx, poses)
    lap0, w0 = seed_canvas(canvas_tiles, bands, np.random.default_rng(53))
    tvo = chip_smoke.make_fastvo(h, w, fx, poses, 128, LEVELS, bands, "cpu",
                                 fast_warp=False, warp_mode="")
    assert (tvo.fast_warp, tvo.warp_mode) == (False, "gather")
    convert.load_fastvo_state(
        tvo, convert.fastvo_state_from_numpy(lap0, w0, device="cpu"))
    rgb = frames[1].to(torch.float32)
    tvo._feed(torch.from_numpy(poses[1]), rgb)
    jvo = JFastVO(JCamera(w, h, fx, fx, w / 2.0, h / 2.0), min_xy,
                  canvas_tiles, lp, bands=bands, n_features=128,
                  n_levels=LEVELS, patch_tiles=patch_tiles,
                  fast_warp=False)
    assert (jvo.fast_warp, jvo.warp_mode) == (False, "gather")
    j_lap, j_w = jax.jit(jvo._feed)(
        jnp.asarray(poses[1]), jnp.asarray(rgb.numpy()),
        [jnp.asarray(a) for a in lap0], [jnp.asarray(a) for a in w0])
    for t, j in zip(tvo.canvas_w, j_w):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=0,
                                   atol=1e-5)
    for t, j in zip(tvo.canvas_lap, j_lap):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=0,
                                   atol=1e-3)
    # the frame went in: it took pixels of the canvas
    assert (tvo.canvas_w[0].numpy() != w0[0]).sum() > 1000


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


def test_convert_round_trip_keeps_a_sift_carry():
    """A SIFT carry's float32 descriptors (RootSIFT values in [0, 0.2])
    come back bit for bit, and load_fastvo_state takes it into a SIFT
    FastVO but refuses it for an ORB one (uint8 descriptors)."""
    rng = np.random.default_rng(52)
    _, poses = chip_smoke.render_strip(1, 256, 320, 320.0, 0.24, 1024,
                                       "cpu")
    vos = {d: chip_smoke.make_fastvo(256, 320, 320.0, poses, 128, LEVELS, 2,
                                     "cpu", d) for d in ("sift", "orb")}
    lap = [a.numpy() for a in vos["sift"].canvas_lap]
    w = [a.numpy() for a in vos["sift"].canvas_w]
    carry = (rng.uniform(0.0, 0.2, (5, 128)).astype(np.float32),
             rng.random(5) < 0.5, rng.normal(size=(5, 3)).astype(np.float32),
             rng.normal(size=7).astype(np.float32),
             rng.normal(size=7).astype(np.float32))
    state = convert.fastvo_state_from_numpy(lap, w, carry, device="cpu")
    back = convert.fastvo_state_to_numpy(state)
    for a, b in zip(back["carry"], carry):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    loaded = convert.load_fastvo_state(vos["sift"], state)
    assert torch.equal(loaded[0], torch.from_numpy(carry[0]))
    with pytest.raises(ValueError, match="carry"):
        convert.load_fastvo_state(vos["orb"], state)


def test_process_from_a_converted_state_matches_a_fresh_run():
    """A run seeded with frame 0's carry and the canvas, both carried to
    numpy and back through convert.py, is the run from frame 0, for either
    detector's carry (ORB's uint8 bit-planes, SIFT's float32 descriptors).
    At 256x320, the smallest frame on which SIFT's octave 0 takes K5."""
    h, w, fx = 256, 320, 320.0
    frames, poses = chip_smoke.render_strip(2, h, w, fx, 0.24, 1024, "cpu")
    for detector, desc_dtype in (("orb", np.uint8), ("sift", np.float32)):
        runs = []
        for seeded in (False, True):
            tvo = chip_smoke.make_fastvo(h, w, fx, poses, 128, LEVELS, 2,
                                         "cpu", detector)
            carry = None
            if seeded:
                state = convert.fastvo_state_to_numpy({
                    "canvas_lap": tvo.canvas_lap, "canvas_w": tvo.canvas_w,
                    "carry": tvo.initial_carry(frames[0],
                                               torch.from_numpy(poses[0]))})
                assert state["carry"][0].dtype == desc_dtype
                carry = convert.load_fastvo_state(
                    tvo, convert.fastvo_state_from_numpy(
                        state["canvas_lap"], state["canvas_w"],
                        state["carry"], device="cpu"))
                assert len(carry) == 5
            runs.append(tvo.process(frames, poses[0], carry)
                        + tvo.blended())
        assert runs[0][1][1] > 0
        for a, b in zip(*runs):
            np.testing.assert_array_equal(a, b)


# the modules of the geometric base (camera models, host copies, solvers),
# of SLAM (state, vocabulary, map file, tracker, mapper, loop closing) and
# of the fused system (fusion, exporters, tiles, viz, the app and its
# `python -m` entry), which the walk below must reach too
GEOMETRY_MODULES = (
    "utils.padding", "utils.host_se3", "core.glog", "core.messenger",
    "core.resource", "core.gps", "core.camera", "io.native_io", "io.dataset",
    "ops.lie", "ops.matching", "ops.image", "ops.ransac", "ops.init2view",
    "ops.multih", "ops.ba", "models.initializers", "models.frame",
    "models.worldmap", "models.matchers", "models.pipeline",
    "models.tracker", "models.mapper", "models.loopclose", "models.slam",
    "ops.vocabulary", "io.maphash", "resources.orb_vocab",
    "resources.sift_vocab", "core.memory_metric", "io.tiles",
    "io.exporters", "models.fusion", "viz", "app", "__main__",
    "parallel.mesh", "parallel.batch", "parallel.dist_ba",
    "parallel.dist_ransac", "parallel.dist_mosaic", "parallel.dist_vo")


def test_port_imports_neither_jax_nor_the_reference():
    """In a fresh interpreter (this one has JAX loaded by conftest): every
    module of the port, chip_smoke.py, the end-to-end scenes and phase
    script (scripts/torch_e2e_scenes.py, scripts/torch_e2e_phase.py), the
    pipeline demo the real-sequence case reads its PSNR from, the ablation
    harness and the two vocabulary trainers."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import pislamfusion_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "sys.path[:0] = ['scripts', 'examples']\n"
        "import chip_smoke, torch_e2e_scenes, torch_e2e_phase\n"
        "import torch_pipeline_demo, torch_batch_evaluate\n"
        "import torch_train_default_vocab, torch_train_sift_vocab\n"
        f"missing = [m for m in {GEOMETRY_MODULES!r}\n"
        "           if 'pislamfusion_tpu_torch.' + m not in sys.modules]\n"
        "assert not missing, missing\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'pislamfusion_tpu' or m.startswith('pislamfusion_tpu.')]\n"
        "assert len([m for m in sys.modules"
        " if m.startswith('pislamfusion_tpu_torch.')]) >= 20\n"
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
