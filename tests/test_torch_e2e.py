"""The JAX package's end-to-end SLAM suites on the PyTorch port, on the CPU
(`scripts/torch_e2e_scenes.py`).

The scene builders, which chip_smoke.py's phase 2h runs on the card without
JAX, against their originals in tests/synth_survey.py, test_loopclose.py,
test_real_texture.py and test_real_sequence.py, from the same numpy seeds:
textures, layers, poses, gains and degraded frames equal, renders through
the port's warp within 1e-4 gray of the JAX package's.

The cases that fit tier-1's time, each at its reference test's own scene,
frames, configuration and bars (`torch_e2e_scenes.Case` lists every bar
beside its value):

- tests/test_bow_reloc.py:22, kidnap recovery by the embedded ORB
  vocabulary;
- tests/test_bow_reloc.py:81, the SIFT vocabulary's wiring and words;
- tests/test_real_texture.py:50, the strip over the aerial photograph;
- tests/test_loopclose.py:78, the testLoopDetector harness on the closed
  circuit (tests/test_torch_slam.py's harness case runs an 8-frame strip,
  which has no loop to find);
- tests/test_gps_fusion.py:123, the two-frame GPS prior.

SLAM over a survey is chaotic in its floats (ROADMAP queue 3), so each case
is held to its reference test's bars against the truth, not to the JAX
package's run. The cases that do not fit (loop closing, GPS fusion, the
real-texture circuit, parallax, the soak, the race hunt, the real sequence)
run on the card: chip_smoke.py phase 2h and scripts/torch_e2e_phase.py.
"""
import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "scripts"))

import synth_survey as S  # noqa: E402
import torch_e2e_scenes as E  # noqa: E402
from pislamfusion_tpu_torch.core.camera import Camera  # noqa: E402
from torch_port_reference import torch_one_thread  # noqa: E402,F401

GRAY_TOL = 1e-4


def _poses_equal(a, b):
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def _jcam(params):
    from pislamfusion_tpu.core.camera import Camera as JCamera
    return JCamera(*params)


def test_make_world_matches_reference():
    """tests/test_parallax.py's hard world from rng 7: the texture and every
    layer equal, and the rng left in the same state."""
    kw = dict(n=1024, rects=500, n_slabs=12, heights=(3.0, 6.0),
              stamp_grid=160)
    ra, rb = np.random.default_rng(7), np.random.default_rng(7)
    ref, ours = S.make_world(ra, **kw), E.make_world(rb, **kw)
    np.testing.assert_array_equal(ours["ground"], ref["ground"])
    assert len(ours["layers"]) == len(ref["layers"])
    for (h1, a), (h2, b) in zip(ours["layers"], ref["layers"]):
        assert h1 == h2
        np.testing.assert_array_equal(a, b)
    assert ra.integers(1 << 30) == rb.integers(1 << 30)


def test_render_view_3d_matches_reference():
    """Views of the hard world (frames 0, 7 and 20 of its lawnmower, with
    the exposure fields) within 1e-4 gray of synth_survey.render_view_3d;
    the exposure field equal."""
    world, cam, poses = E.parallax_world()
    jcam = _jcam((200, 150, 140.0, 140.0, 100.0, 75.0))
    w = E.world_on(world, "cpu")
    for k in (0, 7, 20):
        ref = S.render_view_3d(world, jcam, poses[k], k=k, illum=0.12)
        ours = E.render_view_3d(w, cam, poses[k], k=k, illum=0.12)
        assert ours.shape == ref.shape == (150, 200, 3)
        np.testing.assert_allclose(ours, ref, rtol=0, atol=GRAY_TOL)
        np.testing.assert_array_equal(E.exposure_field(cam, k, 0.12),
                                      S.exposure_field(jcam, k, 0.12))


def test_degrade_frame_matches_reference():
    """tests/test_parallax.py:219's degradation (3 px blur, sigma 6) of a
    frame, from the same rng: equal, and the rng in the same state."""
    img = np.random.default_rng(3).uniform(0, 255, (192, 256, 3)).astype(
        np.float32)
    ra, rb = np.random.default_rng(17), np.random.default_rng(17)
    np.testing.assert_array_equal(
        E.degrade_frame(img, rb, blur_px=3.0, noise=6.0),
        S.degrade_frame(img, ra, blur_px=3.0, noise=6.0))
    assert ra.integers(1 << 30) == rb.integers(1 << 30)


def test_render_view_matches_reference():
    """The survey's view through the port's warp (render_view) within 1e-4
    gray of synth_survey.render_view, from tests/test_loopclose.py's
    ground (rng 13) along its circuit's corners."""
    import test_loopclose as tl
    ground = S.make_ground(np.random.default_rng(13))
    np.testing.assert_array_equal(
        E.survey_ground(np.random.default_rng(13)), ground)
    jcam = _jcam(E.SLAM_CAM)
    g = torch.from_numpy(ground)
    for p in tl._circuit()[[0, 11, 30]]:
        np.testing.assert_allclose(
            E.render_view(g, Camera(*E.SLAM_CAM), p),
            S.render_view(ground, jcam, p), rtol=0, atol=GRAY_TOL)


@pytest.mark.parametrize("name", ["loopclose circuit",
                                  "real-texture circuit",
                                  "real-sequence trajectory"])
def test_poses_match_reference(name):
    import test_loopclose as tl
    import test_real_sequence as trs
    import test_real_texture as trt
    if name == "loopclose circuit":
        _poses_equal(E.circuit(), tl._circuit())
    elif name == "real-texture circuit":
        _poses_equal(E.real_circuit_poses(), trt._circuit_poses())
    else:
        poses, strips = E.sequence_trajectory()
        ref_poses, ref_strips = trs._trajectory()
        _poses_equal(poses, ref_poses)
        np.testing.assert_array_equal(strips, ref_strips)
        for k in range(len(poses)):
            assert E.sequence_exposure(k, int(strips[k])) == \
                trs._exposure(k, int(ref_strips[k]))


@pytest.mark.parametrize("kw", [{}, {"n": 2048, "unique_speckle": True}],
                         ids=["strip", "circuit"])
def test_real_ground_matches_reference(kw):
    """The aerial photograph's ground as tests/test_real_texture.py builds
    it for its strip and its circuit, and as test_real_sequence.py builds
    it: equal."""
    import test_real_sequence as trs
    import test_real_texture as trt
    np.testing.assert_array_equal(E.real_ground(**kw), trt._real_ground(**kw))
    if not kw:
        np.testing.assert_array_equal(E.sequence_ground(), trs._ground())


@pytest.mark.parametrize("case", ["bow_kidnap", "sift_bow",
                                  "real_texture_strip",
                                  "loop_detector_harness",
                                  "gps_priory_two_frames"])
def test_e2e_case_on_the_cpu(case):
    c = getattr(E, case)("cpu")
    assert c.bars and c.ok, c.line()
