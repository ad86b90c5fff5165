"""The online mode of the PyTorch port's SLAM on the CPU:
`pipeline.fused_track_chain` / `fused_track_chain_images`,
`Tracker.track_chain`, the tracking thread and the mapper's worker
(`SLAM.isOnline=1`, `SLAM.TrackChain`).

Held to the JAX package on the same inputs, with these tolerances:

- `fused_track_chain` on tests/test_track_chain.py's synthetic scene
  (`torch_port_reference.chain_scene`): every row within rtol/atol 1e-4
  of the JAX package's `fused_track_chain` (jitted once a session on the
  main thread, `once_per_session`), as that test holds the chain against
  its sequential steps.

Held to the port itself:

- the chain's rows equal the port's own `fused_track_packed_feats` fed
  the carry rebuilt on the host (tests/test_track_chain.py's
  `_emulate_next_carry`), within rtol/atol 1e-4;
- `fused_track_chain_images` equals `fused_extract` of each frame
  followed by `fused_track_chain` (exactly: the same operations), on
  three survey frames from a SLAM's state.

Online runs are not reproducible (which keyframes skip their local BA
depends on timing), so they are held to bars: tests/test_slam.py's online
cases (:117-186: more than 35 % of frames tracked, more than 200 map
points) per frame and with `SLAM.TrackChain=3`, and test_soak.py's
liveness case (:91-122: 40 frames with loop closing and GPS, more than
20 % tracked). Every run also holds `frames_total` to the frames fed,
`track_errors` and the mapper's `worker_errors` to 0, the mapper's pool
drained, and the tracking thread ended; a chained run must have
dispatched a chain of 2 frames or more (`Tracker.chain_lengths`). The
frames are fed from a thread of the test joined within 60 s, and
`SLAM.finish` waits at most 60 s for the tracking thread and the mapper.
No JAX code runs on a thread here.

The online mode under a fixed starvation
(`test_online_starved_mapper_matches_reference`): the mapper's pool is
replaced (`torch_port_reference.lagged_mapper`) so that each keyframe's
job runs on the tracking thread `lag` frames after the keyframe, and a
keyframe skips its local BA exactly when a newer one came within those
frames. That run is deterministic: three port runs in one process give
the same tracked count, keyframes and geo ATE. The JAX package runs the
same schedule on the same frames in a subprocess
(`torch_port_reference.py online-starved`: its threads may crash in
concurrent XLA compiles, and a crash must not take a test worker with
it). With the JAX package's relocalization fit (every match) the port
is held to its tracked count within 1 frame and its keyframe geo ATE
within 0.5 m; with its own (the PnP inliers) to at least its tracked
count less 1 and at most its geo ATE plus 0.5 m. Both packages lose the
track once the mapper is 3 frames or more behind (ROADMAP queue 3, known
faults in the reference).
"""
import contextlib
import importlib
import json
import os
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

import chip_smoke
from pislamfusion_tpu_torch.core.camera import Camera
from pislamfusion_tpu_torch.core.messenger import DataTrans
from pislamfusion_tpu_torch.models import pipeline as tp
from pislamfusion_tpu_torch.models.slam import create_slam
from pislamfusion_tpu_torch.utils import host_se3 as hse3
from torch_port_reference import (SLAM_CAM, STARVED_CFG, STARVED_ORIGIN,
                                  StartedOncePerSession, chain_scene,
                                  jax_chain_capture, lagged_mapper,
                                  once_per_session, reference_pose_fit,
                                  slam_survey_frames, starved_run,
                                  starved_scene,
                                  torch_one_thread)  # noqa: F401

JOIN_S = 60.0
CHAIN_KEYS = ("desc_k", "valid_k", "xy_k", "prev_desc", "prev_valid", "aux",
              "local_pos", "local_desc", "local_valid")


def T(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def chain_ref(tmp_path_factory, worker_id):
    return once_per_session("torch_chain_capture", jax_chain_capture,
                            tmp_path_factory, worker_id)


# ---------------------------------------------------------------------------
# the chain functions
# ---------------------------------------------------------------------------

def test_chain_matches_reference(chain_ref):
    inputs, kw, poses, jrows = chain_ref
    rows = tp.fused_track_chain(*[T(inputs[k]) for k in CHAIN_KEYS],
                                **kw).numpy()
    assert rows.shape == jrows.shape == (4, 16 + 6 * 64 + 2 * 96)
    np.testing.assert_allclose(rows, jrows, rtol=1e-4, atol=1e-4)
    for k in range(4):
        assert rows[k][15] >= 20, f"frame {k}: only {rows[k][15]} inliers"
        c2w = hse3.se3_inv(rows[k][8:15])
        assert np.linalg.norm(c2w[:3] - poses[k + 1][:3]) < 0.05


def test_chain_matches_its_own_sequential_steps():
    import test_track_chain as ttc
    inputs, kw, _ = chain_scene()
    rows = tp.fused_track_chain(*[T(inputs[k]) for k in CHAIN_KEYS],
                                **kw).numpy()
    n, P = inputs["prev_desc"].shape[0], inputs["local_pos"].shape[0]
    aux = inputs["aux"]
    p3d, has = aux[:3 * n].reshape(n, 3), aux[3 * n:4 * n] > 0.5
    pose, mot = aux[4 * n:4 * n + 7], aux[4 * n + 7:]
    pdesc, pvalid = T(inputs["prev_desc"]), T(inputs["prev_valid"])
    local = [T(inputs[k]) for k in ("local_pos", "local_desc",
                                    "local_valid")]
    for k in range(rows.shape[0]):
        T_pred = hse3.se3_inv(hse3.se3_mul(pose, mot)).astype(np.float32)
        a = np.concatenate([p3d.reshape(-1), has.astype(np.float32),
                            T_pred]).astype(np.float32)
        feats = {"desc": T(inputs["desc_k"][k]),
                 "valid": T(inputs["valid_k"][k]),
                 "xy": T(inputs["xy_k"][k])}
        row = tp.fused_track_packed_feats(feats, pdesc, pvalid, T(a),
                                          *local, **kw).numpy()
        np.testing.assert_allclose(rows[k], row, rtol=1e-4, atol=1e-4,
                                   err_msg=f"chain row {k} != sequential")
        p3d, has, pose_new = ttc._emulate_next_carry(
            row, p3d, inputs["local_pos"], n, P)
        mot = hse3.se3_mul(hse3.se3_inv(pose), pose_new).astype(np.float32)
        pose, pdesc, pvalid = pose_new, feats["desc"], feats["valid"]


def test_chain_images_equals_extract_then_chain():
    """Three frames of the survey after a short offline run (frames 0-3):
    the image chain's rows and features equal extraction followed by the
    feature chain, and the rows track (more than 30 inliers each)."""
    frames, _ = slam_survey_frames(7)
    first = 4
    slam = create_slam(chip_smoke.slam_survey_cfg(), Camera(*SLAM_CAM),
                       device="cpu")
    for i in range(first):
        slam.track(frames[i], float(i))
    ins, kw = chip_smoke.slam_chain_inputs(slam)
    imgs = T(chip_smoke.bench_gray(frames[first:]))
    params = slam.detector.params
    rows, feats_k = tp.fused_track_chain_images(imgs, *ins, params=params,
                                                **kw)
    feats = [tp.fused_extract(im, params) for im in imgs]
    stacked = [torch.stack([f[k] for f in feats]) for k in ("desc", "valid",
                                                            "xy")]
    ref = tp.fused_track_chain(*stacked, *ins, **kw)
    assert torch.equal(rows, ref)
    for k in feats[0]:
        assert torch.equal(feats_k[k], torch.stack([f[k] for f in feats]))
    assert rows.shape[0] == len(frames) - first
    assert (rows[:, 15] > 30).all(), rows[:, 15]


# ---------------------------------------------------------------------------
# the online mode, held to bars
# ---------------------------------------------------------------------------

def _feed_online(slam, images, gps=None):
    """Feed the frames from a thread of the test, joined within JOIN_S;
    then SLAM.finish within JOIN_S. Fails if any thread is still alive."""
    errors = []

    def feed():
        try:
            for i, img in enumerate(images):
                kw = {} if gps is None else gps(i)
                slam.track(img, float(i), **kw)
        except BaseException as e:                        # noqa: BLE001
            errors.append(e)

    feeder = threading.Thread(target=feed, daemon=True)
    feeder.start()
    feeder.join(JOIN_S)
    assert not feeder.is_alive(), "the feeder did not end within 60 s"
    assert not errors, errors
    assert slam.finish(timeout=JOIN_S), "finish did not drain within 60 s"
    assert not slam._worker.is_alive()
    assert slam.mapper._pool.pending() == 0, "mapper queue not drained"
    assert slam.track_errors == 0, f"{slam.track_errors} thread errors"
    assert slam.mapper.worker_errors == 0
    assert slam.frames_total == len(images)   # blocking queue: no drops


def _online_cfg(**extra):
    """tests/test_slam.py:117-186's online config: ORB-500, no loop
    closing, the small BA caps."""
    base = {"SLAM.nFeature": 500, "SLAM.isOnline": 1,
            "Plane.MinPoints": 2000}
    base.update(extra)
    return chip_smoke.slam_survey_cfg(**base)


@pytest.fixture(scope="module")
def strip_frames():
    """tests/test_slam.py:117-186's strip: 16 frames 3 m apart at y 30."""
    ground = torch.from_numpy(chip_smoke.survey_ground(
        np.random.default_rng(11)))
    cam = Camera(*SLAM_CAM)
    poses = chip_smoke.survey_poses(y1=31.0, x1=73.0)
    return [chip_smoke.survey_view(ground, cam, p).numpy() for p in poses]


@pytest.mark.parametrize("chain", [1, 3])
def test_online_mode(strip_frames, chain):
    """tests/test_slam.py:117-186 on the port, per frame and with
    SLAM.TrackChain=3."""
    slam = create_slam(_online_cfg(**{"SLAM.TrackChain": chain}),
                       Camera(*SLAM_CAM), device="cpu")
    slam.trans_queue = DataTrans(30)
    _feed_online(slam, strip_frames)
    assert slam._online and slam._chain == chain
    assert slam.frames_tracked > 0.35 * slam.frames_total
    assert slam.map.point_num() > 200
    lengths = slam.tracker.chain_lengths
    if chain > 1:
        assert lengths and max(lengths) >= 2, \
            "no chain dispatched (chain path silently skipped)"
    else:
        assert not lengths


def test_online_liveness():
    """tests/test_soak.py:91-122 on the port: 40 frames online with loop
    closing and noisy GPS; the run completes, the tracking thread survives
    every frame, and tracking makes progress."""
    from pislamfusion_tpu_torch.core.gps import LocalFrame
    rng = np.random.default_rng(5)
    ground = torch.from_numpy(chip_smoke.survey_ground(rng))
    cam = Camera(*SLAM_CAM)
    poses = [np.array([26.0 + 1.8 * i, 36.0, 25.0, 1.0, 0.0, 0.0, 0.0])
             for i in range(40)]
    images = [chip_smoke.survey_view(ground, cam, p).numpy() for p in poses]
    local = LocalFrame(116.0, 40.0, 0.0)
    fixes = [local.local_to_lla(p[:3] + rng.normal(0, 0.4, 3))
             for p in poses]
    cfg = chip_smoke.slam_survey_cfg(**{
        "SLAM.nFeature": 500, "SLAM.MaxOverlap": 0.9, "SLAM.LoopClose": 1,
        "SLAM.isOnline": 1, "SLAM.LocalBAIters": 6, "GPS.MinFrames2Fit": 5,
        "Plane.MinPoints": 2000})
    slam = create_slam(cfg, cam, device="cpu")
    slam.trans_queue = DataTrans(30)
    _feed_online(slam, images, lambda i: {"gps_lla": fixes[i],
                                          "gps_acc": 0.5})
    assert slam.frames_tracked > 0.2 * len(poses)


@pytest.mark.parametrize("mode", ["per-frame", "chained"])
def test_track_scale_two_full_case(mode):
    """tests/test_slam.py:188-235's full case (640x480, ORB-500, 12 frames
    3 m apart, TrackScale 2) per frame (offline) and chained (online,
    TrackChain 8, bench.py's chain at half size): more than 70 % tracked,
    the steps between tracked frames 3-11 within 35 % of their median,
    and the mosaic queue fed the full-size frame."""
    ground = torch.from_numpy(chip_smoke.survey_ground(
        np.random.default_rng(12)))
    cam = Camera(640, 480, 520.0, 520.0, 320.0, 240.0)
    poses = chip_smoke.survey_poses(y1=31.0)
    images = [chip_smoke.survey_view(ground, cam, p).numpy() for p in poses]
    extra = {"SLAM.nFeature": 500, "SLAM.TrackScale": 2,
             "Plane.MinPoints": 2000}
    if mode == "chained":
        extra.update({"SLAM.isOnline": 1, "SLAM.TrackChain": 8})
    slam = create_slam(chip_smoke.slam_survey_cfg(**extra), cam,
                       device="cpu")
    slam.trans_queue = DataTrans(30)
    frames = []
    if mode == "chained":
        slam.track = _recording(slam.track, frames)
        _feed_online(slam, images)
        assert max(slam.tracker.chain_lengths) >= 2
    else:
        frames = [slam.track(img, float(i)) for i, img in enumerate(images)]
        slam.finish()
    assert slam._track_scale == 2 and slam._scaled_cam.width == 320
    assert slam.frames_tracked > 0.7 * len(poses)
    est = [f.pose_c2w[:3].copy() if f.n_tracked() > 0 else None
           for f in frames]
    steps = [np.linalg.norm(b - a) for a, b in zip(est[2:-1], est[3:])
             if a is not None and b is not None]
    assert len(steps) > 6
    ratio = np.asarray(steps) / np.median(steps)
    assert np.all(np.abs(ratio - 1.0) < 0.35), ratio
    img0 = slam.trans_queue.try_consume()[0]
    assert img0.shape[:2] == (480, 640), img0.shape


def _recording(track, frames):
    def rec(*a, **k):
        fr = track(*a, **k)
        frames.append(fr)
        return fr
    return rec


# the mapper's lag in frames: 2 keeps the track in both packages, 4 loses it
# in both (tests/torch_port_reference.py LaggedPool)
STARVED_LAGS = (2, 4)


def _jax_starved_start():
    """The JAX package's runs at STARVED_LAGS (tests/torch_port_reference.py
    online-starved LAG ...), one subprocess, started so that it runs
    beside the port's runs."""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [repo, os.path.join(repo, "tests")]))
    return subprocess.Popen(
        [sys.executable, os.path.join(repo, "tests",
                                      "torch_port_reference.py"),
         "online-starved", *map(str, STARVED_LAGS)], cwd=repo, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def _jax_starved_read(proc):
    try:
        out, err = proc.communicate(timeout=900)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, err[-4000:]
    return {int(k): v for k, v in json.loads(
        out.strip().splitlines()[-1]).items()}


@pytest.fixture(scope="module")
def jax_starved(tmp_path_factory, worker_id):
    ref = StartedOncePerSession("torch_jax_starved", _jax_starved_start,
                                _jax_starved_read, tmp_path_factory,
                                worker_id)
    yield ref
    ref.close()


@pytest.mark.parametrize("lag", STARVED_LAGS)
def test_online_starved_mapper_matches_reference(jax_starved, lag):
    """tests/test_soak.py:91-121's online run (40 frames, loop closing,
    GPS) with the mapper held `lag` frames behind the tracker, under the
    JAX package's schedule (its runs in one subprocess, beside the
    port's). The track is lost and relocalized here, where the port fits
    the PnP inliers and the JAX package every match (ROADMAP queue 3), so
    the port runs three times with each fit:
    - with the JAX package's fit (`reference_pose_fit`): three runs equal,
      its tracked count within 1 frame and its keyframe geo ATE within
      0.5 m;
    - with its own: three runs equal, tracked at least the JAX package's
      count less 1 and keyframe geo ATE at most the JAX package's plus
      0.5 m."""
    from pislamfusion_tpu_torch.core.gps import LocalFrame
    from pislamfusion_tpu_torch.models import slam as ts
    from pislamfusion_tpu_torch.models import tracker as ttracker
    messenger = importlib.import_module(
        "pislamfusion_tpu_torch.core.messenger")
    scene = starved_scene()
    runs = {"reference fit": [], "port fit": []}
    for fit, rs in runs.items():
        for _ in range(3):
            cfg = chip_smoke.slam_survey_cfg(**dict(STARVED_CFG))
            with lagged_mapper(messenger, ts.SLAM, lag), (
                    reference_pose_fit(ttracker.Tracker)
                    if fit == "reference fit" else contextlib.nullcontext()):
                slam = create_slam(cfg, Camera(*SLAM_CAM), device="cpu")
                r = starved_run(slam, scene, LocalFrame(*STARVED_ORIGIN),
                                lambda: slam.finish(timeout=JOIN_S))
            assert r["finished"] and not slam._worker.is_alive()
            assert r["errors"] == 0 and slam.mapper.worker_errors == 0
            assert r["total"] == len(scene[0])
            rs.append(r)
        assert rs[1] == rs[0] and rs[2] == rs[0], (fit, rs)
    ref = jax_starved.get()[lag]
    assert ref["finished"] and ref["errors"] == 0, ref
    same, own = runs["reference fit"][0], runs["port fit"][0]
    assert abs(same["tracked"] - ref["tracked"]) <= 1, (same, ref)
    assert abs(same["geo_ate"] - ref["geo_ate"]) <= 0.5, (same, ref)
    assert own["tracked"] >= ref["tracked"] - 1, (own, ref)
    assert own["geo_ate"] <= ref["geo_ate"] + 0.5, (own, ref)
