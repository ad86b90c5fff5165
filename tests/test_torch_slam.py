"""SLAM of the PyTorch port on the CPU: `models/pipeline.py`,
`models/tracker.py`, `models/mapper.py`, `models/loopclose.py` and
`models/slam.py`.

The stage tests start from ONE short run of the JAX package's SLAM over
frames 0-3 of tests/test_slam.py's survey
(`torch_port_reference.jax_slam_capture`, once a session) and feed the
port the same inputs:

- the fused tracking step of frame 3 (`fused_track_packed_feats`, and
  `fused_localmap_step` from the first LM's bindings): the same poses
  within 1e-4 of the translation scale (the norm of the pose's
  translation), inlier counts within 2, the matches of the last frame
  equal on at least 99 % of its keypoints;
- every local BA window the run solved (`Mapper.solve_local_window`, the
  same LM steps and tol): poses within 1e-4 and points within 1e-3 of the
  scene depth;
- frame 3's triangulation sweep (`_new_points_dispatch` / `_commit`) from
  the map it started from: the same count of new points within 2 %, and
  the points both make within 1e-3 of the scene depth;
- `LoopCloserSE3Graph._close` of frame 3 onto keyframe 0 with a given
  correction: keyframe poses within 1e-4, points within 1e-3 of the scene
  depth;
- `Mapper.fit_gps_all` with each keyframe's true centre as its GPS fix:
  the scale within 1e-4 relative and the aligned centres within 1e-3 m.
  Only these are held: on a straight strip the rotation about the track is
  not determined (ROADMAP queue 3, `sim3_horn`'s rank guard), so the
  orientations are not compared;
- `load_worldmap_state` continues the run from before frame 3: frame 3
  tracks and becomes a keyframe, its pose within 1e-3 of the JAX run's.

`SLAM.track` end to end over the whole survey on the CPU is held to
ground truth with tests/test_slam.py's own bars (more than 85 % of frames
tracked, ATE after Sim3 alignment under 2 % of the span, the plane
published), and the reference's stage-version tests (test_slam.py:693-759)
run on it. Short runs cover FeatureDetector=Sift, an ORB.nLevels /
ORB.ScaleFactor pair outside K1's plan (the resize chain) and
SLAM.TrackScale=2.
"""
import numpy as np
import pytest
import torch

import chip_smoke
from pislamfusion_tpu_torch import convert
from pislamfusion_tpu_torch.core.camera import Camera
from pislamfusion_tpu_torch.models import mapper as tmapper
from pislamfusion_tpu_torch.models import pipeline as tp
from pislamfusion_tpu_torch.models.slam import create_slam
from torch_port_reference import (SLAM_CAM, SLAM_STAGE_FRAME,
                                  jax_slam_capture, once_per_session,
                                  slam_survey_frames,
                                  torch_one_thread)  # noqa: F401


@pytest.fixture(scope="module")
def capture(tmp_path_factory, worker_id):
    return once_per_session("torch_slam_capture", jax_slam_capture,
                            tmp_path_factory, worker_id)


def T(a):
    return torch.from_numpy(np.array(a))


def _scene_depth(state):
    """Median depth of the map's points below the keyframes' centres."""
    pts = np.stack([p["position"] for p in state["points"]])
    z = np.mean([f["pose_c2w"][2] for f in state["frames"]])
    return float(np.median(np.abs(z - pts[:, 2]))) if len(pts) else 1.0


# ---------------------------------------------------------------------------
# stages, from the JAX run's state
# ---------------------------------------------------------------------------

def test_fused_track_step_matches_reference(capture):
    c = capture["track"]
    feats = {k: T(v) for k, v in c["feats"].items()}
    packed = tp.fused_track_packed_feats(
        feats, T(c["last_desc"]), T(c["last_valid"]), T(c["aux"]),
        T(c["lpos"]), T(c["ldesc"]), T(c["lvalid"]), radius=20.0,
        radius_local=8.0, chi2_th=5.991, **c["geo"]).numpy()
    ref = c["packed"]
    scale = float(np.linalg.norm(ref[8:11]))
    for s in (slice(0, 7), slice(8, 15)):      # T1, T2 (w2c)
        assert np.abs(packed[s] - ref[s]).max() <= 1e-4 * max(scale, 1.0)
    assert abs(packed[7] - ref[7]) <= 2 and abs(packed[15] - ref[15]) <= 2
    n = len(c["last_valid"])
    ok_t, ok_j = packed[16 + n:16 + 2 * n], ref[16 + n:16 + 2 * n]
    assert np.mean(ok_t != ok_j) <= 0.01 and ok_j.sum() > 100


def test_fused_localmap_step_matches_reference(capture):
    c = capture["track"]
    f = {k: T(v) for k, v in c["feats"].items()}
    res = tp.fused_localmap_step(
        f["desc"], f["valid"], f["xy"], T(c["packed"][:7]), T(c["p3d_cur"]),
        T(c["w_cur"]), T(c["lpos"]), T(c["ldesc"]), T(c["lvalid"]),
        radius=8.0, chi2_th=5.991, **c["geo"])
    T_j, n_j, idx_j, ok_j = c["lm"][:4]
    scale = float(np.linalg.norm(T_j[:3]))
    assert np.abs(res.T_w2c.numpy() - T_j).max() <= 1e-4 * max(scale, 1.0)
    assert abs(int(res.n_inliers) - int(n_j)) <= 2
    assert np.mean(res.ok.numpy() != ok_j) <= 0.01
    np.testing.assert_array_equal(res.idx.numpy()[ok_j & res.ok.numpy()],
                                  idx_j[ok_j & res.ok.numpy()])


@pytest.mark.parametrize("which", [0, 1])
def test_local_window_matches_reference(capture, which):
    args, kw, (poses_j, pts_j) = capture["windows"][which]
    poses, pts = tmapper.Mapper.solve_local_window(*args, **kw,
                                                   device="cpu")
    depth = _scene_depth(capture["before"])
    np.testing.assert_allclose(poses, poses_j, atol=1e-4)
    np.testing.assert_allclose(pts, pts_j, atol=1e-3 * depth)
    # the window moved: the LM steps did work
    assert np.abs(pts_j - args[2]).max() > 1e-5


def test_new_points_match_reference(capture):
    npc = capture["new_points"]
    wmap = convert.worldmap_from_numpy(npc["map"], device="cpu")
    mapper = tmapper.Mapper(wmap, chip_smoke.slam_survey_cfg(),
                            device="cpu")
    mapper._kf_count = npc["kf_count"]
    frame = wmap.frame(npc["frame"])
    ctx = mapper._new_points_dispatch(frame, frame.feats_dev)
    created = mapper._new_points_commit(frame, ctx[1], ctx[0].numpy())
    assert abs(created - npc["created"]) <= 0.02 * npc["created"]
    assert npc["created"] > 50
    depth = _scene_depth(npc["map"])
    both = [k for k in npc["kp"] if frame.kp2mp[k] >= 0]
    assert len(both) >= 0.98 * len(npc["kp"])
    got = np.stack([wmap.point(int(frame.kp2mp[k])).position for k in both])
    ref = np.stack([npc["kp"][k] for k in both])
    assert np.abs(got - ref).max() <= 1e-3 * depth


def test_loop_close_matches_reference(capture):
    from pislamfusion_tpu_torch.models.loopclose import LoopCloserSE3Graph
    wmap = convert.worldmap_from_numpy(capture["after"], device="cpu")
    cfg = chip_smoke.slam_survey_cfg(**{"SLAM.LoopGraphDenseMax": 0})
    kfs = wmap.keyframes()
    close = capture["close"]
    closer = LoopCloserSE3Graph(wmap, cfg, device="cpu")
    hooked = []
    closer.on_map_deformed = lambda: hooked.append(wmap.version)
    v0 = wmap.version
    closer._close(kfs[-1], kfs[0].id, close["T_corr"])
    assert hooked == [v0 + 1]
    depth = _scene_depth(capture["after"])
    for f in wmap.keyframes():
        np.testing.assert_allclose(f.pose_c2w, close["poses"][f.id],
                                   atol=1e-4)
    for p in wmap.points():
        np.testing.assert_allclose(p.position, close["points"][p.id],
                                   atol=1e-3 * depth)
    # the correction moved the last keyframe
    before = {f["id"]: f["pose_c2w"] for f in capture["after"]["frames"]}
    assert np.abs(close["poses"][kfs[-1].id][:3]
                  - before[kfs[-1].id][:3]).max() > 1e-3


def test_gps_fit_matches_reference(capture):
    wmap = convert.worldmap_from_numpy(capture["after"], device="cpu")
    for f in wmap.keyframes():
        f.gps_enu = capture["poses"][f.id][:3].astype(np.float32)
    kf_ids = [f.id for f in wmap.keyframes()]
    before = {f.id: f.pose_c2w.copy() for f in wmap.keyframes()}
    mapper = tmapper.Mapper(wmap, chip_smoke.slam_survey_cfg(),
                            device="cpu")
    transforms = []
    mapper.on_map_transformed = transforms.append
    assert mapper.fit_gps_all(min_frames=3) and capture["gps"]["ok"]
    assert mapper.gps_fitted
    assert abs(mapper.last_gps_fit_rms - capture["gps"]["rms"]) <= 1e-3
    ref = capture["gps"]["poses"]

    def scale(poses):
        c = np.stack([poses[i][:3] for i in kf_ids])
        b = np.stack([before[i][:3] for i in kf_ids])
        return np.linalg.norm(c[-1] - c[0]) / np.linalg.norm(b[-1] - b[0])
    got = {f.id: f.pose_c2w for f in wmap.keyframes()}
    assert abs(scale(got) / scale(ref) - 1.0) <= 1e-4
    assert abs(float(transforms[0][7]) / scale(ref) - 1.0) <= 1e-4
    for i in kf_ids:                      # the aligned centres
        np.testing.assert_allclose(got[i][:3], ref[i][:3], atol=1e-3)
        assert np.linalg.norm(got[i][:3] - capture["poses"][i][:3]) < 0.2


def test_slam_continues_from_the_captured_state(capture):
    """load_worldmap_state makes a port SLAM continue the JAX run: frame 3
    tracks through the fused step and becomes a keyframe."""
    slam = create_slam(chip_smoke.slam_survey_cfg(), Camera(*SLAM_CAM),
                       device="cpu")
    convert.load_worldmap_state(slam, capture["before"])
    assert slam.tracker.status.name == "TRACKING"
    assert slam.map.keyframes()[-1].id == SLAM_STAGE_FRAME - 1
    fr = slam.track(capture["frames"][SLAM_STAGE_FRAME],
                    float(SLAM_STAGE_FRAME))
    assert slam.frames_tracked == 1 and fr.is_keyframe
    ref = [f for f in capture["after"]["frames"]
           if f["id"] == SLAM_STAGE_FRAME][0]
    np.testing.assert_allclose(fr.pose_c2w, ref["pose_c2w"], atol=1e-3)
    assert abs(slam.map.point_num() - len(capture["after"]["points"])) \
        <= 0.05 * len(capture["after"]["points"])


# ---------------------------------------------------------------------------
# SLAM.track end to end, held to ground truth
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def slam_run():
    frames, gt = slam_survey_frames()
    slam = create_slam(chip_smoke.slam_survey_cfg(), Camera(*SLAM_CAM),
                       device="cpu")
    for i, img in enumerate(frames):
        slam.track(img, float(i))
    return slam, gt


def test_slam_tracks_the_survey(slam_run):
    """tests/test_slam.py's bars: more than 85 % of frames tracked, ATE
    after Sim3 alignment under 2 % of the span, the map populated, the
    plane published with most points on it."""
    slam, gt = slam_run
    assert slam.frames_total == len(gt)
    assert slam.frames_tracked / slam.frames_total > 0.85
    ate, span, _ = chip_smoke.slam_ate(slam, gt)
    assert ate < 0.02 * span, f"ATE {ate:.3f} m vs span {span:.1f} m"
    assert slam.map.point_num() > 300 and len(slam.map.keyframes()) >= 2
    assert slam.tracker.use_fused and slam.device.type == "cpu"
    plane = slam.plane
    assert plane is not None, "plane was never published"
    from pislamfusion_tpu_torch.utils import host_se3 as hse3
    pts = np.stack([p.position for p in slam.map.points()])
    local = hse3.se3_apply(hse3.se3_inv(plane), pts)
    extent = np.linalg.norm(pts.max(0) - pts.min(0))
    assert np.percentile(np.abs(local[:, 2]), 80) < 0.05 * extent


def test_slam_checkpoint_and_exports(slam_run, tmp_path):
    from pislamfusion_tpu_torch.models.worldmap import WorldMap
    slam, _ = slam_run
    path = str(tmp_path / "map.bin")
    assert slam.map.save(path)
    m2 = WorldMap()
    assert m2.load(path)
    assert m2.frame_num() == slam.map.frame_num()
    assert m2.point_num() == slam.map.point_num()
    assert slam.map.export_trajectory(str(tmp_path / "traj.txt"))
    lines = open(tmp_path / "traj.txt").read().strip().splitlines()
    assert len(lines) == slam.map.frame_num()
    ts, traj = slam.trajectory()
    assert traj.shape == (slam.map.frame_num(), 7)


def test_stage_publish_respects_version_bump(slam_run, monkeypatch):
    """tests/test_slam.py:693-724: a map transform landing between
    _stage_local_map's locked read and its publish must not reinstate the
    stale-gauge cloud."""
    import pislamfusion_tpu_torch.models.tracker as trmod
    slam, _ = slam_run
    tr = slam.tracker
    tr._stage_local_map()
    assert tr._local_stage is not None
    orig = trmod.pad_to
    bumped = []

    def bumping_pad_to(*a, **k):
        if not bumped:
            bumped.append(1)
            with tr.map.update_lock:
                tr.map.version += 1
                tr.invalidate_local_stage()
        return orig(*a, **k)

    monkeypatch.setattr(trmod, "pad_to", bumping_pad_to)
    tr._stage_local_map()
    assert tr._local_stage is None
    monkeypatch.setattr(trmod, "pad_to", orig)
    tr._stage_local_map()
    assert tr._local_stage is not None


@pytest.mark.parametrize("owner", ["loop_closer", "mapper"])
def test_deform_hooks_invalidate_the_stage(slam_run, owner):
    """tests/test_slam.py:726-759: the loop closer's and the mapper's
    whole-map rewrites invalidate the tracker's staged local map through
    on_map_deformed, wired by SLAM."""
    slam, _ = slam_run
    hook = getattr(getattr(slam, owner), "on_map_deformed", None)
    assert hook is not None
    slam.tracker._stage_local_map()
    assert slam.tracker._local_stage is not None
    hook()
    assert slam.tracker._local_stage is None


def _strip_run(cfg_extra, n, cam=SLAM_CAM, seed=11):
    """A port SLAM on the first n frames of the survey's first row (or a
    strip at the given camera), through track() and finish()."""
    ground = torch.from_numpy(chip_smoke.survey_ground(
        np.random.default_rng(seed)))
    c = Camera(*cam)
    poses = chip_smoke.survey_poses()[:n]
    cfg = chip_smoke.slam_survey_cfg(**cfg_extra)
    slam = create_slam(cfg, c, device="cpu")
    from pislamfusion_tpu_torch.core.messenger import DataTrans
    slam.trans_queue = DataTrans(30)
    for i, p in enumerate(poses):
        slam.track(chip_smoke.survey_view(ground, c, p).numpy(), float(i))
    slam.finish()
    return slam, poses


def test_slam_sift_short_strip():
    """tests/test_slam.py::test_slam_sift_path's config (SIFT-400, DoG
    contrast 0.005, 50 matches to initialize) on 6 frames: the fused path,
    more than 70 % of frames tracked, a populated map."""
    slam, poses = _strip_run({"FeatureDetector": "Sift",
                              "SLAM.nFeature": 400,
                              "Sift.ContrastThreshold": 0.005,
                              "SLAM.MinInitMatches": 50}, 6)
    assert slam.detector.kind == "sift" and slam.tracker.use_fused
    assert slam.frames_tracked > 0.7 * slam.frames_total
    assert slam.map.point_num() > 100


def test_slam_orb_levels_outside_the_flat_plan():
    """ORB.nLevels 4 with ScaleFactor 1.5: a pair the K1 plan does not
    take at this size, so the port's ORB runs its resize chain; 6 frames
    track with the scale of the truth's 3 m steps."""
    from pislamfusion_tpu_torch.ops.features import flatpyr
    slam, poses = _strip_run({"ORB.nLevels": 4, "ORB.ScaleFactor": 1.5}, 6)
    p = slam.detector.params
    assert (p.n_levels, p.scale_factor) == (4, 1.5)
    assert not flatpyr.flat_pyramid_available(240, 320, 4, 1.5, p.cell)
    assert slam.frames_tracked == 5
    kf = sorted(slam.map.keyframes(), key=lambda f: f.id)
    c = np.stack([f.pose_c2w[:3] for f in kf])
    steps = np.linalg.norm(np.diff(c, axis=0), axis=1)
    assert np.all(np.abs(steps / np.median(steps) - 1.0) < 0.35), steps


def test_slam_track_scale_two():
    """SLAM.TrackScale=2 (tests/test_slam.py::test_slam_track_scale's
    640x480 camera and ORB-500) on 6 frames: tracking on the half-size
    frame with the downsampled camera, uniform steps, and the mosaic fed
    the full-size frame."""
    slam, poses = _strip_run({"SLAM.TrackScale": 2, "SLAM.nFeature": 500},
                             6, cam=(640, 480, 520.0, 520.0, 320.0, 240.0),
                             seed=12)
    assert slam._track_scale == 2 and slam._scaled_cam.width == 320
    assert slam.frames_tracked >= 4
    kf = sorted(slam.map.keyframes(), key=lambda f: f.id)
    c = np.stack([f.pose_c2w[:3] for f in kf])
    steps = np.linalg.norm(np.diff(c, axis=0), axis=1)
    assert np.all(np.abs(steps / np.median(steps) - 1.0) < 0.35), steps
    img0 = slam.trans_queue.try_consume()[0]
    assert img0.shape[:2] == (480, 640)


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------

def test_slam_defaults_to_cuda_and_raises_without_it():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is usable")
    with pytest.raises(RuntimeError, match="CUDA"):
        create_slam(chip_smoke.slam_survey_cfg(), Camera(*SLAM_CAM))
    cfg = chip_smoke.slam_survey_cfg(**{"SLAM.Device": "cpu"})
    assert create_slam(cfg, Camera(*SLAM_CAM)).device.type == "cpu"


def test_slam_modules_and_registry_names():
    from pislamfusion_tpu_torch.core.registry import (
        FEATURE_DETECTORS, LOOP_CLOSERS, LOOP_DETECTORS, MAPPERS, MAPS,
        RELOCALIZERS, TRACKERS)
    from pislamfusion_tpu_torch.models import loopclose, tracker
    slam = create_slam(chip_smoke.slam_survey_cfg(), Camera(*SLAM_CAM),
                       device="cpu")
    slam._ensure_modules()
    assert type(slam.tracker) is tracker.Tracker
    assert type(slam.mapper) is tmapper.Mapper
    assert type(slam.loop_closer) is loopclose.LoopCloserSE3Graph
    assert slam.tracker._key.words == (0, 0)   # PRNGKey(SLAM.Seed 0)
    assert slam.mapper.generator.initial_seed() == 1
    assert slam.loop_closer._key.words == (0, 7)   # PRNGKey(7)
    for reg, names in ((FEATURE_DETECTORS, ("ORB", "cvORB", "liu_ORB",
                                            "liu_cvORB", "Sift")),
                       (TRACKERS, ("opt", "demo", "testInit",
                                   "liu_testInit", "planar", "ransacPnP",
                                   "testLoopDetector", "loadmap",
                                   "rtsfmInit")),
                       (MAPPERS, ("demo", "zhangmi")),
                       (MAPS, ("Hash",)), (LOOP_CLOSERS, ("se3graph",)),
                       (LOOP_DETECTORS, ("GPS", "distance", "BoW")),
                       (RELOCALIZERS, ("demo", "default"))):
        assert all(n in reg for n in names)
    from pislamfusion_tpu_torch.models.worldmap import WorldMap
    from pislamfusion_tpu_torch.core.svar import Svar
    for name in ("opt", "demo", "testInit", "liu_testInit", "planar",
                 "ransacPnP", "testLoopDetector", "loadmap", "rtsfmInit"):
        assert TRACKERS.create(name, WorldMap(), Svar(), device="cpu") \
            is not None, name
    for name in ("demo", "zhangmi"):
        assert MAPPERS.create(name, WorldMap(), Svar(), device="cpu") \
            is not None, name


# ---------------------------------------------------------------------------
# the tracker variants and MapperZhangMi
# ---------------------------------------------------------------------------

def test_ransac_pnp_last_frame_step_matches_reference(capture, monkeypatch):
    """TrackerRansacPnP._track_last_frame, from the JAX run's state before
    frame 3, of a view 1 m on from the last frame (its JAX features), on
    the JAX package's PnP samples and with the JAX pose LM on the PnP
    inliers, as the port fits them: the same decision, the pose within
    1e-4 of the translation scale, inliers within 2 and the bindings equal
    on 99 % of the keypoints."""
    from pislamfusion_tpu_torch.models import tracker as ttr
    from pislamfusion_tpu_torch.models.frame import Frame
    from pislamfusion_tpu_torch.ops import ransac as tr_ransac
    ref = capture["ransac_pnp"]
    assert ref["ok"] and len(ref["draws"]) == 1
    slam = create_slam(chip_smoke.slam_survey_cfg(), Camera(*SLAM_CAM),
                       device="cpu")
    convert.load_worldmap_state(slam, capture["before"])
    tr = ttr.TrackerRansacPnP(slam.map, slam.cfg, device="cpu")
    tr.last_frame = slam.tracker.last_frame
    frame = Frame(id=SLAM_STAGE_FRAME, timestamp=float(SLAM_STAGE_FRAME),
                  camera=tr.last_frame.camera)
    frame.set_features({k: np.array(v) for k, v in ref["feats"].items()},
                       tr.last_frame.desc_kind)
    (i6, i4), = ref["draws"]

    def on_the_samples(gen, p3d, p2n, valid, **kw):
        return tr_ransac._find_pnp_from_samples(T(i6), T(i4), p3d, p2n,
                                                valid, 0.01, 2)
    monkeypatch.setattr(ttr.ransac, "find_pnp", on_the_samples)
    assert tr._track_last_frame(frame)
    scale = max(float(np.linalg.norm(ref["pose"][:3])), 1.0)
    assert np.abs(frame.pose_c2w - ref["pose"]).max() <= 1e-4 * scale
    assert abs(tr._n_inliers - ref["n_inliers"]) <= 2
    assert np.mean(frame.kp2mp != ref["kp2mp"]) <= 0.01


def _pose_fit_frames(pkg, xy, n_kp):
    """A source keyframe whose keypoints i bind map points i, and the
    current frame with keypoints `xy` (320x240, fx 260), in `pkg`."""
    import importlib
    Frame = importlib.import_module(f"{pkg}.models.frame").Frame
    Cam = importlib.import_module(f"{pkg}.core.camera").Camera
    cam = Cam(*SLAM_CAM)
    feats = dict(xy=xy.astype(np.float32),
                 desc=np.zeros((n_kp, 256), np.uint8),
                 angle=np.zeros(n_kp, np.float32),
                 octave=np.zeros(n_kp, np.int32),
                 response=np.ones(n_kp, np.float32),
                 valid=np.ones(n_kp, bool))
    src = Frame(id=0, timestamp=0.0, camera=cam)
    src.set_features(feats, "orb")
    src.kp2mp[:] = np.arange(n_kp)
    cur = Frame(id=1, timestamp=1.0, camera=cam)
    cur.set_features(feats, "orb")
    return src, cur


def test_relocalization_pose_fits_the_pnp_inliers():
    """`_solve_pose` given the PnP-RANSAC inliers (the port's
    `_track_ref_kf`, which relocalizes) is the JAX package's `_solve_pose`
    on those matches alone: the same decision, pose within 1e-5 m, the same
    bindings; the outliers change nothing. The JAX package fits every
    match there, and its Huber LM can walk off the PnP pose (ROADMAP
    queue 3: the real fixture's relocalization)."""
    from pislamfusion_tpu.core.svar import Svar as JSvar
    from pislamfusion_tpu.models import tracker as jtracker
    from pislamfusion_tpu.models.worldmap import WorldMap as JWorldMap
    from pislamfusion_tpu_torch.core.svar import Svar
    from pislamfusion_tpu_torch.models import tracker as ttracker
    from pislamfusion_tpu_torch.models.worldmap import WorldMap
    from pislamfusion_tpu_torch.utils import host_se3 as hse3
    rng = np.random.default_rng(4)
    n, n_in = 60, 48
    pos = np.concatenate([rng.uniform(-8, 8, (n, 2)),
                          rng.uniform(-1, 1, (n, 1))], 1).astype(np.float32)
    T_c2w = np.array([0.3, -0.2, 25.0, 1.0, 0.0, 0.0, 0.0], np.float32)
    T_w2c = hse3.se3_inv(T_c2w)
    pc = hse3.se3_apply(T_w2c, pos)
    xy = 260.0 * pc[:, :2] / pc[:, 2:] + np.array([160.0, 120.0])
    xy[:n_in] += rng.normal(0, 0.3, (n_in, 2))
    xy[n_in:] = rng.uniform([0, 0], [320, 240], (n - n_in, 2))
    has = np.ones(n, bool)
    idxn = np.arange(n)
    okn = np.ones(n, bool)
    inliers = np.arange(n) < n_in
    T0 = T_c2w + np.array([0.4, -0.3, 0.5, 0, 0, 0, 0], np.float32)
    src, cur = _pose_fit_frames("pislamfusion_tpu_torch", xy, n)
    tt = ttracker.Tracker(WorldMap(), Svar(), device="cpu")
    assert tt._solve_pose(cur, T0, pos, has, idxn, okn, src, inliers)
    jsrc, jcur = _pose_fit_frames("pislamfusion_tpu", xy, n)
    jt = jtracker.Tracker(JWorldMap(), JSvar())
    assert jt._solve_pose(jcur, T0, pos, has, idxn, okn & inliers, jsrc)
    np.testing.assert_allclose(cur.pose_c2w[:3], jcur.pose_c2w[:3],
                               atol=1e-5)
    np.testing.assert_allclose(cur.pose_c2w[3:], jcur.pose_c2w[3:],
                               atol=1e-6)
    np.testing.assert_array_equal(cur.kp2mp, jcur.kp2mp)
    assert tt._n_inliers == jt._n_inliers and (cur.kp2mp[n_in:] < 0).all()
    # near the truth: 48 points under 0.3 px of noise, 25 m up
    np.testing.assert_allclose(cur.pose_c2w[:3], T_c2w[:3], atol=0.2)


def test_zhangmi_filter_matches_reference():
    """MapperZhangMi._filter_new_points (host numpy) equals the JAX
    package's on the same frame, candidates and errors, exactly."""
    from pislamfusion_tpu.core.camera import Camera as JCamera
    from pislamfusion_tpu.core.svar import Svar as JSvar
    from pislamfusion_tpu.models import mapper as jm
    from pislamfusion_tpu.models.frame import Frame as JFrame
    from pislamfusion_tpu.models.worldmap import WorldMap as JWorldMap
    from pislamfusion_tpu_torch.core.svar import Svar
    from pislamfusion_tpu_torch.models.frame import Frame
    from pislamfusion_tpu_torch.models.worldmap import WorldMap
    rng = np.random.default_rng(3)
    n = 600
    feats = {"xy": rng.uniform([0, 0], [320, 240], (n, 2)).astype(
        np.float32), "desc": rng.integers(0, 256, (n, 32), dtype=np.uint8),
        "valid": np.ones(n, bool)}
    kp2mp = np.where(rng.random(n) < 0.3, rng.integers(0, 500, n), -1)
    good = rng.random(n) < 0.5
    err = rng.random(n).astype(np.float32)
    out = []
    for mk, fr_cls, cam_cls, wm, sv in (
            (jm.MapperZhangMi, JFrame, JCamera, JWorldMap, JSvar),
            (tmapper.MapperZhangMi, Frame, Camera, WorldMap, Svar)):
        fr = fr_cls(id=0, timestamp=0.0, camera=cam_cls(*SLAM_CAM))
        fr.set_features(feats, "orb")
        fr.kp2mp = kp2mp.copy()
        m = mk(wm(), sv()) if mk is jm.MapperZhangMi else mk(
            wm(), sv(), device="cpu")
        out.append([m._filter_new_points(fr, good.copy(), e)
                    for e in (err, None)])
    for a, b in zip(*out):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert 0 < out[1][0].sum() < good.sum()


def _variant_strip(name, n, seed, extra=None, gps=False):
    """tests/test_slam.py's variant runs: a strip at y 30 (or, with GPS,
    8 frames 4 m apart at y 40 with 0.1 m fixes and the nadir attitude)
    through the named tracker, offline."""
    from pislamfusion_tpu_torch.core.gps import LocalFrame
    rng = np.random.default_rng(seed)
    ground = torch.from_numpy(chip_smoke.survey_ground(rng))
    cam = Camera(*SLAM_CAM)
    if gps:
        poses = np.stack([[28.0 + 4.0 * k, 40.0, 25.0, 1.0, 0.0, 0.0, 0.0]
                          for k in range(n)])
    else:
        poses = chip_smoke.survey_poses(y1=31.0, x1=25.0 + 3.0 * n)
    cfg = chip_smoke.slam_survey_cfg(**{
        "Tracker": name, "SLAM.nFeature": 500 if gps else 600,
        "Plane.MinPoints": 2000, **(extra or {})})
    slam = create_slam(cfg, cam, device="cpu")
    from pislamfusion_tpu_torch.core.messenger import DataTrans
    slam.trans_queue = DataTrans(30)
    local, anchor = LocalFrame(116.35, 39.96, 40.0), None
    for i, p in enumerate(poses):
        img = chip_smoke.survey_view(ground, cam, p).numpy()
        if gps:
            noisy = p[:3] + rng.normal(0, 0.1, 3)
            anchor = noisy if anchor is None else anchor
            slam.track(img, float(i), gps_lla=local.local_to_lla(noisy),
                       gps_acc=0.1, pyr=(90.0, 0.0, 0.0))
        else:
            slam.track(img, float(i))
    slam.finish()
    return slam, poses, anchor


def test_tracker_ransacpnp_path():
    """tests/test_slam.py:347-374: more than 70 % tracked, more than 100
    map points, never the fused step."""
    from pislamfusion_tpu_torch.models.tracker import TrackerRansacPnP
    slam, _, _ = _variant_strip("ransacPnP", 12, 12)
    assert isinstance(slam.tracker, TrackerRansacPnP)
    assert not slam.tracker.use_fused
    assert slam.frames_tracked > 0.7 * slam.frames_total
    assert slam.map.point_num() > 100


@pytest.mark.parametrize("name", ["planar", "rtsfmInit"])
def test_tracker_geo_pair_chains(name):
    """tests/test_slam.py:439-543 (planar, rtsfmInit): GPS-snapped pairs
    land directly in the geo frame, every frame a keyframe, centres within
    1.0 m (mean 0.5 m) of the truth less the first fix, more than 200
    points; planar with at least 5 successful pairs and the ground one
    flight height (25 m) from the cameras' plane within 1.5 m for 80 % of
    the points; rtsfmInit never falls back and tracks 5 frames or more."""
    from pislamfusion_tpu_torch.models.tracker import (Status,
                                                       TrackerPlanar,
                                                       TrackerRTSfMInit)
    slam, poses, anchor = _variant_strip(name, 8, 5, gps=True)
    tr = slam.tracker
    assert slam.cfg.get_int("GPS.Fitted", 0) == 1
    frames = slam.map.frames()
    assert len(frames) >= (6 if name == "planar" else 5)
    assert all(f.is_keyframe for f in frames)
    est = np.stack([f.pose_c2w[:3] for f in frames])
    gt = poses[np.asarray([f.id for f in frames])][:, :3] - anchor
    err = np.linalg.norm(est - gt, axis=1)
    assert err.max() < 1.0 and err.mean() < 0.5, err
    assert slam.map.point_num() > 200
    if name == "planar":
        assert type(tr) is TrackerPlanar and len(tr._successes) >= 5
        pz = np.stack([p.position for p in slam.map.points()])[:, 2]
        assert np.percentile(np.abs(pz - (est[:, 2].mean() + 25.0)),
                             80) < 1.5
    else:
        assert isinstance(tr, TrackerRTSfMInit)
        assert tr.status == Status.TRACKING
        assert slam.frames_tracked >= 5


def test_tracker_liu_testinit_harness():
    """tests/test_slam.py:582-607: every frame after the first is an
    attempt, at least 60 % succeed with more than 50 mean inliers, and no
    map is built."""
    from pislamfusion_tpu_torch.models.tracker import TrackerInitTest
    slam, poses, _ = _variant_strip("liu_testInit", 8, 14)
    rep = slam.tracker.report()
    assert isinstance(slam.tracker, TrackerInitTest)
    assert rep["attempts"] == len(poses) - 1
    assert rep["success"] >= 0.6 * rep["attempts"], rep
    assert rep["mean_inliers"] > 50, rep
    assert slam.map.point_num() == 0


def test_tracker_loop_detector_harness():
    """Tracker?=testLoopDetector on an 8-frame strip: no pose is
    estimated and no point made; the first frame and those
    whose matches to the last keyframe fall under 200 become its
    keyframes, each inserted into the map and the detector."""
    from pislamfusion_tpu_torch.models.tracker import TrackerLoopTest
    slam, _, _ = _variant_strip("testLoopDetector", 8, 12,
                                {"SLAM.nFeature": 500})
    tr = slam.tracker
    assert isinstance(tr, TrackerLoopTest) and not tr.use_fused
    assert tr.n_keyframes >= 2 and slam.map.frame_num() == tr.n_keyframes
    assert slam.map.point_num() == 0
    assert slam.frames_tracked == slam.frames_total


def test_tracker_loadmap(capture, tmp_path):
    """tests/test_slam.py:413-437 on the JAX run's map after frame 3:
    MapFile2Load (the reference's MapHash binary, io/maphash.py) is
    loaded, track() never tracks, the map is untouched."""
    from pislamfusion_tpu_torch.models.tracker import TrackerLoadMap
    wmap = convert.worldmap_from_numpy(capture["after"], device="cpu")
    ckpt = str(tmp_path / "map.maphash")
    assert wmap.save(ckpt)
    n_f, n_p = wmap.frame_num(), wmap.point_num()
    cfg = chip_smoke.slam_survey_cfg(**{"Tracker": "loadmap",
                                        "MapFile2Load": ckpt})
    slam2 = create_slam(cfg, Camera(*SLAM_CAM), device="cpu")
    for i in range(3):
        slam2.track(capture["frames"][SLAM_STAGE_FRAME], float(i))
    slam2.finish()
    assert isinstance(slam2.tracker, TrackerLoadMap)
    assert slam2.frames_tracked == 0
    assert slam2.map.frame_num() == n_f and slam2.map.point_num() == n_p


def test_mapper_zhangmi_grid_quota():
    """tests/test_slam.py:545-580: with Mapper?=zhangmi more than 70 % of
    the strip tracks, with fewer than 0.8x the points of the demo mapper
    on the same frames."""
    from pislamfusion_tpu_torch.models.mapper import MapperZhangMi
    zm, _, _ = _variant_strip("opt", 12, 13, {"Mapper": "zhangmi"})
    assert isinstance(zm.mapper, MapperZhangMi)
    assert zm.frames_tracked > 0.7 * zm.frames_total
    demo, _, _ = _variant_strip("opt", 12, 13)
    assert 0 < zm.map.point_num() < 0.8 * demo.map.point_num(), \
        (zm.map.point_num(), demo.map.point_num())
