"""The JAX package's end-to-end SLAM suites, run on the PyTorch port.

Free of JAX: numpy, PIL and the port's own operations only, so that
`chip_smoke.py` (phase 2h) and `scripts/torch_e2e_phase.py` run it on the
card, and tests/test_torch_e2e.py runs its CPU rows.

Scenes. The counterparts of tests/synth_survey.py's `make_world`,
`true_ortho`, `render_view_3d`, `exposure_field` and `degrade_frame`, and
of the scene builders of tests/test_loopclose.py (`circuit`),
tests/test_real_texture.py (`real_ground`, `real_circuit_poses`) and
tests/test_real_sequence.py (`sequence_ground`, `sequence_trajectory`,
`sequence_exposure`). Each draws
from the same numpy `rng` as its original; `chip_smoke.survey_ground`,
`survey_poses` and `survey_view` are the counterparts of `make_ground`,
`lawnmower` and `render_view`. tests/test_torch_e2e.py holds each one equal
to its original.

Cases. One function a reference test, or a group of tests that share one
run, with that test's scene, frames, configuration and bars, through the
port's entry points (`create_slam(cfg, cam, device=...)`, `FusionSystem`
where the test uses it). Each returns a `Case`: what the run measured and
every bar of the reference test beside its value. `CARD_CASES` names the
rows that run on the card; `run_cases` runs some of them with every kernel's
launch count set to 0 before each case and read after it.
"""
from __future__ import annotations

import contextlib
import os
import sys
import threading
import time
from dataclasses import dataclass, field

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402
from chip_smoke import SURVEY_GS, survey_ground, survey_poses  # noqa: E402

SLAM_CAM = (320, 240, 260.0, 260.0, 160.0, 120.0)
AERIAL_PNG = os.path.join(ROOT, "tests", "data", "aerial_npu.png")
JOIN_S = 120.0      # the longest wait for a thread a case starts


def nadir_pose(x, y, z):
    return np.array([x, y, z, 1.0, 0.0, 0.0, 0.0])


# ---------------------------------------------------------------------------
# scenes
# ---------------------------------------------------------------------------

def make_world(rng, n=1024, rects=700, n_slabs=14, heights=(4.0, 8.0),
               stamp_grid=0):
    """tests/synth_survey.py's make_world: the ground texture and one RGBA
    layer [n, n, 4] a slab height (RGB the roof texture, A its footprint),
    numpy, from `rng`."""
    ground = survey_ground(rng, n, rects)
    if stamp_grid:
        stamp = survey_ground(rng, 128, 30)[:48, :48]
        for y in range(40, n - 88, stamp_grid):
            for x in range(40, n - 88, stamp_grid):
                ground[y:y + 48, x:x + 48] = stamp
    layers = [(float(h), np.zeros((n, n, 4), np.float32)) for h in heights]
    for _ in range(n_slabs):
        li = int(rng.integers(0, len(heights)))
        _, rgba = layers[li]
        sy, sx = rng.integers(n // 8, n - n // 4, 2)
        sh, sw = rng.integers(40, 110, 2)
        roof = survey_ground(rng, 128, 60)[:sh, :sw]
        roof = np.clip(roof * rng.uniform(0.55, 0.8) + 40.0, 0, 255)
        rgba[sy:sy + sh, sx:sx + sw, :3] = roof
        rgba[sy:sy + sh, sx:sx + sw, 3] = 1.0
    return {"ground": ground, "layers": layers}


def true_ortho(world):
    """tests/synth_survey.py's true_ortho: the ground with every slab
    pasted at its true footprint (the nadir view from infinity), numpy."""
    img = world["ground"].copy()
    for _, rgba in world["layers"]:
        a = rgba[..., 3:4]
        img = img * (1.0 - a) + rgba[..., :3] * a
    return img


def world_on(world, device):
    """make_world's arrays as tensors on `device`, layers without a slab
    left out (render_view_3d skips them)."""
    import torch
    return {"ground": torch.from_numpy(world["ground"]).to(device),
            "layers": [(h, torch.from_numpy(rgba).to(device))
                       for h, rgba in world["layers"]
                       if rgba[..., 3].any()]}


def exposure_field(cam, k, strength=0.12):
    """tests/synth_survey.py's exposure_field: the smooth gain [H, W, 1]
    of frame k (a tilted plane and a vignette whose phase walks with k)."""
    h, w = cam.height, cam.width
    yy, xx = np.meshgrid(np.linspace(-1, 1, h, dtype=np.float32),
                         np.linspace(-1, 1, w, dtype=np.float32),
                         indexing="ij")
    ph = 0.9 * k
    tilt = np.cos(ph) * xx + np.sin(ph) * yy
    gain = (1.0 + strength * 0.6 * np.sin(0.7 * k)
            + strength * tilt - 0.5 * strength * (xx * xx + yy * yy))
    return gain[..., None].astype(np.float32)


def render_view(ground, cam, pose):
    """tests/synth_survey.py's render_view of a ground tensor: numpy
    [H, W, 3] float32."""
    return chip_smoke.survey_view(ground, cam, pose).cpu().numpy()


def render_view_3d(world, cam, pose, k=None, illum=0.0):
    """tests/synth_survey.py's render_view_3d of `world_on`'s tensors: the
    ground, then each slab layer through its plane's homography (the pose
    lowered by the layer's height), alpha-composited, then the exposure
    gain of frame k. Returns numpy [H, W, 3] float32."""
    import torch
    from pislamfusion_tpu_torch.ops import image as im
    from pislamfusion_tpu_torch.ops import mosaic as M
    img = chip_smoke.survey_view(world["ground"], cam, pose)
    for h, rgba in world["layers"]:
        pose_h = np.asarray(pose, np.float64).copy()
        pose_h[2] -= h
        Hm = M.homography_canvas_to_image_np(pose_h, cam, (0.0, 0.0),
                                             SURVEY_GS)
        warped = im.warp_perspective(
            rgba, torch.from_numpy(np.linalg.inv(Hm).astype(np.float32)).to(
                rgba.device), (cam.height, cam.width), border="constant")[0]
        a = torch.clamp(warped[..., 3:4], 0.0, 1.0)
        img = img * (1.0 - a) + warped[..., :3] * a
    img = img.cpu().numpy()
    if illum and k is not None:
        img = img * (1.0 + (exposure_field(cam, k, illum) - 1.0))
    return np.clip(img, 0, 255).astype(np.float32)


def degrade_frame(img, rng, blur_px=0.0, noise=0.0, direction=(1.0, 0.0)):
    """tests/synth_survey.py's degrade_frame: a box motion blur of blur_px
    along `direction`, then Gaussian noise from `rng`."""
    out = np.asarray(img, np.float32)
    n = int(round(blur_px))
    if n >= 2:
        dx, dy = direction
        nrm = max(np.hypot(dx, dy), 1e-9)
        acc = np.zeros_like(out)
        for i in range(n):
            t = (i - (n - 1) / 2.0)
            sx = int(round(t * dx / nrm))
            sy = int(round(t * dy / nrm))
            acc += np.roll(out, (sy, sx), (0, 1))
        out = acc / n
    if noise > 0:
        out = out + rng.normal(0.0, noise, out.shape).astype(np.float32)
    return np.clip(out, 0, 255)


def circuit(alt=25.0, cx=43.0, cy=42.0, hw=16.0, hh=12.0, step=3.0):
    """tests/test_loopclose.py's _circuit: a closed rectangle that overlaps
    its start leg at the end."""
    poses = []
    x0, x1 = cx - hw, cx + hw
    y0, y1 = cy - hh, cy + hh
    for x in np.arange(x0, x1, step):
        poses.append(nadir_pose(x, y0, alt))
    for y in np.arange(y0, y1, step):
        poses.append(nadir_pose(x1, y, alt))
    for x in np.arange(x1, x0, -step):
        poses.append(nadir_pose(x, y1, alt))
    for y in np.arange(y1, y0 - 2 * step, -step):
        poses.append(nadir_pose(x0, y, alt))
    for x in np.arange(x0, x0 + 4 * step, step):
        poses.append(nadir_pose(x, y0, alt))
    return np.stack(poses)


def real_ground(n=1024, unique_speckle=False, seed=5):
    """tests/test_real_texture.py's _real_ground: the aerial photograph
    tests/data/aerial_npu.png mirror-tiled 2x2, Lanczos-resized to n x n,
    with a unique speckle of sigma 5 from `seed` when asked."""
    from PIL import Image
    a = np.asarray(Image.open(AERIAL_PNG).convert("RGB"), np.float32)
    a = np.concatenate([a, a[:, ::-1]], 1)
    a = np.concatenate([a, a[::-1]], 0)
    out = np.asarray(Image.fromarray(a.astype(np.uint8)).resize(
        (n, n), Image.LANCZOS), np.float32)
    if unique_speckle:
        out = out + np.random.default_rng(seed).normal(
            0, 5.0, out.shape).astype(np.float32)
    return np.clip(out, 0, 255)


def real_circuit_poses(step=2.0):
    """tests/test_real_texture.py's _circuit_poses: the 196 m rectangle
    over the photograph with a 12 m revisit of its first strip."""
    poses = []
    x0, x1, y0, y1, alt = 25.0, 91.0, 30.0, 62.0, 25.0
    for x in np.arange(x0, x1, step):
        poses.append(nadir_pose(x, y0, alt))
    for y in np.arange(y0, y1, step):
        poses.append(nadir_pose(x1, y, alt))
    for x in np.arange(x1, x0, -step):
        poses.append(nadir_pose(x, y1, alt))
    for y in np.arange(y1, y0, -step):
        poses.append(nadir_pose(x0, y, alt))
    for x in np.arange(x0, x0 + 12.0, step):
        poses.append(nadir_pose(x, y0, alt))
    return np.stack(poses)


def sequence_ground(n=1024):
    """tests/test_real_sequence.py's _ground."""
    return real_ground(n=n, unique_speckle=True, seed=7)


def sequence_trajectory():
    """tests/test_real_sequence.py's _trajectory: a 5-strip lawnmower of 19
    frames a strip, then the first strip again (from frame 95); (poses
    [114, 7], strip index a frame)."""
    poses, strip_id = [], []
    xs = np.arange(25.0, 63.0, 2.0)
    ys = [30.0, 36.0, 42.0, 48.0, 54.0]
    for iy, y in enumerate(ys):
        for x in (xs if iy % 2 == 0 else xs[::-1]):
            poses.append(nadir_pose(x, y, 25.0))
            strip_id.append(iy)
    for x in xs:
        poses.append(nadir_pose(x, ys[0], 25.0))
        strip_id.append(len(ys))
    return np.stack(poses), np.asarray(strip_id)


def sequence_exposure(k, strip):
    """tests/test_real_sequence.py's _exposure: (gain, bias) of frame k."""
    gain = 1.0 + 0.05 * np.sin(0.13 * k) + 0.04 * ((strip % 3) - 1)
    bias = 6.0 * np.sin(0.07 * k + 1.0) + 3.0 * (strip % 2)
    return gain, bias


def soak_poses():
    """tests/test_soak.py:30-35: four rows of 20 frames 1.8 m apart."""
    poses = []
    for iy, y in enumerate(np.arange(32.0, 56.0, 6.0)):
        xs = np.arange(26.0, 62.0, 1.8)
        for x in (xs if iy % 2 == 0 else xs[::-1]):
            poses.append(nadir_pose(x, y, 25.0))
    return np.stack(poses)


def race_poses():
    """tests/test_soak.py:141-147: the 7-row lawnmower flown twice, cut to
    250 frames."""
    poses = []
    for _ in range(2):
        for iy, y in enumerate(np.arange(30.0, 56.0, 4.0)):
            xs = np.arange(26.0, 62.0, 1.5)
            for x in (xs if iy % 2 == 0 else xs[::-1]):
                poses.append(nadir_pose(x, y, 25.0))
    return np.stack(poses)[:250]


# ---------------------------------------------------------------------------
# a case's record
# ---------------------------------------------------------------------------

@dataclass
class Case:
    """One case's measurements (`stats`, printed in order) and the
    reference test's bars: (label, value, op, limit, met)."""
    name: str
    reference: str
    device: str
    stats: dict = field(default_factory=dict)
    bars: list = field(default_factory=list)
    frames: int = 0
    seconds: float = 0.0
    launches: dict = field(default_factory=dict)

    def bar(self, label, value, op, limit):
        met = {"<": value < limit, "<=": value <= limit, ">": value > limit,
               ">=": value >= limit, "==": value == limit}[op]
        self.bars.append((label, value, op, limit, bool(met)))
        return met

    @property
    def ok(self):
        return all(b[4] for b in self.bars)

    def line(self, prefix="e2e"):
        ms = (f"{self.seconds * 1e3 / self.frames:.1f} ms a frame over "
              f"{self.frames} frames" if self.frames else
              f"{self.seconds:.1f} s")
        stats = ", ".join(f"{k} {_fmt(v)}" for k, v in self.stats.items())
        bars = ", ".join(
            f"{label} {_fmt(v)} {op} {_fmt(lim)} "
            + ("met" if met else "MISSED")
            for label, v, op, lim, met in self.bars)
        return (f"{prefix} {self.name} ({self.reference}, {self.device}): "
                f"{ms}; {stats}; bars: {bars}")


def _fmt(v):
    if isinstance(v, (bool, np.bool_)):
        return str(bool(v))
    if isinstance(v, (float, np.floating)):
        return f"{float(v):.4g}"
    return str(v)


def slam_cfg(**kv):
    """A port Svar with the keys and values of `kv`."""
    from pislamfusion_tpu_torch.core.svar import Svar
    cfg = Svar()
    for k, v in kv.items():
        cfg.set(k, str(v))
    return cfg


BA_SMALL = {"SLAM.BAFrameCap": 8, "SLAM.BAPointCap": 1024,
            "SLAM.BAObsCap": 4096, "SLAM.LocalBAIters": 8}


def _camera(params=SLAM_CAM):
    from pislamfusion_tpu_torch.core.camera import Camera
    return Camera(*params)


def _ground_on(ground, device):
    import torch
    return torch.from_numpy(ground).to(device)


def _tracked_ate(slam, poses):
    """(ATE, span) of the frames that tracked or are keyframes, after the
    Sim3 alignment to the truth (tests/test_loopclose.py's measure; span:
    the extent of their true centres)."""
    ate, span, _ = chip_smoke.slam_ate(slam, np.asarray(poses))
    return ate, span


def _aligned_rms(est, gt):
    """RMS of est after the Sim3 (Horn) alignment to gt (both [N, 3])."""
    import torch
    from pislamfusion_tpu_torch.ops import lie, ransac
    e = torch.from_numpy(np.asarray(est, np.float32))
    S = ransac.sim3_horn(e, torch.from_numpy(np.asarray(gt, np.float32)))
    al = lie.sim3_apply(S, e).numpy()
    return float(np.sqrt(np.mean(np.sum((al - gt) ** 2, -1))))


def _track_all(slam, frames):
    """Feed the frames (timestamps 0, 1, ...) and finish; (seconds, the
    frames `track` returned)."""
    t0 = time.perf_counter()
    out = [slam.track(img, float(i)) for i, img in enumerate(frames)]
    slam.finish(JOIN_S)
    return time.perf_counter() - t0, out


def _fusion(cfg, cam, slam, device):
    """A FusionSystem consuming `slam`'s own pair of queues (the reference
    tests' process-wide queues would carry one case's frames into the
    next)."""
    from pislamfusion_tpu_torch.core.messenger import DataTrans
    from pislamfusion_tpu_torch.models.fusion import FusionSystem
    trans_q, plane_q = DataTrans(30), DataTrans(30)
    slam.trans_queue, slam.plane_queue = trans_q, plane_q
    return FusionSystem(cfg, cam, trans_q=trans_q, plane_q=plane_q,
                        device=device).start()


# ---------------------------------------------------------------------------
# tier-1 cases (tests/test_torch_e2e.py runs them on the CPU)
# ---------------------------------------------------------------------------

def bow_kidnap(device):
    """tests/test_bow_reloc.py:22: 20 frames of a strip, 3 blank frames
    (LOST), then frames 4-6 again: the embedded ORB vocabulary relocalizes
    at least 2 of the 3, one near the early keyframes."""
    from pislamfusion_tpu_torch.models.loopclose import LoopDetectorBoW
    from pislamfusion_tpu_torch.models.slam import create_slam
    c = Case("BoW relocalization", "tests/test_bow_reloc.py:22", str(device))
    rng = np.random.default_rng(7)
    ground = _ground_on(survey_ground(rng), device)
    cam = _camera()
    cfg = slam_cfg(**{"FeatureDetector": "ORB", "SLAM.nFeature": 500,
                      "SLAM.LoopClose": 1, "LoopDetector": "BoW",
                      "SLAM.LoopMinFrameGap": 10}, **BA_SMALL)
    slam = create_slam(cfg, cam, device=device)
    poses = np.stack([nadir_pose(30.0 + 2.0 * i, 40.0, 25.0)
                      for i in range(20)])
    t0 = time.perf_counter()
    for i, p in enumerate(poses):
        slam.track(render_view(ground, cam, p), float(i))
    c.bar("BoW detector", isinstance(slam.tracker.loop_detector,
                                     LoopDetectorBoW), "==", True)
    c.bar("vocabulary loaded", slam.vocabulary is not None
          and not slam.vocabulary.empty(), "==", True)
    before = slam.frames_tracked
    c.bar("tracked before", before, ">", 14)
    kf_pose = {f.id: f.pose_c2w.copy() for f in slam.map.keyframes()}
    blank = np.full((240, 320), 128.0, np.float32)
    t = float(len(poses))
    for j in range(3):
        slam.track(blank, t + j)
    recovered = []
    for j, fi in enumerate([4, 5, 6]):
        recovered.append(slam.track(render_view(ground, cam, poses[fi]),
                                    t + 3.0 + j))
    c.seconds, c.frames = time.perf_counter() - t0, len(poses) + 6
    after = slam.frames_tracked - before
    c.bar("relocalized of 3", after, ">=", 2)
    early = [kf_pose[k][:3] for k in sorted(kf_pose) if k <= 10]
    c.bar("early keyframes", len(early), ">", 0)
    span = float(np.linalg.norm(poses[-1, :3] - poses[0, :3]))
    near = 0
    if early:
        early = np.stack(early)
        for fr in recovered[1:]:
            d = np.min(np.linalg.norm(early - fr.pose_c2w[:3], axis=1))
            near += int(d < 0.2 * span)
    c.bar("recovered near the early map", near, ">=", 1)
    c.stats.update(tracked=f"{slam.frames_tracked}/{slam.frames_total}",
                   keyframes=len(slam.map.keyframes()),
                   points=slam.map.point_num())
    return c


def sift_bow(device):
    """tests/test_bow_reloc.py:81: the embedded float SIFT vocabulary
    loads, assigns more than 20 words (more than 10 distinct) to SIFT-300
    descriptors of a view, and SLAM with FeatureDetector Sift and
    LoopDetector BoW wires it."""
    import torch
    from pislamfusion_tpu_torch.models.loopclose import LoopDetectorBoW
    from pislamfusion_tpu_torch.models.slam import (_default_vocabulary,
                                                    create_slam)
    from pislamfusion_tpu_torch.ops.features import sift
    c = Case("SIFT BoW wiring and words", "tests/test_bow_reloc.py:81",
             str(device))
    t0 = time.perf_counter()
    voc = _default_vocabulary("sift")
    c.bar("vocabulary loaded", voc is not None and not voc.empty(), "==",
          True)
    if voc is None:
        return c
    c.bar("float vocabulary", not voc.is_binary, "==", True)
    c.bar("descriptor width", int(voc.node_desc.shape[1]), "==", 128)
    rng = np.random.default_rng(8)
    ground = _ground_on(survey_ground(rng), device)
    cam = _camera()
    img = render_view(ground, cam, nadir_pose(40.0, 40.0, 25.0))
    feats = sift.sift_detect(
        torch.from_numpy(img.mean(-1)).to(device),
        sift.SiftParams(n_features=300, contrast_threshold=0.008))
    wid, _, _ = voc.transform_arrays(feats["desc"], feats["valid"])
    widn = np.asarray(wid.cpu())[feats["valid"].cpu().numpy()]
    c.bar("words", len(widn), ">", 20)
    c.bar("smallest word id", int(widn.min()) if len(widn) else -1, ">=", 0)
    c.bar("distinct words", len(np.unique(widn)), ">", 10)
    cfg = slam_cfg(**{"FeatureDetector": "Sift",
                      "Sift.ContrastThreshold": 0.008, "SLAM.nFeature": 300,
                      "SLAM.LoopClose": 1, "LoopDetector": "BoW"})
    slam = create_slam(cfg, cam, device=device)
    slam.track(img, 0.0)
    slam.track(render_view(ground, cam, nadir_pose(42.0, 40.0, 25.0)), 1.0)
    c.bar("BoW detector", isinstance(slam.tracker.loop_detector,
                                     LoopDetectorBoW), "==", True)
    c.bar("SLAM's vocabulary float", slam.vocabulary is not None
          and not slam.vocabulary.is_binary, "==", True)
    c.seconds, c.frames = time.perf_counter() - t0, 2
    return c


def real_texture_strip(device):
    """tests/test_real_texture.py:50: a 12-frame strip over the aerial
    photograph: more than 80 % tracked, more than 150 points, 8 estimates,
    ATE after Sim3 alignment under 5 % of the span."""
    from pislamfusion_tpu_torch.models.slam import create_slam
    c = Case("real-texture strip", "tests/test_real_texture.py:50",
             str(device))
    ground = _ground_on(real_ground(), device)
    cam = _camera()
    xs = np.arange(25.0, 61.0, 3.0)
    poses = [nadir_pose(x, 30.0, 25.0) for x in xs]
    cfg = slam_cfg(**{"FeatureDetector": "ORB", "SLAM.nFeature": 600,
                      "SLAM.LoopClose": 0}, **BA_SMALL)
    slam = create_slam(cfg, cam, device=device)
    c.seconds, out = _track_all(
        slam, [render_view(ground, cam, p) for p in poses])
    c.frames = len(poses)
    est = [None if fr is None else fr.pose_c2w[:3].copy() for fr in out]
    c.bar("tracked share", slam.frames_tracked / slam.frames_total, ">",
          0.8)
    c.bar("points", slam.map.point_num(), ">", 150)
    pts = np.array([e for e in est if e is not None])
    gt = np.array([[x, 30.0, 25.0] for x, e in zip(xs, est)
                   if e is not None])
    c.bar("estimates", len(pts), ">=", 8)
    ate = _aligned_rms(pts, gt)
    span = float(np.linalg.norm(gt[-1] - gt[0]))
    c.bar("ATE m", ate, "<", 0.05 * span)
    c.stats.update(tracked=f"{slam.frames_tracked}/{slam.frames_total}",
                   ate_m=ate, keyframes=len(slam.map.keyframes()),
                   points=slam.map.point_num(), span_m=span)
    return c


def loop_detector_harness(device):
    """tests/test_loopclose.py:78: Tracker testLoopDetector over the closed
    circuit finds at least one verified loop pair 25 frames apart or more,
    with at least 4 keyframes."""
    from pislamfusion_tpu_torch.models.slam import create_slam
    from pislamfusion_tpu_torch.models.tracker import TrackerLoopTest
    c = Case("loop-detector harness", "tests/test_loopclose.py:78",
             str(device))
    rng = np.random.default_rng(15)
    ground = _ground_on(survey_ground(rng), device)
    cam = _camera()
    poses = circuit()
    cfg = slam_cfg(**{"FeatureDetector": "ORB",
                      "Tracker": "testLoopDetector", "SLAM.nFeature": 500,
                      "SLAM.LoopClose": 1, "LoopDetector": "BoW",
                      "SLAM.LoopMinFrameGap": 25})
    slam = create_slam(cfg, cam, device=device)
    c.seconds, _ = _track_all(
        slam, [render_view(ground, cam, p) for p in poses])
    c.frames = len(poses)
    tr = slam.tracker
    c.bar("testLoopDetector tracker", isinstance(tr, TrackerLoopTest), "==",
          True)
    c.bar("keyframes", tr.n_keyframes, ">=", 4)
    c.bar("loops found", len(tr.loops_found), ">=", 1)
    gaps = [f - r for r, f in tr.loops_found]
    c.bar("smallest frame gap", min(gaps) if gaps else 0, ">=", 25)
    c.stats.update(loops=tr.loops_found)
    return c


def gps_priory_two_frames(device):
    """tests/test_gps_fusion.py:123: Mapper.fit_gps_priory on two keyframes
    with GPS and attitude priors places keyframe 0 at its fix (1e-3 m) and
    turns it to look down in ENU (1e-4)."""
    from pislamfusion_tpu_torch.models.frame import Frame
    from pislamfusion_tpu_torch.models.mapper import Mapper
    from pislamfusion_tpu_torch.models.worldmap import WorldMap
    from pislamfusion_tpu_torch.utils import host_se3 as hse3
    c = Case("two-frame GPS prior", "tests/test_gps_fusion.py:123",
             str(device))
    t0 = time.perf_counter()
    cfg = slam_cfg()
    cam = _camera()
    wmap = WorldMap(cfg)
    mapper = Mapper(wmap, cfg, device=device)
    scale_true = 12.5
    offset = np.array([100.0, -40.0, 60.0], np.float32)
    for i, t_est in enumerate([np.zeros(3), np.array([1.6, 0.0, 0.0])]):
        fr = Frame(id=i, timestamp=float(i), camera=cam)
        fr.pose_c2w = np.concatenate(
            [t_est, [0, 0, 0, 1]]).astype(np.float32)
        fr.is_keyframe = True
        fr.gps_enu = (offset + scale_true * t_est).astype(np.float32)
        fr.pyr = np.array([-90.0, 0.0, 0.0])
        fr.height_ground = 25.0
        fr.kp2mp = np.zeros(0, np.int64)
        wmap.insert_frame(fr)
    c.bar("fit_gps_priory", bool(mapper.fit_gps_priory()), "==", True)
    c.bar("gps_fitted", mapper.gps_fitted, "==", True)
    f0 = wmap.frame(0)
    c.bar("keyframe 0 from its fix m", float(np.max(np.abs(
        f0.pose_c2w[:3] - offset))), "<=", 1e-3)
    view = hse3.quat_rotate(f0.pose_c2w[3:7], np.array([0.0, 0.0, 1.0]))
    c.bar("view from straight down", float(np.max(np.abs(
        view - np.array([0.0, 0.0, -1.0])))), "<=", 1e-4)
    c.seconds = time.perf_counter() - t0
    return c


# ---------------------------------------------------------------------------
# the card's cases (chip_smoke.py phase 2h, scripts/torch_e2e_phase.py)
# ---------------------------------------------------------------------------

def _circuit_run(device, loop_close):
    """tests/test_loopclose.py:44-75's _run."""
    from pislamfusion_tpu_torch.models.slam import create_slam
    rng = np.random.default_rng(13)
    ground = _ground_on(survey_ground(rng), device)
    cam = _camera()
    poses = circuit()
    cfg = slam_cfg(**{"FeatureDetector": "ORB", "SLAM.nFeature": 500,
                      "SLAM.MaxOverlap": 0.95,
                      "SLAM.LoopClose": int(loop_close),
                      "SLAM.LoopMinFrameGap": 25}, **BA_SMALL)
    slam = create_slam(cfg, cam, device=device)
    secs, _ = _track_all(slam, [render_view(ground, cam, p)
                                for p in poses])
    return slam, _tracked_ate(slam, poses)[0], secs, len(poses)


def loop_closing(device):
    """tests/test_loopclose.py:66: the circuit with LoopClose 1 tracks
    more than 80 %, closes a loop, ends within 3 % of the 32 m span and
    no worse than 1.05x the LoopClose 0 run, which closes none."""
    c = Case("loop closing", "tests/test_loopclose.py:66", str(device))
    on, ate_on, s1, n = _circuit_run(device, True)
    off, ate_off, s2, _ = _circuit_run(device, False)
    c.seconds, c.frames = s1 + s2, 2 * n
    c.bar("tracked share (on)", on.frames_tracked / on.frames_total, ">",
          0.8)
    c.bar("closed loops (on)", on.loop_closer.closed_loops, ">=", 1)
    c.bar("closed loops (off)", off.loop_closer.closed_loops, "==", 0)
    c.bar("ATE on m", ate_on, "<=", ate_off * 1.05)
    c.bar("ATE on m (span bar)", ate_on, "<", 0.03 * 2 * 16.0)
    c.stats.update(
        tracked=f"{on.frames_tracked}/{on.frames_total} and "
        f"{off.frames_tracked}/{off.frames_total}",
        closed_loops=on.loop_closer.closed_loops, ate_m=ate_on,
        ate_off_m=ate_off, keyframes=len(on.map.keyframes()),
        points=on.map.point_num())
    return c


GPS_ORIGIN = (116.35, 39.96, 40.0)
GPS_SIGMA = 0.5


@contextlib.contextmanager
def gps_fit_scatter(record):
    """Append to `record`, for every Horn fit inside `Mapper.fit_gps_all`,
    the eigenvalues (ascending) of its sources' weighted scatter:
    sim3_horn's rank guard (ops/ransac.py) takes the sources as collinear
    when the middle one is at most 1e-5 of the largest."""
    import torch
    from pislamfusion_tpu_torch.models import mapper as tm
    from pislamfusion_tpu_torch.ops import ransac
    horn, locked = ransac.sim3_horn, tm.Mapper._fit_gps_all_locked
    inside = threading.local()

    def spy_horn(pa, pb, w=None):
        if getattr(inside, "on", False):
            a = pa.double().cpu()
            wt = (torch.ones(a.shape[0], dtype=a.dtype) if w is None
                  else w.double().cpu())
            ca = (a * wt[:, None]).sum(0) / wt.sum().clamp(min=1e-9)
            A = a - ca
            record.append(torch.linalg.eigvalsh(
                (A * wt[:, None]).T @ A).numpy())
        return horn(pa, pb, w)

    def spy_locked(self, *a, **k):
        inside.on = True
        try:
            return locked(self, *a, **k)
        finally:
            inside.on = False

    ransac.sim3_horn, tm.Mapper._fit_gps_all_locked = spy_horn, spy_locked
    try:
        yield record
    finally:
        ransac.sim3_horn, tm.Mapper._fit_gps_all_locked = horn, locked


def _gps_run(device, with_gps):
    """tests/test_gps_fusion.py:40-67's _run: (slam, est, gt, seconds,
    frames), gt in the SLAM's ENU frame (anchored at the first fix)."""
    from pislamfusion_tpu_torch.core.gps import LocalFrame
    from pislamfusion_tpu_torch.models.slam import create_slam
    rng = np.random.default_rng(3)
    ground = _ground_on(survey_ground(rng), device)
    cam = _camera()
    poses = survey_poses()
    local = LocalFrame(*GPS_ORIGIN)
    cfg = slam_cfg(**{"FeatureDetector": "ORB", "SLAM.nFeature": 500,
                      "SLAM.MaxOverlap": 0.95, "SLAM.LoopClose": 0},
                   **BA_SMALL)
    slam = create_slam(cfg, cam, device=device)
    anchor = None
    t0 = time.perf_counter()
    for i, p in enumerate(poses):
        img = render_view(ground, cam, p)
        gps = None
        if with_gps:
            noisy = p[:3] + rng.normal(0, GPS_SIGMA, 3)
            if anchor is None:
                anchor = noisy
            gps = local.local_to_lla(noisy)
        slam.track(img, float(i), gps_lla=gps, gps_acc=GPS_SIGMA)
    slam.finish(JOIN_S)
    secs = time.perf_counter() - t0
    frames = [f for f in slam.map.frames()
              if f.n_tracked() > 0 or f.is_keyframe]
    est = np.stack([f.pose_c2w[:3] for f in frames])
    gt = poses[np.asarray([f.id for f in frames])][:, :3]
    if anchor is not None:
        gt = gt - anchor
    return slam, est, gt, secs, len(poses)


def gps_fusion(device):
    """tests/test_gps_fusion.py:73-120: with noisy GPS (0.5 m) the map is
    fitted, geo-registered (unaligned ATE under 4 sigma), at metric scale
    (altitude above the mapper's plane within 3.5 m of 25), and beats the
    GPS-off run's unaligned error and stays within 4 sigma of its aligned
    one. Also records sim3_horn's rank guard on the lawnmower's fits."""
    c = Case("GPS fusion", "tests/test_gps_fusion.py:73-120", str(device))
    scatter = []
    with gps_fit_scatter(scatter):
        on, est_on, gt_on, s1, n = _gps_run(device, True)
        plane = on.mapper.force_plane()
    off, est_off, gt_off, s2, _ = _gps_run(device, False)
    c.seconds, c.frames = s1 + s2, 2 * n
    c.bar("gps_fitted", on.mapper.gps_fitted, "==", True)
    c.bar("GPS.Fitted", on.cfg.get_bool("GPS.Fitted"), "==", True)
    ate_on = float(np.sqrt(np.mean(np.sum((est_on - gt_on) ** 2, -1))))
    c.bar("unaligned ATE m", ate_on, "<", 4.0 * GPS_SIGMA)
    c.bar("plane", plane is not None, "==", True)
    alt = (float(np.mean(est_on[:, 2]) - plane[2]) if plane is not None
           else float("nan"))
    c.bar("altitude error m", abs(alt - 25.0), "<", 3.5)
    c.bar("gps_fitted (off)", off.mapper.gps_fitted, "==", False)
    ate_off_raw = float(np.sqrt(np.mean(np.sum((est_off - gt_off) ** 2,
                                               -1))))
    ate_off = _aligned_rms(est_off, gt_off)
    c.bar("ATE on vs off unaligned m", ate_on, "<", ate_off_raw)
    c.bar("ATE on vs off aligned + 4 sigma m", ate_on, "<",
          ate_off + 4.0 * GPS_SIGMA)
    guard = [ev[1] / max(ev[2], 1e-12) for ev in scatter]
    c.stats.update(
        tracked=f"{on.frames_tracked}/{on.frames_total} and "
        f"{off.frames_tracked}/{off.frames_total}",
        closed_loops=on.loop_closer.closed_loops, geo_ate_m=ate_on,
        altitude_m=alt, keyframes=len(on.map.keyframes()),
        points=on.map.point_num(), gps_fits=len(scatter),
        rank_guard_hits=sum(g <= 1e-5 for g in guard),
        scatter_middle_over_largest_min=min(guard) if guard else None,
        smallest_singular_over_largest_min=min(
            float(np.sqrt(max(ev[0], 0.0) / max(ev[2], 1e-12)))
            for ev in scatter) if scatter else None)
    return c


def _real_circuit_run(device, ground, cam, frames, loop_close):
    """tests/test_real_texture.py:115-145's _run_circuit."""
    from pislamfusion_tpu_torch.models.slam import create_slam
    cfg = slam_cfg(**{"FeatureDetector": "ORB", "SLAM.nFeature": 600,
                      "SLAM.LoopClose": int(loop_close),
                      "LoopDetector": "BoW", "SLAM.MaxOverlap": 0.95,
                      "SLAM.LoopMinFrameGap": 25,
                      "Mapper.MapFrameCulling": 0,
                      "SLAM.LoopMinCommonWords": 30,
                      "LoopCloser.MinInliers": 60}, **BA_SMALL)
    slam = create_slam(cfg, cam, device=device)
    secs, _ = _track_all(slam, frames)
    return slam, secs


def _kf_ate(slam, poses):
    """tests/test_real_texture.py:148-162's Sim3-aligned keyframe ATE."""
    kfs = slam.map.keyframes()
    pts = np.stack([f.pose_c2w[:3] for f in kfs])
    ids = np.asarray([int(round(f.timestamp)) for f in kfs])
    return _aligned_rms(pts, poses[ids][:, :3])


def real_texture_circuit(device):
    """tests/test_real_texture.py:158: the 196 m circuit over the
    photograph (2048 px, speckled) with exposure drift: LoopClose 1 tracks
    more than 80 %, closes a loop on the revisit and ends under 3 % of the
    span and under the LoopClose 0 run's keyframe ATE."""
    c = Case("real-texture circuit", "tests/test_real_texture.py:158",
             str(device))
    ground = _ground_on(real_ground(n=2048, unique_speckle=True), device)
    cam = _camera()
    poses = real_circuit_poses()
    c.bar("circuit frames", len(poses), ">=", 90)
    gains = 1.0 + 0.12 * np.sin(np.linspace(0, 2 * np.pi, len(poses)))
    frames = [np.clip(render_view(ground, cam, p) * g, 0, 255)
              for p, g in zip(poses, gains)]
    closed, s1 = _real_circuit_run(device, ground, cam, frames, True)
    c.bar("tracked share (on)", closed.frames_tracked
          / closed.frames_total, ">", 0.8)
    c.bar("closed loops (on)", closed.loop_closer.closed_loops, ">=", 1)
    ate_closed = _kf_ate(closed, poses)
    open_, s2 = _real_circuit_run(device, ground, cam, frames, False)
    c.bar("tracked share (off)", open_.frames_tracked / open_.frames_total,
          ">", 0.8)
    ate_open = _kf_ate(open_, poses)
    c.bar("keyframe ATE closed m", ate_closed, "<", ate_open)
    span = 2 * (91.0 - 25.0) + 2 * (62.0 - 30.0)
    c.bar("keyframe ATE closed m (span bar)", ate_closed, "<", 0.03 * span)
    c.seconds, c.frames = s1 + s2, 2 * len(poses)
    c.stats.update(
        tracked=f"{closed.frames_tracked}/{closed.frames_total} and "
        f"{open_.frames_tracked}/{open_.frames_total}",
        closed_loops=closed.loop_closer.closed_loops, ate_m=ate_closed,
        ate_open_m=ate_open, keyframes=len(closed.map.keyframes()),
        points=closed.map.point_num())
    return c


def parallax_world():
    """tests/test_parallax.py:57-67's hard_world: (world, camera, poses)
    for 200x150 frames of a 5-row lawnmower at 30 m."""
    rng = np.random.default_rng(7)
    world = make_world(rng, n=1024, rects=500, n_slabs=12,
                       heights=(3.0, 6.0), stamp_grid=160)
    cam = _camera((200, 150, 140.0, 140.0, 100.0, 75.0))
    poses = survey_poses(alt=30.0, y0=32.0, y1=70.0, dy=9.0, x0=30.0,
                         x1=72.0, dx=6.0)
    return world, cam, poses


LUMA = np.array([0.299, 0.587, 0.114], np.float32)


def parallax_slam(device):
    """tests/test_parallax.py:132: SLAM over the parallax scene (roof
    slabs at 3 and 6 m, stamped texture, exposure fields) tracks 85 % of
    the frames with ATE under 3 % of the span."""
    from pislamfusion_tpu_torch.models.slam import create_slam
    c = Case("parallax SLAM", "tests/test_parallax.py:132", str(device))
    world, cam, poses = parallax_world()
    w = world_on(world, device)
    frames = [render_view_3d(w, cam, p, k=k, illum=0.12)
              for k, p in enumerate(poses)]
    cfg = slam_cfg(**{"FeatureDetector": "ORB", "SLAM.nFeature": 500,
                      "SLAM.LoopClose": 0, "SLAM.MinInitMatches": 60})
    slam = create_slam(cfg, cam, device=device)
    c.seconds, _ = _track_all(slam, [(img @ LUMA).astype(np.float32)
                                     for img in frames])
    n = c.frames = len(frames)
    c.bar("tracked", slam.frames_tracked, ">=", 0.85 * n)
    ate, span = _tracked_ate(slam, poses)
    c.bar("ATE m", ate, "<", 0.03 * span)
    c.stats.update(tracked=f"{slam.frames_tracked}/{slam.frames_total}",
                   ate_m=ate, span_m=span,
                   closed_loops=slam.loop_closer.closed_loops,
                   keyframes=len(slam.map.keyframes()),
                   points=slam.map.point_num())
    return c


def blur_noise_slam(device):
    """tests/test_parallax.py:219: 16 frames with a 3 px motion blur and
    sigma-6 noise track 80 % with ATE under 5 % of the span."""
    from pislamfusion_tpu_torch.models.slam import create_slam
    c = Case("blur and noise SLAM", "tests/test_parallax.py:219",
             str(device))
    rng = np.random.default_rng(17)
    ground = _ground_on(survey_ground(rng), device)
    cam = _camera((256, 192, 200.0, 200.0, 128.0, 96.0))
    poses = np.stack([nadir_pose(26.0 + 2.0 * i, 32.0, 22.0)
                      for i in range(16)])
    frames = []
    for p in poses:
        img = degrade_frame(render_view(ground, cam, p), rng, blur_px=3.0,
                            noise=6.0)
        frames.append((img @ LUMA).astype(np.float32))
    cfg = slam_cfg(**{"FeatureDetector": "ORB", "SLAM.nFeature": 500,
                      "SLAM.LoopClose": 0, "SLAM.MinInitMatches": 60})
    slam = create_slam(cfg, cam, device=device)
    c.seconds, _ = _track_all(slam, frames)
    n = c.frames = len(poses)
    c.bar("tracked", slam.frames_tracked, ">=", 0.8 * n)
    ate, span = _tracked_ate(slam, poses)
    c.bar("ATE m", ate, "<", 0.05 * span)
    c.stats.update(tracked=f"{slam.frames_tracked}/{slam.frames_total}",
                   ate_m=ate, span_m=span,
                   closed_loops=slam.loop_closer.closed_loops,
                   keyframes=len(slam.map.keyframes()),
                   points=slam.map.point_num())
    return c


def soak(device):
    """tests/test_soak.py:27: 80 frames with everything on (GPS with 0.4 m
    noise, loop closing, culling, the FusionSystem feed), offline: more
    than 85 % tracked, no thread error, GPS fitted with keyframe geo ATE
    under 2 m, fewer than 0.75 keyframes a frame and 120 points a
    keyframe, more than half the frames fed, more than 20000 pixels
    covered."""
    from pislamfusion_tpu_torch.core.gps import LocalFrame
    from pislamfusion_tpu_torch.models.slam import create_slam
    c = Case("soak", "tests/test_soak.py:27", str(device))
    rng = np.random.default_rng(21)
    ground = _ground_on(survey_ground(rng), device)
    cam = _camera()
    poses = soak_poses()
    n = len(poses)
    c.bar("frames", n, ">=", 80)
    local = LocalFrame(116.0, 40.0, 0.0)
    cfg = slam_cfg(**{"FeatureDetector": "ORB", "SLAM.nFeature": 500,
                      "SLAM.MaxOverlap": 0.9, "SLAM.LoopClose": 1,
                      "SLAM.isOnline": 0, "SLAM.BAFrameCap": 8,
                      "SLAM.BAPointCap": 1024, "SLAM.BAObsCap": 4096,
                      "SLAM.LocalBAIters": 6, "Plane.MinPoints": 400,
                      "GPS.MinFrames2Fit": 5})
    slam = create_slam(cfg, cam, device=device)
    fusion = _fusion(cfg, cam, slam, device)
    t0 = time.perf_counter()
    for i, p in enumerate(poses):
        img = render_view(ground, cam, p)
        lla = local.local_to_lla(p[:3] + rng.normal(0, 0.4, 3))
        slam.track(img, float(i), gps_lla=lla, gps_acc=0.5)
    slam.finish(JOIN_S)
    ended = fusion.finish(JOIN_S)
    c.seconds, c.frames = time.perf_counter() - t0, n
    c.bar("tracked share", slam.frames_tracked / slam.frames_total, ">",
          0.85)
    c.bar("track errors", slam.track_errors, "==", 0)
    c.bar("gps_fitted", slam.mapper.gps_fitted, "==", True)
    kfs = slam.map.keyframes()
    est = np.stack([f.pose_c2w[:3] for f in kfs])
    gt = np.stack([slam._local_frame.to_local(
        *local.local_to_lla(poses[f.id][:3])) for f in kfs])
    geo = float(np.sqrt(np.mean(np.sum((est - gt) ** 2, -1))))
    c.bar("keyframe geo ATE m", geo, "<", 2.0)
    c.bar("keyframes", len(kfs), "<", 0.75 * n)
    c.bar("points", slam.map.point_num(), "<", 120 * len(kfs))
    c.bar("frames fed", fusion.frames_fed, ">", 0.5 * n)
    c.bar("consumer ended without error", ended and not fusion.alive(),
          "==", True)
    covered = fusion.map2d.blended()[1] if fusion.map2d is not None else None
    c.bar("covered pixels", int(covered.sum()) if covered is not None
          else 0, ">", 20000)
    c.stats.update(tracked=f"{slam.frames_tracked}/{slam.frames_total}",
                   closed_loops=slam.loop_closer.closed_loops,
                   geo_ate_m=geo, keyframes=len(kfs),
                   points=slam.map.point_num(),
                   frames_refreshed=fusion.frames_refreshed)
    return c


def race_hunt(device, chain):
    """tests/test_soak.py:125: 250 frames online (loop closing by BoW, GPS,
    culling, the FusionSystem feed) per frame (chain 1) or through
    Tracker.track_chain (chain 3): no tracking-thread error, every frame
    counted, a map left; every thread ends within JOIN_S."""
    from pislamfusion_tpu_torch.core.gps import LocalFrame
    from pislamfusion_tpu_torch.models.slam import create_slam
    c = Case(f"race hunt, chain {chain}", "tests/test_soak.py:125",
             str(device))
    rng = np.random.default_rng(31)
    ground = _ground_on(survey_ground(rng), device)
    cam = _camera()
    poses = race_poses()
    local = LocalFrame(116.0, 40.0, 0.0)
    cfg = slam_cfg(**{"FeatureDetector": "ORB", "SLAM.nFeature": 400,
                      "SLAM.MaxOverlap": 0.9, "SLAM.LoopClose": 1,
                      "LoopDetector": "BoW", "SLAM.isOnline": 1,
                      "SLAM.BAFrameCap": 8, "SLAM.BAPointCap": 1024,
                      "SLAM.BAObsCap": 4096, "SLAM.LocalBAIters": 6,
                      "Plane.MinPoints": 400, "GPS.MinFrames2Fit": 5,
                      "SLAM.TrackChain": chain})
    slam = create_slam(cfg, cam, device=device)
    fusion = _fusion(cfg, cam, slam, device)
    rng2 = np.random.default_rng(32)
    t0 = time.perf_counter()
    for i, p in enumerate(poses):
        img = render_view(ground, cam, p)
        lla = local.local_to_lla(p[:3] + rng2.normal(0, 0.4, 3))
        slam.track(img, float(i), gps_lla=lla, gps_acc=0.5)
    done = slam.finish(JOIN_S)
    ended = fusion.finish(JOIN_S)
    c.seconds, c.frames = time.perf_counter() - t0, len(poses)
    c.bar("threads ended", done and not fusion.alive(), "==", True)
    c.bar("track errors", slam.track_errors, "==", 0)
    c.bar("mapper worker errors", slam.mapper.worker_errors, "==", 0)
    c.bar("frames counted", slam.frames_total, "==", len(poses))
    c.bar("points", slam.map.point_num(), ">", 0)
    c.stats.update(tracked=f"{slam.frames_tracked}/{slam.frames_total}",
                   closed_loops=slam.loop_closer.closed_loops,
                   gps_fitted=slam.mapper.gps_fitted,
                   keyframes=len(slam.map.keyframes()),
                   points=slam.map.point_num(),
                   frames_fed=fusion.frames_fed, consumer_ok=ended,
                   longest_chain=max(slam.tracker.chain_lengths, default=1))
    return c


def real_sequence(device):
    """tests/test_real_sequence.py:82: the 114-frame lawnmower over the
    photograph with exposure steps, noisy GPS, loop closing and the
    FusionSystem: more than 85 % tracked, GPS fitted, ATE under 2 m, at
    least 60 frames fed and a refresh, mosaic coverage over 0.25 and PSNR
    over 10.5 dB, result.png written (into a temporary directory)."""
    import tempfile
    from pislamfusion_tpu_torch.core.gps import LocalFrame
    from pislamfusion_tpu_torch.models.slam import create_slam
    examples = os.path.join(ROOT, "examples")
    if examples not in sys.path:
        sys.path.insert(0, examples)
    from torch_pipeline_demo import mosaic_psnr_vs_truth
    c = Case("real sequence", "tests/test_real_sequence.py:82", str(device))
    ground_np = sequence_ground()
    ground = _ground_on(ground_np, device)
    cam = _camera()
    poses, strips = sequence_trajectory()
    cfg = slam_cfg(**{"FeatureDetector": "ORB", "SLAM.nFeature": 600,
                      "SLAM.MaxOverlap": 0.95, "SLAM.LoopClose": 1,
                      "Plane.MinPoints": 400, "PrepareFrameNum": 8,
                      "Map2D.BandNumber": 4}, **BA_SMALL)
    slam = create_slam(cfg, cam, device=device)
    fusion = _fusion(cfg, cam, slam, device)
    local = LocalFrame(108.9, 34.0, 0.0)
    rng = np.random.default_rng(21)
    t0 = time.perf_counter()
    for i, p in enumerate(poses):
        img = render_view(ground, cam, p)
        g, b = sequence_exposure(i, int(strips[i]))
        img = np.clip(img * g + b, 0, 255).astype(np.float32)
        noisy = p[:3] + rng.normal(0, 0.5, 3)
        slam.track(img, float(i), gps_lla=local.local_to_lla(noisy),
                   gps_acc=0.5)
    slam.finish(JOIN_S)
    slam.mapper.force_plane()
    ended = fusion.finish(JOIN_S)
    c.seconds, c.frames = time.perf_counter() - t0, len(poses)
    c.bar("consumer ended without error", ended and not fusion.alive(),
          "==", True)
    c.bar("tracked share", slam.frames_tracked / max(slam.frames_total, 1),
          ">", 0.85)
    c.bar("gps_fitted", slam.mapper.gps_fitted, "==", True)
    ate, span = _tracked_ate(slam, poses)
    c.bar("ATE m", ate, "<", 2.0)
    c.bar("mosaic and plane", fusion.map2d is not None
          and slam.plane is not None, "==", True)
    c.bar("frames fed", fusion.frames_fed, ">=", 60)
    c.bar("frames refreshed", fusion.frames_refreshed, ">", 0)
    psnr = cov = 0.0
    if fusion.map2d is not None:
        import torch
        from pislamfusion_tpu_torch.ops import ransac
        frames = [f for f in slam.map.frames()
                  if f.n_tracked() > 0 or f.is_keyframe]
        est = np.stack([f.pose_c2w[:3] for f in frames]).astype(np.float32)
        gt = poses[np.asarray([f.id for f in frames])][:, :3].astype(
            np.float32)
        S = ransac.sim3_horn(torch.from_numpy(gt), torch.from_numpy(est))
        psnr, cov = mosaic_psnr_vs_truth(fusion.map2d, ground_np,
                                         S.numpy())
    c.bar("coverage", cov, ">", 0.25)
    c.bar("PSNR dB", psnr, ">", 10.5)
    with tempfile.TemporaryDirectory() as out:
        png = os.path.join(out, "result.png")
        fusion.save(png)
        c.bar("result.png written", os.path.exists(png), "==", True)
    c.stats.update(tracked=f"{slam.frames_tracked}/{slam.frames_total}",
                   closed_loops=slam.loop_closer.closed_loops, ate_m=ate,
                   keyframes=len(slam.map.keyframes()),
                   points=slam.map.point_num(), span_m=span,
                   frames_fed=fusion.frames_fed,
                   frames_refreshed=fusion.frames_refreshed)
    return c


# the cases run on the card: name -> case function of the device
CARD_CASES = {
    "loop": loop_closing,
    "gps": gps_fusion,
    "circuit": real_texture_circuit,
    "parallax": parallax_slam,
    "blur": blur_noise_slam,
    "soak": soak,
    "race1": lambda d: race_hunt(d, 1),
    "race3": lambda d: race_hunt(d, 3),
    "sequence": real_sequence,
}


def run_cases(names, device, wrappers, card):
    """Run the cases `names` (keys of CARD_CASES) on `device`, each with
    every launch count of `wrappers` ({kernel: wrapper}) set to 0 just
    before and read just after; print each case's
    line, its launches (also kept as the case's `launches`) and its peak
    device memory. Returns (cases, the launches summed over them)."""
    import torch
    cuda = torch.device(device).type == "cuda"
    total = {k: 0 for k in wrappers}
    cases = []
    prefix = "e2e (phase 2h)"
    for name in names:
        fn = CARD_CASES[name]
        if cuda:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        for w in wrappers.values():
            w.launches = 0
        c = fn(device)
        if cuda:
            torch.cuda.synchronize()
        c.launches = launches = {k: w.launches for k, w in wrappers.items()}
        for k, v in launches.items():
            total[k] += v
        cases.append(c)
        print(c.line(prefix) + f"; {card}", flush=True)
        peak = (f"{torch.cuda.max_memory_allocated() / 2 ** 20:.1f} MiB"
                if cuda else "not measured (CPU)")
        print(f"{prefix} {c.name} launches: " + ", ".join(
            f"{k} {v}" for k, v in launches.items())
            + f"; peak device memory {peak}", flush=True)
    return cases, total
