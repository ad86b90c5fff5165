"""The port's fused system (models/fusion, io/exporters, io/tiles, viz,
core/memory_metric, the `_build.load` lock) against the JAX package's, on
the CPU.

The fusion consumer runs inline (`_finishing` set, then `run()`) on a
scripted queue that hands out the same (image, pose, meta) items to both
packages and publishes the same fake `map_transformed` events at the
same points of the stream, so both consume one deterministic sequence
(the JAX package's own tests race a thread against sleeps). The world is
tests/test_refresh.py's: 320x240 nadir frames (fx 260) at 25 m over
`synth_survey.make_ground`, 3 bands; the mosaics of the three
test_refresh.py cases (partial deformation, rotational gauge, plane-move
rebase) at its Map2D.Scale 1, the ADVICE r5 cases at Map2D.Scale 0.5.

Tolerances: `frames_fed`, `frames_refreshed` and coverage exactly; the
feed gauge within 1e-6 (float64 fits of the same poses); the blended
mosaics >= 40 dB PSNR against each other over the covered pixels (the
JAX package's XLA programs and the port's eager ops sum in other orders,
and a refresh re-renders on top of f32 bands); `TrajectoryLength`
exactly.

ADVICE r5 (ROADMAP queue 3): the port holds the fixed behaviour of four
faulty branches of the JAX package's `fusion.py`. Each case below is
built to reach its branch and shows the port's result beside the JAX
package's faulty one:
  (a) :533, a rebase whose re-feeds are all refused: the port keeps the
      old canvas, the JAX package swaps in the empty new one;
  (b) :445, the fallback for fewer than 3 resolved poses under a feed
      gauge: the port refreshes at the gauged pose, the JAX package at
      the raw map pose;
  (c) :449, a rebase that drops an off-plane entry: the port's cache
      holds only what the new canvas was fed, the JAX package's the
      dropped entry too;
  (d) :572, frames queued before a refit: the port gauges them by the
      epoch they were tracked in, the JAX package with the post-refit
      gauge.

Exporters: `export_geo_tiles` from one stub engine byte-equal (wgs84 and
gcj02); `save_map2dfusion` / `save_mapfusion` on test_exporters.py's tiny
map: the same files byte for byte, and on exactly planar points the same
fitted plane within 1e-5; viz PNGs byte-equal to the JAX package's
through its own zlib encoder; tiles as in test_tiles_resource.py, equal
to the JAX package's.
"""
import os
import sys
import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from pislamfusion_tpu.core.messenger import messenger as jmessenger
from pislamfusion_tpu.core.camera import Camera as JCamera
from pislamfusion_tpu.core.svar import Svar as JSvar
from pislamfusion_tpu.models import fusion as jfusion
from pislamfusion_tpu.utils import host_se3 as hse3
import chip_smoke
from pislamfusion_tpu_torch import _build
from pislamfusion_tpu_torch.core.messenger import DataTrans
from pislamfusion_tpu_torch.core.messenger import messenger as tmessenger
from pislamfusion_tpu_torch.core.camera import Camera
from pislamfusion_tpu_torch.core.svar import Svar
from pislamfusion_tpu_torch.models import fusion as tfusion
from torch_port_reference import torch_one_thread  # noqa: F401

CAM = chip_smoke.FUSION_CAM
GAUGE_TOL, PSNR_MIN = chip_smoke.FUSION_GAUGE_TOL, chip_smoke.FUSION_PSNR
FakeMap, gauge_pose = chip_smoke.FakeMap, chip_smoke.gauge_pose
fusion_items = chip_smoke.fusion_items


@pytest.fixture(scope="module")
def world():
    """tests/test_refresh.py's ground (seed 0) and 16 lawnmower frames
    (chip_smoke.fusion_world, the port's renderer)."""
    return chip_smoke.fusion_world()


def run_fusion(pkg, items, events, scale=None, patch=None):
    """One inline consumer run of package `pkg` ("jax" or "torch") over
    `items` (chip_smoke.run_fusion); events {index: FakeMap} are published
    when item `index` is asked for, patch(fusion) runs just before the
    first."""
    if pkg == "torch":
        return chip_smoke.run_fusion(
            tfusion.FusionSystem, chip_smoke.fusion_cfg(Svar, scale),
            Camera(*CAM), items, events, tmessenger, patch, device="cpu")
    return chip_smoke.run_fusion(
        jfusion.FusionSystem, chip_smoke.fusion_cfg(JSvar, scale),
        JCamera(*CAM), items, events, jmessenger, patch)


def _psnr_vs_ground(map2d, ground):
    """tests/test_refresh.py's _psnr of a mosaic against the ground."""
    img, covered = map2d.blended()
    ys, xs = np.nonzero(covered)
    lp, min_xy = map2d.length_pixel, map2d.min_xy
    gx = np.clip(((min_xy[0] + (xs + 0.5) * lp) / 0.1).astype(int), 0,
                 ground.shape[1] - 1)
    gy = np.clip(((min_xy[1] + (ys + 0.5) * lp) / 0.1).astype(int), 0,
                 ground.shape[0] - 1)
    d = img[ys, xs].astype(np.float64) - ground[gy, gx]
    return 10 * np.log10(255.0 ** 2 / max((d ** 2).mean(), 1e-12))


def assert_agree(jf, tf):
    assert tf.frames_fed == jf.frames_fed
    assert tf.frames_refreshed == jf.frames_refreshed
    if jf._feed_gauge is None:
        assert tf._feed_gauge is None
    else:
        np.testing.assert_allclose(tf._feed_gauge, jf._feed_gauge,
                                   atol=GAUGE_TOL)
    img_j, cov_j = jf.map2d.blended()
    img_t, cov_t = tf.map2d.blended()
    assert img_j.shape == img_t.shape
    assert np.array_equal(cov_j, cov_t)
    assert chip_smoke.mosaic_psnr(img_t, img_j, cov_j) >= PSNR_MIN
    np.testing.assert_allclose(tf.map2d.plane, jf.map2d.plane, atol=1e-9)
    np.testing.assert_allclose(tf.map2d.min_xy, jf.map2d.min_xy, atol=1e-9)


# ---------------------------------------------------------------------------
# the three tests/test_refresh.py fusion cases, JAX against port
# ---------------------------------------------------------------------------

CASES = ("partial_deformation", "rotational_gauge", "plane_move_rebase")


def _case_rebase(frames, poses):
    return chip_smoke.fusion_cases(frames, poses)["plane_move_rebase"]


@pytest.mark.parametrize("case", CASES)
def test_refresh_cases_match_reference(case, world, torch_one_thread):
    ground, poses, frames = world
    items, events = chip_smoke.fusion_cases(frames, poses)[case]
    jf = run_fusion("jax", items, events)
    tf = run_fusion("torch", items, events)
    assert_agree(jf, tf)
    # test_refresh.py's own bars, on the port
    if case == "partial_deformation":
        assert tf.frames_refreshed > 0
    elif case == "rotational_gauge":
        assert tf.frames_refreshed == 0
    else:
        assert tf.frames_refreshed >= 12 and tf.frames_fed == 16
        assert not np.allclose(tf.map2d.plane, [0, 0, 0, 0, 0, 0, 1.0])


# ---------------------------------------------------------------------------
# ADVICE r5 (a)-(d): the port's fixed branches beside the JAX package's
# ---------------------------------------------------------------------------

def _clean_psnr(frames, poses, ground, scale):
    """PSNR against the ground of the known-pose mosaic of all frames."""
    from pislamfusion_tpu_torch.models.map2d import create_map2d
    m = create_map2d("3", chip_smoke.fusion_cfg(Svar, scale), device="cpu")
    assert m.prepare(np.array([0, 0, 0, 0, 0, 0, 1.0]), Camera(*CAM),
                     [(None, p) for p in poses])
    for f, p in zip(frames, poses):
        m.feed(f, p)
    return _psnr_vs_ground(m, ground)


def test_advice_a_rebase_keeps_the_canvas_when_no_refeed_lands(
        world, torch_one_thread):
    """Fix (a): every re-feed of a rebase is refused (the re-derived
    engine is made to refuse its first 12 feeds, the rebase's): the port
    keeps its canvas and falls through to the gauge on it, so the frames
    after the refit land consistently; the JAX package swaps in the new
    canvas, which lost frames 0-11, and gauges the later frames into the
    old frame, which the new canvas is not in."""
    ground, poses, frames = world
    items, events = _case_rebase(frames, poses)
    kept = {}

    def refusing(engine, n=12):
        feed, left = engine.feed, [n]

        def refuse_first(img, pose):
            if left[0] > 0:
                left[0] -= 1
                return False
            return feed(img, pose)
        engine.feed = refuse_first
        return engine

    def patch(fus):
        kept["map2d"] = fus.map2d
        if isinstance(fus, tfusion.FusionSystem):
            make = fus._new_map2d
            fus._new_map2d = lambda: refusing(make())
        else:
            jfusion.create_map2d = lambda *a, **k: refusing(make_j(*a, **k))

    make_j = jfusion.create_map2d
    try:
        jf = run_fusion("jax", items, events, scale=0.5, patch=patch)
    finally:
        jfusion.create_map2d = make_j
    j_map = jf.map2d is not kept["map2d"]
    tf = run_fusion("torch", items, events, scale=0.5, patch=patch)
    assert tf.map2d is kept["map2d"]                 # the old canvas
    assert tf.frames_refreshed == 0 and tf.frames_fed == 16
    S = tf._feed_gauge
    assert S is not None                             # gauge fall-through
    # the gauge maps the new world onto the old canvas frame
    new_world = chip_smoke.fusion_new_world(poses)
    np.testing.assert_allclose(hse3.sim3_apply_se3(S, new_world[13])[:3],
                               poses[13][:3], atol=1e-6)
    t_psnr = _psnr_vs_ground(tf.map2d, ground)
    assert t_psnr > _clean_psnr(frames, poses, ground, 0.5) - 2.0
    # the JAX package: the re-derived canvas, without frames 0-11
    assert j_map
    assert jf.map2d.blended()[1].mean() < 0.5 * tf.map2d.blended()[1].mean()


def test_advice_b_fallback_refresh_is_gauged(world, torch_one_thread):
    """Fix (b): a gauge is set by a first (pure gauge) refit; a second
    event resolves only frames 0 and 1, correcting their 1.5 m drift.
    The port re-renders them at the gauged poses (the truth in the canvas
    frame); the JAX package at the raw map poses, off by the gauge."""
    ground, poses, frames = world
    poses, frames = poses[:10], frames[:10]
    fed = poses.copy()
    fed[:2, 0] += 1.5
    gauge = gauge_pose([0.8, -0.6, 0.0], 2, 0.004)
    moved = np.stack([hse3.se3_mul(gauge, p) for p in fed])
    # frames 8 and 9 are tracked after the first refit, in its world
    fed[8:] = moved[8:]
    metas = [(1000 + i, 1000 + i, p.copy()) for i, p in enumerate(fed)]
    ev1 = FakeMap({1000 + i: p for i, p in enumerate(moved)})
    ev2 = FakeMap({1000 + i: hse3.se3_mul(gauge, poses[i])
                   for i in range(2)})
    items = fusion_items(frames, fed, metas)
    runs = {pkg: run_fusion(pkg, items, {8: ev1, 10: ev2}, scale=0.5)
            for pkg in ("jax", "torch")}
    for fus in runs.values():
        assert fus.frames_refreshed > 0
    cached = {pkg: {m[0]: pose for m, _img, pose in fus._refresh_cache}
              for pkg, fus in runs.items()}
    for i in range(2):
        np.testing.assert_allclose(cached["torch"][1000 + i], poses[i],
                                   atol=1e-6)
        # the JAX package cached (and rendered) the ungauged map pose
        np.testing.assert_allclose(cached["jax"][1000 + i],
                                   hse3.se3_mul(gauge, poses[i]), atol=1e-6)
    assert _psnr_vs_ground(runs["torch"].map2d, ground) > \
        _psnr_vs_ground(runs["jax"].map2d, ground) + 0.5


def test_advice_c_rebase_caches_only_what_was_fed(world, torch_one_thread):
    """Fix (c): the refit puts frame 3's new pose below the plane, so the
    rebase drops it. The port's cache then holds the 11 entries the new
    canvas was fed; the JAX package's all 12, the dropped one too."""
    ground, poses, frames = world
    items, events = _case_rebase(frames, poses)
    fake = events[12]
    bad = fake.store[1003].pose_c2w.copy()
    bad[2] = -bad[2]
    fake.store[1003] = SimpleNamespace(pose_c2w=bad)
    runs = {pkg: run_fusion(pkg, items, events, scale=0.5)
            for pkg in ("jax", "torch")}
    ids = {pkg: [m[0] for m, _i, _p in fus._refresh_cache]
           for pkg, fus in runs.items()}
    assert runs["torch"].frames_refreshed == runs["jax"].frames_refreshed \
        == 11
    assert 1003 not in ids["torch"] and len(ids["torch"]) == 15
    assert 1003 in ids["jax"] and len(ids["jax"]) == 16
    # the rest of the two runs agree
    assert_agree(runs["jax"], runs["torch"])


def test_advice_d_queued_frames_keep_their_epoch(world, torch_one_thread):
    """Fix (d): frames 4-7 were queued before a refit (a 0.8 m, 0.004 rad
    gauge) that is processed when frame 4 comes out; frames 8-11 were
    tracked after it, in the new world. The port gauges 4-7 by their
    stamp (the old epoch: no gauge) and 8-11 with the refit's gauge; the
    JAX package gauges 4-7 with the refit's gauge too, off by it."""
    ground, poses, frames = world
    poses, frames = poses[:12], frames[:12]
    gauge = gauge_pose([0.8, -0.6, 0.0], 2, 0.004)
    new_world = np.stack([hse3.se3_mul(gauge, p) for p in poses])
    fed = np.concatenate([poses[:8], new_world[8:]])
    c0 = tmessenger.published(*tfusion.TRANSFORM_TOPICS)
    metas_j = [(1000 + i, 1000 + i, p.copy()) for i, p in enumerate(fed)]
    metas_t = [m + (c0 if i < 8 else c0 + 1,) for i, m in enumerate(metas_j)]
    fake = FakeMap({1000 + i: new_world[i] for i in range(12)})
    jf = run_fusion("jax", fusion_items(frames, fed, metas_j), {4: fake},
                    scale=0.5)
    tf = run_fusion("torch", fusion_items(frames, fed, metas_t), {4: fake},
                    scale=0.5)
    assert tf.frames_fed == jf.frames_fed == 12
    cached = {id(f): {m[0]: pose for m, _img, pose in f._refresh_cache}
              for f in (jf, tf)}
    for i in range(12):
        np.testing.assert_allclose(cached[id(tf)][1000 + i], poses[i],
                                   atol=1e-6)
    S = jf._feed_gauge
    for i in range(4, 8):
        np.testing.assert_allclose(cached[id(jf)][1000 + i],
                                   hse3.sim3_apply_se3(S, poses[i]),
                                   atol=1e-6)
    assert _psnr_vs_ground(tf.map2d, ground) > \
        _psnr_vs_ground(jf.map2d, ground) + 0.5


def test_unstamped_frames_take_the_current_gauge(world, torch_one_thread):
    """A frame without the epoch stamp (3-item meta) is gauged as the JAX
    package gauges it: with the current gauge (the case above, unstamped,
    gives the JAX package's result)."""
    ground, poses, frames = world
    poses, frames = poses[:12], frames[:12]
    gauge = gauge_pose([0.8, -0.6, 0.0], 2, 0.004)
    new_world = np.stack([hse3.se3_mul(gauge, p) for p in poses])
    fed = np.concatenate([poses[:8], new_world[8:]])
    metas = [(1000 + i, 1000 + i, p.copy()) for i, p in enumerate(fed)]
    fake = FakeMap({1000 + i: new_world[i] for i in range(12)})
    items = fusion_items(frames, fed, metas)
    assert_agree(run_fusion("jax", items, {4: fake}, scale=0.5),
                 run_fusion("torch", items, {4: fake}, scale=0.5))


# ---------------------------------------------------------------------------
# TrajectoryLength, TestMap2D playback, the threaded consumer
# ---------------------------------------------------------------------------

def test_trajectory_length_matches_reference():
    pts = np.random.default_rng(3).normal(0, 10, (50, 3))
    a, b = jfusion.TrajectoryLength(), tfusion.TrajectoryLength()
    for p in pts:
        a.feed(p)
        b.feed(p)
    assert a.length == b.length
    t = tfusion.TrajectoryLength()
    for p in ([0, 0, 0], [3, 4, 0], [3, 4, 12]):
        t.feed(p)
    assert t.length == 17.0


def write_playback_dataset(root, n=6):
    """tests/test_fusion.py's playback folder, its images real JPEGs
    (quality 92, decoded by PIL in the JAX package and by the native
    decoder in the port)."""
    from PIL import Image
    rng = np.random.default_rng(5)
    os.makedirs(os.path.join(root, "rgb"), exist_ok=True)
    with open(os.path.join(root, "config.cfg"), "w") as f:
        f.write("Plane=0 0 0 0 0 0 1\n"
                "Camera.Paraments=160 120 130 130 80 60\n"
                "Map2D.BandNumber=3\n")
    with open(os.path.join(root, "trajectory.txt"), "w") as tf:
        for i in range(n):
            name = f"{float(i):.6f}"
            img = rng.uniform(0, 255, (120, 160, 3)).astype(np.uint8)
            Image.fromarray(img).save(os.path.join(root, "rgb",
                                                   name + ".jpg"),
                                      quality=92)
            tf.write(f"{name} {25.0 + i * 2.0} 30.0 20.0 1 0 0 0\n")


def test_testmap2d_playback_matches_reference(tmp_path, torch_one_thread):
    root = str(tmp_path / "ds")
    write_playback_dataset(root)
    runs = []
    for cls, fus_mod, kw in ((JSvar, jfusion, {}),
                             (Svar, tfusion, {"device": "cpu"})):
        cfg = cls()
        cfg.set("Map2D.Act", "TestMap2D")
        cfg.set("Map2D.DataPath", root)
        cfg.set("PrepareFrameNum", "3")
        fus = fus_mod.FusionSystem(cfg, **kw)
        fus.run()
        assert fus.error is None, fus.error
        runs.append(fus)
    jf, tf = runs
    assert tf.frames_fed == jf.frames_fed == 6
    assert tf.length_calc.length == jf.length_calc.length
    img_j, cov_j = jf.map2d.blended()
    img_t, cov_t = tf.map2d.blended()
    assert np.array_equal(cov_j, cov_t) and cov_t.any()
    assert chip_smoke.mosaic_psnr(img_t, img_j, cov_j) >= PSNR_MIN
    out = str(tmp_path / "result.png")
    assert tf.save(out) and os.path.getsize(out) > 0


def test_consumer_thread_prepares_and_feeds(world, torch_one_thread):
    """test_fusion.py's Map2DWithSLAM consumer, in its thread: frames
    through the queue, the plane through the plane queue, `finish`."""
    ground, poses, frames = world
    tq, pq = DataTrans(30), DataTrans(30)
    cfg = Svar()
    cfg.set("PrepareFrameNum", "3")
    cfg.set("Camera.Paraments", " ".join(str(v) for v in CAM))
    cfg.set("Map2D.BandNumber", "3")
    cfg.set("Map2D.Scale", "0.5")
    fus = tfusion.FusionSystem(cfg, trans_q=tq, plane_q=pq,
                               device="cpu").start()
    for f, p in zip(frames[:6], poses[:6]):
        tq.product((f, p.copy()))
    pq.product(np.array([0, 0, 0, 0, 0, 0, 1.0]))
    assert fus.finish(timeout=120)
    assert not fus.alive()
    assert fus.error is None, fus.error
    assert fus.frames_fed == 6 and fus.map2d.blended()[1].any()


def test_fusion_defaults_to_cuda_and_raises_without_it():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is usable")
    with pytest.raises(RuntimeError, match="CUDA"):
        tfusion.FusionSystem(Svar())


# ---------------------------------------------------------------------------
# _build.load from several threads
# ---------------------------------------------------------------------------

def test_build_load_builds_once_from_many_threads(monkeypatch):
    """The fusion consumer and SLAM's thread may first use one kernel at
    once: `load` must build it once (two builds would both write one
    temporary file)."""
    calls = {"start": 0, "finish": 0, "cdll": 0}

    def fake_start(name):
        calls["start"] += 1
        time.sleep(0.05)                  # widen the window of the race
        return object(), "tmp", "out"

    def fake_finish(name, proc, tmp, out):
        calls["finish"] += 1
        return ""

    def fake_cdll(path):
        calls["cdll"] += 1
        return SimpleNamespace(path=path)

    monkeypatch.setattr(_build, "_start", fake_start)
    monkeypatch.setattr(_build, "_finish", fake_finish)
    monkeypatch.setattr(_build.ctypes, "CDLL", fake_cdll)
    monkeypatch.delitem(_build._LIBS, "fake_kernel", raising=False)
    n = 16                                # more threads than cores
    barrier = threading.Barrier(n)
    got = []

    def worker():
        barrier.wait()
        got.append(_build.load("fake_kernel"))

    threads = [threading.Thread(target=worker) for _ in range(n)]
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
    finally:
        sys.setswitchinterval(switch)
        _build._LIBS.pop("fake_kernel", None)
    assert not any(t.is_alive() for t in threads)
    assert calls == {"start": 1, "finish": 1, "cdll": 1}
    assert len(got) == n and all(g is got[0] for g in got)


# ---------------------------------------------------------------------------
# exporters, viz, tiles, memory metric
# ---------------------------------------------------------------------------

class StubEngine:
    """An engine for export_geo_tiles: blended(), length_pixel, min_xy,
    plane."""

    def __init__(self, rng):
        self.out = rng.uniform(0, 255, (600, 800, 3)).astype(np.float32)
        self.covered = np.zeros((600, 800), bool)
        self.covered[50:520, 80:700] = True
        self.length_pixel = 0.2
        self.min_xy = np.array([-20.0, -35.0])
        self.plane = np.concatenate([[1.0, -2.0, 0.5],
                                     gauge_pose([0, 0, 0], 2, 0.3)[3:]])

    def blended(self):
        return self.out.copy(), self.covered.copy()


def _files(root):
    out = {}
    for r, _, fs in os.walk(root):
        for f in fs:
            p = os.path.join(r, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = fh.read()
    return out


@pytest.fixture
def jax_native_png(monkeypatch):
    """The JAX package's native PNG writer loaded in this process wherever
    the port's is, so that both packages write with one encoder.

    Under pytest-xdist every worker imports tests/test_native_io.py, whose
    `skipif` loads the JAX package's library at collection: the workers
    build native/libpsfimageio.so in place at once
    (pislamfusion_tpu/io/native_io.py:27-39), and a worker that opens it
    half-written ("file too short") writes through PIL for the rest of
    its life, other bytes (and no PNG at all to a `.tmp` name, as
    `viz.Visualizer._atomic` writes). By the time a test runs the library
    is whole: load it again."""
    from pislamfusion_tpu.io import native_io as jnative
    from pislamfusion_tpu_torch.io import native_io as tnative
    if jnative._lib is None and tnative.available():
        monkeypatch.setattr(jnative, "_build_failed", False)
        assert jnative.get_lib() is not None
    assert (jnative._lib is not None) == tnative.available()


@pytest.mark.parametrize("datum", ["wgs84", "gcj02"])
def test_geo_tiles_byte_equal(datum, tmp_path, jax_native_png):
    from pislamfusion_tpu.io import exporters as jex
    from pislamfusion_tpu_torch.io import exporters as tex
    eng = StubEngine(np.random.default_rng(9))
    origin = [116.35, 39.96, 40.0]
    n_j = jex.export_geo_tiles(eng, origin, str(tmp_path / "j"), zoom=19,
                               datum=datum)
    n_t = tex.export_geo_tiles(eng, origin, str(tmp_path / "t"), zoom=19,
                               datum=datum)
    assert n_t == n_j > 1
    fj, ft = _files(str(tmp_path / "j")), _files(str(tmp_path / "t"))
    assert sorted(fj) == sorted(ft)
    assert all(fj[k] == ft[k] for k in fj)


def _tiny_map(pkg, planar=False):
    """tests/test_exporters.py's tiny map, built from `pkg`'s classes from
    seed 0 (its points exactly on z=0 with `planar`)."""
    import importlib
    Frame = importlib.import_module(f"{pkg}.models.frame")
    WorldMap = importlib.import_module(f"{pkg}.models.worldmap").WorldMap
    Cam = importlib.import_module(f"{pkg}.core.camera").Camera
    rng = np.random.default_rng(0)
    m = WorldMap()
    cam = Cam(320, 240, 260.0, 260.0, 160.0, 120.0)
    n_kp = 32
    for i in range(4):
        fr = Frame.Frame(id=m.get_fid(), timestamp=float(i), camera=cam)
        feats = dict(
            xy=rng.uniform(0, 320, (n_kp, 2)).astype(np.float32),
            desc=rng.integers(0, 2, (n_kp, 256)).astype(np.uint8),
            angle=rng.uniform(0, 6.28, n_kp).astype(np.float32),
            octave=rng.integers(0, 4, n_kp).astype(np.int32),
            response=rng.uniform(0, 1, n_kp).astype(np.float32),
            valid=np.ones(n_kp, bool))
        fr.set_features(feats, "orb")
        fr.pose_c2w = np.array([i * 2.0, 0, 25, 1, 0, 0, 0], np.float32)
        fr.is_keyframe = True
        fr.gps_lla = np.array([116.0 + i * 1e-5, 40.0, 65.0])
        fr.gps_enu = np.array([i * 2.0, 0, 25], np.float32)
        fr.image = np.full((240, 320), 128, np.float32)
        fr.image[40:120, 60:200] = rng.uniform(0, 255, (80, 140))
        m.insert_frame(fr)
    frames = m.frames()
    for j in range(40):
        mp = Frame.MapPoint(id=m.get_pid(),
                            position=rng.uniform(-5, 5, 3).astype(
                                np.float32),
                            descriptor=rng.integers(0, 2, 256).astype(
                                np.uint8))
        mp.position[2] = 0.0 if planar else rng.normal(0, 0.05)
        mp.color = rng.integers(0, 255, 3).astype(np.uint8)
        mp.ref_frame = frames[j % 4].id
        m.insert_point(mp)
        for fr in frames[:2]:
            m.add_observation(mp.id, fr.id, j % n_kp)
    return m


def test_map2dfusion_and_mapfusion_match_reference(tmp_path):
    from pislamfusion_tpu.io import exporters as jex
    from pislamfusion_tpu_torch.io import exporters as tex
    origin = [116.0, 40.0, 65.0]
    plane = np.array([0.5, -0.25, 0.0, 0, 0, 0, 1.0])
    jm, tm = _tiny_map("pislamfusion_tpu"), _tiny_map(
        "pislamfusion_tpu_torch")
    assert jex.save_map2dfusion(jm, str(tmp_path / "j"), plane=plane,
                                gps_origin=origin)
    assert tex.save_map2dfusion(tm, str(tmp_path / "t"), plane=plane,
                                gps_origin=origin, device="cpu")
    fj, ft = _files(str(tmp_path / "j")), _files(str(tmp_path / "t"))
    assert sorted(fj) == sorted(ft) and len(fj) == 6
    assert all(fj[k] == ft[k] for k in fj)
    assert jex.save_mapfusion(jm, str(tmp_path / "j.mf"))
    assert tex.save_mapfusion(tm, str(tmp_path / "t.mf"))
    with open(tmp_path / "j.mf", "rb") as a, open(tmp_path / "t.mf",
                                                  "rb") as b:
        assert a.read() == b.read()


def _cfg_lines(folder):
    with open(os.path.join(folder, "config.cfg")) as f:
        return f.read().splitlines()


def test_map2dfusion_plane_fit_matches_reference(tmp_path):
    """No plane given: both fit one to the map points (exactly planar
    here, so every draw agrees on the inliers): within 1e-5; the rest of
    the folder byte-equal."""
    from pislamfusion_tpu.io import exporters as jex
    from pislamfusion_tpu_torch.io import exporters as tex
    jm = _tiny_map("pislamfusion_tpu", planar=True)
    tm = _tiny_map("pislamfusion_tpu_torch", planar=True)
    assert jex.save_map2dfusion(jm, str(tmp_path / "j"))
    assert tex.save_map2dfusion(tm, str(tmp_path / "t"), device="cpu")
    lj, lt = _cfg_lines(str(tmp_path / "j")), _cfg_lines(str(tmp_path / "t"))
    pj = np.array([float(v) for v in lj[0].split("=")[1].split()])
    pt = np.array([float(v) for v in lt[0].split("=")[1].split()])
    np.testing.assert_allclose(pt, pj, atol=1e-5)
    assert lj[1:] == lt[1:]
    fj, ft = _files(str(tmp_path / "j")), _files(str(tmp_path / "t"))
    assert sorted(fj) == sorted(ft)
    assert all(fj[k] == ft[k] for k in fj if k != "config.cfg")


def test_viz_pngs_byte_equal(tmp_path, monkeypatch, jax_native_png):
    """The port writes PNGs with the JAX package's own zlib encoder (its
    last resort after the native writer and PIL): byte-equal to it, and
    equal in pixels to what the JAX package writes by default."""
    import sys
    from pislamfusion_tpu import viz as jviz
    from pislamfusion_tpu.io import native_io as jnative
    from pislamfusion_tpu.models.map2d import read_png
    from pislamfusion_tpu_torch import viz as tviz
    jm, tm = _tiny_map("pislamfusion_tpu"), _tiny_map(
        "pislamfusion_tpu_torch")

    def views(mod, m, d):
        v = mod.Visualizer(d, every=1)
        v.update(slam=SimpleNamespace(map=m), fusion=None,
                 frame=m.frames()[0])
        assert mod.save_map_view(m, os.path.join(d, "map2.png"))
        return _files(d)
    default = views(jviz, jm, str(tmp_path / "jdefault"))
    port = views(tviz, tm, str(tmp_path / "t"))
    monkeypatch.setattr(jnative, "save_png", lambda *a, **k: False)
    monkeypatch.setitem(sys.modules, "PIL", None)
    ref = views(jviz, jm, str(tmp_path / "j"))
    monkeypatch.undo()
    assert sorted(ref) == sorted(port) == sorted(default) == [
        "frame.png", "map.png", "map2.png"]
    assert all(ref[k] == port[k] for k in ref)
    for k in ref:
        np.testing.assert_array_equal(
            read_png(str(tmp_path / "t" / k)),
            read_png(str(tmp_path / "jdefault" / k)))


def test_tiles_match_reference(tmp_path):
    from pislamfusion_tpu.io import tiles as jt
    from pislamfusion_tpu_torch.io import tiles as tt
    assert tt.tile_hash(5, 5, 5) == jt.tile_hash(5, 5, 5) == \
        (5 << 48) | (5 << 24) | 5
    assert tt.tile_hash(1, 2, 3) != tt.tile_hash(2, 1, 3)
    rng = np.random.default_rng(2)
    imgs = [rng.integers(0, 255, (256, 256, 3)).astype(np.uint8)
            for _ in range(4)]
    mans = []
    for mod in (jt, tt):
        tm = mod.TileManager()
        for k, (x, y) in enumerate(((0, 0), (0, 1), (1, 0), (1, 1))):
            tm.set_tile(100 + x, 200 + y, 5, imgs[k])
        assert tm.build_parent_level(5) == 1
        mans.append(tm)
    np.testing.assert_array_equal(mans[1].get_tile(50, 100, 4).image,
                                  mans[0].get_tile(50, 100, 4).image)
    # save / load round trip
    assert mans[1].save(str(tmp_path)) == 5
    back = tt.TileManager.load(str(tmp_path))
    assert len(back) == 5
    np.testing.assert_array_equal(back.get_tile(100, 200, 5).image, imgs[0])
    # the LRU bound
    lru = tt.TileManager(max_bytes=3 * 256 * 256 * 3)
    for i in range(5):
        lru.set_tile(i, 0, 3, np.zeros((256, 256, 3), np.uint8))
    assert len(lru) <= 3
    assert lru.get_tile(4, 0, 3) is not None
    assert lru.get_tile(0, 0, 3) is None
    # lng/lat <-> tile
    for mod in (jt, tt):
        x, y = mod.lnglat_to_tile(116.35, 39.96, 15)
        (lng0, lat0), (lng1, lat1) = mod.tile_bounds(x, y, 15)
        assert lng0 <= 116.35 <= lng1 and lat1 <= 39.96 <= lat0
    assert tt.lnglat_to_tile(116.35, 39.96, 15) == \
        jt.lnglat_to_tile(116.35, 39.96, 15)


def test_memory_metric():
    from pislamfusion_tpu_torch.core import memory_metric as mm
    if not torch.cuda.is_available():
        assert mm.device_usage() == {}
    mm.enable()
    try:
        blob = [bytearray(200_000) for _ in range(4)]
        assert mm.used_bytes() > 500_000
        assert mm.peak_bytes() >= mm.used_bytes()
        assert "callsite" in mm.dump_by_size(top=5)
        assert "callsite" in mm.dump_by_count(top=5)
        del blob
    finally:
        mm.disable()
    assert mm.dump_by_size() == "(memory metric disabled)"
