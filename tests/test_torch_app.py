"""The port's app (`python -m pislamfusion_tpu_torch`) on the CPU.

tests/test_cli.py's unified `.npudronemap` dataset (config.cfg,
frames.txt, gps.txt and PNG images; 320x240, fx 260, two lawnmower rows
of 12 frames at 25 m, a GPS fix a frame with 0.4 m noise) through the
port's `run_slam` and `main` with `Device=cpu`. Whole SLAM runs are
chaotic in their floats (ROADMAP queue 3), so the runs are held to
test_cli.py's bars, not to a JAX run:

- `Act=SLAM` (`run_slam`, test_cli.py's config with SLAM.LoopClose=1
  and the mosaic at Map2D.Scale 0.5, a third of the CPU time):
  85 % of frames tracked, the map geo-registered by GPS, no fusion error
  and the consumer thread ended, frames fed > 0.8 x tracked, some frames
  refreshed, every artifact written (result.png, trajectory.txt,
  map.ply, viz, the Map2DFusion folder, the .mf file, geo tiles), geo
  ATE under 2.0 m after removing the common offset;
- `SLAM_Call Stop` from another thread ends the feed loop early;
- `Act=Survey` (test_cli_survey_engine's arguments): rc 0, result.png,
  one trajectory row a frame, tiles, ATE under 2.0 m, a covered mosaic;
- `Act=TestMap2D` plays a trajectory folder back;
- without `Device` every Act that computes raises on a machine without
  CUDA, and with several cards `Survey.Mesh` builds the segment-parallel
  survey's mesh of them.
"""
import os
import threading
import time

import numpy as np
import pytest
import torch

from pislamfusion_tpu_torch import app
from pislamfusion_tpu_torch.core.svar import Svar
from pislamfusion_tpu_torch.core.svar import scommand
from test_cli import _write_dataset
from torch_port_reference import torch_one_thread  # noqa: F401


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    """test_cli.py's two-row dataset (seed 4), written once."""
    root = str(tmp_path_factory.mktemp("ds"))
    return _write_dataset(root, np.random.default_rng(4))


def _slam_cfg(out, **extra):
    cfg = Svar()
    for k, v in (("SLAM.nFeature", 500), ("SLAM.BAFrameCap", 8),
                 ("SLAM.BAPointCap", 1024), ("SLAM.BAObsCap", 4096),
                 ("SLAM.LocalBAIters", 8), ("SLAM.LoopClose", 1),
                 ("Plane.MinPoints", 400), ("PrepareFrameNum", 8),
                 ("Map2D.BandNumber", 4), ("Map2D.Scale", 0.5),
                 ("Timer.Report", 0)):
        cfg.set(k, str(v))
    for k, v in extra.items():
        cfg.set(k, str(v))
    return cfg


def _geo_ate(est, gt):
    err = est - gt
    err = err - err.mean(0)       # remove the anchor common-mode offset
    return float(np.sqrt(np.mean(np.sum(err ** 2, -1))))


def test_run_slam_end_to_end(dataset, tmp_path, torch_one_thread):
    ds_file, poses, _ground = dataset
    out = str(tmp_path / "out")
    cfg = _slam_cfg(out, **{
        "Viz.Dir": os.path.join(out, "viz"), "Viz.Every": 10,
        "Map2DFusionFolder": os.path.join(out, "m2df"),
        "MapFusionFile": os.path.join(out, "map.mf"),
        "GeoTiles.Dir": os.path.join(out, "tiles")})
    slam, fusion = app.run_slam(cfg, [ds_file], out_dir=out, device="cpu")
    assert slam.frames_tracked >= 0.85 * slam.frames_total
    assert slam.mapper.gps_fitted, "dataset GPS must geo-register the map"
    assert fusion.error is None, fusion.error
    assert not fusion.alive()
    assert fusion.frames_fed > 0.8 * slam.frames_tracked
    assert fusion.frames_refreshed > 0
    for f in ("result.png", "trajectory.txt", "map.ply"):
        assert os.path.isfile(os.path.join(out, f)), f
    assert os.path.isfile(os.path.join(out, "viz", "map.png"))
    assert os.path.isfile(os.path.join(out, "m2df", "config.cfg"))
    assert os.path.isfile(os.path.join(out, "map.mf"))
    assert [f for _, _, fs in os.walk(os.path.join(out, "tiles"))
            for f in fs], "geo tiles missing"
    frames = [f for f in slam.map.frames()
              if f.n_tracked() > 0 or f.is_keyframe]
    est = np.stack([f.pose_c2w[:3] for f in frames])
    ids = np.asarray([int(round(f.timestamp)) for f in frames])
    ate = _geo_ate(est, poses[ids][:, :3])
    assert ate < 2.0, f"geo ATE {ate:.2f} m"
    # the exported Map2DFusion folder plays back through Act=TestMap2D
    rc = app.main(["Act=TestMap2D", f"Map2D.DataPath={out}/m2df",
                   f"Map.File2Save={out}/playback.png", "Device=cpu"],
                  cfg=Svar())
    assert rc == 0
    assert os.path.isfile(os.path.join(out, "playback.png"))


def test_slam_call_stop(dataset, tmp_path, torch_one_thread):
    """`SLAM_Call Stop` (gui/pislam.cpp:43) from another thread ends the
    feed loop before the dataset does."""
    ds_file, poses, _ground = dataset
    cfg = _slam_cfg(str(tmp_path), **{"SLAM.LoopClose": 0,
                                      "Dataset.NativeIO": 0,
                                      "Frequency": 4})

    def stopper():
        time.sleep(1.5)
        scommand.call("SLAM_Call Stop")
    t = threading.Thread(target=stopper, daemon=True)
    t.start()
    slam, fusion = app.run_slam(cfg, [ds_file], out_dir=str(tmp_path),
                                device="cpu")
    t.join()
    assert slam.frames_total < len(poses), "Stop did not end the feed loop"
    assert not fusion.alive()


def test_survey_act(dataset, tmp_path, torch_one_thread):
    """test_cli.py's test_cli_survey_engine through the port's main."""
    ds_file, poses, _ground = dataset
    out = str(tmp_path / "out")
    rc = app.main(["Act=Survey", ds_file, f"Out.Dir={out}",
                   "Survey.Height=25", "Survey.NFeature=512",
                   f"GeoTiles.Dir={os.path.join(out, 'tiles')}",
                   "Survey.Mesh=1", "Device=cpu"], cfg=Svar())
    assert rc == 0
    assert os.path.isfile(os.path.join(out, "result.png"))
    traj = np.loadtxt(os.path.join(out, "trajectory.txt"))
    assert traj.shape[0] == len(poses)
    assert [f for _, _, fs in os.walk(os.path.join(out, "tiles"))
            for f in fs if f.endswith(".png")], "geo tiles missing"
    ate = _geo_ate(traj[:, 1:3], poses[:, :2])
    assert ate < 2.0, f"survey ATE {ate:.2f} m"
    from pislamfusion_tpu_torch.io.dataset import imread
    img = imread(os.path.join(out, "result.png"))
    assert (img != 255).any(-1).sum() > 3000


@pytest.mark.parametrize("act", ["SLAM", "Survey", "TestMap2D"])
def test_main_without_device_needs_cuda(act, dataset, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        app.main([f"Act={act}", dataset[0]], cfg=Svar())


def test_survey_mesh_builds_a_mesh_of_cards(dataset, monkeypatch):
    """With four CUDA devices, `Survey.Mesh` 0 (all) and 4 run the
    segment-parallel survey over cuda:0-3, 2 over cuda:0-1, and 1 the
    serial FastVO (the cards are faked: FastVO and process_survey are
    stand-ins that record what run_survey hands them)."""
    from pislamfusion_tpu_torch.models import fastvo
    from pislamfusion_tpu_torch.parallel import dist_vo

    class Stop(Exception):
        pass

    class FakeVO:
        def __init__(self, *args, device=None, **kwargs):
            self.device = device

        def process(self, frames, pose0):
            raise Stop("serial")

    meshes = []

    def fake_survey(vo, segs, anchors, mesh, **kw):
        meshes.append((mesh, kw))
        raise Stop("mesh")

    monkeypatch.setattr(app, "resolve_device",
                        lambda device=None: torch.device("cuda"))
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setattr(fastvo, "FastVO", FakeVO)
    monkeypatch.setattr(dist_vo, "process_survey", fake_survey)
    for n, want in (("0", 4), ("4", 4), ("2", 2), ("1", 0)):
        cfg = Svar()
        cfg.set("Survey.Mesh", n)
        with pytest.raises(Stop, match="mesh" if want else "serial"):
            app.run_survey(cfg, [dataset[0]])
        if want:
            mesh, kw = meshes.pop()
            assert mesh.devices.size == want
            assert [str(d) for d in mesh.flat] == [
                f"cuda:{i}" for i in range(want)]
            assert kw["correct_drift"]     # the dataset has GPS
