"""Application glue: `python -m pislamfusion_tpu_torch <dataset> [key=value ...]`.

Port of pislamfusion_tpu/app.py, the equivalent of src/main.cpp (:6-43)
— ParseMain, Act dispatch, positional args opened as datasets — plus the
SLAM feed loop of gui/pislam.cpp (slamThread :132-183) and the result
saving that the reference spreads over MainWindow/TestSystem. Headless:
the observability surface is the saved result.png / trajectory.txt /
map.ply and the section-timer report (core/timer.py).

Acts: `SLAM` (the default: offline SLAM with the fusion consumer in its
own thread), `Survey` (FastVO's batch track+fuse), `TestMap2D`
(trajectory playback into the mosaic) and `Tests`. Everything numeric
runs on one device: the `device` argument of each function, on the
command line the `Device` key (default `cuda`; an error without a CUDA
device, never a silent CPU run; `Device=cpu` runs the plain PyTorch
versions of the kernels). `Survey` runs segment-parallel over a mesh
of devices (`Survey.Mesh`, `parallel.dist_vo`) where it has more than
one, else serially on the one device.
"""
from __future__ import annotations

import os
import sys
import time
from typing import List, Optional

import numpy as np
import torch

from .core.device import resolve_device
from .core.messenger import DataTrans
from .core.svar import Svar
from .core.timer import timer
from .io.dataset import open_dataset
from .models.fusion import FusionSystem
from .models.slam import create_slam


def run_slam(cfg: Svar, dataset_paths: List[str], out_dir: str = ".",
             device=None):
    """Open datasets, run the SLAM feed loop with the fusion consumer
    attached, save outputs. device: where SLAM and the mosaic run (None
    means `cuda`). Returns (slam, fusion)."""
    dev = resolve_device(device)
    if not dataset_paths:
        raise SystemExit("no dataset given (pass e.g. survey.npudronemap)")
    # validate end-of-run export knobs UP FRONT: a typo'd datum must fail
    # here, not after the multi-hour survey has already been tracked
    datum = cfg.get_string("GeoTiles.Datum", "wgs84").strip().lower()
    if datum not in ("wgs84", "gcj02", "bd09"):
        raise SystemExit(f"GeoTiles.Datum={datum!r} unknown "
                         "(expected wgs84, gcj02 or bd09)")
    cfg.set("GeoTiles.Datum", datum)
    datasets = []
    for p in dataset_paths:
        ds = open_dataset(p)
        if ds is None or not ds.is_opened():
            raise SystemExit(f"could not open dataset {p}")
        # dataset config (camera, plane, GPS origin) fills gaps; CLI wins
        for k in ds.cfg.keys():
            cfg.insert(k, ds.cfg.get(k), overwrite=False)
        datasets.append(ds)

    camera = datasets[0].camera
    # a pair of queues of this run's own (the reference's are process
    # globals, and a run left planes behind in them for the next)
    slam = create_slam(cfg, camera, device=dev)
    slam.trans_queue, slam.plane_queue = DataTrans(30), DataTrans(30)
    fusion = FusionSystem(cfg, camera, trans_q=slam.trans_queue,
                          plane_q=slam.plane_queue, device=dev).start()

    # SLAM_Call command surface (gui/pislam.cpp:43 RegisterCommand):
    # Start/Pause/Stop gate the feed loop; everything else forwards to the
    # plugin's call() (DIYSLAM.cpp:366-394) — usable from other threads or
    # embedded callers via core.svar.scommand.
    from .core.svar import scommand
    run_state = {"paused": False, "stop": False}

    def _slam_call(arg: str):
        a = arg.strip()
        if a == "Start":
            run_state["paused"] = False
        elif a == "Pause":
            run_state["paused"] = True
        elif a == "Stop":
            run_state["stop"] = True
        else:
            cmd, _, rest = a.partition(" ")
            slam.call(cmd, rest or None)
    scommand.register("SLAM_Call", _slam_call)

    freq = cfg.get_double("Frequency", 0.0)   # gui/pislam.cpp:134 (100 Hz)
    period = 1.0 / freq if freq > 0 else 0.0
    viz_dir = cfg.get_string("Viz.Dir", "")
    visualizer = None
    if viz_dir:
        from . import viz
        visualizer = viz.Visualizer(viz_dir, cfg.get_int("Viz.Every", 25))
    # native decode-ahead pipeline (C++ worker threads, native/imageio.cpp)
    # — the reference's dataset prepare thread (DatasetRTMapper.cpp:171-205)
    prefetcher = None
    if cfg.get_bool("Dataset.NativeIO", True):
        from .io import native_io
        if native_io.available():
            prefetcher = native_io.Prefetcher(
                threads=cfg.get_int("Dataset.PrefetchThreads", 2))
    depth = max(1, cfg.get_int("Dataset.PrefetchDepth", 4))

    t0 = time.perf_counter()
    n_images = 0
    last_gps = None
    from collections import deque
    for ds in datasets:
        if run_state["stop"]:
            break
        pending = deque()   # (frame, ticket-or-None)

        def fill():
            while len(pending) < depth:
                nxt = ds.grab_frame(load=False)
                if nxt is None:
                    return False
                t = None
                if prefetcher is not None and nxt.image_path \
                        and nxt.image is None and not nxt.is_gps_only:
                    t = prefetcher.submit(nxt.image_path)
                pending.append((nxt, t))
            return True

        while True:
            if run_state["stop"]:
                break
            while run_state["paused"] and not run_state["stop"]:
                time.sleep(0.02)
            fill()
            if not pending:
                break
            fr, ticket = pending.popleft()
            if fr.is_gps_only:
                last_gps = fr                       # attach to next image
                continue
            img = None
            if ticket is not None:
                with timer.scope("App::prefetchWait"):
                    img = prefetcher.wait(ticket)
            if img is None:
                img = fr.load_image()
            if img is None:
                continue
            gps_src = fr if fr.gps_lla is not None else last_gps
            gps_lla = gps_src.gps_lla if gps_src is not None else None
            gps_acc = 5.0
            if gps_src is not None and gps_src.gps_sigma is not None:
                gps_acc = float(np.mean(gps_src.gps_sigma))
            last_gps = None
            with timer.scope("App::track"):
                tracked = slam.track(
                    img, fr.timestamp, gps_lla=gps_lla, gps_acc=gps_acc,
                    pyr=(gps_src.pyr if gps_src is not None else None),
                    height_ground=(gps_src.height_ground
                                   if gps_src is not None else None))
            if tracked is not None and fr.image_path:
                tracked.image_path = fr.image_path   # for .mf/folder export
            if visualizer is not None:
                visualizer.update(slam=slam, fusion=fusion, frame=tracked)
            n_images += 1
            if period:
                dt = t0 + n_images * period - time.perf_counter()
                if dt > 0:
                    time.sleep(dt)
    if prefetcher is not None:
        prefetcher.close()
    slam.finish()
    if slam.mapper is not None:
        slam.mapper.force_plane()   # publish plane even on short runs
    fusion.finish()

    wall = time.perf_counter() - t0
    os.makedirs(out_dir, exist_ok=True)
    result_png = cfg.get_string("Map.File2Save",
                                os.path.join(out_dir, "result.png"))
    saved = fusion.save(result_png)
    if slam.map is not None:
        slam.map.export_trajectory(os.path.join(out_dir, "trajectory.txt"))
        slam.map.export_ply(os.path.join(out_dir, "map.ply"))
        map_file = cfg.get_string("MapFile2Save", "")
        if map_file:
            slam.map.save(map_file)
        from .io import exporters
        m2df = cfg.get_string("Map2DFusionFolder", "")
        origin = cfg.get_vec("GPS.Origin") or None
        if m2df:
            exporters.save_map2dfusion(slam.map, m2df, plane=slam.plane,
                                       gps_origin=origin, device=dev)
        mf = cfg.get_string("MapFusionFile", "")
        if mf:
            exporters.save_mapfusion(slam.map, mf)
        tiles_dir = cfg.get_string("GeoTiles.Dir", "")
        if tiles_dir and origin and fusion.map2d is not None:
            n = exporters.export_geo_tiles(
                fusion.map2d, origin, tiles_dir,
                zoom=cfg.get_int("GeoTiles.Zoom", 19),
                datum=cfg.get_string("GeoTiles.Datum", "wgs84"))
            print(f"geo-tiles: wrote {n} tiles to {tiles_dir}")

    ratio = slam.frames_tracked / max(slam.frames_total, 1)
    print(f"frames: {slam.frames_total} tracked {slam.frames_tracked} "
          f"({100 * ratio:.1f}%) in {wall:.1f}s "
          f"({slam.frames_total / max(wall, 1e-9):.1f} fps)")
    if slam.map is not None:
        print(f"map: {len(slam.map.keyframes())} keyframes, "
              f"{slam.map.point_num()} points")
    print(f"mosaic: fed {fusion.frames_fed} frames, "
          f"trajectory length {fusion.length_calc.length:.2f}"
          + (f", saved {result_png}" if saved else ", nothing blended"))
    if fusion.error:
        print(f"fusion error: {fusion.error}", file=sys.stderr)
    if cfg.get_bool("Timer.Report", True):
        timer.dump()
    return slam, fusion


def run_survey(cfg: Svar, dataset_paths: List[str], out_dir: str = ".",
               device=None):
    """Act=Survey: dataset -> batched FastVO on `device` (None means
    `cuda`) -> result.png + trajectory.txt + optional geo-tiles. With a
    mesh of more than one device (`Survey.Mesh`: on CUDA the first that
    many cards, all by default, where there are several; on the CPU that
    many shards of it, one by default) the survey runs segment-parallel
    (`parallel.dist_vo.process_survey`: segments of Survey.SegLen frames
    overlapping by one, anchored and drift-corrected by GPS where the
    dataset has it) and the trajectory is re-assembled from the segments.

    The batch survey mode the reference's architecture cannot express
    (its closest role: Map2DFusion.cpp:153-248 TestMap2D playback, which
    needs known poses; here poses come from the one-program VO). GPS
    fixes anchor the plane frame.

    Knobs: Survey.MaxFrames?=0 (all), Survey.Height?=0 (m above ground
    when frames carry no height), Survey.Mesh?=0 (0 = all cards, one
    shard on the CPU), Survey.SegLen?=max(4, ceil(frames / mesh) + 1),
    Survey.NFeature?=1000, Map2D.Scale?=0.5.
    """
    dev = resolve_device(device)
    if not dataset_paths:
        raise SystemExit("no dataset given (pass e.g. survey.npudronemap)")
    ds = open_dataset(dataset_paths[0])
    if ds is None or not ds.is_opened():
        raise SystemExit(f"could not open dataset {dataset_paths[0]}")
    for k in ds.cfg.keys():
        cfg.insert(k, ds.cfg.get(k), overwrite=False)
    cam = ds.camera
    if cam is None:
        raise SystemExit("dataset has no camera calibration")

    from .core import gps as gpsmod
    from .models.fastvo import FastVO
    from .models.map2d import _write_png
    from .ops import mosaic as M

    max_frames = cfg.get_int("Survey.MaxFrames", 0)
    raws = []
    gps_track = gpsmod.GPSArray()     # interleaved GPSFrame records
    while True:
        fr = ds.grab_frame(load=False)
        if fr is None:
            break
        if fr.is_gps_only:
            if fr.gps_lla is not None:
                gps_track.add(fr.timestamp, *fr.gps_lla)
            continue
        raws.append(fr)
        if max_frames and len(raws) >= max_frames:
            break
    if len(raws) < 2:
        raise SystemExit("survey needs at least 2 image frames")
    if len(gps_track):
        # associate interleaved fixes to image frames by timestamp
        # (DatasetNPUDroneMap's Unified GPS/mono interleave)
        ts_arr, _ = gps_track._freeze()
        for fr in raws:
            if fr.gps_lla is None:
                t = min(max(fr.timestamp, float(ts_arr[0])),
                        float(ts_arr[-1]))
                lla = gps_track.at(t)
                if lla is not None:
                    fr.gps_lla = np.asarray(lla, np.float64)

    # plane-frame anchors from GPS when present (ENU at the first fix;
    # ground plane z=0 sits Survey.Height / height_ground below the cam)
    local = None
    positions = np.zeros((len(raws), 2), np.float64)
    heights = np.zeros(len(raws), np.float64)
    h_default = cfg.get_double("Survey.Height", 0.0)
    have_gps = raws[0].gps_lla is not None
    for i, fr in enumerate(raws):
        if have_gps and fr.gps_lla is not None:
            if local is None:
                local = gpsmod.LocalFrame(*fr.gps_lla)
                # set (not insert): dataset probing leaves an EMPTY
                # "GPS.Origin" behind (Svar's get-with-default inserts
                # the default, dataset.py:143), which would block an
                # overwrite=False insert here
                if not cfg.get_string("GPS.Origin", "").strip():
                    cfg.set("GPS.Origin",
                            " ".join(str(v) for v in fr.gps_lla))
            enu = local.to_local(*fr.gps_lla)
            positions[i] = enu[:2]
        heights[i] = (fr.height_ground if fr.height_ground
                      else (h_default or 1.0))
    h_med = float(np.median(heights))
    scale = cfg.get_double("Map2D.Scale", 0.5)
    lp, _ = M.auto_resolution(cam, h_med, scale)
    es = M.ELE_PIXELS * lp
    fp_m = float(np.hypot(cam.width, cam.height)) / cam.fx * h_med
    min_xy = positions.min(0) - 0.7 * fp_m
    span = positions.max(0) - min_xy + 0.7 * fp_m
    tiles = int(np.ceil(span.max() / es)) + 2
    n_feat = cfg.get_int("Survey.NFeature",
                         cfg.get_int("SLAM.nFeature", 1000))
    vo = FastVO(cam, min_xy, tiles, lp, bands=cfg.get_int("Map2D.BandNum",
                                                          5),
                n_features=n_feat, window_radius=max(4.0 * es, 40.0),
                warp_mode="", device=dev)
    print(f"survey: {len(raws)} frames, canvas {tiles}x{tiles} tiles, "
          f"GSD {lp:.3f} m/px, median height {h_med:.1f} m")

    frames = np.stack([fr.load_image() for fr in raws])
    t0 = time.perf_counter()

    def anchor_pose(i):
        t = np.array([positions[i, 0], positions[i, 1], heights[i]],
                     np.float64)
        if raws[i].pyr is not None:
            q = gpsmod.pyr_to_rotation(*raws[i].pyr)  # camera->ENU quat
        else:
            # nadir: 180deg about x maps camera +z onto -z (down at the
            # z=0 ground plane), the synth_survey/bench convention
            q = np.array([1.0, 0.0, 0.0, 0.0])
        return np.concatenate([t, np.asarray(q, np.float64)]).astype(
            np.float32)

    # the segment-parallel engine over a mesh: the first Survey.Mesh
    # cards on CUDA (all by default); on the CPU Survey.Mesh shards of it
    # (the reference's test mesh), one by default
    if dev.type == "cuda":
        n_dev = torch.cuda.device_count()
        mesh_n = cfg.get_int("Survey.Mesh", 0) or n_dev
        mesh_devs = [torch.device("cuda", i)
                     for i in range(min(mesh_n, n_dev))]
    else:
        n_dev = mesh_n = cfg.get_int("Survey.Mesh", 0) or 1
        mesh_devs = [dev] * mesh_n
    if mesh_n > 1 and n_dev > 1:
        from .parallel import make_mesh, dist_vo
        seg_len = cfg.get_int("Survey.SegLen",
                              max(4, -(-len(raws) // mesh_n) + 1))
        segs, firsts = dist_vo.segments_from_frames(frames, seg_len,
                                                    overlap=1)
        anchors = np.stack([anchor_pose(s) for s in firsts])
        mesh = make_mesh(mesh_devs)
        kw = dict(correct_drift=True, anchor_stride=seg_len - 1) \
            if have_gps else {}
        print(f"{segs.shape[0]} segments x {seg_len} over "
              f"{mesh.devices.size} devices"
              + (", drift-corrected" if kw else ""))
        est_s, nm = dist_vo.process_survey(vo, segs, anchors, mesh, **kw)
        est = np.zeros((len(raws), 7), np.float32)
        n_match = np.zeros(len(raws), np.int64)
        for i, s in enumerate(firsts):
            take = min(seg_len, len(raws) - s)
            est[s:s + take] = est_s[i][:take]
            n_match[s:s + take] = nm[i][:take]
    else:
        est, n_match = vo.process(frames, anchor_pose(0))
    dt = time.perf_counter() - t0
    tracked = int((np.asarray(n_match)[1:] > 10).sum()) + 1
    print(f"tracked {tracked}/{len(raws)} frames in {dt:.1f}s "
          f"({len(raws) / max(dt, 1e-9):.1f} fps incl. compile)")

    os.makedirs(out_dir, exist_ok=True)
    traj_path = os.path.join(out_dir, "trajectory.txt")
    with open(traj_path, "w") as f:
        for fr, p in zip(raws, est):
            f.write(f"{fr.timestamp:.6f} " +
                    " ".join(f"{v:.6f}" for v in p) + "\n")
    img, covered = vo.blended()
    result_png = os.path.join(out_dir,
                              cfg.get_string("Map.File2Save",
                                             "result.png"))
    saved = False
    if covered.any():
        _write_png(result_png, img.astype(np.uint8))
        saved = True
    tiles_dir = cfg.get_string("GeoTiles.Dir", "")
    n_tiles = 0
    if tiles_dir and cfg.get_string("GPS.Origin", "").strip():
        from .io.exporters import export_geo_tiles
        origin = [float(v) for v in
                  cfg.get_string("GPS.Origin", "").split()]
        plane = np.array([0, 0, 0, 0, 0, 0, 1], np.float64)
        n_tiles = export_geo_tiles(
            vo, origin, tiles_dir,
            zoom=cfg.get_int("GeoTiles.Zoom", 19), plane_se3=plane,
            datum=cfg.get_string("GeoTiles.Datum", "wgs84"))
    print(f"outputs: {traj_path}"
          + (f", {result_png}" if saved else ", nothing blended")
          + (f", {n_tiles} geo-tiles" if n_tiles else ""))
    return est, n_match, vo


def main(argv: Optional[List[str]] = None,
         cfg: Optional[Svar] = None) -> int:
    """The binary's entry point: argv's key=value pairs go into `cfg`
    (default: the process-global `svar`), its other arguments are the
    datasets. Returns the exit code."""
    if cfg is None:
        from .core.svar import svar as cfg
    svar = cfg
    if argv is None:
        argv = sys.argv[1:]
    # crash stacktraces on SIGSEGV/SIGABRT/fatal signals — the reference
    # installs installStackTrace() first thing in main (src/main.cpp:12,
    # gui/StackTrace.cpp:334 prints 100 frames to stderr). faulthandler is
    # the CPython-native equivalent (covers C-extension/CUDA crashes that a
    # Python traceback would miss). Opt out with StackTrace=0.
    import faulthandler
    if "StackTrace=0" not in argv:
        faulthandler.enable()
    positional = svar.parse_main(argv)
    act = svar.get_string("Act", "SLAM")
    if act in ("SLAM", "Survey", "TestMap2D"):
        device = resolve_device(svar.get_string("Device", "cuda"))
    if act == "SLAM":
        run_slam(svar, positional,
                 out_dir=svar.get_string("Out.Dir", "."), device=device)
        return 0
    if act == "Survey":
        run_survey(svar, positional,
                   out_dir=svar.get_string("Out.Dir", "."), device=device)
        return 0
    if act == "TestMap2D":
        # the consumer's playback mode: without it FusionSystem.run waits
        # for a SLAM producer that this Act never starts (the JAX package
        # leaves Map2D.Act to the caller and blocks there)
        svar.set("Map2D.Act", "TestMap2D")
        fusion = FusionSystem(svar, device=device)
        fusion.run()        # inline (no SLAM producer to overlap with)
        saved = fusion.save(svar.get_string(
            "Map.File2Save", os.path.join(
                svar.get_string("Out.Dir", "."), "result.png")))
        print(f"mosaic: fed {fusion.frames_fed} frames, saved={saved}")
        if fusion.error:
            print(f"error: {fusion.error}", file=sys.stderr)
            return 1
        return 0
    if act == "Tests":      # gtest runner parity (gui/pislam.cpp:228-232)
        import pytest
        return pytest.main(["-q"] + positional)
    print(f"No act {act}!", file=sys.stderr)
    return 1
