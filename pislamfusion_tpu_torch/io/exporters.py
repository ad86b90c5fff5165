"""Map exporters: Map2DFusion input folder, .mf MapFusion file, and
web-mercator geo-tiles.

Equivalents of:
  * MapHash::saveMap2DFusion (GSLAM-DIYSLAM/src/zhaoyong/MapHash.cpp:655-767)
    — folder with config.cfg (`Plane=`, `Camera.Paraments=`, `GPS.Origin=`,
    `TrajectoryFile=`), trajectory.txt, and rgb/<timestamp>.jpg images —
    the input format of the standalone Map2DFusion binary.
  * MapHash::saveMapFusion (.mf) (MapHash.cpp:786-836) — per-frame CSV line:
    image path, pose t/q, camera parameter list, keypoint (plane-coords,
    inverse-depth) pairs.
  * The geo-tile path of the GUI (MultiBandMap2DCPU::draw Fuse2Google,
    MultiBandMap2DCPU.cpp:693-775 + TileManager.h/TileProjection.h +
    calcLngLatFromDistance in PIL utils_GPS) — here a z/x/y web-mercator
    PNG tile pyramid written to disk from the blended mosaic.

Port of pislamfusion_tpu/io/exporters.py. `save_map2dfusion` fits its
plane with the port's `ops.ransac.find_plane` on `device` (None means
`cuda`), drawing from a CPU `torch.Generator` seeded 0 where the
reference takes `PRNGKey(0)`; it writes JPEG through PIL, as the
reference does.
`export_geo_tiles` is numpy over any engine with `blended()`,
`length_pixel`, `min_xy` and `plane` (the Map2D engines and FastVO).
"""
from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from ..core import gps as gpsmod
from ..core.device import resolve_device
from ..ops import ransac
from . import native_io


def _pose_str(pose: np.ndarray) -> str:
    return " ".join(f"{v:.10g}" for v in pose)


def save_map2dfusion(wmap, folder: str, plane: Optional[np.ndarray] = None,
                     gps_origin=None, device=None) -> bool:
    """Write a Map2DFusion input folder (MapHash.cpp:655-767). Uses the
    given ground plane or RANSAC-fits one from the map points on `device`;
    images come from frame.image / frame.color or the frame's
    image_path."""
    frames = sorted(wmap.keyframes(), key=lambda f: f.id)
    if not frames:
        return False
    os.makedirs(os.path.join(folder, "rgb"), exist_ok=True)
    cam = frames[0].camera
    if plane is None:
        pts = np.stack([p.position for p in wmap.points()])
        if len(pts) < 10:
            return False
        dev = resolve_device(device)
        ids, pos, _ = wmap.point_arrays()
        med = frames[0].median_depth(pos) if len(ids) else 1.0
        res = ransac.find_plane(torch.Generator().manual_seed(0),
                                torch.from_numpy(pts.astype(np.float32)).to(
                                    dev),
                                torch.ones(len(pts), dtype=torch.bool,
                                           device=dev),
                                sigma=0.1 * float(med))
        if not bool(res.ok):
            return False
        plane = res.model.cpu().numpy()
    with open(os.path.join(folder, "config.cfg"), "w") as f:
        f.write(f"Plane={_pose_str(np.asarray(plane))}\n")
        f.write(f"Camera.CameraType={cam.name}\n")
        f.write("Camera.Paraments=" + " ".join(
            f"{v:.10g}" for v in cam.parameters()) + "\n")
        f.write("TrajectoryFile=$(Svar.ParsingPath)/trajectory.txt\n")
        if gps_origin is not None:
            f.write("GPS.Origin=" + " ".join(
                f"{v:.10g}" for v in np.asarray(gps_origin)) + "\n")
    with open(os.path.join(folder, "trajectory.txt"), "w") as tf:
        for fr in frames:
            t = fr.timestamp if fr.timestamp > 1e-9 else fr.id
            ts = f"{t:.6f}"
            tf.write(ts + " " + _pose_str(fr.pose_c2w) + "\n")
            img = fr.color if fr.color is not None else fr.image
            dest = os.path.join(folder, "rgb", ts + ".jpg")
            if img is not None:
                arr = np.clip(np.asarray(img), 0, 255).astype(np.uint8)
                if arr.ndim == 2:
                    arr = np.repeat(arr[..., None], 3, -1)
                from PIL import Image
                Image.fromarray(arr).save(dest, quality=92)
            elif getattr(fr, "image_path", None):
                import shutil
                shutil.copy(fr.image_path, dest)
    return True


def save_mapfusion(wmap, path: str) -> bool:
    """.mf export (MapHash::saveMapFusion, MapHash.cpp:786-836): one line
    per keyframe: image path, pose (t, q), camera parameters, then
    (normalized keypoint, (inverse depth, -1)) pairs."""
    frames = sorted(wmap.keyframes(), key=lambda f: f.id)
    if not frames:
        return False
    with open(path, "w") as f:
        for fr in frames:
            img_path = getattr(fr, "image_path", None) or f"frame_{fr.id}"
            t = fr.pose_c2w[:3]
            q = fr.pose_c2w[3:7]
            params = fr.camera.parameters()
            # world->camera for inverse depths
            x, y, z, w = q
            R = np.array([
                [1 - 2 * (y * y + z * z), 2 * (x * y - z * w),
                 2 * (x * z + y * w)],
                [2 * (x * y + z * w), 1 - 2 * (x * x + z * z),
                 2 * (y * z - x * w)],
                [2 * (x * z - y * w), 2 * (y * z + x * w),
                 1 - 2 * (x * x + y * y)]])
            pairs = []
            for ci in np.nonzero(fr.kp2mp >= 0)[0]:
                mp = wmap.point(int(fr.kp2mp[ci]))
                if mp is None:
                    continue
                pc = R.T @ (mp.position - t)
                if pc[2] <= 0.01:
                    continue
                ray = fr.rays[ci]
                pairs.append((ray[0], ray[1], 1.0 / pc[2], -1.0))
            line = [img_path] + [f"{v:.12g}" for v in (*t, *q)] \
                + [str(len(params))] + [f"{v:.6g}" for v in params] \
                + [str(len(pairs))]
            for p in pairs:
                line += [f"{v:.6g}" for v in p]
            f.write(", ".join(line) + "\n")
    return True


# ---------------------------------------------------------------------------
# web-mercator tiles
# ---------------------------------------------------------------------------

def lnglat_to_global_px(lng, lat, zoom: int):
    """Web-mercator global pixel coordinates at `zoom` (256px tiles) —
    TileProjection.h semantics."""
    n = 256 * (2 ** zoom)
    x = (np.asarray(lng, np.float64) + 180.0) / 360.0 * n
    latr = np.deg2rad(np.asarray(lat, np.float64))
    y = (1.0 - np.log(np.tan(latr) + 1.0 / np.cos(latr)) / np.pi) / 2.0 * n
    return x, y


def global_px_to_lnglat(x, y, zoom: int):
    n = 256 * (2 ** zoom)
    lng = np.asarray(x, np.float64) / n * 360.0 - 180.0
    lat = np.rad2deg(np.arctan(np.sinh(np.pi * (1 - 2 * np.asarray(
        y, np.float64) / n))))
    return lng, lat


def export_geo_tiles(map2d, gps_origin, out_dir: str, zoom: int = 19,
                     plane_se3: Optional[np.ndarray] = None,
                     datum: str = "wgs84") -> int:
    """Resample the blended mosaic into a z/x/y/256 PNG tile pyramid level.

    The mosaic canvas lives in ground-plane coordinates (meters once GPS is
    fitted); the canvas->(lng,lat) placement uses calcLngLatFromDistance
    from the GPS origin exactly like the reference's Fuse2Google path
    (MultiBandMap2DCPU.cpp:693-775). Returns the number of tiles written.

    datum: 'wgs84' | 'gcj02' | 'bd09' — shift tile placement onto a
    Chinese basemap grid (the reference's map widget does this per
    provider: TileProjection.h GPSConverter / opmapcontrol).
    """
    from ..models.map2d import _write_png
    out, covered = map2d.blended()
    if not covered.any():
        return 0
    lp = map2d.length_pixel
    min_xy = np.asarray(map2d.min_xy, np.float64)
    lng0, lat0 = float(gps_origin[0]), float(gps_origin[1])
    if plane_se3 is None:
        plane_se3 = np.asarray(map2d.plane, np.float64)

    def canvas_to_lnglat(px, py):
        # canvas px -> plane-local meters -> world (ENU) -> lng/lat
        lx = min_xy[0] + px * lp
        ly = min_xy[1] + py * lp
        local = np.stack([lx, ly, np.zeros_like(lx)], -1)
        q = plane_se3[3:7]
        x, y, z, w = q
        R = np.array([
            [1 - 2 * (y * y + z * z), 2 * (x * y - z * w),
             2 * (x * z + y * w)],
            [2 * (x * y + z * w), 1 - 2 * (x * x + z * z),
             2 * (y * z - x * w)],
            [2 * (x * z - y * w), 2 * (y * z + x * w),
             1 - 2 * (x * x + y * y)]])
        world = local @ R.T + plane_se3[:3]
        lng, lat = gpsmod.lnglat_from_distance(
            lng0, lat0, world[..., 0], world[..., 1])
        if datum != "wgs84":
            pairs = [gpsmod.datum_shift(la, ln, datum)
                     for la, ln in zip(np.atleast_1d(lat),
                                       np.atleast_1d(lng))]
            lat = np.asarray([p[0] for p in pairs])
            lng = np.asarray([p[1] for p in pairs])
        return lng, lat

    H, W = covered.shape
    # affine fit canvas->global-px from the three canvas corners (the
    # mapping is near-affine at survey scale)
    cpts = np.array([[0.0, 0.0], [W, 0.0], [0.0, H]])
    lng, lat = canvas_to_lnglat(cpts[:, 0], cpts[:, 1])
    gx, gy = lnglat_to_global_px(lng, lat, zoom)
    A = np.stack([cpts[:, 0], cpts[:, 1], np.ones(3)], -1)
    coefx = np.linalg.solve(A, gx)
    coefy = np.linalg.solve(A, gy)
    M = np.array([[coefx[0], coefx[1], coefx[2]],
                  [coefy[0], coefy[1], coefy[2]],
                  [0, 0, 1.0]])
    Minv = np.linalg.inv(M)
    # tile range covering the canvas
    corners = np.array([[0, 0, 1], [W, 0, 1], [0, H, 1], [W, H, 1]]) @ M.T
    tx0, ty0 = int(corners[:, 0].min() // 256), int(corners[:, 1].min()
                                                    // 256)
    tx1, ty1 = int(corners[:, 0].max() // 256), int(corners[:, 1].max()
                                                    // 256)
    n_tiles = 0
    ys_t, xs_t = np.meshgrid(np.arange(256), np.arange(256), indexing="ij")
    for ty in range(ty0, ty1 + 1):
        for tx in range(tx0, tx1 + 1):
            gxp = tx * 256 + xs_t + 0.5
            gyp = ty * 256 + ys_t + 0.5
            src = np.stack([gxp, gyp, np.ones_like(gxp)], -1) @ Minv.T
            u = src[..., 0]
            v = src[..., 1]
            u0 = np.clip(np.floor(u).astype(int), 0, W - 2)
            v0 = np.clip(np.floor(v).astype(int), 0, H - 2)
            inb = (u >= 0) & (u < W - 1) & (v >= 0) & (v < H - 1)
            cov = inb & covered[v0, u0]
            if cov.sum() < 32:
                continue
            fu = np.clip(u - u0, 0, 1)[..., None]
            fv = np.clip(v - v0, 0, 1)[..., None]
            img = (out[v0, u0] * (1 - fu) * (1 - fv)
                   + out[v0, u0 + 1] * fu * (1 - fv)
                   + out[v0 + 1, u0] * (1 - fu) * fv
                   + out[v0 + 1, u0 + 1] * fu * fv)
            img = np.where(cov[..., None], img, 255.0)
            d = os.path.join(out_dir, str(zoom), str(tx))
            os.makedirs(d, exist_ok=True)
            tile8 = np.clip(img, 0, 255).astype(np.uint8)
            tpath = os.path.join(d, f"{ty}.png")
            # queue encode+write on the native writer thread; fall back
            # to the synchronous Python writer when it's unavailable
            if not native_io.save_png(tpath, tile8, wait=False):
                _write_png(tpath, tile8)
            n_tiles += 1
    failed = native_io.flush_writes()
    return n_tiles - failed
