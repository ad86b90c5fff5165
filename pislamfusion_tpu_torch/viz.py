"""Thin headless viewer: trajectory / map / mosaic snapshots as PNGs.

Replaces the reference's Qt observability surface (gui/SLAMVisualizer.cpp
point-cloud+trajectory view, FrameVisualizer current-frame widget,
Map2DItem mosaic view) with matplotlib-free PNG rendering — suitable for
headless machines and CI. Wired into the CLI via `Viz.Dir=<folder>`
(snapshots every `Viz.Every` frames) or called directly:

    from pislamfusion_tpu_torch import viz
    viz.save_map_view(slam.map, "map.png")
    viz.save_track_view(frame, "frame.png")

A copy of pislamfusion_tpu/viz.py: PNGs through the port's own
`models.map2d._write_png`; `save_mosaic_view` reads the engine's
`blended()`, which the engine's lock guards against the consumer
thread's renders.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from .models.map2d import _write_png


def _canvas(w=1024, h=1024, bg=245):
    return np.full((h, w, 3), bg, np.uint8)


def _fit(pts2d, w, h, margin=40):
    """Fit scatter points into canvas pixels; returns (px, py, to_px fn)."""
    mn = pts2d.min(0)
    mx = pts2d.max(0)
    span = np.maximum(mx - mn, 1e-9)
    s = min((w - 2 * margin) / span[0], (h - 2 * margin) / span[1])
    c = 0.5 * (mn + mx)

    def to_px(p):
        q = (p - c) * s
        return (np.round(q[..., 0] + w / 2).astype(int),
                np.round(h / 2 - q[..., 1]).astype(int))

    return to_px


def _splat(img, px, py, color, r=1):
    h, w = img.shape[:2]
    for dy in range(-r, r + 1):
        for dx in range(-r, r + 1):
            x = np.clip(px + dx, 0, w - 1)
            y = np.clip(py + dy, 0, h - 1)
            img[y, x] = color


def _line(img, p0, p1, color):
    n = int(max(abs(p1[0] - p0[0]), abs(p1[1] - p0[1]), 1))
    xs = np.linspace(p0[0], p1[0], n + 1).astype(int)
    ys = np.linspace(p0[1], p1[1], n + 1).astype(int)
    h, w = img.shape[:2]
    img[np.clip(ys, 0, h - 1), np.clip(xs, 0, w - 1)] = color


def save_map_view(wmap, path: str, size: int = 1024) -> bool:
    """Top-down map view: colored points, trajectory polyline, keyframe
    markers (SLAMVisualizer's MapVisualizer equivalent)."""
    points = wmap.points()
    frames = sorted(wmap.frames(), key=lambda f: f.timestamp)
    if not frames:
        return False
    img = _canvas(size, size)
    all_xy = []
    if points:
        all_xy.append(np.stack([p.position[:2] for p in points]))
    all_xy.append(np.stack([f.pose_c2w[:2] for f in frames]))
    to_px = _fit(np.concatenate(all_xy, 0), size, size)
    if points:
        pos = np.stack([p.position[:2] for p in points])
        col = np.stack([p.color for p in points])
        px, py = to_px(pos)
        inb = (px >= 0) & (px < size) & (py >= 0) & (py < size)
        img[py[inb], px[inb]] = col[inb]
    # trajectory
    traj = np.stack([f.pose_c2w[:2] for f in frames])
    px, py = to_px(traj)
    for i in range(len(traj) - 1):
        _line(img, (px[i], py[i]), (px[i + 1], py[i + 1]), (30, 80, 220))
    for f, x, y in zip(frames, px, py):
        if f.is_keyframe:
            _splat(img, np.asarray([x]), np.asarray([y]), (220, 40, 30), 2)
    _write_png(path, img)
    return True


def save_track_view(frame, path: str) -> bool:
    """Current-frame view with keypoints (FrameVisualizer equivalent):
    tracked keypoints green, untracked red."""
    if frame.image is None:
        return False
    img = np.asarray(frame.image)
    if img.ndim == 2:
        img = np.repeat(img[..., None], 3, -1)
    img = np.clip(img, 0, 255).astype(np.uint8).copy()
    if frame.xy is not None:
        xy = frame.xy.astype(int)
        tracked = frame.kp2mp >= 0
        for sel, color in ((~tracked & frame.valid, (220, 60, 40)),
                           (tracked, (40, 200, 60))):
            pts = xy[sel]
            _splat(img, pts[:, 0], pts[:, 1], color, 1)
    _write_png(path, img)
    return True


def save_mosaic_view(map2d, path: str) -> bool:
    """Blended mosaic snapshot (Map2DItem equivalent)."""
    if map2d is None:
        return False
    return map2d.save(path)


class Visualizer:
    """Periodic snapshot writer the app glue drives (GUI thread analogue)."""

    def __init__(self, out_dir: str, every: int = 25):
        import os
        self.out_dir = out_dir
        self.every = max(1, int(every))
        self._n = 0
        os.makedirs(out_dir, exist_ok=True)

    def _atomic(self, name, writer) -> None:
        """Write via tmp + os.replace so a watcher (imgcat loop, browser
        refresh) never reads a half-written PNG — the headless stand-in
        for the reference's live GUI views (SLAMVisualizer.cpp:393-447)."""
        import os
        path = os.path.join(self.out_dir, name)
        tmp = path + ".tmp"
        try:
            if writer(tmp):
                os.replace(tmp, path)
            elif os.path.exists(tmp):
                os.remove(tmp)
        except OSError:
            pass

    def update(self, slam=None, fusion=None, frame=None):
        self._n += 1
        if self._n % self.every:
            return
        if frame is not None:
            self._atomic("frame.png", lambda p: save_track_view(frame, p))
        if slam is not None and slam.map is not None \
                and slam.map.frame_num() > 1:
            self._atomic("map.png", lambda p: save_map_view(slam.map, p))
        if fusion is not None and fusion.map2d is not None:
            self._atomic("mosaic.png",
                         lambda p: save_mosaic_view(fusion.map2d, p))
