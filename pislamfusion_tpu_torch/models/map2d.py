"""Incremental orthomosaic engines (the Map2DFusion half of the reference).

Port of pislamfusion_tpu/models/map2d.py:36-745. `create_map2d` mirrors
Map2D::create (Map2D.cpp:51-66) through the `MAP2DS` registry:

- Type 3, "multiband" (the default): `MultiBandMap2D`, the tiled Laplacian
  multi-band max-weight blender (MultiBandMap2DCPU);
- Type 4, "render": `RenderMap2D`, the same blend over batches of
  `Map2D.RenderBatch` frames, with the `Map2DRender.EnableSeam` seam pass;
- Type 1, "weighted": `WeightedMap2D`, the single-band running weighted
  blend (Map2DCPU);
- Type 2, "gpu": `WeightedGPUMap2D`, UtilGPU.cu's blend rule.

Usage (`device=None` means `cuda`, and raises without a CUDA device):

    m = create_map2d(3, cfg, device=None)
    m.prepare(plane_se3, camera, [(None, pose_c2w), ...])
    for img, pose_c2w in frames:
        m.feed(img, pose_c2w)
    img, covered = m.blended()        # or m.save("result.png")

Per-frame geometry (corner projection, tile grid, growth, homography) is
float64 numpy on the host, as in the reference; everything per pixel runs
on the engine's device, where the canvas stays. The reference's jitted
programs become eager calls of `ops.mosaic` that update the canvas in
place, so the engine lock still guards every render, growth and read.
Map2D.WarpMode "" resolves as the reference resolves it on its
accelerator: "shear" (K3) on a CUDA device, "gather" elsewhere. Every
pyrDown and pyrUp runs through K8. `mark`, when set to a callable, is
called with each stage's name as it is enqueued ("geometry", "seam",
"warp", "pyramids", "composite"), for stage timing.

PNGs are written with the reference's zlib/struct encoder. `read_png`
reads any PNG through PIL where PIL imports, as the reference does, and
otherwise through its own decoder (every colour type and depth, Adam7),
which converts to RGB as PIL does.
"""
from __future__ import annotations

import struct
import threading
import zlib
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.camera import Camera
from ..core.device import resolve_device, upload
from ..core.registry import MAP2DS
from ..core.timer import timer
from ..ops import mosaic as M

ELE = M.ELE_PIXELS


def _se3_inv_mul_np(plane, pose):
    """host float64: plane^{-1} * pose for [7] (t, q) arrays."""
    def qconj(q):
        return np.array([-q[0], -q[1], -q[2], q[3]])

    def qmul(a, b):
        x1, y1, z1, w1 = a
        x2, y2, z2, w2 = b
        return np.array([
            w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
            w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
            w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
            w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
        ])

    def qrot(q, p):
        v, w = q[:3], q[3]
        t = 2.0 * np.cross(v, p)
        return p + w * t + np.cross(v, t)

    pq = qconj(plane[3:7])
    pt = -qrot(pq, plane[:3])
    t = qrot(pq, pose[:3]) + pt
    q = qmul(pq, pose[3:7])
    q = q / np.linalg.norm(q)
    return np.concatenate([t, q])


def _np(x):
    return x.detach().cpu().numpy()


class Map2DBase:
    """Common prepare/bbox/tile-grid logic (MultiBandMap2DCPUData::prepare)."""

    def __init__(self, cfg=None, device=None):
        from ..core.svar import svar as default_svar
        self.cfg = cfg if cfg is not None else default_svar
        self.device = resolve_device(device)
        self.camera: Optional[Camera] = None
        self.plane = np.array([0, 0, 0, 0, 0, 0, 1.0])
        self.length_pixel = 0.0
        self.min_xy = np.zeros(2)
        self.w_tiles = 0
        self.h_tiles = 0
        self.patch_tiles = 0
        self._lock = threading.Lock()
        self.frames_rendered = 0
        self.frames_skipped = 0
        self.mark = None

    def _mark(self, stage: str):
        if self.mark is not None:
            self.mark(stage)

    # -- geometry ------------------------------------------------------------
    def prepare(self, plane_se3: np.ndarray, camera: Camera,
                frames: Sequence[Tuple[np.ndarray, np.ndarray]]) -> bool:
        """plane_se3: [7] SE3 of the ground plane in world coords; frames:
        (image or None, pose_c2w [7]) pairs used to size the canvas."""
        if camera is None or not camera.is_valid() or len(frames) == 0:
            return False
        self.camera = camera
        self.plane = np.asarray(plane_se3, np.float64)
        poses = [_se3_inv_mul_np(self.plane, np.asarray(p, np.float64))
                 for _, p in frames]
        ts = np.stack([p[:3] for p in poses])
        mn, mx = ts.min(0), ts.max(0)
        if mn[2] * mx[2] <= 0:  # cameras must be on one side of the plane
            return False
        maxh = mx[2] if mx[2] > 0 else -mn[2]
        res = self.cfg.get_double("Map2D.Resolution", 0.0)
        auto_lp, radius = M.auto_resolution(
            camera, maxh, self.cfg.get_double("Map2D.Scale", 1.0))
        self.length_pixel = res if res else auto_lp
        # expand bbox by footprint radius, then double around center (:239-243)
        mn2 = mn[:2] - radius
        mx2 = mx[:2] + radius
        center = 0.5 * (mn2 + mx2)
        mn2 = 2 * mn2 - center
        mx2 = 2 * mx2 - center
        ele_size = ELE * self.length_pixel
        self.w_tiles = int(np.ceil((mx2[0] - mn2[0]) / ele_size))
        self.h_tiles = int(np.ceil((mx2[1] - mn2[1]) / ele_size))
        self.min_xy = mn2
        # static patch size: a frame footprint is <= 2*radius across at max
        # height; snap to tiles with +1 for alignment slack
        self.patch_tiles = int(np.ceil(2 * radius / ele_size)) + 1
        # the canvas must hold at least one patch
        self.w_tiles = max(self.w_tiles, self.patch_tiles)
        self.h_tiles = max(self.h_tiles, self.patch_tiles)
        self._alloc()
        return True

    def _alloc(self):
        raise NotImplementedError

    @property
    def ele_size(self):
        return ELE * self.length_pixel

    def _frame_geometry(self, pose_plane: np.ndarray):
        """Compute (origin_tiles, h_patch2img) for one frame; None to skip."""
        pts, ok = M.plane_corners_np(pose_plane, self.camera)
        if not ok:
            return None
        xmin, ymin = pts.min(0)
        xmax, ymax = pts.max(0)
        es = self.ele_size
        # grow canvas when the footprint leaves it (spreadMap, :561-604)
        self._maybe_grow(xmin, ymin, xmax, ymax)
        tx0 = int(np.floor((xmin - self.min_xy[0]) / es))
        ty0 = int(np.floor((ymin - self.min_xy[1]) / es))
        tx1 = int(np.ceil((xmax - self.min_xy[0]) / es))
        ty1 = int(np.ceil((ymax - self.min_xy[1]) / es))
        if tx1 - tx0 > self.patch_tiles:
            # footprint exceeds the static patch: center the patch on it
            tx0 = (tx0 + tx1 - self.patch_tiles) // 2
        if ty1 - ty0 > self.patch_tiles:
            ty0 = (ty0 + ty1 - self.patch_tiles) // 2
        tx0 = max(0, min(tx0, self.w_tiles - self.patch_tiles))
        ty0 = max(0, min(ty0, self.h_tiles - self.patch_tiles))
        origin_xy_plane = (self.min_xy[0] + tx0 * es,
                           self.min_xy[1] + ty0 * es)
        H = M.homography_canvas_to_image_np(pose_plane, self.camera,
                                            origin_xy_plane,
                                            self.length_pixel)
        return (ty0, tx0), H

    def _maybe_grow(self, xmin, ymin, xmax, ymax):
        es = self.ele_size
        grow_left = int(np.ceil(max(0.0, self.min_xy[0] - xmin) / es))
        grow_top = int(np.ceil(max(0.0, self.min_xy[1] - ymin) / es))
        max_x = self.min_xy[0] + self.w_tiles * es
        max_y = self.min_xy[1] + self.h_tiles * es
        grow_right = int(np.ceil(max(0.0, xmax - max_x) / es))
        grow_bottom = int(np.ceil(max(0.0, ymax - max_y) / es))
        if grow_left or grow_top or grow_right or grow_bottom:
            self._grow(grow_top, grow_bottom, grow_left, grow_right)

    def _grow(self, top, bottom, left, right):
        raise NotImplementedError

    def _shift_origin(self, top, bottom, left, right):
        self.h_tiles += top + bottom
        self.w_tiles += left + right
        self.min_xy = self.min_xy - np.array([left, top]) * self.ele_size

    # -- feed ----------------------------------------------------------------
    def feed(self, img, pose_c2w: np.ndarray) -> bool:
        """One frame: img [H, W, 3] (numpy or tensor, uint8 or float,
        0..255), pose_c2w [7] in world coordinates."""
        pose_plane = _se3_inv_mul_np(self.plane,
                                     np.asarray(pose_c2w, np.float64))
        return self.render_frame(img, pose_plane)

    def queue_size(self) -> int:
        return 0

    def render_frame(self, img, pose_plane) -> bool:
        # the canvas is updated in place and _grow reallocates it, so a
        # concurrent reader must never see a half-done render
        with self._lock:
            return self._render_frame_locked(img, pose_plane)

    def _render_frame_locked(self, img, pose_plane) -> bool:
        raise NotImplementedError

    def _upload_frame(self, img, H):
        """The frame as float32 on the engine's device and the homography
        as a float32 [3, 3] tensor there."""
        return (upload(img, self.device).to(torch.float32),
                upload(H, self.device, torch.float32))

    # -- pose refresh --------------------------------------------------------
    def _footprint_px(self, pose_plane: np.ndarray):
        """Frame footprint as a canvas-pixel rect (y0, y1, x0, x1), or
        None when the frame doesn't project onto the plane."""
        pts, ok = M.plane_corners_np(pose_plane, self.camera)
        if not ok:
            return None
        lp = self.length_pixel
        x0 = (pts[:, 0].min() - self.min_xy[0]) / lp
        x1 = (pts[:, 0].max() - self.min_xy[0]) / lp
        y0 = (pts[:, 1].min() - self.min_xy[1]) / lp
        y1 = (pts[:, 1].max() - self.min_xy[1]) / lp
        Hpx, Wpx = self.h_tiles * ELE, self.w_tiles * ELE
        return (max(0, int(np.floor(y0))), min(Hpx, int(np.ceil(y1))),
                max(0, int(np.floor(x0))), min(Wpx, int(np.ceil(x1))))

    def _clear_rect_px(self, y0, y1, x0, x1):
        raise NotImplementedError

    def refresh(self, entries, thresh: Optional[float] = None) -> int:
        """Re-render the canvas regions whose contributing frames moved
        (reference map2d.py:212-309).

        entries: [(img, old_pose_c2w, new_pose_c2w)], every frame the
        caller still holds, in feed order. Frames whose plane-frame camera
        center moved more than `thresh` meters (default 2 * GSD) mark
        their old and new footprints dirty; the footprints of every frame
        overlapping a dirty region join it until nothing changes; the
        regions are cleared and those frames re-fed at their new poses.
        A move larger than half a patch is taken for another gauge epoch
        and that entry is left alone. Returns the number of frames
        re-fed."""
        if self.camera is None:
            return 0
        if thresh is None:
            thresh = 2.0 * self.length_pixel
        max_move = 0.5 * self.patch_tiles * ELE * self.length_pixel
        with self._lock:
            plane = self.plane
            moved, rects = [], []
            planes_new = []
            for i, (img, old_pose, new_pose) in enumerate(entries):
                po = _se3_inv_mul_np(plane, np.asarray(old_pose,
                                                       np.float64))
                pn = _se3_inv_mul_np(plane, np.asarray(new_pose,
                                                       np.float64))
                planes_new.append(pn)
                d = np.linalg.norm(po[:3] - pn[:3])
                if d > max_move:
                    planes_new[i] = None      # unrefreshable epoch
                    continue
                if d > thresh:
                    fps = [self._footprint_px(p) for p in (po, pn)]
                    if any(f is None for f in fps):
                        planes_new[i] = None  # off-plane: don't touch
                        continue
                    moved.append(i)
                    rects.extend(fps)
            if not moved or not rects:
                return 0

            def overlaps(a, b):
                return (a[0] < b[1] and b[0] < a[1]
                        and a[2] < b[3] and b[2] < a[3])

            fps = [None] * len(entries)
            for i in range(len(entries)):
                if planes_new[i] is not None:
                    fps[i] = self._footprint_px(planes_new[i])
            refeed = set()
            changed = True
            while changed:
                changed = False
                for i, fp in enumerate(fps):
                    if fp is None or i in refeed:
                        continue
                    if any(overlaps(fp, r) for r in rects):
                        refeed.add(i)
                        rects.append(fp)
                        changed = True
            for r in rects:
                self._clear_rect_px(*r)
            refed = 0
            for i in sorted(refeed):            # feed order preserved
                if self._render_frame_locked(entries[i][0],
                                             planes_new[i]):
                    refed += 1
            return refed

    # -- output --------------------------------------------------------------
    def _background(self, bg):
        return (float(self.cfg.get_int("Result.BackGroundColor", 255))
                if bg is None else bg)

    def blended(self, bg: Optional[float] = None):
        raise NotImplementedError

    def save(self, filename: str) -> bool:
        """Crop to touched tiles, reconstruct, write PNG (save:779-847)."""
        out, covered = self.blended()
        ys, xs = np.nonzero(covered)
        if len(ys) == 0:
            return False
        ty0, ty1 = ys.min() // ELE, ys.max() // ELE + 1
        tx0, tx1 = xs.min() // ELE, xs.max() // ELE + 1
        _write_png(filename, out[ty0 * ELE:ty1 * ELE,
                                 tx0 * ELE:tx1 * ELE].astype(np.uint8))
        return True


def _empty():
    """blended() before prepare(): one blank tile."""
    return (np.zeros((ELE, ELE, 3), np.float32), np.zeros((ELE, ELE), bool))


@MAP2DS.register("3")
@MAP2DS.register("multiband")
class MultiBandMap2D(Map2DBase):
    """Tiled Laplacian multi-band max-weight blender (MultiBandMap2DCPU)."""

    def __init__(self, cfg=None, device=None):
        super().__init__(cfg, device)
        self.bands = int(self.cfg.get_int("Map2D.BandNumber", 5))
        self.weight_type = int(self.cfg.get_int("Map2D.WeightType", 0))
        # Map2D.FastWarp: the half-resolution warp (see ops.mosaic)
        self.fast_warp = bool(self.cfg.get_int("Map2D.FastWarp", 0))
        # Map2D.WarpMode: "" = as the reference resolves it, or explicit
        # "shear"/"gather"
        self.warp_mode = self.cfg.get("Map2D.WarpMode", "") \
            or M.default_warp_mode(self.device)
        self.canvas_lap: List[torch.Tensor] = []
        self.canvas_w: List[torch.Tensor] = []

    def _alloc(self):
        # canvas tiles must stay divisible by 2**bands at every band level
        align = max(1, (1 << self.bands) // ELE)
        self.w_tiles = int(-(-self.w_tiles // align) * align)
        self.h_tiles = int(-(-self.h_tiles // align) * align)
        self.canvas_lap, self.canvas_w = M.alloc_canvas(
            self.h_tiles, self.w_tiles, self.bands, self.device)

    def _grow(self, top, bottom, left, right):
        self.canvas_lap, self.canvas_w = M.grow_canvas(
            self.canvas_lap, self.canvas_w,
            self.h_tiles + top + bottom, self.w_tiles + left + right,
            (top, left))
        self._shift_origin(top, bottom, left, right)

    @property
    def patch_hw(self):
        return (self.patch_tiles * ELE,) * 2

    def _render_frame_locked(self, img, pose_plane) -> bool:
        geo = self._frame_geometry(pose_plane)
        if geo is None:
            self.frames_skipped += 1
            return False
        (ty0, tx0), H = geo
        with timer.scope("MultiBandMap2D::renderFrame"):
            img32, h = self._upload_frame(img, H)
            self._mark("geometry")
            M.composite_frame(
                self.canvas_lap, self.canvas_w, img32, h,
                (ty0 * ELE, tx0 * ELE), bands=self.bands,
                patch_hw=self.patch_hw, weight_type=self.weight_type,
                half_res=self.fast_warp, warp=self.warp_mode,
                mark=self.mark)
        self.frames_rendered += 1
        return True

    def _clear_rect_px(self, y0, y1, x0, x1):
        """Zero lap + weight bands over a pixel rect (rect snapped out to
        the coarsest band's granularity so every level clears the same
        ground area)."""
        g = 1 << self.bands
        y0, x0 = (y0 // g) * g, (x0 // g) * g
        y1 = -(-y1 // g) * g
        x1 = -(-x1 // g) * g
        for b in range(len(self.canvas_lap)):
            s = 1 << b
            sl = (slice(y0 >> b, -(-y1 // s)), slice(x0 >> b, -(-x1 // s)))
            self.canvas_lap[b][sl] = 0.0
            self.canvas_w[b][sl] = 0.0

    def blended(self, bg: Optional[float] = None):
        """Full-canvas blended RGB image (float32 0..255, numpy) and its
        coverage mask."""
        bg = self._background(bg)
        if not self.canvas_lap:   # prepare() hasn't allocated yet
            return _empty()
        with self._lock:
            out, covered = M.reconstruct_canvas(self.canvas_lap,
                                                self.canvas_w, bg=bg)
            return _np(out), _np(covered)


@MAP2DS.register("4")
@MAP2DS.register("render")
class RenderMap2D(MultiBandMap2D):
    """Batched multiband compositor, the Map2DRender analogue: queued
    frames are composited Map2D.RenderBatch at a time (a short batch is
    padded with zero-weight copies of its last frame, as the reference's
    fixed-size scan is), with max-weight seams or, with
    Map2DRender.EnableSeam, the smoothed-argmax seam pass
    (`mosaic.seam_masks_batch`, Map2DRender.SeamSigma)."""

    def __init__(self, cfg=None, device=None):
        super().__init__(cfg, device)
        self.batch = max(1, int(self.cfg.get_int("Map2D.RenderBatch", 8)))
        self.enable_seam = self.cfg.get_bool("Map2DRender.EnableSeam",
                                             False)
        self.seam_sigma = self.cfg.get_double("Map2DRender.SeamSigma", 3.0)
        self._pending: List = []   # (img tensor on the device, pose_plane)

    def render_frame(self, img, pose_plane) -> bool:
        with self._lock:
            self._pending.append((upload(img, self.device), pose_plane))
            full = len(self._pending) >= self.batch
        if full:
            self.flush()
        return True

    def flush(self):
        """Composite every pending frame as one batch."""
        with self._lock:
            pending, self._pending = self._pending, []
            if not pending:
                return
            # pass 1: union footprint -> grow the canvas once, so every
            # origin below is computed against the settled min_xy
            boxes = []
            for img, pp in pending:
                pts, ok = M.plane_corners_np(pp, self.camera)
                boxes.append(pts if ok else None)
            live = [b for b in boxes if b is not None]
            self.frames_skipped += len(boxes) - len(live)
            if not live:
                return
            allpts = np.concatenate(live, 0)
            self._maybe_grow(allpts[:, 0].min(), allpts[:, 1].min(),
                             allpts[:, 0].max(), allpts[:, 1].max())
            # pass 2: per-frame geometry (growth is now a no-op)
            imgs, hs, origins, won = [], [], [], []
            for (img, pp), box in zip(pending, boxes):
                if box is None:
                    continue
                geo = self._frame_geometry(pp)
                if geo is None:
                    self.frames_skipped += 1
                    continue
                (ty0, tx0), H = geo
                if img.ndim == 2:
                    img = img[..., None].expand(-1, -1, 3)
                imgs.append(img)
                hs.append(H)
                origins.append((ty0 * ELE, tx0 * ELE))
                won.append(1.0)
            if not imgs:
                return
            while len(imgs) < self.batch:
                imgs.append(imgs[-1])
                hs.append(hs[-1])
                origins.append(origins[-1])
                won.append(0.0)
            with timer.scope("RenderMap2D::renderFrames"):
                imgs_t = torch.stack(imgs).to(torch.float32)
                hs_t = upload(np.stack(hs), self.device, torch.float32)
                self._mark("geometry")
                masks = None
                if self.enable_seam:
                    ih, iw = imgs_t.shape[1:3]
                    masks = M.seam_masks_batch(
                        hs_t, origins, won, (ih, iw), self.patch_hw,
                        (self.h_tiles * ELE, self.w_tiles * ELE),
                        weight_type=self.weight_type,
                        smooth_sigma=float(self.seam_sigma))
                    self._mark("seam")
                M.composite_frames_batch(
                    self.canvas_lap, self.canvas_w, imgs_t, hs_t, origins,
                    won, bands=self.bands, patch_hw=self.patch_hw,
                    weight_type=self.weight_type, half_res=self.fast_warp,
                    warp=self.warp_mode, seam_masks=masks, mark=self.mark)
            self.frames_rendered += int(np.sum(np.asarray(won) > 0))

    def blended(self, bg: Optional[float] = None):
        self.flush()
        return super().blended(bg)


@MAP2DS.register("1")
@MAP2DS.register("weighted")
class WeightedMap2D(Map2DBase):
    """Single-band weighted running blend (Map2DCPU semantics: per-pixel
    accumulate weight*color and weight, display sum/weight)."""

    def __init__(self, cfg=None, device=None):
        super().__init__(cfg, device)
        self.weight_type = int(self.cfg.get_int("Map2D.WeightType", 0))
        self.acc = None   # [H, W, 3]
        self.wsum = None  # [H, W, 1]

    def _alloc(self):
        H, W = self.h_tiles * ELE, self.w_tiles * ELE
        self.acc = torch.zeros((H, W, 3), dtype=torch.float32,
                               device=self.device)
        self.wsum = torch.zeros((H, W, 1), dtype=torch.float32,
                                device=self.device)

    def _grow(self, top, bottom, left, right):
        H = (self.h_tiles + top + bottom) * ELE
        W = (self.w_tiles + left + right) * ELE
        y0, x0 = top * ELE, left * ELE
        for name in ("acc", "wsum"):
            old = getattr(self, name)
            new = old.new_zeros((H, W, old.shape[2]))
            new[y0:y0 + old.shape[0], x0:x0 + old.shape[1]] = old
            setattr(self, name, new)
        self._shift_origin(top, bottom, left, right)

    def _patch(self, ty0, tx0):
        ph = self.patch_tiles * ELE
        return (slice(ty0 * ELE, ty0 * ELE + ph),
                slice(tx0 * ELE, tx0 * ELE + ph))

    def _render_frame_locked(self, img, pose_plane) -> bool:
        geo = self._frame_geometry(pose_plane)
        if geo is None:
            self.frames_skipped += 1
            return False
        (ty0, tx0), H = geo
        img32, h = self._upload_frame(img, H)
        self._mark("geometry")
        patch_px = self.patch_tiles * ELE
        warped, w = M.warp_frame_to_patch(img32, h, (patch_px, patch_px),
                                          self.weight_type)
        self._mark("warp")
        sl = self._patch(ty0, tx0)
        self.acc[sl] = self.acc[sl] + warped * w
        self.wsum[sl] = self.wsum[sl] + w
        self._mark("composite")
        self.frames_rendered += 1
        return True

    def _clear_rect_px(self, y0, y1, x0, x1):
        sl = (slice(y0, y1), slice(x0, x1))
        self.acc[sl] = 0.0
        self.wsum[sl] = 0.0

    def blended(self, bg: Optional[float] = None):
        bg = self._background(bg)
        if self.acc is None:      # prepare() hasn't allocated yet
            return _empty()
        with self._lock:
            w = _np(self.wsum)
            acc = _np(self.acc)
        covered = w[..., 0] > 0
        out = np.where(covered[..., None], acc / np.maximum(w, 1e-12), bg)
        return np.clip(out, 0, 255), covered


@MAP2DS.register("2")
@MAP2DS.register("gpu")
class WeightedGPUMap2D(WeightedMap2D):
    """Map2D.Type 2, the CUDA engine's blend rule (Map2DFusion/UtilGPU.cu
    renderFramesKernel:311-381, as compiled):

      * the per-pixel weight is inverse-quadratic distance to the frame's
        footprint center in canvas pixels, w = 1e5 / (d^2 + 1000);
      * blending is a biased overwrite: when the incoming weight >= the
        stored one, out = (old*2*w_old + new*w_new) / (2*w_old + w_new)
        and the stored weight becomes w_new; otherwise the pixel stays.

    As in the reference, the source is sampled bilinearly (the CUDA
    kernel samples nearest-neighbour). `acc` holds blended color here."""

    def _render_frame_locked(self, img, pose_plane) -> bool:
        geo = self._frame_geometry(pose_plane)
        if geo is None:
            self.frames_skipped += 1
            return False
        (ty0, tx0), H = geo
        patch_px = self.patch_tiles * ELE
        # frame footprint center in patch coords: the image center mapped
        # through H^-1 (H: patch px -> image px)
        cam = self.camera
        p = np.linalg.solve(np.asarray(H, np.float64),
                            np.array([cam.cx, cam.cy, 1.0]))
        center = (p[:2] / p[2]).astype(np.float32)
        img32, h = self._upload_frame(img, H)
        self._mark("geometry")
        warped, w_valid = M.warp_frame_to_patch(img32, h,
                                                (patch_px, patch_px), 0)
        self._mark("warp")
        dev = self.device
        yy = torch.arange(patch_px, dtype=torch.float32, device=dev)[:, None]
        xx = torch.arange(patch_px, dtype=torch.float32, device=dev)[None, :]
        d2 = (xx - float(center[0])) ** 2 + (yy - float(center[1])) ** 2
        w_new = (1e5 / (d2 + 1000.0))[..., None]
        w_new = torch.where(w_valid > 0, w_new, torch.zeros_like(w_new))
        sl = self._patch(ty0, tx0)
        cur_c = self.acc[sl]
        cur_w = self.wsum[sl]
        fresh = cur_w <= 0
        take = (cur_w <= w_new) & (w_new > 0)
        denom = torch.clamp(2.0 * cur_w + w_new, min=1e-12)
        mix = (cur_c * 2.0 * cur_w + warped * w_new) / denom
        new_c = torch.where(fresh & (w_new > 0), warped,
                            torch.where(take, mix, cur_c))
        new_w = torch.where(take, w_new, cur_w)
        self.acc[sl] = new_c
        self.wsum[sl] = new_w
        self._mark("composite")
        self.frames_rendered += 1
        return True

    def blended(self, bg: Optional[float] = None):
        bg = self._background(bg)
        if self.acc is None:
            return _empty()
        with self._lock:
            w = _np(self.wsum)
            color = _np(self.acc)
        covered = w[..., 0] > 0
        out = np.where(covered[..., None], color, bg)
        return np.clip(out, 0, 255), covered


def create_map2d(map2d_type, cfg=None, device=None):
    """Factory mirroring Map2D::create (Map2D.cpp:51-66): Type 1-4 or a
    registry name. device: None means `cuda`, and raises without one."""
    return MAP2DS.create(str(map2d_type), cfg, device=device)


def _write_png(path: str, arr: np.ndarray):
    """8-bit RGB PNG with zlib and struct (the reference's own encoder,
    map2d.py:709-738): one unfiltered scanline per row."""
    h, w = arr.shape[:2]
    if arr.ndim == 2:
        arr = np.repeat(arr[..., None], 3, -1)
    raw = b"".join(b"\x00" + arr[i].tobytes() for i in range(h))

    def chunk(tag, data):
        c = struct.pack(">I", len(data)) + tag + data
        return c + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF)

    png = (b"\x89PNG\r\n\x1a\n"
           + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
           + chunk(b"IDAT", zlib.compress(raw, 6))
           + chunk(b"IEND", b""))
    with open(path, "wb") as f:
        f.write(png)


_PNG_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
# Adam7 passes: (first column, first row, column step, row step)
_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
          (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))


def _unfilter_rows(rows, bpp: int):
    """Unfiltered bytes [h, stride] of filtered scanlines [h, 1 + stride]
    (PNG spec section 9). With only None (0), Sub (1) and Up (2) rows:
    None and Sub rows together, Sub as a cumulative sum of each byte lane
    mod 256, a run of Up rows as one cumulative sum down the run from the
    row above it. With Average (3) or Paeth (4) rows, whose bytes depend
    on the byte before them, `_unfilter_diagonals`."""
    ftype, data = rows[:, 0], rows[:, 1:]
    if ftype.max(initial=0) > 4:
        raise ValueError(f"PNG filter type {ftype.max()} is not defined")
    if ftype.max(initial=0) > 2:
        return _unfilter_diagonals(ftype, data, bpp)
    h, stride = data.shape
    out = data.copy()
    sub = np.nonzero(ftype == 1)[0]
    if sub.size:
        out[sub] = np.cumsum(data[sub].reshape(sub.size, -1, bpp), 1,
                             dtype=np.uint8).reshape(sub.size, stride)
    prev = np.zeros(stride, np.uint8)
    y = 0
    while y < h:
        if ftype[y] == 2:
            e = y
            while e < h and ftype[e] == 2:
                e += 1
            out[y:e] = prev + np.cumsum(data[y:e], 0, dtype=np.uint8)
            y = e
        else:
            y += 1
        prev = out[y - 1]
    return out


def _unfilter_diagonals(ftype, data, bpp: int):
    """All rows at once, whatever their filters: a pixel's bytes depend on
    the pixels left, above and above-left of it, so the pixels of one
    anti-diagonal (row + column = k) are undone together, in h + w - 1
    steps of vector operations. The image is held sheared and transposed,
    [k, row, byte], so that an anti-diagonal is one contiguous slice and
    its neighbours the slices before it; what lies outside the image
    stays 0, as the filters' borders are."""
    h, stride = data.shape
    w = stride // bpp
    n = w + h + 2
    cur = np.zeros((n, h, bpp), np.int16)
    out = np.zeros((n, h + 1, bpp), np.int16)
    rows = np.arange(h)
    for x in range(w):      # pixel (y, x) -> diagonal x + y + 2
        cur[x + 2 + rows, rows] = data[:, x * bpp:(x + 1) * bpp]
    t = ftype.astype(np.int16)[:, None]
    for k in range(2, w + h + 1):
        lo, hi = max(0, k - w - 1), min(h, k - 1)
        a = out[k - 1, lo + 1:hi + 1]
        b = out[k - 1, lo:hi]
        c = out[k - 2, lo:hi]
        p = a + b - c
        pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
        paeth = np.where((pa <= pb) & (pa <= pc), a,
                         np.where(pb <= pc, b, c))
        ty = t[lo:hi]
        pred = np.select([ty == 1, ty == 2, ty == 3, ty == 4],
                         [a, b, (a + b) >> 1, paeth], 0)
        out[k, lo + 1:hi + 1] = (cur[k, lo:hi] + pred) & 0xFF
    res = np.empty((h, stride), np.uint8)
    for x in range(w):
        res[:, x * bpp:(x + 1) * bpp] = out[x + 2 + rows, rows + 1]
    return res


def _png_samples(rows, width: int, chans: int, depth: int):
    """Samples [h, width, chans] of unfiltered scanlines [h, stride]."""
    h = rows.shape[0]
    if depth == 16:
        return np.ascontiguousarray(rows).view(">u2").reshape(
            h, width, chans).astype(np.uint16)
    if depth == 8:
        return rows.reshape(h, width, chans)
    bits = np.unpackbits(rows, 1).reshape(h, -1, depth)
    vals = bits @ (1 << np.arange(depth - 1, -1, -1)).astype(np.uint8)
    return vals[:, :width * chans].reshape(h, width, chans)


def _decode_png(data: bytes, path: str) -> np.ndarray:
    """[H, W, 3] uint8 of any PNG, converted to RGB as PIL's
    `convert("RGB")` converts it: palette through PLTE (tRNS ignored);
    16-bit colour and gray+alpha by their high byte, 16-bit gray clipped
    at 255 (PIL's I;16 mode); 1-, 2- and 4-bit gray scaled to 0-255;
    alpha dropped."""
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError(f"{path}: not a PNG file")
    pos, idat, hdr, plte = 8, [], None, None
    while pos < len(data):
        n, tag = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        if tag == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
        elif tag == b"PLTE":
            plte = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif tag == b"IDAT":
            idat.append(body)
        elif tag == b"IEND":
            break
        pos += 12 + n
    w, h, depth, ctype, _comp, _filt, interlace = hdr
    chans = _PNG_CHANNELS.get(ctype)
    if chans is None or depth not in (1, 2, 4, 8, 16):
        raise ValueError(f"{path}: PNG colour type {ctype} at depth "
                         f"{depth} is not defined")
    bits = depth * chans
    bpp = max(1, bits // 8)
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    img = np.zeros((h, w, chans), np.uint16 if depth == 16 else np.uint8)
    pos = 0
    for x0, y0, dx, dy in (_ADAM7 if interlace else ((0, 0, 1, 1),)):
        pw, ph = -(-(w - x0) // dx), -(-(h - y0) // dy)
        if pw <= 0 or ph <= 0:
            continue
        stride = -(-pw * bits // 8)
        rows = raw[pos:pos + ph * (stride + 1)].reshape(ph, stride + 1)
        pos += ph * (stride + 1)
        img[y0::dy, x0::dx] = _png_samples(_unfilter_rows(rows, bpp), pw,
                                           chans, depth)
    if ctype == 3:
        pal = np.zeros((256, 3), np.uint8)
        pal[:len(plte)] = plte
        return pal[img[..., 0]]
    if depth == 16:
        img = (np.minimum(img, 255) if ctype == 0 else img >> 8).astype(
            np.uint8)
    elif depth < 8:
        img = img * np.uint8(255 // ((1 << depth) - 1))
    if chans < 3:
        return np.repeat(img[..., :1], 3, -1)
    return np.ascontiguousarray(img[..., :3])


def read_png(path: str) -> np.ndarray:
    """[H, W, 3] uint8 RGB of any PNG: through PIL's `convert("RGB")` where
    PIL imports, as the reference reads it (map2d.py:740-745), else
    through the package's own decoder, which converts as PIL does."""
    try:
        from PIL import Image
    except ImportError:
        Image = None
    if Image is not None:
        with Image.open(path) as img:
            return np.asarray(img.convert("RGB"))
    with open(path, "rb") as f:
        return _decode_png(f.read(), path)
