"""FastVO: batch visual odometry + orthomosaic over a ground plane.

Port of pislamfusion_tpu/models/fastvo.py:36-313 with one frame per step
and either detector of the reference. Per frame: rgb->gray, feature
extraction, a windowed match against the previous frame's plane points,
an 8-iteration pose-only Huber LM, plane re-unprojection, then the mosaic
feed (canvas->image homography, by default K3 shear warp at half
resolution, Laplacian pyramid and weight pyramid through K8, analytic
weights, max-weight composite).

- detector "orb" (the reference's default here): the K1 flat pyramid
  (or, with pyramid="packed", the K7 serial packed pyramid), FAST + NMS +
  per-cell selection (K4 where every level keeps one keypoint a cell),
  K2 patch gather, IC angle, binned BRIEF; Hamming match at 80.
- detector "sift" (the reference system's default extractor,
  Default.cfg): K5 octave stacks, DoG extrema, K6 orientation and
  descriptor grids; L2 match at 0.2.

The reference runs the K frames as one `lax.scan` program; here they run
as a Python loop over frames on the device. Nothing inside the loop reads
back to the host, so the loop only enqueues work; the poses and match
counts come back as one packed [K, 8] tensor, fetched once. The canvas
pyramid is the module's buffers (`canvas_lap_<band>`, `canvas_w_<band>`)
and every frame's feed updates it in place. The reference's frame
grouping (`_step_group`, PISLAM_PAIR*, PISLAM_GROUP_SPLIT) was a TPU
scheduling device and is not carried over.

Scope: nadir-ish surveys over a dominant ground plane; frame-to-frame VO
with plane re-unprojection - no keyframes, no BA, no loop closing.
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from ..core.device import resolve_device
from ..ops import ba, image as im, lie
from ..ops import mosaic as M
from ..ops.features import orb, sift
from . import pipeline

ELE = M.ELE_PIXELS
LM_ITERS = 8            # pose-LM iterations per frame (fastvo.py:179-183)


class FastVO(torch.nn.Module):
    """Batch visual odometry + mosaic over a ground plane.

    Usage:
        vo = FastVO(cam, min_xy, canvas_tiles, length_pixel, bands=5)
        poses, n_match = vo.process(frames_rgb, pose0)
        img, covered = vo.blended()

    detector: "orb" or "sift" (n_levels applies to ORB only).
    fast_warp, warp_mode: the feed's warp (the reference's arguments).
    warp_mode "shear" (K3) or "gather"; "" resolves as Map2D.WarpMode
    does, to "shear" on a CUDA device and "gather" elsewhere. fast_warp
    warps at half resolution (band 0's Laplacian zero). The default is
    the reference's path on its accelerator, half-resolution shear.
    pyramid: the ORB front end, "flat" (K1) or "packed" (K7)
    (`orb.orb_detect`).
    device: where everything runs; None means `cuda`, and raises without a
    CUDA device. Pass "cpu" for the plain PyTorch versions of the kernels.
    """

    def __init__(self, camera, min_xy, canvas_tiles: int,
                 length_pixel: float, bands: int = 5,
                 n_features: int = 1000, n_levels: int = 8,
                 window_radius: float = 60.0, patch_tiles: int = 0,
                 fast_warp: bool = True, warp_mode: str = "shear",
                 detector: str = "orb", pyramid: str = "flat",
                 device=None):
        super().__init__()
        self.device = resolve_device(device)
        self.cam = camera
        self.min_xy = np.asarray(min_xy, np.float64)
        self.canvas_tiles = int(canvas_tiles)
        self.length_pixel = float(length_pixel)
        self.bands = int(bands)
        self.detector = detector
        self.fast_warp = bool(fast_warp)
        self.warp_mode = warp_mode or M.default_warp_mode(self.device)
        if self.warp_mode not in ("shear", "gather"):
            raise ValueError(f"warp_mode must be 'shear', 'gather' or '', "
                             f"not {warp_mode!r}")
        if pyramid not in orb.PYRAMIDS:
            raise ValueError(f"pyramid must be one of {orb.PYRAMIDS}, not "
                             f"{pyramid!r}")
        self.pyramid = pyramid
        if detector == "orb":
            self.params = orb.OrbParams(n_features=n_features,
                                        n_levels=n_levels)
        elif detector == "sift":
            self.params = sift.SiftParams(n_features=n_features)
        else:
            raise ValueError(f"detector must be 'orb' or 'sift', not "
                             f"{detector!r}")
        self.window_radius = float(window_radius)
        if not patch_tiles:
            diag = float(np.hypot(camera.width, camera.height))
            patch_tiles = int(np.ceil(diag * 1.0 / ELE)) + 1
        self.patch_tiles = min(int(patch_tiles), self.canvas_tiles)
        # uploaded once: a per-frame host->device copy would wait for
        # the stream and stall the frame loop
        self._min_xy = torch.tensor(self.min_xy, dtype=torch.float32,
                                    device=self.device)
        self._min_xy_at = {}
        lap, w = M.alloc_canvas(self.canvas_tiles, self.canvas_tiles,
                                self.bands, self.device)
        for i, (a, b) in enumerate(zip(lap, w)):
            self.register_buffer(f"canvas_lap_{i}", a)
            self.register_buffer(f"canvas_w_{i}", b)

    @property
    def canvas_lap(self) -> List[torch.Tensor]:
        """Laplacian canvas bands, [H >> i, W >> i, 3] each."""
        return [getattr(self, f"canvas_lap_{i}")
                for i in range(self.bands + 1)]

    @property
    def canvas_w(self) -> List[torch.Tensor]:
        """Canvas weight bands, [H >> i, W >> i, 1] each."""
        return [getattr(self, f"canvas_w_{i}")
                for i in range(self.bands + 1)]

    # ------------------------------------------------------------------
    def _plane_points(self, xy, pose_c2w):
        """Unproject keypoints through the pose onto the plane z=0."""
        cam = self.cam
        rays = torch.stack([(xy[:, 0] - cam.cx) / cam.fx,
                            (xy[:, 1] - cam.cy) / cam.fy,
                            torch.ones_like(xy[:, 0])], -1)
        Rw = lie.quat_rotate(pose_c2w[3:7].expand(xy.shape[0], 4), rays)
        o = pose_c2w[:3]
        rz = Rw[:, 2]
        s = o[2] / torch.where(rz.abs() < 1e-6, torch.full_like(rz, 1e-6),
                               rz)
        return o[None, :] - Rw * s[:, None]

    def _patch_homography(self, pose_c2w):
        """The frame's canvas patch: (origin in canvas tiles [2] int32 as
        (x, y), patch px -> image px homography [3, 3])."""
        cam = self.cam
        es = ELE * self.length_pixel
        min_xy = self._min_xy_on(pose_c2w.device)
        origin_t = torch.floor((pose_c2w[:2] - min_xy) / es).to(torch.int32)
        origin_t = origin_t - self.patch_tiles // 2
        origin_t = origin_t.clamp(0, self.canvas_tiles - self.patch_tiles)
        origin_xy = min_xy + origin_t.to(torch.float32) * es
        return origin_t, M.homography_canvas_to_image(
            pose_c2w, cam.fx, cam.fy, cam.cx, cam.cy, origin_xy,
            self.length_pixel)

    def _min_xy_on(self, device):
        """min_xy as a tensor on `device` (uploaded once a device)."""
        if device == self._min_xy.device:
            return self._min_xy
        t = self._min_xy_at.get(device)
        if t is None:
            t = self._min_xy_at[device] = self._min_xy.to(device)
        return t

    def _feed(self, pose_c2w, rgb, canvas=None):
        """Warp + pyramid + max-weight composite of one frame into the
        canvas (in place): `canvas` = (lap bands, weight bands), on the
        pose's device; None means this FastVO's own."""
        origin_t, Hc2i = self._patch_homography(pose_c2w)
        patch_px = self.patch_tiles * ELE
        rgb3 = rgb if rgb.ndim == 3 else rgb[..., None].expand(-1, -1, 3)
        p_lap, p_w = M.patch_pyramids(rgb3, Hc2i, (patch_px, patch_px),
                                      self.bands, half_res=self.fast_warp,
                                      warp=self.warp_mode)
        oyx = torch.stack([origin_t[1], origin_t[0]]) * ELE
        lap, w = (self.canvas_lap, self.canvas_w) if canvas is None \
            else canvas
        M.composite_patch(lap, w, p_lap, p_w, oyx)

    def _track_core(self, carry, feats):
        """Match + pose LM given the frame's features. carry = (prev_desc,
        prev_valid, prev_p3d, pose_prev2, pose_est). Returns (new carry,
        (pose_new, n_match))."""
        cam = self.cam
        fx, fy, cx, cy = cam.fx, cam.fy, cam.cx, cam.cy
        prev_desc, prev_valid, prev_p3d, pose_prev2, pose_est = carry
        # constant-velocity prediction (TrackerOpt::trackLastFrame)
        pose_pred = lie.se3_mul(
            lie.se3_mul(pose_est, lie.se3_inv(pose_prev2)), pose_est)
        T_pred = lie.se3_inv(pose_pred)
        pix, _ = pipeline.project(T_pred, prev_p3d, fx, fy, cx, cy)
        # matched points carried to the new feature order
        _, ok, p3d, wgt = pipeline.match_to_slots(
            pix, prev_desc, prev_valid, prev_p3d, feats, self.window_radius)
        rays_xy = torch.stack([(feats["xy"][:, 0] - cx) / fx,
                               (feats["xy"][:, 1] - cy) / fy], -1)
        T_ref, _, _ = ba.optimize_pose(T_pred, p3d, rays_xy, wgt,
                                       iters=LM_ITERS,
                                       huber_delta=2.45 / fx)
        pose_new = lie.se3_inv(T_ref)
        new_p3d = self._plane_points(feats["xy"], pose_new)
        return ((feats["desc"], feats["valid"], new_p3d, pose_est,
                 pose_new), (pose_new, ok.sum()))

    def _detect(self, rgb, mark=None):
        """Features of one frame [H, W(, 3)] (any dtype), in the
        detector's three stages; `mark(stage)` as each is enqueued."""
        rgb = rgb.to(torch.float32)
        gray = im.rgb_to_gray(rgb) if rgb.ndim == 3 else rgb
        return pipeline._detect(gray, self.params, self.pyramid, mark)

    def _step(self, carry, rgb, mark=None, canvas=None):
        """One frame: extract + match + pose LM + mosaic feed (into
        `canvas`, see `_feed`). `mark`, when given, is called with each
        stage's name as that stage is enqueued (chip_smoke.py records a
        CUDA event there to time the stages)."""
        carry, (pose_new, n_match) = self._track_core(
            carry, self._detect(rgb, mark))
        pipeline._mark(mark, "match_lm")
        self._feed(pose_new, rgb.to(torch.float32), canvas)
        pipeline._mark(mark, "feed")
        return carry, (pose_new, n_match)

    def initial_carry(self, frame0, pose0):
        """The track carry before frame 0's step: frame 0's features and
        plane points; the motion model starts at rest."""
        f0 = self._detect(frame0)
        p3d0 = self._plane_points(f0["xy"], pose0)
        return (f0["desc"], f0["valid"], p3d0, pose0, pose0)

    def process_tensor(self, frames, pose0, carry=None, mark=None):
        """Track+fuse frames [K, H, W(, 3)] (a tensor on self.device) from
        pose0 [7]. `carry` is the track carry to start from (the one
        `convert.load_fastvo_state` returns, say); None starts from
        `initial_carry(frames[0], pose0)`. `mark` goes to every `_step`.
        Returns the packed [K, 8] tensor (pose, n_match) on the device,
        without waiting for it."""
        if carry is None:
            carry = self.initial_carry(frames[0], pose0)
        poses, nms = [], []
        for k in range(frames.shape[0]):
            carry, (pose_new, n_match) = self._step(carry, frames[k], mark)
            poses.append(pose_new)
            nms.append(n_match)
        return torch.cat([torch.stack(poses),
                          torch.stack(nms).to(torch.float32)[:, None]], -1)

    def process(self, frames, pose0,
                carry=None) -> Tuple[np.ndarray, np.ndarray]:
        """Track+fuse a frame batch. frames: [K, H, W(, 3)] array or tensor
        (uint8 or float); pose0: [7] array or tensor, SE3 c2w of frame 0 in
        plane coordinates (plane = z=0); carry: see `process_tensor`.
        Returns (poses [K, 7], n_matches [K]) as numpy; the mosaic
        accumulates in place."""
        frames = torch.as_tensor(frames).to(self.device)
        pose0 = torch.as_tensor(pose0, dtype=torch.float32,
                                device=self.device)
        # one fetch
        out = self.process_tensor(frames, pose0, carry).cpu().numpy()
        return out[:, :7], out[:, 7].astype(np.int32)

    def blended(self, bg: float = 255.0):
        """Reconstructed mosaic + coverage mask (host numpy)."""
        img, covered = M.reconstruct_canvas(self.canvas_lap, self.canvas_w,
                                            bg=bg)
        return img.cpu().numpy(), covered.cpu().numpy()
