"""Frame and MapPoint host-side containers.

Port of pislamfusion_tpu/models/frame.py (the reference's MapFrame /
MapPoint, GSLAM-DIYSLAM/src/MapFrame.{h,cpp}, MapPoint.{h,cpp}): a frame
carries its camera, image, padded feature arrays (the products of
`ops.features`), unprojected rays, the keypoint->mappoint assignment, GPS,
and its pose; a map point carries position/normal/color/descriptor and a
bidirectionally-consistent observation dict.

Feature storage is DEVICE-FIRST: the fused tracker leaves the padded
feature tensors on the frame's device (`feats_dev`), and host numpy views
are made on first access, from ONE packed [N, C] float32 tensor (one
copy to the host, one synchronisation). Ordinary tracked frames are never
copied at all; only keyframes (the mapper reads descriptors) and
bootstrap frames are.

This module is a copy of the reference's with its imports changed; the
definitions that differ (the packing, and the two methods that move the
packed buffer and read its descriptor dtype) are the ones that handle
torch tensors.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from ..core.camera import Camera

# padded per-keypoint arrays produced by ops.features.*_detect
_FEAT_KEYS = ("xy", "desc", "angle", "octave", "response", "valid")
_FEAT_DTYPES = {"xy": np.float32, "angle": np.float32, "octave": np.int32,
                "response": np.float32, "valid": bool}


def _pack_feats(fd: dict):
    """Concatenate every feature array into ONE float32 [N, C] tensor on
    the features' device, so that the host copy is one transfer and one
    synchronisation. All values survive the float32 round trip exactly:
    ORB descriptor bits (0/1), octave indices, and the bool mask are
    integers well under 2^24; xy/angle/response/SIFT descriptors are
    float32 already."""
    n = fd["xy"].shape[0]
    return torch.cat([fd[k].to(torch.float32).reshape(n, -1)
                      for k in _FEAT_KEYS if k in fd], 1)


@dataclasses.dataclass
class Frame:
    id: int
    timestamp: float
    camera: Camera
    image: Optional[np.ndarray] = None          # [H, W] gray or [H, W, 3]
    color: Optional[np.ndarray] = None          # [H, W, 3] for the mosaic
    # full-resolution gray kept for the mosaic when SLAM.TrackScale
    # downsampled `image` and no color frame exists (models/slam.py)
    mosaic_image: Optional[np.ndarray] = None
    desc_kind: str = "orb"
    pose_c2w: np.ndarray = dataclasses.field(
        default_factory=lambda: np.array([0, 0, 0, 0, 0, 0, 1.0], np.float32))
    kp2mp: Optional[np.ndarray] = None          # [N] int64 mappoint id or -1
    gps_lla: Optional[np.ndarray] = None        # (lon, lat, alt)
    gps_enu: Optional[np.ndarray] = None        # local-frame xyz
    gps_acc: float = 5.0
    pyr: Optional[np.ndarray] = None            # (pitch, yaw, roll) degrees
    height_ground: Optional[float] = None       # height above ground (m)
    is_keyframe: bool = False
    # keyframe connection weights: {frame_id: shared point count}
    connections: Dict[int, int] = dataclasses.field(default_factory=dict)
    # lazy BoW word set (MapFrame.cpp:156-209 lazy BoW via global vocab)
    bow_words: Optional[np.ndarray] = None
    image_path: Optional[str] = None   # source file (dataset frames)
    # device-resident padded feature dict (torch tensors); host cache below
    feats_dev: Optional[dict] = dataclasses.field(default=None, repr=False)
    _feats: Optional[dict] = dataclasses.field(default=None, repr=False)
    _rays: Optional[np.ndarray] = dataclasses.field(default=None, repr=False)

    # ------------------------------------------------------------- features
    def set_features(self, feats: dict, kind: str):
        """Install padded feature arrays host-side (eager numpy copy)."""
        self._feats = {k: np.asarray(feats[k], _FEAT_DTYPES.get(k))
                       for k in _FEAT_KEYS if k in feats}
        self.desc_kind = kind
        self._rays = None
        self.kp2mp = np.full(len(self._feats["xy"]), -1, np.int64)

    def set_features_device(self, feats_dev: dict, kind: str):
        """Install DEVICE feature arrays; host views materialize lazily."""
        self.feats_dev = {k: feats_dev[k] for k in _FEAT_KEYS
                          if k in feats_dev}
        self.desc_kind = kind
        self._feats = None
        self._rays = None
        self.kp2mp = np.full(int(feats_dev["xy"].shape[0]), -1, np.int64)

    def _materialize(self):
        """ONE device->host copy of every feature array (see
        _pack_feats)."""
        ctx = self.dispatch_pack()
        if ctx is None:
            return
        fd, buf = ctx
        self.install_packed(fd, buf.cpu().numpy())  # [N, C], single copy

    def dispatch_pack(self):
        """Enqueue (but do not copy) the packed host-copy buffer.

        Returns (feats_dev snapshot, device buffer) — the caller copies
        the buffer, ideally merged into one copy with other results (the
        mapper's keyframe path batches it with the triangulation sweep
        and fuse bind), then calls install_packed. None when there is
        nothing on device."""
        fd = self.feats_dev   # snapshot: another thread may null this field
        if fd is None:
            return None
        return fd, _pack_feats(fd)

    def install_packed(self, fd, buf):
        """Unpack a fetched _pack_feats buffer into the host-side feature
        dict. No-op if another thread's materialize already won (both
        produce identical contents)."""
        if self._feats is not None:
            return
        feats, c = {}, 0
        for k in _FEAT_KEYS:
            if k not in fd:
                continue
            w = int(np.prod(fd[k].shape[1:], dtype=np.int64)) \
                if fd[k].ndim > 1 else 1
            col = buf[:, c:c + w] if fd[k].ndim > 1 else buf[:, c]
            c += w
            if k == "desc":
                feats[k] = col.astype(np.uint8) \
                    if fd[k].dtype == torch.uint8 else col
            else:
                feats[k] = col.astype(_FEAT_DTYPES.get(k, np.float32))
        self._feats = feats

    def ensure_host_features(self):
        if self._feats is None and self.feats_dev is not None:
            self._materialize()

    def release_device_features(self):
        """Drop device buffers (called once the frame is no longer the
        tracker's staging input). Keyframes keep/acquire host copies; plain
        frames simply free the HBM."""
        if self.feats_dev is not None and self._feats is None \
                and self.is_keyframe:
            self._materialize()
        self.feats_dev = None

    def _host(self, key):
        f = self._feats
        if f is None:
            if self.feats_dev is not None:
                self._materialize()
            f = self._feats
            if f is None:
                return None
        return f.get(key)

    def _set_host(self, key, value):
        if self._feats is None:
            self._feats = {}
        if value is None:
            self._feats.pop(key, None)
        else:
            self._feats[key] = np.asarray(value, _FEAT_DTYPES.get(key))
        if key == "xy":
            self._rays = None

    # feature accessors (checkpoint load writes through the setters)
    @property
    def xy(self):
        return self._host("xy")

    @xy.setter
    def xy(self, v):
        self._set_host("xy", v)

    @property
    def desc(self):
        return self._host("desc")

    @desc.setter
    def desc(self, v):
        self._set_host("desc", v)

    @property
    def angle(self):
        return self._host("angle")

    @angle.setter
    def angle(self, v):
        self._set_host("angle", v)

    @property
    def octave(self):
        return self._host("octave")

    @octave.setter
    def octave(self, v):
        self._set_host("octave", v)

    @property
    def response(self):
        return self._host("response")

    @response.setter
    def response(self, v):
        self._set_host("response", v)

    @property
    def valid(self):
        return self._host("valid")

    @valid.setter
    def valid(self, v):
        self._set_host("valid", v)

    @property
    def rays(self):
        """[N, 3] unprojected pixel rays (z=1), lazily from xy."""
        if self._rays is None and self.xy is not None:
            self._rays = np.asarray(self.camera.unproject(self.xy),
                                    np.float32)
        return self._rays

    @rays.setter
    def rays(self, v):
        self._rays = None if v is None else np.asarray(v, np.float32)

    @property
    def n_kp(self) -> int:
        if self._feats is not None and "xy" in self._feats:
            return len(self._feats["xy"])
        if self.feats_dev is not None:
            return int(self.feats_dev["xy"].shape[0])
        return 0

    def n_tracked(self) -> int:
        return 0 if self.kp2mp is None else int((self.kp2mp >= 0).sum())

    def median_depth(self, points_xyz: np.ndarray) -> float:
        """Median depth of given world points in this camera
        (MapFrame::getMedianDepth, MapFrame.cpp:135-154). Host numpy — this
        runs in per-keyframe bookkeeping, no device round trip."""
        from ..utils import host_se3 as hse3
        if len(points_xyz) == 0:
            return 1.0
        pc = hse3.se3_apply(hse3.se3_inv(self.pose_c2w), points_xyz)
        z = pc[:, 2]
        z = z[z > 0]
        return float(np.median(z)) if len(z) else 1.0

    def priory_pose(self):
        """GPS+attitude prior pose in the local ENU frame:
        (SE3 c2w [7] float32, scale) or None.

        MapFrame::getPrioryPose (MapFrame.cpp:369-401) re-based from ECEF to
        the ENU local frame this build geo-registers in: the reference's
        local2ECEF rotation (east/north/up columns) is exactly the ENU->ECEF
        change of basis, so camera->ENU is PYR2Rotation alone with the ENU
        fix as translation. Scale is height-above-ground when measured, else
        the caller substitutes median depth."""
        if self.gps_enu is None or self.pyr is None:
            return None
        from ..core.gps import pyr_to_rotation
        q = pyr_to_rotation(*[float(v) for v in self.pyr[:3]])
        scale = (float(self.height_ground)
                 if self.height_ground is not None else 1.0)
        T = np.concatenate([np.asarray(self.gps_enu, np.float64),
                            q]).astype(np.float32)
        return T, scale


@dataclasses.dataclass
class MapPoint:
    id: int
    position: np.ndarray                         # [3]
    descriptor: np.ndarray                       # [D]
    normal: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(3, np.float32))
    color: np.ndarray = dataclasses.field(
        default_factory=lambda: np.full(3, 128, np.uint8))
    ref_frame: int = -1
    observations: Dict[int, int] = dataclasses.field(default_factory=dict)
    bad: bool = False
    created_at_kf: int = 0                       # for culling bookkeeping

    def n_obs(self) -> int:
        return len(self.observations)
