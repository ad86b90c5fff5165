"""The SLAM map store: frames + map points with consistent observations.

Equivalent of the reference's MapHash (GSLAM-DIYSLAM/src/zhaoyong/
MapHash.cpp): hash stores with id allocators (:38-99), bidirectionally
consistent add/erase of observations (MapFrame.cpp:22-97 / MapPoint private
add/erase), binary checkpoint save/load (:365-545), and exporters: .ply
point cloud (:548-620), TUM trajectory.txt, and a Map2DFusion input folder.

Thread-safety: a single RLock over mutations (the reference uses RW mutexes
per structure; our mutation rate is per-keyframe, not per-pixel, so one lock
suffices — the compute-heavy work happens on the device outside it).
"""
from __future__ import annotations

import pickle
import threading
from typing import Dict, List, Optional

import numpy as np

from ..core.registry import MAPS
from .frame import Frame, MapPoint

CHECKPOINT_MAGIC = b"PSFTPU_MAP_V1"


@MAPS.register("Hash")
class WorldMap:
    def __init__(self, cfg=None):
        self._frames: Dict[int, Frame] = {}
        self._points: Dict[int, MapPoint] = {}
        self._next_fid = 0
        self._next_pid = 0
        self._lock = threading.RLock()
        # coarse guard for WHOLE-MAP geometry rewrites (GPS SIM3 fits, loop
        # closures, BA writeback) vs the tracker's staging reads: writers
        # hold update_lock and bump `version`; the tracker snapshots inputs
        # under the lock and discards a fused result if version moved while
        # the device step was in flight (the map changed gauge under it)
        self.update_lock = threading.RLock()
        self.version = 0
        self._keyframe_ids: List[int] = []
        # lazily-built packed keyframe-center array for the loop
        # detector's distance sweep (LoopDetectorGPS.cpp:28-56 rescans
        # all keyframes per query; here the scan is one vectorized numpy
        # norm over this cache). Invalidated on keyframe insert/erase and
        # on whole-map gauge rewrites (version bump); local-BA pose
        # nudges (meters) are accepted as staleness against the
        # hundreds-of-meters loop radius.
        self._kf_center_cache = None   # (version, ids [K] i64, ctr [K,3])

    # ---------------------------------------------------------------- ids
    def get_fid(self) -> int:
        with self._lock:
            fid = self._next_fid
            self._next_fid += 1
            return fid

    def get_pid(self) -> int:
        with self._lock:
            pid = self._next_pid
            self._next_pid += 1
            return pid

    # ------------------------------------------------------------- frames
    def insert_frame(self, frame: Frame):
        with self._lock:
            self._frames[frame.id] = frame
            if frame.is_keyframe:
                self._keyframe_ids.append(frame.id)
                self._kf_center_cache = None

    def erase_frame(self, fid: int):
        with self._lock:
            fr = self._frames.pop(fid, None)
            if fr is None:
                return
            if fid in self._keyframe_ids:
                self._keyframe_ids.remove(fid)
                self._kf_center_cache = None
            # drop its observations
            if fr.kp2mp is not None:
                for pid in fr.kp2mp[fr.kp2mp >= 0]:
                    mp = self._points.get(int(pid))
                    if mp is not None:
                        mp.observations.pop(fid, None)
            for other in self._frames.values():
                other.connections.pop(fid, None)

    def frame(self, fid: int) -> Optional[Frame]:
        return self._frames.get(fid)

    def frames(self) -> List[Frame]:
        with self._lock:
            return list(self._frames.values())

    def keyframes(self) -> List[Frame]:
        with self._lock:
            return [self._frames[i] for i in self._keyframe_ids
                    if i in self._frames]

    def frame_num(self) -> int:
        return len(self._frames)

    # ------------------------------------------------------------- points
    def insert_point(self, mp: MapPoint):
        with self._lock:
            self._points[mp.id] = mp

    def erase_point(self, pid: int):
        with self._lock:
            mp = self._points.pop(pid, None)
            if mp is None:
                return
            for fid, kp_idx in mp.observations.items():
                fr = self._frames.get(fid)
                if fr is not None and fr.kp2mp is not None \
                        and fr.kp2mp[kp_idx] == pid:
                    fr.kp2mp[kp_idx] = -1

    def point(self, pid: int) -> Optional[MapPoint]:
        return self._points.get(pid)

    def points(self) -> List[MapPoint]:
        with self._lock:
            return list(self._points.values())

    def point_num(self) -> int:
        return len(self._points)

    def add_observation(self, pid: int, fid: int, kp_idx: int):
        """Bidirectionally consistent (MapFrame.cpp:22-97)."""
        with self._lock:
            mp = self._points.get(pid)
            fr = self._frames.get(fid)
            if mp is None or fr is None:
                return False
            mp.observations[fid] = int(kp_idx)
            fr.kp2mp[kp_idx] = pid
            return True

    def erase_observation(self, pid: int, fid: int):
        with self._lock:
            mp = self._points.get(pid)
            if mp is None:
                return
            kp = mp.observations.pop(fid, None)
            fr = self._frames.get(fid)
            if fr is not None and kp is not None and fr.kp2mp[kp] == pid:
                fr.kp2mp[kp] = -1

    # ---------------------------------------------------------- array views
    def keyframe_center_arrays(self):
        """(ids [K] int64, centers [K,3] f32) of all keyframes' camera
        centers, cached across calls (see _kf_center_cache note). One
        numpy build per keyframe-set change or gauge rewrite instead of
        a per-candidate Python loop on every loop-detector query."""
        with self._lock:
            c = self._kf_center_cache
            if c is not None and c[0] == self.version:
                return c[1], c[2]
            kfs = [self._frames[i] for i in self._keyframe_ids
                   if i in self._frames]
            ids = np.asarray([f.id for f in kfs], np.int64)
            if kfs:
                ctr = np.stack([np.asarray(f.pose_c2w[:3], np.float32)
                                for f in kfs])
            else:
                ctr = np.zeros((0, 3), np.float32)
            self._kf_center_cache = (self.version, ids, ctr)
            return ids, ctr

    def point_position_sample(self, cap: int = 256) -> np.ndarray:
        """[<=cap, 3] strided sample of good point positions without
        materializing the full object list (loop-detector depth proxy)."""
        with self._lock:
            n = len(self._points)
            if n == 0:
                return np.zeros((0, 3), np.float32)
            step = max(1, n // cap)
            out = [p.position for i, p in enumerate(self._points.values())
                   if i % step == 0 and not p.bad]
            return (np.asarray(out, np.float32) if out
                    else np.zeros((0, 3), np.float32))

    def point_arrays(self, ids: Optional[List[int]] = None):
        """(ids, positions [P,3], descs [P,D]) snapshot for device kernels."""
        with self._lock:
            if ids is None:
                ids = [p.id for p in self._points.values() if not p.bad]
            pts = [self._points[i] for i in ids if i in self._points]
            if not pts:
                return [], np.zeros((0, 3), np.float32), None
            pos = np.stack([p.position for p in pts]).astype(np.float32)
            desc = np.stack([p.descriptor for p in pts])
            return [p.id for p in pts], pos, desc

    # ----------------------------------------------------------- checkpoint
    def save(self, path: str) -> bool:
        """Map checkpoint. Two formats by extension, mirroring the
        reference's dispatch (MapHash::save, MapHash.cpp:376-381):

        * ``.npz`` (and any extension not listed below) -> this build's
          native format (magic header + npz of plain arrays,
          allow_pickle=False — safe, lossless, refactor-stable);
        * ``.map`` / ``.gmap`` / ``.maphash`` / ``.bin`` -> the
          reference's MapHash BINARY layout (io/maphash.py), loadable by
          the C++ system and vice versa. MapHash is intentionally opt-in
          by extension: it cannot carry this build's full state (valid
          masks, keyframe flags, per-axis GPS sigma), so an arbitrary
          user path must not silently lose fidelity. load() sniffs the
          header, so either format loads from any name.
        """
        if path.endswith((".map", ".gmap", ".maphash", ".bin")):
            from ..io import maphash
            with self._lock:
                data = maphash.from_worldmap(self)
            return maphash.save_file(path, data)
        import io as _io
        with self._lock:
            frames = list(self._frames.values())
            points = [p for p in self._points.values() if not p.bad]
            fids = np.asarray([f.id for f in frames], np.int64)
            arrs = {
                "frame_id": fids,
                "frame_ts": np.asarray([f.timestamp for f in frames]),
                "frame_pose": np.stack([f.pose_c2w for f in frames])
                if frames else np.zeros((0, 7), np.float32),
                "frame_is_kf": np.asarray([f.is_keyframe for f in frames],
                                          bool),
                "frame_gps_acc": np.asarray([f.gps_acc for f in frames]),
                "next_ids": np.asarray([self._next_fid, self._next_pid],
                                       np.int64),
            }
            # per-frame camera parameter rows (padded to the longest model)
            cam_rows = [f.camera.parameters() for f in frames]
            cw = max((len(c) for c in cam_rows), default=6)
            arrs["frame_camera"] = np.asarray(
                [c + [0.0] * (cw - len(c)) for c in cam_rows]).reshape(
                    len(frames), cw)
            arrs["frame_camlen"] = np.asarray([len(c) for c in cam_rows],
                                              np.int64)
            # features: uniform N per frame in practice; store stacked with
            # per-frame keypoint counts to stay general
            kp_counts = np.asarray([f.n_kp for f in frames], np.int64)
            arrs["frame_nkp"] = kp_counts
            if frames and frames[0].xy is not None:
                for key in ("xy", "desc", "angle", "octave", "response",
                            "valid", "kp2mp"):
                    arrs["kp_" + key] = np.concatenate(
                        [getattr(f, key) for f in frames], 0)
                arrs["frame_desc_kind"] = np.asarray(
                    [1 if f.desc_kind == "sift" else 0 for f in frames],
                    np.int8)
            gps = np.full((len(frames), 6), np.nan)
            for i, f in enumerate(frames):
                if f.gps_lla is not None:
                    gps[i, :3] = f.gps_lla
                if f.gps_enu is not None:
                    gps[i, 3:6] = f.gps_enu
            arrs["frame_gps"] = gps
            conn = [(f.id, cid, n) for f in frames
                    for cid, n in f.connections.items()]
            arrs["connections"] = np.asarray(conn, np.int64) if conn \
                else np.zeros((0, 3), np.int64)
            arrs["point_id"] = np.asarray([p.id for p in points], np.int64)
            arrs["point_pos"] = np.stack([p.position for p in points]) \
                if points else np.zeros((0, 3), np.float32)
            arrs["point_normal"] = np.stack(
                [p.normal if p.normal is not None else np.zeros(3)
                 for p in points]) if points else np.zeros((0, 3))
            arrs["point_color"] = np.stack([p.color for p in points]) \
                if points else np.zeros((0, 3), np.uint8)
            arrs["point_desc"] = np.stack([p.descriptor for p in points]) \
                if points else np.zeros((0, 1), np.uint8)
            arrs["point_ref"] = np.asarray([p.ref_frame for p in points],
                                           np.int64)
            obs = [(p.id, fid, kp) for p in points
                   for fid, kp in p.observations.items()]
            arrs["observations"] = np.asarray(obs, np.int64) if obs \
                else np.zeros((0, 3), np.int64)
        buf = _io.BytesIO()
        np.savez_compressed(buf, **arrs)
        with open(path, "wb") as fh:
            fh.write(b"PSFTPU_MAP_V2")
            fh.write(buf.getvalue())
        return True

    def load(self, path: str) -> bool:
        """Load any supported checkpoint, sniffing the header: our npz
        format, the legacy v1 format, or a reference MapHash binary
        ("Hash\\nbinary\\n" — MapHash.cpp:470-473)."""
        from ..core.camera import Camera
        from ..io import maphash
        with open(path, "rb") as fh:
            magic = fh.read(13)
            if magic == b"PSFTPU_MAP_V2":
                import io as _io
                data = np.load(_io.BytesIO(fh.read()), allow_pickle=False)
            elif magic == CHECKPOINT_MAGIC[:13]:
                return self._load_v1(path)
            elif magic.startswith(maphash.MAGIC[:12]):
                maphash.into_worldmap(maphash.load_file(path), self)
                return True
            else:
                return False
        with self._lock:
            self._frames.clear()
            self._points.clear()
            self._keyframe_ids.clear()
            self._kf_center_cache = None
            self.version += 1   # a load replaces the whole map: stale
                                # caches and in-flight device steps must
                                # observe the gauge change
            n = len(data["frame_id"])
            nkp = data["frame_nkp"]
            offs = np.concatenate([[0], np.cumsum(nkp)])
            for i in range(n):
                cam_p = list(data["frame_camera"][i][
                    :int(data["frame_camlen"][i])])
                fr = Frame(id=int(data["frame_id"][i]),
                           timestamp=float(data["frame_ts"][i]),
                           camera=Camera.from_parameters(cam_p))
                fr.pose_c2w = data["frame_pose"][i]
                fr.is_keyframe = bool(data["frame_is_kf"][i])
                fr.gps_acc = float(data["frame_gps_acc"][i])
                g = data["frame_gps"][i]
                if np.isfinite(g[:3]).all():
                    fr.gps_lla = g[:3].copy()
                if np.isfinite(g[3:6]).all():
                    fr.gps_enu = g[3:6].astype(np.float32)
                if "kp_xy" in data and nkp[i] > 0:
                    s, e = offs[i], offs[i + 1]
                    for key in ("xy", "desc", "angle", "octave", "response",
                                "valid", "kp2mp"):
                        setattr(fr, key, data["kp_" + key][s:e].copy())
                    fr.desc_kind = ("sift" if data["frame_desc_kind"][i]
                                    else "orb")
                    fr.rays = np.asarray(fr.camera.unproject(fr.xy),
                                         np.float32)
                self._frames[fr.id] = fr
                if fr.is_keyframe:
                    self._keyframe_ids.append(fr.id)
            for fid, cid, cnum in data["connections"]:
                fr = self._frames.get(int(fid))
                if fr is not None:
                    fr.connections[int(cid)] = int(cnum)
            for i in range(len(data["point_id"])):
                mp = MapPoint(id=int(data["point_id"][i]),
                              position=data["point_pos"][i],
                              descriptor=data["point_desc"][i])
                mp.normal = data["point_normal"][i].astype(np.float32)
                mp.color = data["point_color"][i]
                mp.ref_frame = int(data["point_ref"][i])
                self._points[mp.id] = mp
            for pid, fid, kp in data["observations"]:
                mp = self._points.get(int(pid))
                if mp is not None:
                    mp.observations[int(fid)] = int(kp)
            self._next_fid = int(data["next_ids"][0])
            self._next_pid = int(data["next_ids"][1])
        return True

    def _save_v1(self, path: str) -> bool:
        """Legacy pickle checkpoint (round-1 format; kept for migration)."""
        with self._lock:
            blob = {
                "frames": [{
                    "id": f.id, "timestamp": f.timestamp,
                    "camera": f.camera.parameters(),
                    "pose_c2w": f.pose_c2w, "xy": f.xy, "desc": f.desc,
                    "desc_kind": f.desc_kind,
                    "angle": f.angle, "octave": f.octave,
                    "response": f.response, "valid": f.valid,
                    "kp2mp": f.kp2mp, "gps_lla": f.gps_lla,
                    "gps_enu": f.gps_enu,
                    "is_keyframe": f.is_keyframe,
                    "connections": dict(f.connections),
                } for f in self._frames.values()],
                "points": [{
                    "id": p.id, "position": p.position, "normal": p.normal,
                    "color": p.color, "descriptor": p.descriptor,
                    "ref_frame": p.ref_frame,
                    "observations": dict(p.observations),
                } for p in self._points.values() if not p.bad],
                "next_fid": self._next_fid, "next_pid": self._next_pid,
            }
        with open(path, "wb") as fh:
            fh.write(CHECKPOINT_MAGIC)
            pickle.dump(blob, fh, protocol=4)
        return True

    def _load_v1(self, path: str) -> bool:
        from ..core.camera import Camera
        with open(path, "rb") as fh:
            magic = fh.read(len(CHECKPOINT_MAGIC))
            if magic != CHECKPOINT_MAGIC:
                return False
            blob = pickle.load(fh)
        with self._lock:
            self._frames.clear()
            self._points.clear()
            self._keyframe_ids.clear()
            self._kf_center_cache = None
            self.version += 1   # a load replaces the whole map: stale
                                # caches and in-flight device steps must
                                # observe the gauge change
            for fd in blob["frames"]:
                fr = Frame(id=fd["id"], timestamp=fd["timestamp"],
                           camera=Camera.from_parameters(fd["camera"]))
                for k in ("pose_c2w", "xy", "desc", "angle", "octave",
                          "response", "valid", "kp2mp", "gps_lla", "gps_enu"):
                    setattr(fr, k, fd[k])
                fr.desc_kind = fd["desc_kind"]
                fr.is_keyframe = fd["is_keyframe"]
                fr.connections = fd["connections"]
                if fr.xy is not None:
                    fr.rays = np.asarray(fr.camera.unproject(fr.xy),
                                         np.float32)
                self._frames[fr.id] = fr
                if fr.is_keyframe:
                    self._keyframe_ids.append(fr.id)
            for pd in blob["points"]:
                mp = MapPoint(id=pd["id"], position=pd["position"],
                              descriptor=pd["descriptor"])
                mp.normal = pd["normal"]
                mp.color = pd["color"]
                mp.ref_frame = pd["ref_frame"]
                mp.observations = pd["observations"]
                self._points[mp.id] = mp
            self._next_fid = blob["next_fid"]
            self._next_pid = blob["next_pid"]
        return True

    # ------------------------------------------------------------ exporters
    def export_ply(self, path: str) -> bool:
        """Colored point cloud + keyframe centers (MapHash.cpp:548-620)."""
        pts = [p for p in self._points.values() if not p.bad]
        with open(path, "w") as fh:
            fh.write("ply\nformat ascii 1.0\n"
                     f"element vertex {len(pts)}\n"
                     "property float x\nproperty float y\nproperty float z\n"
                     "property uchar red\nproperty uchar green\n"
                     "property uchar blue\nend_header\n")
            for p in pts:
                x, y, z = p.position
                r, g, b = p.color
                fh.write(f"{x} {y} {z} {int(r)} {int(g)} {int(b)}\n")
        return True

    def export_trajectory(self, path: str) -> bool:
        """TUM format: timestamp tx ty tz qx qy qz qw."""
        with open(path, "w") as fh:
            for f in sorted(self._frames.values(), key=lambda f: f.timestamp):
                t = f.pose_c2w
                fh.write(f"{f.timestamp:.6f} " +
                         " ".join(f"{v:.7f}" for v in t) + "\n")
        return True
