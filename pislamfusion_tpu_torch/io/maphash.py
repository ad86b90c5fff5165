"""MapHash binary checkpoint IO — bit-compatible with the reference.

The reference serializes its full map (points, frames, keypoints,
observations, connections) as a raw little-endian struct stream
(GSLAM-DIYSLAM/src/zhaoyong/MapHash.cpp:365-545, OutStream/InStream
:305-375). This module reads and writes that exact layout so checkpoints
cross between the C++ system and this one — the artifact-level bridge
SURVEY.md section 4 calls for.

Layout (x86-64 little-endian; no containers beyond what is listed):

  header      two text lines: "Hash\n" "binary\n"
  counts      frameNum: u64, pointNum: u64
  per point   id: u64
              position: 3 x f64            (Point3d x, y, z)
              normal:   3 x f64
              color:    3 x u8             (Point3ub; reference BGR order)
              refKeyframe: u64
              descriptor: GImage           (reference writes it EMPTY)
  per frame   id: u64, timestamp: f64
              pose: SIM3 = quat xyzw 4 x f64, translation 3 x f64, scale f64
                    (SO3 members x,y,z,w first — SE3.h:321-323, SO3.h:511)
              image: GImage                (empty), imagePath: string
              imageChannels: i32
              cameraParams: vec<f64>, gpsData: vec<f64>
              descriptors: GImage          (reference writes EMPTY; this
                                            writer CAN populate it — the
                                            reference loader consumes it
                                            via setKeyPoints(kps, des))
              keypoints: vec<KeyPoint>     (28 B: x f32, y f32, size f32,
                                            angle f32, response f32,
                                            octave i32, class_id i32)
              colors: vec<3 x u8>
              observations: vec<pair<u64 pointId, u64 kpIndex>>  (16 B)
              children: vec<pair<u64 frameId, i32 matches>>      (16 B —
                         4 pad bytes; the reference writes stack garbage
                         there, this writer zeroes them)
              parents:  vec<pair<u64 frameId, i32 matches>>

  string      u64 length + raw bytes
  vec<T>      u64 count + packed elements
  GImage      cols i32, rows i32, flags i32 (OpenCV type encoding:
              depth = flags & 7, channels = (flags >> 3 & 63) + 1),
              then rows*cols*elemSize raw bytes

Note the reference's own writer leaves every GImage slot empty (the
descriptor writes are commented out, MapHash.cpp:399,415); its loader
nevertheless consumes populated slots, so this writer stores real
descriptors by default — strictly more faithful, still loadable there.
"""
from __future__ import annotations

import dataclasses
import struct
from typing import List, Optional, Tuple

import numpy as np

MAGIC = b"Hash\nbinary\n"

_KP_DTYPE = np.dtype([("x", "<f4"), ("y", "<f4"), ("size", "<f4"),
                      ("angle", "<f4"), ("response", "<f4"),
                      ("octave", "<i4"), ("class_id", "<i4")])
_OBS_DTYPE = np.dtype([("pid", "<u8"), ("kp", "<u8")])
_CONN_DTYPE = np.dtype([("fid", "<u8"), ("matches", "<i4"), ("pad", "<i4")])

# OpenCV depth codes -> numpy dtypes (GImage.h flags compatibility)
_DEPTH_NP = {0: np.uint8, 1: np.int8, 2: np.uint16, 3: np.int16,
             4: np.int32, 5: np.float32, 6: np.float64}
_NP_DEPTH = {np.dtype(np.uint8): 0, np.dtype(np.int8): 1,
             np.dtype(np.uint16): 2, np.dtype(np.int16): 3,
             np.dtype(np.int32): 4, np.dtype(np.float32): 5,
             np.dtype(np.float64): 6}


@dataclasses.dataclass
class MHPoint:
    id: int
    position: np.ndarray            # [3] f64
    normal: np.ndarray              # [3] f64
    color: np.ndarray               # [3] u8
    ref_frame: int
    descriptor: Optional[np.ndarray] = None   # [1, D] or None


@dataclasses.dataclass
class MHFrame:
    id: int
    timestamp: float
    pose_qtxyzw_t_s: np.ndarray     # [8] f64: qx qy qz qw tx ty tz scale
    image_path: str
    image_channels: int
    camera_params: List[float]
    gps_data: List[float]
    keypoints: np.ndarray           # structured _KP_DTYPE [N]
    colors: np.ndarray              # [N, 3] u8
    observations: List[Tuple[int, int]]      # (point id, kp index)
    children: List[Tuple[int, int]]          # (frame id, matches)
    parents: List[Tuple[int, int]]
    descriptors: Optional[np.ndarray] = None  # [N, D] or None
    image: Optional[np.ndarray] = None


@dataclasses.dataclass
class MapHashData:
    frames: List[MHFrame]
    points: List[MHPoint]


class _Cursor:
    def __init__(self, buf: bytes):
        self.buf = buf
        self.off = 0

    def u64(self) -> int:
        v = struct.unpack_from("<Q", self.buf, self.off)[0]
        self.off += 8
        return v

    def i32(self) -> int:
        v = struct.unpack_from("<i", self.buf, self.off)[0]
        self.off += 4
        return v

    def f64(self, n=1):
        v = np.frombuffer(self.buf, "<f8", n, self.off)
        self.off += 8 * n
        return v.copy()

    def raw(self, n: int) -> bytes:
        v = self.buf[self.off:self.off + n]
        self.off += n
        return v

    def array(self, dtype, n: int):
        v = np.frombuffer(self.buf, dtype, n, self.off)
        self.off += dtype.itemsize * n
        return v.copy()

    def string(self) -> str:
        n = self.u64()
        return self.raw(n).decode("utf-8", errors="replace")

    def f64_vec(self):
        return list(self.f64(self.u64()))

    def gimage(self) -> Optional[np.ndarray]:
        cols, rows, flags = self.i32(), self.i32(), self.i32()
        if cols <= 0 or rows <= 0:
            return None
        depth = flags & 7
        channels = ((flags >> 3) & 63) + 1
        dt = np.dtype(_DEPTH_NP[depth])
        data = self.array(np.dtype((dt.str, (channels,))) if channels > 1
                          else dt, rows * cols)
        return data.reshape((rows, cols) if channels == 1
                            else (rows, cols, channels))


class _Writer:
    def __init__(self):
        self.parts: List[bytes] = []

    def u64(self, v: int):
        self.parts.append(struct.pack("<Q", int(v)))

    def i32(self, v: int):
        self.parts.append(struct.pack("<i", int(v)))

    def f64(self, arr):
        self.parts.append(np.asarray(arr, "<f8").tobytes())

    def raw(self, b: bytes):
        self.parts.append(b)

    def string(self, s: str):
        b = s.encode("utf-8")
        self.u64(len(b))
        self.raw(b)

    def f64_vec(self, vals):
        self.u64(len(vals))
        self.f64(vals)

    def gimage(self, arr: Optional[np.ndarray]):
        if arr is None or arr.size == 0:
            self.i32(0)
            self.i32(0)
            self.i32(0)
            return
        a = np.ascontiguousarray(arr)
        ch = 1 if a.ndim == 2 else a.shape[2]
        flags = _NP_DEPTH[a.dtype] | ((ch - 1) << 3)
        self.i32(a.shape[1])
        self.i32(a.shape[0])
        self.i32(flags)
        self.raw(a.tobytes())

    def getvalue(self) -> bytes:
        return b"".join(self.parts)


def loads(buf: bytes) -> MapHashData:
    """Parse a MapHash binary blob."""
    if not buf.startswith(MAGIC):
        raise ValueError("not a MapHash binary checkpoint")
    c = _Cursor(buf)
    c.off = len(MAGIC)
    frame_num = c.u64()
    point_num = c.u64()
    points = []
    for _ in range(point_num):
        pid = c.u64()
        pos = c.f64(3)
        norm = c.f64(3)
        color = np.frombuffer(c.raw(3), np.uint8).copy()
        ref = c.u64()
        desc = c.gimage()
        points.append(MHPoint(pid, pos, norm, color, ref, desc))
    frames = []
    for _ in range(frame_num):
        fid = c.u64()
        ts = c.f64(1)[0]
        quat = c.f64(4)                  # SO3 x, y, z, w
        trans = c.f64(3)
        scale = c.f64(1)[0]
        image = c.gimage()
        img_path = c.string()
        channels = c.i32()
        cam = c.f64_vec()
        gps = c.f64_vec()
        desc = c.gimage()
        n_kp = c.u64()
        kps = c.array(_KP_DTYPE, n_kp)
        n_col = c.u64()
        colors = c.array(np.dtype(("u1", (3,))), n_col)
        n_obs = c.u64()
        obs_arr = c.array(_OBS_DTYPE, n_obs)
        n_ch = c.u64()
        ch_arr = c.array(_CONN_DTYPE, n_ch)
        n_pa = c.u64()
        pa_arr = c.array(_CONN_DTYPE, n_pa)
        frames.append(MHFrame(
            id=fid, timestamp=float(ts),
            pose_qtxyzw_t_s=np.concatenate([quat, trans, [scale]]),
            image_path=img_path, image_channels=channels,
            camera_params=cam, gps_data=gps, keypoints=kps,
            colors=colors.reshape(-1, 3),
            observations=[(int(o["pid"]), int(o["kp"])) for o in obs_arr],
            children=[(int(x["fid"]), int(x["matches"])) for x in ch_arr],
            parents=[(int(x["fid"]), int(x["matches"])) for x in pa_arr],
            descriptors=desc, image=image))
    return MapHashData(frames, points)


def dumps(data: MapHashData) -> bytes:
    """Serialize to the MapHash binary layout (frames/points in list
    order, so load->save round-trips are byte-stable)."""
    w = _Writer()
    w.raw(MAGIC)
    w.u64(len(data.frames))
    w.u64(len(data.points))
    for p in data.points:
        w.u64(p.id)
        w.f64(p.position)
        w.f64(p.normal)
        w.raw(np.asarray(p.color, np.uint8).tobytes()[:3])
        w.u64(p.ref_frame)
        w.gimage(p.descriptor)
    for f in data.frames:
        w.u64(f.id)
        w.f64([f.timestamp])
        w.f64(f.pose_qtxyzw_t_s[:4])
        w.f64(f.pose_qtxyzw_t_s[4:7])
        w.f64([f.pose_qtxyzw_t_s[7]])
        w.gimage(f.image)
        w.string(f.image_path)
        w.i32(f.image_channels)
        w.f64_vec(f.camera_params)
        w.f64_vec(f.gps_data)
        w.gimage(f.descriptors)
        w.u64(len(f.keypoints))
        w.raw(np.asarray(f.keypoints, _KP_DTYPE).tobytes())
        w.u64(len(f.colors))
        w.raw(np.asarray(f.colors, np.uint8).tobytes())
        w.u64(len(f.observations))
        obs = np.zeros(len(f.observations), _OBS_DTYPE)
        for i, (pid, kp) in enumerate(f.observations):
            obs[i] = (pid, kp)
        w.raw(obs.tobytes())
        for conn in (f.children, f.parents):
            w.u64(len(conn))
            arr = np.zeros(len(conn), _CONN_DTYPE)
            for i, (fid, m) in enumerate(conn):
                arr[i] = (fid, m, 0)
            w.raw(arr.tobytes())
    return w.getvalue()


def load_file(path: str) -> MapHashData:
    with open(path, "rb") as fh:
        return loads(fh.read())


def save_file(path: str, data: MapHashData) -> bool:
    with open(path, "wb") as fh:
        fh.write(dumps(data))
    return True


def is_maphash(path: str) -> bool:
    try:
        with open(path, "rb") as fh:
            return fh.read(len(MAGIC)) == MAGIC
    except OSError:
        return False


# ---------------------------------------------------------------------------
# WorldMap adapters
# ---------------------------------------------------------------------------

def from_worldmap(wmap) -> MapHashData:
    """Snapshot a WorldMap into the MapHash schema.

    Pose: our SE3 c2w (t, qxyzw) f32 -> SIM3 with scale 1. Keypoints keep
    their padded slot order so observation indices transfer verbatim.
    Descriptors are written packed (ORB: [N, 32] u8; SIFT: [N, 128] f32).
    """
    points = []
    for mp in wmap.points():
        if mp.bad:
            continue
        desc = None
        if mp.descriptor is not None and np.asarray(mp.descriptor).size > 1:
            d = np.asarray(mp.descriptor)
            desc = _pack_desc(d.reshape(1, -1))
        points.append(MHPoint(
            id=mp.id,
            position=np.asarray(mp.position, np.float64),
            normal=np.asarray(mp.normal if mp.normal is not None
                              else np.zeros(3), np.float64),
            color=np.asarray(mp.color if mp.color is not None
                             else np.full(3, 128), np.uint8),
            ref_frame=max(int(mp.ref_frame), 0),
            descriptor=desc))
    pt_obs = {}
    for mp in wmap.points():
        if mp.bad:
            continue
        for fid, kp in mp.observations.items():
            pt_obs.setdefault(fid, []).append((mp.id, kp))
    frames = []
    for fr in wmap.frames():
        q = np.asarray(fr.pose_c2w[3:7], np.float64)
        t = np.asarray(fr.pose_c2w[:3], np.float64)
        n = fr.n_kp
        kps = np.zeros(n, _KP_DTYPE)
        desc = None
        if n and fr.xy is not None:
            kps["x"] = fr.xy[:, 0]
            kps["y"] = fr.xy[:, 1]
            ang = fr.angle if fr.angle is not None else np.full(n, -1.0)
            # preserve the -1 'undefined orientation' sentinel (cv::KeyPoint
            # convention): mod-360 would turn it into a bogus 302.7 degrees
            kps["angle"] = np.where(ang < 0, -1.0,
                                    np.degrees(ang) % 360.0)
            kps["response"] = fr.response if fr.response is not None \
                else np.zeros(n)
            octv = fr.octave if fr.octave is not None else np.zeros(n)
            kps["octave"] = octv
            kps["size"] = 31.0 * (1.2 ** np.asarray(octv, np.float64))
            kps["class_id"] = -1
            if fr.desc is not None:
                desc = _pack_desc(np.asarray(fr.desc),
                                  sift=fr.desc_kind == "sift")
        gps = []
        if fr.gps_lla is not None:
            gps = list(np.asarray(fr.gps_lla, np.float64))
            gps += [fr.gps_acc] * 3     # size-6 layout: lla + sigmas
        frames.append(MHFrame(
            id=fr.id, timestamp=fr.timestamp,
            pose_qtxyzw_t_s=np.concatenate([q, t, [1.0]]),
            image_path=fr.image_path or "",
            image_channels=1,
            camera_params=[float(v) for v in fr.camera.parameters()],
            gps_data=gps,
            keypoints=kps,
            colors=np.full((n, 3), 128, np.uint8),
            observations=sorted(pt_obs.get(fr.id, [])),
            children=sorted((cid, m) for cid, m in fr.connections.items()
                            if cid > fr.id),
            parents=sorted((cid, m) for cid, m in fr.connections.items()
                           if cid < fr.id),
            descriptors=desc))
    return MapHashData(frames, points)


def into_worldmap(data: MapHashData, wmap) -> None:
    """Populate a WorldMap from MapHash data (inverse of from_worldmap;
    also accepts checkpoints written by the C++ reference, where the
    descriptor slots are empty)."""
    from ..core.camera import Camera
    from ..models.frame import Frame, MapPoint
    with wmap._lock:
        wmap._frames.clear()
        wmap._points.clear()
        wmap._keyframe_ids.clear()
        wmap._kf_center_cache = None
        wmap.version += 1   # whole-map replacement (see WorldMap.load)
        max_pid = 0
        for p in data.points:
            desc = _unpack_desc(p.descriptor)[0] \
                if p.descriptor is not None else np.zeros(256, np.uint8)
            mp = MapPoint(id=int(p.id),
                          position=np.asarray(p.position, np.float32),
                          descriptor=desc)
            mp.normal = np.asarray(p.normal, np.float32)
            mp.color = np.asarray(p.color, np.uint8)
            mp.ref_frame = int(p.ref_frame)
            wmap._points[mp.id] = mp
            max_pid = max(max_pid, mp.id)
        max_fid = 0
        for f in data.frames:
            cam = Camera.from_parameters([float(v)
                                          for v in f.camera_params]) \
                if f.camera_params else Camera.from_parameters(
                    [640, 480, 500, 500, 320, 240])
            fr = Frame(id=int(f.id), timestamp=float(f.timestamp),
                       camera=cam)
            q = f.pose_qtxyzw_t_s[:4]
            t = f.pose_qtxyzw_t_s[4:7]
            fr.pose_c2w = np.concatenate([t, q]).astype(np.float32)
            fr.image_path = f.image_path or None
            n = len(f.keypoints)
            if n:
                fr.xy = np.stack([f.keypoints["x"],
                                  f.keypoints["y"]], -1)
                ang = np.asarray(f.keypoints["angle"], np.float32)
                fr.angle = np.where(ang < 0, -1.0, np.radians(ang))
                fr.octave = f.keypoints["octave"]
                fr.response = f.keypoints["response"]
                fr.valid = f.keypoints["response"] > 0
                if f.descriptors is not None \
                        and len(f.descriptors) == n:
                    d = _unpack_desc(f.descriptors)
                    fr.desc = d
                    fr.desc_kind = ("sift" if f.descriptors.dtype
                                    == np.float32 else "orb")
                fr.kp2mp = np.full(n, -1, np.int64)
                for pid, kp in f.observations:
                    if kp < n:
                        fr.kp2mp[kp] = pid
            if len(f.gps_data) >= 6:
                fr.gps_lla = np.asarray(f.gps_data[:3], np.float64)
                fr.gps_acc = float(np.mean(f.gps_data[3:6]))
            for cid, m in list(f.children) + list(f.parents):
                fr.connections[int(cid)] = int(m)
            fr.is_keyframe = bool(f.observations) or bool(fr.connections)
            wmap._frames[fr.id] = fr
            if fr.is_keyframe:
                wmap._keyframe_ids.append(fr.id)
            max_fid = max(max_fid, fr.id)
        for p in data.points:
            mp = wmap._points[int(p.id)]
            mp.observations = {}
        for f in data.frames:
            for pid, kp in f.observations:
                mp = wmap._points.get(int(pid))
                if mp is not None:
                    mp.observations[int(f.id)] = int(kp)
        wmap._next_fid = max_fid + 1
        wmap._next_pid = max_pid + 1


def _pack_desc(d: np.ndarray, sift: bool = False) -> np.ndarray:
    """[N, D] descriptor rows -> GImage matrix. ORB bit-planes [N, 256]
    {0,1} become the reference's [N, 32] u8 packed bytes."""
    if sift or d.dtype in (np.float32, np.float64):
        return np.ascontiguousarray(d, np.float32)
    if d.shape[1] == 256:          # bit-planes -> packed bytes
        bits = d.reshape(d.shape[0], 32, 8).astype(np.uint16)
        weights = (1 << np.arange(8, dtype=np.uint16))
        return (bits * weights[None, None, :]).sum(-1).astype(np.uint8)
    return np.ascontiguousarray(d, np.uint8)


def _unpack_desc(d: np.ndarray) -> np.ndarray:
    """GImage matrix -> [N, D] descriptor rows (ORB packed bytes -> 256
    bit-planes; SIFT floats pass through). Callers take row 0 for
    single-descriptor (map point) slots."""
    d = np.asarray(d)
    if d.ndim == 3:
        d = d.reshape(d.shape[0], -1)
    if d.ndim == 1:
        d = d.reshape(1, -1)
    if d.dtype == np.uint8 and d.shape[-1] == 32:
        bits = (d[..., None] >> np.arange(8, dtype=np.uint8)) & 1
        return bits.reshape(d.shape[0], 256).astype(np.uint8)
    return d
