"""Dataset adapters: file-extension-keyed readers producing frames.

Equivalent of GSLAM/GSLAM/core/Dataset.h (extension -> creator registry,
Dataset.h:74-102) and the gui/IO adapters (SURVEY.md section 2.6):

  .npudronemap  DatasetNPUDroneMap.cpp — two modes chosen by files present:
                trajectory.txt -> known-pose keyframes (mosaic-only), or
                frames.txt + gps.txt -> interleaved GPS + mono frames
  .rtm          DatasetRTMapper.cpp — Svar project file + imageLists.txt,
                frames carry the _gpshpyr GPS/attitude vector (layout
                documented at DatasetRTMapper.cpp:155-159)
  .kitti        odometry gray/color mono (image_0/, times.txt, calib cfg)
  .tummono      TUM monocular (images/ + times.txt + ATAN camera.txt)
  .tumrgbd/.tum TUM RGB-D rgb.txt listing
  .euroc        EuRoC mav0/cam0 csv
  .cvmono       image-directory / video feed (video decode needs OpenCV,
                which is intentionally not a dependency — directories of
                frames work out of the box)

Frames are host-side RawFrame records; feature extraction happens in the
SLAM system (device-side), not in the reader.

A copy of pislamfusion_tpu/io/dataset.py; only `imread` differs, since
the machine with the card has no PIL.
"""
from __future__ import annotations

import dataclasses
import os
import re
from typing import List, Optional

import numpy as np

from ..core.camera import Camera
from ..core.registry import DATASETS
from ..core.svar import Svar


def imread(path: str) -> np.ndarray:
    """RGB uint8 image reader (the reference package reads through PIL;
    the original used cv::imread). A PNG goes through `read_png` (PIL
    where it imports, else the package's own decoder; both convert as
    PIL's `convert("RGB")` does, which the native decoder does not for
    16-bit gray); any other file through the native decoder
    (libjpeg/libpng, `native_io`), then PIL. Raises when none of them
    can decode the file."""
    with open(path, "rb") as f:
        magic = f.read(8)
    if magic == b"\x89PNG\r\n\x1a\n":
        from ..models.map2d import read_png
        return read_png(path)
    from . import native_io
    img = native_io.imread_f32(path)
    if img is not None:
        return np.clip(np.rint(img), 0, 255).astype(np.uint8)
    try:
        from PIL import Image
    except ImportError:
        raise RuntimeError(
            f"cannot decode {path}: it is not a PNG, the native decoder "
            "(g++ with libjpeg and libpng) is unavailable or refused it, "
            "and PIL is not installed") from None
    with Image.open(path) as img:
        return np.asarray(img.convert("RGB"))


@dataclasses.dataclass
class RawFrame:
    timestamp: float
    image: Optional[np.ndarray] = None      # RGB uint8 (lazy: see image_path)
    image_path: Optional[str] = None
    camera: Optional[Camera] = None
    gps_lla: Optional[np.ndarray] = None    # (lon, lat, alt)
    gps_sigma: Optional[np.ndarray] = None  # (sx, sy, sz)
    pyr: Optional[np.ndarray] = None        # (pitch, yaw, roll) degrees
    height_ground: Optional[float] = None   # height above ground (m)
    pose_c2w: Optional[np.ndarray] = None   # known pose (KF datasets)
    is_gps_only: bool = False               # GPSFrame (no image)
    depth_path: Optional[str] = None        # RGB-D depth image (npurgbd)

    def load_image(self) -> Optional[np.ndarray]:
        if self.image is None and self.image_path:
            self.image = imread(self.image_path)
        return self.image


class Dataset:
    """Base reader. Subclasses fill self._frames (list of RawFrame) or
    override grab_frame for streaming."""

    def __init__(self):
        self._frames: List[RawFrame] = []
        self._idx = 0
        self.camera: Optional[Camera] = None
        self.cfg = Svar()
        self.plane: Optional[np.ndarray] = None
        self.gps_origin: Optional[np.ndarray] = None

    def open(self, path: str) -> bool:
        raise NotImplementedError

    def is_opened(self) -> bool:
        return bool(self._frames)

    def __len__(self):
        return len(self._frames)

    def grab_frame(self, load: bool = True) -> Optional[RawFrame]:
        if self._idx >= len(self._frames):
            return None
        fr = self._frames[self._idx]
        self._idx += 1
        if load:
            fr.load_image()
        return fr

    def rewind(self):
        self._idx = 0


def _parse_gpshpyr(vals):
    """Decode the reference's _gpshpyr layouts (6/8/11/12/14 doubles,
    DatasetRTMapper.cpp:155-159) into (lla, sigma, pyr, height).

    pyr follows getPitchYawRoll (MapFrame.h:46-51) with sigma-validity
    gates; height follows getHeight2Ground (MapFrame.h:77-80: sizes 8/14
    carry (height, sigma), valid when sigma < 100).

    Intentional deviation for the size-14 layout: the reference gates pyr
    on `_gpshpyr[11]` being *nonzero* (a truthiness test on the sigma
    value, which accepts sigma >= 20 and rejects sigma == 0 — almost
    certainly a bug, since every other layout gates on sigma < 20). Here
    all three layouts use the consistent `sigma < 20` gate."""
    v = [float(x) for x in vals]
    lla = sigma = pyr = height = None
    n = len(v)
    if n >= 6:
        lla = np.asarray(v[0:3])
        # reference getGPSLLASigma (MapFrame.h:65-69): its size()>=6 branch
        # reads sigma = v[3:6] for every layout (the ==7 arm is unreachable).
        sigma = np.asarray(v[3:6])
    if n == 11 and v[8] < 20:
        pyr = np.asarray(v[5:8])
    elif n == 12 and v[9] < 20:
        pyr = np.asarray(v[6:9])
    elif n == 14 and v[11] < 20:
        pyr = np.asarray(v[8:11])
    if n in (8, 14) and v[7] < 100:
        height = v[6]
    return lla, sigma, pyr, height


@DATASETS.register("npudronemap")
class DatasetNPUDroneMap(Dataset):
    def open(self, path: str) -> bool:
        folder = os.path.dirname(os.path.abspath(path))
        cfg_file = os.path.join(folder, "config.cfg")
        if os.path.isfile(cfg_file):
            self.cfg.parse_file(cfg_file)
        cam_params = self.cfg.get_vec("Camera.Paraments")
        if cam_params:
            self.camera = Camera.from_parameters(cam_params)
        plane = self.cfg.get_vec("Plane")
        if len(plane) == 7:
            self.plane = np.asarray(plane)
        origin = self.cfg.get_vec("GPS.Origin")
        if len(origin) >= 2:
            self.gps_origin = np.asarray(origin + [0.0] * (3 - len(origin)))
        traj = os.path.join(folder, "trajectory.txt")
        if os.path.isfile(traj):
            return self._open_kf(folder, traj)
        frames_txt = os.path.join(folder, "frames.txt")
        if os.path.isfile(frames_txt):
            return self._open_unified(folder, frames_txt)
        return False

    def _open_kf(self, folder, traj) -> bool:
        """DroneMapKFDataset: `name tx ty tz qx qy qz qw` per line; image at
        rgb/<name>.jpg; poses in the local (GPS.Origin-anchored) frame."""
        with open(traj) as fh:
            for line in fh:
                toks = line.split()
                if len(toks) < 8:
                    continue
                name = toks[0]
                pose = np.asarray([float(t) for t in toks[1:8]])
                img = os.path.join(folder, "rgb", name + ".jpg")
                if not os.path.isfile(img):
                    img_png = os.path.join(folder, "rgb", name + ".png")
                    img = img_png if os.path.isfile(img_png) else img
                try:
                    ts = float(name)
                except ValueError:
                    ts = float(len(self._frames))
                self._frames.append(RawFrame(
                    timestamp=ts, image_path=img, camera=self.camera,
                    pose_c2w=pose))
        return bool(self._frames)

    def _open_unified(self, folder, frames_txt) -> bool:
        """DatasetDroneMapUnified: frames.txt `timestamp imgfile`, gps.txt
        `timestamp lon lat alt`, merged by timestamp emitting GPS-only
        frames interleaved (DatasetNPUDroneMap.cpp:246-338)."""
        entries = []
        with open(frames_txt) as fh:
            for line in fh:
                toks = line.split()
                if len(toks) >= 2:
                    img = toks[1]
                    if not os.path.isabs(img):
                        img = os.path.join(folder, img)
                    entries.append(("img", float(toks[0]), img))
        gps_txt = os.path.join(folder, "gps.txt")
        if os.path.isfile(gps_txt):
            with open(gps_txt) as fh:
                for line in fh:
                    toks = line.split()
                    if len(toks) >= 4:
                        entries.append(("gps", float(toks[0]),
                                        [float(t) for t in toks[1:4]]))
        entries.sort(key=lambda e: e[1])
        for kind, ts, payload in entries:
            if kind == "img":
                self._frames.append(RawFrame(timestamp=ts,
                                             image_path=payload,
                                             camera=self.camera))
            else:
                self._frames.append(RawFrame(
                    timestamp=ts, gps_lla=np.asarray(payload),
                    gps_sigma=np.asarray([5.0, 5.0, 10.0]),
                    is_gps_only=True))
        return bool(self._frames)


@DATASETS.register("rtm")
class DatasetRTMapper(Dataset):
    """RTMapper project, both modes of DatasetRTMapper.cpp:
      * Svar mode: the .rtm file is a config naming the camera
        (`Dataset.Camera` / `VideoReader.Camera` -> `<name>.Paraments`),
        with imageLists.txt rows `imgpath gpshpyr...` next to it.
      * XML mode (openRTM_XML, DatasetRTMapper.cpp:378-395): a <project>
        element whose attribute tree maps to dotted config keys, followed
        by an <images> element with per-frame timestamp/image attributes
        and gps/gpsSigma/height/attitude/attitudeSigma children forming
        the _gpshpyr vector (exportFrame :306-375)."""

    def open(self, path: str) -> bool:
        with open(path, "r", errors="replace") as fh:
            head = fh.read(512).lstrip()
        if head.startswith("<"):
            return self._open_xml(path)
        self.cfg.parse_file(path)
        folder = os.path.dirname(os.path.abspath(path))
        cam_name = self.cfg.get_string(
            "VideoReader.Camera", self.cfg.get_string("Dataset.Camera", ""))
        if cam_name:
            params = self.cfg.get_vec(cam_name + ".Paraments")
            if params:
                self.camera = Camera.from_parameters(params)
        lists = os.path.join(folder, "imageLists.txt")
        if not os.path.isfile(lists):
            return False
        with open(lists) as fh:
            for i, line in enumerate(fh):
                toks = line.split()
                if not toks:
                    continue
                img = toks[0]
                if not os.path.isabs(img):
                    img = os.path.join(folder, img)
                lla, sigma, pyr, height = _parse_gpshpyr(toks[1:])
                m = re.search(r"(\d+\.?\d*)", os.path.basename(img))
                ts = float(m.group(1)) if m else float(i)
                self._frames.append(RawFrame(
                    timestamp=ts, image_path=img, camera=self.camera,
                    gps_lla=lla, gps_sigma=sigma, pyr=pyr,
                    height_ground=height))
        return bool(self._frames)

    def _open_xml(self, path: str) -> bool:
        import xml.etree.ElementTree as ET
        folder = os.path.dirname(os.path.abspath(path))
        try:
            root = ET.parse(path).getroot()
        except ET.ParseError:
            return False
        # <project> attribute tree -> dotted config keys (exportEle)
        proj = root if root.tag == "project" else root.find("project")
        if proj is None:
            return False

        def export(ele, parent=""):
            if ele.get("value") is not None:
                key = (parent + "." if parent else "") + ele.tag
                self.cfg.insert(key, ele.get("value"))
            pfx = (parent + "." if parent else "") + ele.tag
            for child in ele:
                export(child, pfx)

        for child in proj:
            export(child, "")
        cam_name = self.cfg.get_string("Dataset.Camera", "")
        if cam_name:
            params = self.cfg.get_vec(cam_name + ".Paraments")
            if params:
                self.camera = Camera.from_parameters(params)
        images = root.find("images") if root.tag == "project" else \
            root.find(".//images")
        # when <project> is the document root, <images> is its sibling —
        # ElementTree has no sibling access from root, so scan the document
        if images is None:
            for ele in root.iter("images"):
                images = ele
                break
        if images is None:
            return False
        # per-frame gpshpyr assembly order (exportFrame :352-357)
        groups = [("gps", ("longtitude", "latitude", "altitude")),
                  ("gpsSigma", ("longtitude", "latitude", "altitude")),
                  ("height", ("value", "sigma")),
                  ("attitude", ("pitch", "yaw", "roll")),
                  ("attitudeSigma", ("pitch", "yaw", "roll"))]
        for fr in images:
            ts = float(fr.get("timestamp", len(self._frames)))
            img = fr.get("image", "")
            if img and not os.path.isabs(img):
                img = os.path.join(folder, img)
            vals = []
            for tag, attrs in groups:
                sub = fr.find(tag)
                if sub is None:
                    continue
                vals.extend(float(sub.get(a, 0.0)) for a in attrs)
            lla, sigma, pyr, height = _parse_gpshpyr(vals)
            self._frames.append(RawFrame(
                timestamp=ts, image_path=img, camera=self.camera,
                gps_lla=lla, gps_sigma=sigma, pyr=pyr,
                height_ground=height))
        return bool(self._frames)


@DATASETS.register("cfg")
class DatasetCfg(Dataset):
    """The GSLAM `.cfg` dataset plugin (GSLAM/GSLAM/plugins/cfg/
    gslamDB_cfg.cpp): a Svar config with `Video.Type=GSLAM`, `Video.File`
    listing `timestamp imgfile` rows, the camera under
    `<Video.CameraInName>.Paraments`, and an optional sibling gps.txt of
    `timestamp lon lat alt sigma?` rows merged in timestamp order as
    GPS-only frames (the GPSFrame emission of grabFrame)."""

    def open(self, path: str) -> bool:
        self.cfg.parse_file(path)
        if self.cfg.get_string("Video.Type", "") != "GSLAM":
            return False
        folder = os.path.dirname(os.path.abspath(path))
        cam_name = self.cfg.get_string("Video.CameraInName", "")
        if cam_name:
            params = self.cfg.get_vec(cam_name + ".Paraments")
            if params:
                self.camera = Camera.from_parameters(params)
        video = self.cfg.get_string("Video.File", "")
        if video and not os.path.isabs(video):
            video = os.path.join(folder, video)
        if not video or not os.path.isfile(video):
            return False
        skip = self.cfg.get_int("Video.Skip", 0)
        entries = []
        with open(video) as fh:
            lines = [ln.split() for ln in fh if ln.split()]
        for i, toks in enumerate(lines[::skip + 1]):
            if len(toks) >= 2:
                img = toks[1]
                if not os.path.isabs(img):
                    img = os.path.join(folder, img)
                entries.append(("img", float(toks[0]), img))
        gps_txt = os.path.join(folder, "gps.txt")
        if os.path.isfile(gps_txt):
            with open(gps_txt) as fh:
                for line in fh:
                    toks = line.split()
                    if len(toks) >= 4:
                        entries.append(("gps", float(toks[0]),
                                        [float(t) for t in toks[1:4]]))
        entries.sort(key=lambda e: e[1])
        for kind, ts, payload in entries:
            if kind == "img":
                self._frames.append(RawFrame(timestamp=ts,
                                             image_path=payload,
                                             camera=self.camera))
            else:   # GPSFrame with the plugin's (5, 5, 10) default sigma
                self._frames.append(RawFrame(
                    timestamp=ts, gps_lla=np.asarray(payload),
                    gps_sigma=np.asarray([5.0, 5.0, 10.0]),
                    is_gps_only=True))
        return bool(self._frames)


@DATASETS.register("npurgbd")
class DatasetNPURGBD(Dataset):
    """NPU RGB-D (DatasetNPURGBD.cpp): a Svar config naming `Camera` +
    `<name>.Paraments` + `VideoFile`; the video file carries lines of
    `t1 x y z qx qy qz qw t2 depth_file t3 rgb_file` (known-pose RGB-D)."""

    def open(self, path: str) -> bool:
        self.cfg.parse_file(path)
        folder = os.path.dirname(os.path.abspath(path))
        cam_name = self.cfg.get_string("Camera", "")
        if cam_name:
            params = self.cfg.get_vec(cam_name + ".Paraments")
            if params:
                self.camera = Camera.from_parameters(params)
        video = self.cfg.get_string("VideoFile", "")
        if video and not os.path.isabs(video):
            video = os.path.join(folder, video)
        if not video or not os.path.isfile(video):
            return False
        with open(video) as fh:
            for line in fh:
                toks = line.split()
                if len(toks) < 12:
                    continue
                pose = np.asarray([float(t) for t in toks[1:8]])
                d_file, ts, rgb_file = toks[9], float(toks[10]), toks[11]
                fr = RawFrame(timestamp=ts,
                              image_path=os.path.join(folder, rgb_file),
                              camera=self.camera, pose_c2w=pose)
                fr.depth_path = os.path.join(folder, d_file)
                self._frames.append(fr)
        return bool(self._frames)


@DATASETS.register("kitti")
class DatasetKITTI(Dataset):
    """KITTI odometry monocular: <seq>/image_0/*.png + times.txt; intrinsics
    from the .kitti Svar file (`Camera.Paraments`) or calib.txt P0."""

    def open(self, path: str) -> bool:
        self.cfg.parse_file(path)
        folder = os.path.dirname(os.path.abspath(path))
        seq = self.cfg.get_string("Dataset.Folder", folder)
        params = self.cfg.get_vec("Camera.Paraments")
        if params:
            self.camera = Camera.from_parameters(params)
        else:
            calib = os.path.join(seq, "calib.txt")
            if os.path.isfile(calib):
                with open(calib) as fh:
                    for line in fh:
                        if line.startswith("P0:"):
                            p = [float(t) for t in line.split()[1:]]
                            self.camera = Camera(1241, 376, p[0], p[5],
                                                 p[2], p[6])
        times = os.path.join(seq, "times.txt")
        ts = []
        if os.path.isfile(times):
            ts = [float(t) for t in open(times)]
        img_dir = os.path.join(seq, "image_0")
        if not os.path.isdir(img_dir):
            return False
        for i, name in enumerate(sorted(os.listdir(img_dir))):
            self._frames.append(RawFrame(
                timestamp=ts[i] if i < len(ts) else float(i),
                image_path=os.path.join(img_dir, name), camera=self.camera))
        return bool(self._frames)


@DATASETS.register("tummono")
class DatasetTUMMono(Dataset):
    """TUM monocular: images/*.jpg + times.txt + camera.txt (ATAN model)."""

    def open(self, path: str) -> bool:
        folder = os.path.dirname(os.path.abspath(path))
        cam_file = os.path.join(folder, "camera.txt")
        if os.path.isfile(cam_file):
            with open(cam_file) as fh:
                first = fh.readline().split()
                second = fh.readline().split()
            if len(first) >= 5 and len(second) >= 2:
                w, h = int(second[0]), int(second[1])
                fxr, fyr, cxr, cyr, d = [float(v) for v in first[:5]]
                # TUM mono stores relative intrinsics
                self.camera = Camera.from_parameters(
                    [w, h, fxr * w, fyr * h, cxr * w - 0.5, cyr * h - 0.5, d])
        times = os.path.join(folder, "times.txt")
        img_dir = os.path.join(folder, "images")
        if not os.path.isdir(img_dir):
            return False
        names = sorted(os.listdir(img_dir))
        ts_map = {}
        if os.path.isfile(times):
            for line in open(times):
                toks = line.split()
                if len(toks) >= 2:
                    ts_map[toks[0]] = float(toks[1])
        for i, name in enumerate(names):
            stem = os.path.splitext(name)[0]
            self._frames.append(RawFrame(
                timestamp=ts_map.get(stem, float(i)),
                image_path=os.path.join(img_dir, name), camera=self.camera))
        return bool(self._frames)


@DATASETS.register("tumrgbd")
@DATASETS.register("tum")
class DatasetTUMRGBD(Dataset):
    """TUM RGB-D: rgb.txt rows `timestamp rgb/xxx.png`."""

    def open(self, path: str) -> bool:
        folder = os.path.dirname(os.path.abspath(path))
        self.cfg.parse_file(path)
        params = self.cfg.get_vec("Camera.Paraments")
        self.camera = (Camera.from_parameters(params) if params else
                       Camera(640, 480, 525.0, 525.0, 319.5, 239.5))
        rgb = os.path.join(folder, "rgb.txt")
        if not os.path.isfile(rgb):
            return False
        for line in open(rgb):
            if line.startswith("#"):
                continue
            toks = line.split()
            if len(toks) >= 2:
                self._frames.append(RawFrame(
                    timestamp=float(toks[0]),
                    image_path=os.path.join(folder, toks[1]),
                    camera=self.camera))
        return bool(self._frames)


@DATASETS.register("euroc")
class DatasetEuroc(Dataset):
    """EuRoC MAV: mav0/cam0/data.csv rows `timestamp_ns,filename`."""

    def open(self, path: str) -> bool:
        folder = os.path.dirname(os.path.abspath(path))
        cam_dir = os.path.join(folder, "mav0", "cam0")
        csv = os.path.join(cam_dir, "data.csv")
        if not os.path.isfile(csv):
            return False
        self.camera = Camera.from_parameters(
            [752, 480, 458.654, 457.296, 367.215, 248.375,
             -0.28340811, 0.07395907, 0.00019359, 1.76187114e-05, 0.0])
        for line in open(csv):
            if line.startswith("#"):
                continue
            toks = line.strip().split(",")
            if len(toks) >= 2:
                self._frames.append(RawFrame(
                    timestamp=float(toks[0]) * 1e-9,
                    image_path=os.path.join(cam_dir, "data", toks[1]),
                    camera=self.camera))
        return bool(self._frames)


@DATASETS.register("cvmono")
class DatasetCVMono(Dataset):
    """Directory-of-frames feed (`Video.File` points at a folder). Video
    container decode would need OpenCV, which this framework deliberately
    does not depend on."""

    def open(self, path: str) -> bool:
        self.cfg.parse_file(path)
        src = self.cfg.get_string("Video.File", "")
        folder = os.path.dirname(os.path.abspath(path))
        if not os.path.isabs(src):
            src = os.path.join(folder, src)
        params = self.cfg.get_vec("Camera.Paraments")
        if params:
            self.camera = Camera.from_parameters(params)
        fps = self.cfg.get_double("Video.fps", 30.0)
        if os.path.isdir(src):
            for i, name in enumerate(sorted(os.listdir(src))):
                if os.path.splitext(name)[1].lower() not in (
                        ".jpg", ".jpeg", ".png", ".bmp"):
                    continue
                self._frames.append(RawFrame(
                    timestamp=i / fps,
                    image_path=os.path.join(src, name), camera=self.camera))
        return bool(self._frames)


def open_dataset(path: str) -> Dataset:
    """DatasetFactory::create equivalent (Dataset.h:74-102): pick the
    adapter by file extension."""
    ext = os.path.splitext(path)[1].lstrip(".").lower()
    if ext not in DATASETS:
        raise KeyError(f"no dataset adapter for extension {ext!r}; "
                       f"have {DATASETS.names()}")
    ds = DATASETS.create(ext)
    if not ds.open(path):
        raise IOError(f"failed to open dataset {path}")
    return ds
