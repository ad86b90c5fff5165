"""The SLAM system: feature extraction + tracker + mapper + loop closing,
behind the reference's SLAM plugin surface.

Port of pislamfusion_tpu/models/slam.py (GSLAM-DIYSLAM/src/DIYSLAM.cpp):
lazy module creation from config names on the first frame (:239-260),
per-frame feature extraction (:279) and frame wrapping, the tracking call,
and the (image, pose, meta) push into the mosaic queue; the meta also
carries the map epoch (the count of map-transform publishes) that the
fusion consumer gauges the frame by (models/fusion.py).

Config keys match the reference (Default.cfg): Map?=Hash, Tracker?=opt,
Mapper?=demo, FeatureDetector?=Sift|ORB, SLAM.nFeature, SLAM.MaxOverlap,
... Everything numeric runs on one device: the `device` argument, else the
`SLAM.Device` config key, else `cuda` (an error without a CUDA device).

Offline (`SLAM.isOnline=0`, the reference's default) `track` runs the
tracker, the mapper and the loop closer in the caller's thread. Online
(`SLAM.isOnline=1` without `SLAM.forceOffline`) `track` enqueues the
frame's extraction (`Tracker.predispatch_extract`) and puts the frame on
a bounded queue (DIYSLAM.cpp:346-363), of depth max(2, SLAM.TrackChain);
a tracking thread takes it from there (with the loop closer), and the
mapper handles keyframes on its own worker. With `SLAM.TrackChain` K > 1
(stock `Tracker.track` only) the feeder queues raw frames and the
tracking thread drains up to K of them, waiting up to `SLAM.ChainWaitMs`,
into one `Tracker.track_chain`. `finish(timeout)` ends the thread and
drains the mapper, each within the timeout. All threads launch on the
device's default stream, which orders their work. Which keyframes skip
their local BA depends on timing, so online runs are not reproducible.
"""
from __future__ import annotations

import functools
import queue
import threading
import time
from typing import Optional

import numpy as np
import torch

from ..core.messenger import trans as _default_trans
from ..core.messenger import trans_plane as _default_trans_plane
from ..core.registry import (FEATURE_DETECTORS, LOOP_CLOSERS, MAPPERS, MAPS,
                             TRACKERS)
from ..core.svar import Svar
from ..core.device import resolve_device
from ..core.timer import timer
from ..ops import image as im
from ..ops.features import orb
from .frame import Frame
from .loopclose import LoopCloserSE3Graph
from .mapper import Mapper
from .tracker import Tracker
from .worldmap import WorldMap


def resolve_vocab_path(cfg) -> str:
    """The configured .gbow path: Default.cfg aliases it as
    SLAM.Vocabulary?=$(Vocabulary), so `Vocabulary` wins over
    `SLAM.Vocabulary`. ONE implementation (matchers.MatcherBoW shares it)
    — Svar.get persists defaults, so duplicated nesting orders diverge."""
    return cfg.get_string("Vocabulary",
                          cfg.get_string("SLAM.Vocabulary", ""))


@functools.lru_cache(maxsize=4)
def _load_vocabulary_cached(path: str):
    """Shared .gbow loads keyed by path: SLAM's detector and Matcher=BoW
    configured with the same Vocabulary= file reuse one instance."""
    from ..ops.vocabulary import Vocabulary
    return Vocabulary.load(path)


@functools.lru_cache(maxsize=2)
def _default_vocabulary(kind: str = "orb"):
    """The embedded default vocabulary for the detector kind — binary ORB
    (resources/orb_vocab.py, scripts/train_default_vocab.py) or float SIFT
    (resources/sift_vocab.py, scripts/train_sift_vocab.py) — or None if
    unavailable. The reference ships its .gbow inside the binary the same
    way (FileResource.h:9-111). Memoized: SLAM's loop detector and
    Matcher=BoW share one instance (one set of descent tables a device)."""
    try:
        from ..core import resource
        from ..ops.vocabulary import Vocabulary
        if kind == "sift":
            from ..resources import sift_vocab as mod           # noqa: F401
        else:
            from ..resources import orb_vocab as mod            # noqa: F401
        data = resource.get(mod.NAME)
        return Vocabulary.loads(data) if data else None
    except Exception:                                           # noqa: BLE001
        return None


@FEATURE_DETECTORS.register("ORB")
@FEATURE_DETECTORS.register("cvORB")      # FeatureDetectorcvORB (OpenCV
@FEATURE_DETECTORS.register("liu_ORB")    # backend) and the liuguochen
@FEATURE_DETECTORS.register("liu_cvORB")  # re-registrations differ only in
class OrbDetector:                        # the host library wrapped; one
    # ORB serves all four names (same pattern/pyramid/BRIEF)
    def __init__(self, cfg, device=None):
        self.params = orb.OrbParams(
            n_features=cfg.get_int("SLAM.nFeature", 1000),
            n_levels=cfg.get_int("ORB.nLevels", 8),
            scale_factor=cfg.get_double("ORB.ScaleFactor", 1.2))
        self.kind = "orb"
        self.pyramid = "flat"   # K1 where its plan applies, else resizes
        self.device = resolve_device(device)

    def __call__(self, gray):
        """Features of a gray frame [H, W] (array or tensor) on the
        detector's device."""
        g = torch.as_tensor(np.asarray(gray) if not isinstance(
            gray, torch.Tensor) else gray).to(self.device, torch.float32)
        return orb.orb_detect(g, self.params, self.pyramid)


@FEATURE_DETECTORS.register("Sift")
class SiftDetector:
    def __init__(self, cfg, device=None):
        from ..ops.features import sift
        self.params = sift.SiftParams(
            n_features=cfg.get_int("SLAM.nFeature", 1000),
            contrast_threshold=cfg.get_double("Sift.ContrastThreshold",
                                              0.02),
            n_octaves=cfg.get_int("Sift.nOctaves", 4))
        self.kind = "sift"
        self.pyramid = "flat"   # unused by SIFT (pipeline._detect)
        self.device = resolve_device(device)
        self._sift_detect = sift.sift_detect

    def __call__(self, gray):
        g = torch.as_tensor(np.asarray(gray) if not isinstance(
            gray, torch.Tensor) else gray).to(self.device, torch.float32)
        return self._sift_detect(g, self.params)


def _box_downsample(img: np.ndarray, s: int) -> np.ndarray:
    """Host s x s box-mean downsample (SLAM.TrackScale). uint8 stays
    uint8 (uint32 accumulate); floats average in their own dtype. The
    bottom/right remainder rows/cols are cropped."""
    h, w = img.shape[0] - img.shape[0] % s, img.shape[1] - img.shape[1] % s
    v = img[:h, :w]
    if v.dtype == np.uint8:
        acc = v.reshape(h // s, s, w // s, s).astype(np.uint32)
        return (acc.sum((1, 3)) // (s * s)).astype(np.uint8)
    return v.reshape(h // s, s, w // s, s).mean((1, 3)).astype(v.dtype)


class SLAM:
    """DIYSLAM equivalent. Use `track(image, timestamp, gps_lla=None)`.

    device: where the numeric work runs; None takes the `SLAM.Device`
    config key, and an empty key means `cuda` (an error without a CUDA
    device). Pass "cpu" for the plain PyTorch versions of the kernels."""

    def __init__(self, cfg: Optional[Svar] = None, camera=None, device=None):
        self.cfg = cfg if cfg is not None else Svar()
        if device is None:
            device = self.cfg.get_string("SLAM.Device", "") or None
        self.device = resolve_device(device)
        self.camera = camera
        self.map: Optional[WorldMap] = None
        self.tracker: Optional[Tracker] = None
        self.mapper: Optional[Mapper] = None
        self.loop_closer: Optional[LoopCloserSE3Graph] = None
        self.detector = None
        self.vocabulary = None   # optional BoW vocab (set or cfg-loaded)
        self._local_frame = None    # gps.LocalFrame once first fix arrives
        self._undistort_xy = None   # lazy Undistorter remap table
        self.trans_queue = _default_trans          # (image, pose) -> mosaic
        self.plane_queue = _default_trans_plane    # ground plane -> mosaic
        self._online = False
        self._chain = 1
        self._queue: Optional[queue.Queue] = None
        self._worker: Optional[threading.Thread] = None
        self.frames_tracked = 0
        self.frames_total = 0
        self.track_errors = 0   # per-frame tracking-thread exceptions
        self._track_scale = max(1, self.cfg.get_int("SLAM.TrackScale", 1))
        self._scaled_cam = None

    # lazy init on first frame (DIYSLAM.cpp:239-260)
    def _ensure_modules(self):
        if self.tracker is not None:
            return
        cfg = self.cfg
        log_file = cfg.get_string("LogFile", "")
        if log_file:   # DIYSLAM.cpp:196-201
            from ..core import glog
            glog.logger.add_sink(glog.LogFileSink(log_file))
        self.map = MAPS.create(cfg.get_string("Map", "Hash"), cfg)
        # resume from a map checkpoint (DIYSLAM.cpp:256-258 loads
        # MapFile2Load on the first frame; tracking then relocalizes)
        import os as _os
        map_load = cfg.get_string("MapFile2Load", "")
        self._loaded_map = bool(map_load and _os.path.isfile(map_load)
                                and self.map.load(map_load))
        dev = self.device
        self.mapper = MAPPERS.create(cfg.get_string("Mapper", "demo"),
                                     self.map, cfg, device=dev)
        self.mapper.plane_queue = self.plane_queue
        self.tracker = TRACKERS.create(cfg.get_string("Tracker", "opt"),
                                       self.map, cfg, self.mapper,
                                       device=dev)
        self.mapper.on_map_transformed = self.tracker.on_map_transformed
        self.mapper.on_map_deformed = self.tracker.invalidate_local_stage
        if hasattr(self.tracker, "restage_after_kf"):
            self.mapper.restage_hook = self.tracker.restage_after_kf
        # vocabulary (for BoW loop detection / relocalization); loaded from
        # a .gbow file (Vocabulary.h:98-107) when configured
        import os
        vocab_path = resolve_vocab_path(cfg)
        if self.vocabulary is None and vocab_path and \
                os.path.isfile(vocab_path):
            from ..ops.vocabulary import Vocabulary
            self.vocabulary = _load_vocabulary_cached(vocab_path)
        det_name = cfg.get_string("LoopDetector", "GPS")
        from ..core.registry import LOOP_DETECTORS
        from .loopclose import LoopDetectorBoW
        feat_kind = cfg.get_string(
            "FeatureDetector", cfg.get_string("SLAM.Feature", "ORB"))
        if det_name == "BoW" and self.vocabulary is None:
            # no vocab configured: fall back to the EMBEDDED default
            # vocabulary matching the detector's descriptor type — binary
            # ORB or float SIFT (the reference's Default.cfg detector) —
            # before degrading to the GPS distance detector
            self.vocabulary = _default_vocabulary(
                "sift" if feat_kind.lower() == "sift" else "orb")
        if det_name == "BoW" and self.vocabulary is None:
            det_name = "GPS"    # no vocab -> fall back to distance detector
        detector = LOOP_DETECTORS.create(det_name, self.map, cfg,
                                         device=dev)
        if isinstance(detector, LoopDetectorBoW):
            detector.vocabulary = self.vocabulary
        self.tracker.loop_detector = detector
        self.loop_closer = LOOP_CLOSERS.create(
            cfg.get_string("LoopCloser", "se3graph"), self.map, cfg,
            detector, device=dev)
        # closure rewrites must invalidate the tracker's staged local map
        # INSIDE their locked critical section (same contract as
        # mapper.on_map_deformed) — the post-try_close invalidate below is
        # only a same-thread refresh, not a cross-thread guarantee
        if hasattr(self.loop_closer, "on_map_deformed"):
            self.loop_closer.on_map_deformed = \
                self.tracker.invalidate_local_stage
        feat = cfg.get_string("FeatureDetector",
                              cfg.get_string("SLAM.Feature", "ORB"))
        self.detector = FEATURE_DETECTORS.create(feat, cfg, device=dev)
        self.tracker.detector = self.detector
        if self._loaded_map:
            kfs = self.map.keyframes()
            if kfs:
                from .tracker import Status
                self.tracker.ref_kf_id = kfs[-1].id
                self.tracker.status = Status.LOST   # relocalize into it
                self.mapper._kf_count = len(kfs)
        # fused device path (extract + match + pose, one readback) — ORB
        # and SIFT both go through pipeline._detect; the reference's
        # default detector IS SIFT (Default.cfg:2-9), so the fast path
        # must cover it
        self.tracker.use_fused = (self.detector.kind in ("orb", "sift")
                                  and self.tracker.supports_fused
                                  and cfg.get_bool("SLAM.Fused", True))
        self._online = cfg.get_bool("SLAM.isOnline", False) and \
            not cfg.get_bool("SLAM.forceOffline", False)
        # K-frame chained tracking (tracker.track_chain): opt-in, and only
        # for trackers running the stock track() — variants with their own
        # per-frame logic (planar, testInit, ...) must not be bypassed
        self._chain = (max(1, cfg.get_int("SLAM.TrackChain", 1))
                       if type(self.tracker).track is Tracker.track else 1)
        if self._online:
            # queue depth covers the chain so the feeder can stay ahead
            self._queue = queue.Queue(   # DIYSLAM.cpp:346-353 (depth 2)
                maxsize=max(2, self._chain))
            self._worker = threading.Thread(target=self._tracking_loop,
                                            name="SLAM-tracking",
                                            daemon=True)
            self._worker.start()

    # ------------------------------------------------------------------ API
    def track(self, image: np.ndarray, timestamp: float,
              gps_lla=None, gps_acc: float = 5.0,
              pyr=None, height_ground=None) -> Optional[Frame]:
        """Feed one frame. image: [H, W] gray or [H, W, 3] RGB uint8/f32."""
        self._ensure_modules()
        if self.camera is None:
            p = self.cfg.get_vec("Camera.Paraments")
            if p:
                from ..core.camera import Camera
                self.camera = Camera.from_parameters(p)
            else:
                raise ValueError("no camera configured")
        image = np.asarray(image)
        color = image if image.ndim == 3 else None
        if self.tracker.use_fused:
            # keep the frame uint8 for upload, but gray-convert RGB ON
            # THE HOST first: one channel uploads a third of the bytes
            gray = image
            if gray.ndim == 3:
                if gray.dtype == np.uint8:
                    g = gray.astype(np.uint16)
                    # BT.601 luma in fixed point (77+150+29 = 256)
                    gray = ((77 * g[..., 0] + 150 * g[..., 1]
                             + 29 * g[..., 2]) >> 8).astype(np.uint8)
                else:
                    # host dot product (the upload this branch avoids)
                    gray = (gray[..., :3].astype(np.float32)
                            @ np.array([0.299, 0.587, 0.114], np.float32))
        else:
            gray = (im.rgb_to_gray(torch.from_numpy(np.asarray(
                image, np.float32)).to(self.device)).cpu().numpy()
                    if image.ndim == 3 else image.astype(np.float32))
        cam = self.camera
        mosaic_full = None
        if self._track_scale > 1:
            # SLAM.TrackScale=s: track on an s-fold host-downsampled frame
            # with intrinsics scaled to match (poses, map geometry and the
            # mosaic feed are resolution-independent; the FULL-RES frame
            # still goes to the mosaic — the color image when there is
            # one, else the pre-downsample gray stashed below). This
            # divides the per-frame upload by s^2.
            if color is None:
                mosaic_full = gray       # full-res gray, pre-downsample
            gray = _box_downsample(gray, self._track_scale)
            if self._scaled_cam is None:
                # downsampled() preserves the distortion model (ATAN /
                # OpenCV coefficients act on normalized coords; OCAM
                # rescales its pixel-space polynomials) and applies the
                # (s-1)/2 box-downsample pixel-center offset to cx/cy.
                self._scaled_cam = cam.downsampled(self._track_scale)
            cam = self._scaled_cam
        frame = Frame(id=self.map.get_fid(), timestamp=timestamp,
                      camera=cam, image=gray, color=color)
        if mosaic_full is not None:
            frame.mosaic_image = mosaic_full
        if not self.tracker.use_fused:
            # fused tracking extracts inside its own step; every other
            # configuration extracts here (DIYSLAM.cpp:279). Host copies
            # come through the frame's packed copy: ONE synchronisation
            # instead of one per feature array.
            with timer.scope("SLAM::extract"):
                feats = self.detector(gray)
                frame.set_features_device(feats, self.detector.kind)
                frame._materialize()
        if gps_lla is not None:
            from ..core import gps as gpsmod
            if self._local_frame is None:
                self._local_frame = gpsmod.LocalFrame(*gps_lla)
                self.cfg.set("GPS.Origin", " ".join(str(v) for v in gps_lla))
            frame.gps_lla = np.asarray(gps_lla, np.float64)
            frame.gps_enu = self._local_frame.to_local(*gps_lla).astype(
                np.float32)
            frame.gps_acc = gps_acc
            if pyr is not None:         # attitude prior (getPrioryPose)
                frame.pyr = np.asarray(pyr, np.float64)
            if height_ground is not None:
                frame.height_ground = float(height_ground)
        if self._online:
            if self._chain <= 1:
                # depth-2 overlap (DIYSLAM.cpp:346-363): upload and enqueue
                # the frame's extraction FROM THIS THREAD, while the
                # tracking thread still waits on the previous frame
                self.tracker.predispatch_extract(frame)
            # chain mode queues the RAW frame: the tracking loop drains K
            # frames and uploads them in one copy (tracker.track_chain)
            self._put(frame)
        else:
            self._track_one(frame)
        return frame

    def _put(self, item, timeout=None) -> bool:
        """Put on the bounded tracking queue, waiting while it is full (at
        most `timeout` seconds when given: then False); an error, not a
        hang, if the tracking thread has ended."""
        end = None if timeout is None else time.monotonic() + timeout
        while True:
            try:
                self._queue.put(item, timeout=1.0)
                return True
            except queue.Full:
                if not self._worker.is_alive():
                    raise RuntimeError("SLAM: the tracking thread has ended")
                if end is not None and time.monotonic() > end:
                    return False

    def _undistort_for_mosaic(self, img):
        """The mosaic warp assumes a pinhole camera; distorted models
        (ATAN/OpenCV) get remapped through the Undistorter table first
        (Undistorter.h prepareReMap/undistortFast; the reference's
        saveMap2DFusion does the same before handing frames to Map2D)."""
        if self.camera.name in ("PinHole", "Ideal"):
            return img
        if self._undistort_xy is None:
            from ..core.camera import undistort_map
            self._undistort_xy = undistort_map(self.camera,
                                               device=self.device)
        return im.remap(torch.from_numpy(np.asarray(img, np.float32)).to(
            self.device), self._undistort_xy).cpu().numpy()

    def _track_one(self, frame: Frame):
        self.frames_total += 1
        ok = self.tracker.track(frame)
        return self._after_track(frame, ok)

    def _after_track(self, frame: Frame, ok: bool):
        """Post-tracking product actions for one frame: mosaic feed, loop
        closing, post-closure GPS re-anchor."""
        if ok:
            self.frames_tracked += 1
            # feed the mosaic queue (TrackerOpt.cpp:374-384)
            img = frame.color if frame.color is not None \
                else (frame.mosaic_image if frame.mosaic_image is not None
                      else frame.image)
            img = self._undistort_for_mosaic(img)
            # attach (frame_id, ref_kf_id, kf_pose_at_feed, epoch) so the
            # fusion consumer can re-render this frame's tiles when the
            # map's poses improve (loop closure / GPS refit ->
            # Map2D.refresh), and gauge it by the map epoch it was tracked
            # in: the count of map-transform publishes so far
            meta = None
            rk = self.tracker.ref_kf_id
            if rk >= 0 and self.map is not None:
                kf = self.map.frame(rk)
                if kf is not None:
                    from ..core.messenger import messenger as _msg
                    from .fusion import TRANSFORM_TOPICS
                    meta = (frame.id, rk,
                            np.asarray(kf.pose_c2w, np.float64).copy(),
                            _msg.published(*TRANSFORM_TOPICS))
            self.trans_queue.product((img, frame.pose_c2w.copy(), meta))
            if frame.is_keyframe and self.cfg.get_bool("SLAM.LoopClose",
                                                       True):
                with timer.scope("SLAM::loopClose"):
                    closed = self.loop_closer.try_close(frame)
                if closed:
                    # the whole map moved: refresh the tracker's staged
                    # local-map arrays
                    self.tracker.invalidate_local_stage()
                    # the closure's SE3 graph fixes only the loop keyframe
                    # (LoopCloserDemo.cpp:327-420) — it can translate the
                    # whole map relative to the geo frame. Re-anchor to
                    # GPS immediately (the reference's mapper re-runs
                    # fitGps on its NFrame2FitGPS cadence; after a closure
                    # waiting for the cadence leaves the map meters off)
                    if self.mapper is not None and self.mapper.gps_fitted:
                        self.mapper.fit_gps_all()
                    # the mosaic consumer re-renders tiles under the
                    # moved poses (fusion._maybe_refresh)
                    from ..core.messenger import messenger as _msg
                    _msg.advertise("map_transformed").publish(self.map)
        return ok

    def _tracking_loop(self):
        stop = False
        while not stop:
            frame = self._queue.get()
            if frame is None:
                return
            frames = [frame]
            # chain mode (SLAM.TrackChain > 1): drain frames the feeder
            # queued so K frames ride ONE upload + ONE packed copy
            # (tracker.track_chain). The drain WAITS a bounded interval for
            # the feeder (SLAM.ChainWaitMs, default 150 ms total): a
            # get_nowait()-only drain degenerates chains to 1-2 frames when
            # the feeder is not ahead. Waiting trades per-frame latency for
            # fewer copies; real-time feeds lower ChainWaitMs (or
            # TrackChain) to taste.
            if self._chain > 1:
                deadline = time.monotonic() + self.cfg.get_double(
                    "SLAM.ChainWaitMs", 150.0) / 1e3
            while len(frames) < self._chain:
                try:
                    if self._chain > 1:
                        left = deadline - time.monotonic()
                        nxt = (self._queue.get(timeout=left) if left > 0
                               else self._queue.get_nowait())
                    else:
                        nxt = self._queue.get_nowait()
                except queue.Empty:
                    break
                if nxt is None:
                    stop = True      # finish() sentinel: flush then exit
                    break
                frames.append(nxt)
            try:
                self._track_many(frames)
            except Exception:   # noqa: BLE001 — the loop must outlive bugs
                # a dead tracking thread would leave the feeder waiting on
                # the bounded queue; a failing batch counts in
                # track_errors (every test gates it at 0) and the loop
                # goes on
                import traceback
                from ..core.glog import logger
                self.track_errors += 1
                logger.error("tracking thread: frame %d raised:\n%s"
                             % (frames[0].id, traceback.format_exc()))

    def _track_many(self, frames):
        """Track a drained batch: the K-frame chain when possible,
        per-frame for the remainder (chain preconditions unmet, or the
        frames after a failure inside the chain, whose device carry went
        bad)."""
        n = 0
        if len(frames) > 1:
            n = self.tracker.track_chain(frames) or 0
            for fr in frames[:n]:
                self.frames_total += 1
                self._after_track(fr, True)
        for fr in frames[n:]:
            self._track_one(fr)

    def finish(self, timeout: float = 60.0):
        """call("Finish") in the reference: end the online tracking thread
        (after the frames queued before this call) and drain the mapper's
        worker, each waiting at most `timeout` seconds, then a final
        full-trajectory GPS refit when geo-registered. Returns whether
        both ended in time (offline always)."""
        done = True
        if self._online and self._worker is not None:
            t0 = time.monotonic()
            if self._worker.is_alive() and self._put(None, timeout):
                self._worker.join(timeout=max(
                    0.0, timeout - (time.monotonic() - t0)))
            done = not self._worker.is_alive()
        if self.mapper is not None:
            done = self.mapper.finish(timeout) and done
            if self.mapper.gps_fitted:
                self.mapper.fit_gps_all()
        # per-run statistics some trackers keep (TrackerPlanar's
        # Evaluater report, TrackerPlanar.cpp:55-78)
        if self.tracker is not None and hasattr(self.tracker, "report"):
            self.tracker.report()
        # final-pose mosaic refresh: the reference's draw path re-blends
        # under CURRENT poses every draw (MultiBandMap2DCPU.cpp:637-775),
        # so its result.png always reflects the final optimized map. Our
        # feed-time compositing bakes in whatever pose each frame had when
        # it streamed; publishing the finished map lets the FusionSystem
        # re-render cached frames whose poses local BA / closures improved
        # since they were fed (fusion._maybe_refresh).
        if self.map is not None and self.cfg.get_int("Fusion.FinalRefresh",
                                                     1):
            from ..core.messenger import messenger as _msg
            _msg.advertise("map_transformed").publish(self.map)
        return done

    def call(self, command: str, arg=None):
        """String-command surface (DIYSLAM.cpp:366-394)."""
        if command == "Finish":
            self.finish()
        elif command == "FitGPSAll":        # DIYSLAM.cpp:392 -> tryFitGPS
            if self.mapper is not None:
                return self.mapper.fit_gps_all()
        elif command == "SetSvar" and arg is not None:
            self.cfg.update(arg)
        return None

    # convenience accessors
    @property
    def plane(self):
        return None if self.mapper is None else self.mapper.plane_se3

    def trajectory(self):
        frames = sorted(self.map.frames(), key=lambda f: f.timestamp)
        return (np.asarray([f.timestamp for f in frames]),
                np.stack([f.pose_c2w for f in frames]) if frames else
                np.zeros((0, 7)))


def create_slam(cfg: Optional[Svar] = None, camera=None,
                device=None) -> SLAM:
    """createSLAMInstance equivalent (DIYSLAM.cpp:507). device: see
    `SLAM`."""
    return SLAM(cfg, camera, device)
