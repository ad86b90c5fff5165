"""Pose tracker: the per-frame state machine.

Port of pislamfusion_tpu/models/tracker.py, the reference's default tracker
`opt` (GSLAM-DIYSLAM/src/zhaoyong/TrackerOpt.cpp): Init/Track/Lost states
(:52-57), two-view bootstrap with baseline check (:508-634), motion-model
trackLastFrame with window matches + pose-only LM (:636-793), PnP-RANSAC
relocalization against keyframes (:795-902, 1307-1350), trackLocalMap
(:1107-1305), and the FOV-overlap keyframe decision vs SLAM.MaxOverlap
(:1420-1502); with the `demo` tracker, the default relocalizer and the
reference's variants `ransacPnP`, `planar`, `testInit`/`liu_testInit`,
`testLoopDetector`, `loadmap` and `rtsfmInit`.

Host code does the bookkeeping in numpy; all per-keypoint work (descriptor
distance matrices, windowed matching, pose LM, PnP RANSAC, two-view init)
runs as tensor ops on the tracker's device (`device`, None meaning `cuda`).
The fused per-frame path (`_track_fused`) enqueues the whole frame's
matching and both pose LMs and reads ONE packed buffer back. RANSAC samples
come from the reference's own key, `PRNGKey(SLAM.Seed)` (`threefry.Key`, on
the CPU), split at the reference's call sites (`_next_key`), so the port
draws the JAX package's hypotheses, and a run on the card and one on the
CPU the same ones.

The online mode's `SLAM.TrackChain` tracks K queued frames at a time
(`track_chain`: one upload of the K raw frames from pinned memory, K
enqueued steps with the carry on the device, one packed copy back), and
its feeder thread enqueues each frame's extraction ahead of the tracking
thread (`predispatch_extract`). Every thread launches on PyTorch's one
default stream of the device, which orders their work.
"""
from __future__ import annotations

import enum
import os
from typing import Optional

import numpy as np
import torch

from ..core import glog
from ..core.device import resolve_device
from ..core.registry import RELOCALIZERS, TRACKERS
from ..core.timer import timer
from ..ops import ba, matching, ransac, threefry
from ..utils import host_se3 as hse3
from ..utils.padding import pad_to
from . import pipeline
from .frame import Frame, MapPoint
from .pipeline import fused_extract, fused_track_packed_feats
from .worldmap import WorldMap

LOCAL_POINT_CAP = 2048   # padded local-map size (one shape for matching)


class Status(enum.Enum):
    INIT = 0
    TRACKING = 1
    LOST = 2


@TRACKERS.register("opt")
class Tracker:
    supports_fused = True   # single-readback hot path (TrackerOpt design)

    def __init__(self, wmap: WorldMap, cfg, mapper=None, device=None):
        self.map = wmap
        self.cfg = cfg
        self.mapper = mapper
        self.device = resolve_device(device)
        self.status = Status.INIT
        self.ref_frame: Optional[Frame] = None    # init reference
        self.ref_kf_id: int = -1
        self.last_frame: Optional[Frame] = None
        self.motion = np.array([0, 0, 0, 0, 0, 0, 1.0], np.float32)
        self.lost_count = 0
        self._key = threefry.Key(cfg.get_int("SLAM.Seed", 0))
        self.max_overlap = cfg.get_double("SLAM.MaxOverlap", 0.95)
        self.loop_detector = None   # wired by SLAM for relocalization
        self.matcher = None         # lazy MATCHERS.create (Matcher?= cfg)
        self._initializer = None    # lazy INITIALIZERS.create (Initializer?=)
        self.detector = None        # wired by SLAM (feature extractor)
        self.use_fused = False      # wired by SLAM (ORB/SIFT + SLAM.Fused)
        self._local_stage = None    # staged local-map tensors (device)
        self.min_inliers = cfg.get_int("SLAM.MinTrackInliers", 30)
        # matching thresholds (MatcherBoW.cpp:133-174)
        self.chi2_px = cfg.get_double("SLAM.Chi2Threshold", 5.991)
        # stage toggles (TrackerOpt.cpp:638, :1109-1110)
        self._track_last = not cfg.get_bool("DisableTrackLastFrame", False)
        self._track_submap = cfg.get_bool("EnableTrackSubMap", True)
        # the lengths of the chains track_chain enqueued, in order
        self.chain_lengths: list = []

    def _t(self, a, dtype=None):
        """A host array as a tensor on the tracker's device."""
        t = torch.from_numpy(np.ascontiguousarray(a))
        return t.to(self.device, dtype)

    def _upload(self, a):
        """A host array on the tracker's device in one copy: on CUDA from
        pinned memory, without waiting for the copy (the caching host
        allocator keeps the pinned buffer until the copy has run)."""
        t = torch.from_numpy(np.ascontiguousarray(a))
        if self.device.type != "cuda":
            return t.to(self.device)
        return t.pin_memory().to(self.device, non_blocking=True)

    def _next_key(self):
        """The reference's `_next_key` (tracker.py:76-78): split the key,
        keep the first half, draw from the second."""
        self._key, k = self._key.split()
        return k

    def on_map_transformed(self, S: np.ndarray):
        """The mapper applied a global SIM3 (GPS fit): frame objects are
        already updated in place; only the cached relative motion needs its
        translation rescaled (t_rel' = s * t_rel, rotation unchanged)."""
        self.motion = self.motion.copy()
        self.motion[:3] *= float(S[7])
        self.invalidate_local_stage()   # staged point cloud moved

    def _relocalizer(self):
        """Named Relocalizer seam (Relocalizer.h:16-28); the `Relocalizer`
        cfg key resolves a named strategy, defaulting to the
        tracker-internal sweep."""
        if getattr(self, "_reloc", None) is None:
            name = self.cfg.get_string("Relocalizer", "demo")
            try:
                self._reloc = RELOCALIZERS.create(name, self.cfg)
            except Exception as exc:                       # noqa: BLE001
                # loud fallback: a typo'd name or a broken user strategy
                # must not silently swap in the default for the whole run
                glog.logger.error(
                    "Relocalizer=%r failed to construct (%s); using the "
                    "default tracker sweep" % (name, exc))
                self._reloc = RelocalizerDemo(self.cfg)
        return self._reloc

    def invalidate_local_stage(self):
        self._local_stage = None

    def predispatch_extract(self, frame: Frame):
        """Upload the raw frame and enqueue its feature extraction without
        waiting; the features stay on the device (`frame.feats_dev`)."""
        if not self.use_fused or self.detector is None:
            return
        if frame.feats_dev is not None or frame._feats is not None:
            return
        with timer.scope("Tracker::predispatch"):
            img_dev = self._t(np.asarray(frame.image))  # raw dtype
            feats = fused_extract(img_dev, self.detector.params,
                                  self.detector.pyramid)
            frame.set_features_device(feats, self.detector.kind)

    def ensure_features(self, frame: Frame):
        """Extract features on demand (the fused path extracts on the
        device without a host copy; every other path needs them host-side
        first, through the frame's ONE packed copy)."""
        if frame.desc is None and self.detector is not None:
            with timer.scope("Tracker::extract"):
                img = self._t(np.asarray(frame.image), torch.float32)
                feats = fused_extract(img, self.detector.params,
                                      self.detector.pyramid)
                frame.set_features_device(feats, self.detector.kind)
                frame._materialize()

    # ------------------------------------------------------------------ API
    def track(self, frame: Frame) -> bool:
        with timer.scope("Tracker::track"), \
                glog.ScopedLogger(self.cfg, bit=1) as lg:
            self._log = lg
            lg << f"frame {frame.id} [{self.status.name}]"
            if self.status == Status.INIT:
                self.ensure_features(frame)
                ok = self._initialize(frame)
            else:
                ok = self._track_frame(frame)
            # frame t-2's device feature buffers are no longer inputs to
            # any step: free them (keyframes are materialized/released by
            # the mapper)
            prev2 = getattr(self, "last_prev", None)
            if prev2 is not None and prev2 is not self.last_frame \
                    and not prev2.is_keyframe:
                prev2.release_device_features()
            self.last_prev = self.last_frame
            if ok and self.last_frame is not None:
                self.motion = hse3.se3_mul(
                    hse3.se3_inv(self.last_frame.pose_c2w),
                    frame.pose_c2w).astype(np.float32)
            self.last_frame = frame
            lg << (f",inliers {getattr(self, '_n_inliers', 0)},"
                   f"{'OK' if ok else 'FAIL'}"
                   f"{',KF' if frame.is_keyframe else ''}")
            return ok

    def track_chain(self, frames) -> Optional[int]:
        """Track up to K consecutive frames with ONE enqueued chain
        (pipeline.fused_track_chain_images, or fused_track_chain for
        frames whose features were extracted already) and ONE copy of the
        packed rows: the per-frame carry (features, point bindings, motion
        model) stays on the device.

        Returns the number of frames CONSUMED — all consumed frames
        tracked, with the per-frame bookkeeping of `track` (motion model,
        keyframe decision, logging, the t-2 release) — or None when the
        chain's preconditions do not hold or a map transform landed while
        it ran. Frames past the consumed count (the first failure inside
        the chain and everything after it, whose device carry went bad)
        must be fed again through the per-frame `track`, which runs the
        fallback cascade. The local-map stage is FIXED across the chain:
        keyframe growth lands on the next chain."""
        if (not self.use_fused or self.status != Status.TRACKING
                or self.detector is None or len(frames) < 2
                or not self._track_last or not self._track_submap):
            return None
        last = self.last_frame
        if last is None or last.n_kp == 0 or last.n_tracked() < 20:
            return None
        if self._local_stage is None:
            self._stage_local_map()
        cam = frames[0].camera
        # the locked snapshot of _track_fused: the stage and the version
        # baseline under one lock
        with timer.scope("Tracker::chainGather"), self.map.update_lock:
            map_version = self.map.version
            stage = self._local_stage
            if stage is None:
                return None
            pos, has = self._gather_frame_points(last)
        lpos, ldesc, lvalid, ids_p = stage
        fd = last.feats_dev
        if fd is not None:
            last_desc, last_valid = fd["desc"], fd["valid"]
        else:
            last_desc, last_valid = self._t(last.desc), self._t(last.valid)
        radius = self.cfg.get_double("SLAM.WindowRadius", 20.0)
        r_local = self.cfg.get_double("SLAM.LocalWindowRadius", 8.0)
        aux = self._t(np.concatenate([
            pos.reshape(-1).astype(np.float32), has.astype(np.float32),
            np.asarray(last.pose_c2w, np.float32),
            np.asarray(self.motion, np.float32)]))
        geo = dict(fx=cam.fx, fy=cam.fy, cx=cam.cx, cy=cam.cy,
                   width=cam.width, height=cam.height, radius=radius,
                   radius_local=r_local, chi2_th=self.chi2_px)
        # RAW-IMAGE chain (frames queued without extraction, the default
        # with SLAM.TrackChain > 1): the K frames go up in one copy and
        # each step extracts its own
        use_images = all(fr.feats_dev is None and fr._feats is None
                         and fr.image is not None for fr in frames)
        if use_images:
            with timer.scope("Tracker::chainUpload"):
                imgs = self._upload(np.stack([np.asarray(fr.image)
                                              for fr in frames]))
            with timer.scope("Tracker::chainDispatch"):
                packed_k, feats_k = pipeline.fused_track_chain_images(
                    imgs, last_desc, last_valid, aux, lpos, ldesc, lvalid,
                    params=self.detector.params,
                    pyramid=self.detector.pyramid, **geo)
            for i, fr in enumerate(frames):
                fr.set_features_device({k: v[i] for k, v in feats_k.items()},
                                       self.detector.kind)
        else:
            for fr in frames:
                if fr.feats_dev is None:
                    self.predispatch_extract(fr)
                if fr.feats_dev is None:
                    return None
            stacked = [torch.stack([fr.feats_dev[k] for fr in frames])
                       for k in ("desc", "valid", "xy")]
            with timer.scope("Tracker::chainDispatch"):
                packed_k = pipeline.fused_track_chain(
                    *stacked, last_desc, last_valid, aux, lpos, ldesc,
                    lvalid, **geo)
        self.chain_lengths.append(len(frames))
        with timer.scope("Tracker::chainFetch"):
            packed_k = packed_k.cpu().numpy()   # ONE copy, K frames
        if self.map.version != map_version:
            return None   # the gauge changed while the chain ran
        P = int(lpos.shape[0])
        prev, prev_has = last, has
        consumed = 0
        for k, frame in enumerate(frames):
            with glog.ScopedLogger(self.cfg, bit=1) as lg:
                self._log = lg
                lg << f"frame {frame.id} [TRACKING chain:{k}]"
                ok = self._apply_packed(frame, prev, packed_k[k], ids_p, P,
                                        prev_has)
                if not ok:
                    lg << ",FAIL(chain tail re-fed)"
                    break
                # per-frame bookkeeping, as track() does it
                prev2 = getattr(self, "last_prev", None)
                if prev2 is not None and prev2 is not self.last_frame \
                        and not prev2.is_keyframe:
                    prev2.release_device_features()
                self.last_prev = self.last_frame
                self.motion = hse3.se3_mul(
                    hse3.se3_inv(self.last_frame.pose_c2w),
                    frame.pose_c2w).astype(np.float32)
                self.last_frame = frame
                self.lost_count = 0
                self._maybe_keyframe(frame)
                lg << (f",inliers {getattr(self, '_n_inliers', 0)},OK"
                       f"{',KF' if frame.is_keyframe else ''}")
                consumed += 1
                prev, prev_has = frame, frame.kp2mp >= 0
        return consumed

    # ----------------------------------------------------------- bootstrap
    def _initialize(self, frame: Frame) -> bool:
        if self.ref_frame is None or self.ref_frame.n_kp == 0:
            self.ref_frame = frame
            return False
        ref = self.ref_frame
        idx, ok = self._get_matcher()(self._next_key(), ref, frame)
        idxn = idx.cpu().numpy()
        okn = ok.cpu().numpy()
        n_match = int(okn.sum())
        if n_match < self.cfg.get_int("SLAM.MinInitMatches", 100):
            self.ref_frame = frame
            return False
        ra = ref.rays[:, :2]
        rb = frame.rays[np.where(okn, idxn, 0)][:, :2]
        sigma = 1.0 / ref.camera.fx
        res = self._get_initializer()(
            self._next_key(), self._t(ra), self._t(rb), self._t(okn),
            sigma=max(sigma, 1e-4))
        if not bool(res.ok):
            return False
        # monocular gauge: scale so median depth == 1
        mask = res.mask.cpu().numpy()
        pts = res.points.cpu().numpy()
        depths = pts[mask][:, 2]
        med = float(np.median(depths[depths > 0])) if (depths > 0).any() else 1.0
        scale = 1.0 / max(med, 1e-6)
        pts = pts * scale
        T_c2w = res.T_c2w.cpu().numpy().copy()
        T_c2w[:3] *= scale

        # build the map: two keyframes + triangulated points
        ref.pose_c2w = np.array([0, 0, 0, 0, 0, 0, 1.0], np.float32)
        ref.is_keyframe = True
        frame.pose_c2w = T_c2w.astype(np.float32)
        frame.is_keyframe = True
        self.map.insert_frame(ref)
        self.map.insert_frame(frame)
        color_img = ref.color if ref.color is not None else ref.image
        for i in np.nonzero(mask)[0]:
            pid = self.map.get_pid()
            kp_ref = int(i)
            kp_cur = int(idxn[i])
            color = np.full(3, 128, np.uint8)
            if color_img is not None:
                x, y = ref.xy[kp_ref].astype(int)
                if 0 <= y < color_img.shape[0] and 0 <= x < color_img.shape[1]:
                    c = color_img[y, x]
                    color = (np.full(3, int(c), np.uint8) if np.ndim(c) == 0
                             else c.astype(np.uint8))
            mp = MapPoint(id=pid, position=pts[i].astype(np.float32),
                          descriptor=np.asarray(frame.desc[kp_cur]),
                          color=color, ref_frame=frame.id)
            view = pts[i] / max(np.linalg.norm(pts[i]), 1e-9)
            mp.normal = -view.astype(np.float32)
            self.map.insert_point(mp)
            self.map.add_observation(pid, ref.id, kp_ref)
            self.map.add_observation(pid, frame.id, kp_cur)
        ref.connections[frame.id] = int(mask.sum())
        frame.connections[ref.id] = int(mask.sum())
        self.ref_kf_id = frame.id
        self.status = Status.TRACKING
        if self.mapper is not None:
            self.mapper.on_map_initialized(ref, frame)
        return True

    # ------------------------------------------------------------ tracking
    def _track_frame(self, frame: Frame) -> bool:
        ok = False
        # the reference's stage toggles (TrackerOpt.cpp:638, :1109-1110):
        # DisableTrackLastFrame skips last-frame matching entirely (every
        # frame tracks against the ref keyframe); EnableTrackSubMap=0 skips
        # the local-map refinement pass
        track_last = self._track_last
        track_submap = self._track_submap
        if track_last and self.status == Status.TRACKING \
                and self.last_frame is not None:
            # gate on the HOST cache directly: touching frame.desc would
            # copy device features to the host. The fused step hard-wires
            # last-frame + local-map stages, so it only serves the default
            # toggle combination
            if self.use_fused and frame._feats is None and track_submap:
                ok = self._track_fused(frame)
                if ok:   # fused path already ran the local-map refinement
                    self.status = Status.TRACKING
                    self.lost_count = 0
                    self._maybe_keyframe(frame)
                    return True
            else:
                self.ensure_features(frame)
                ok = self._track_last_frame(frame)
        self.ensure_features(frame)
        if not ok:
            ok = self._relocalizer().relocalize(self, frame)
        if ok and track_submap:
            ok = self._track_local_map(frame)
        if ok:
            self.status = Status.TRACKING
            self.lost_count = 0
            self._maybe_keyframe(frame)
        else:
            self.status = Status.LOST
            self.lost_count += 1
            if self.lost_count > self.cfg.get_int("SLAM.LostRestart", 10) \
                    and self.cfg.get_bool("SLAM.RestartWhenLost", False):
                self.status = Status.INIT
                self.ref_frame = None
        return ok

    def _gather_frame_points(self, src: Frame):
        """Map points assigned to src's keypoints, aligned to kp index."""
        pos = np.zeros((src.n_kp, 3), np.float32)
        has = np.zeros(src.n_kp, bool)
        for i in np.nonzero(src.kp2mp >= 0)[0]:
            mp = self.map.point(int(src.kp2mp[i]))
            if mp is not None and not mp.bad:
                pos[i] = mp.position
                has[i] = True
        return pos, has

    def _stage_local_map(self):
        """Stage the padded local-map tensors on the device (refreshed after
        every keyframe / map transform) so the per-frame hot path needs no
        upload of the cloud."""
        with self.map.update_lock:   # consistent gauge for the staged cloud
            stage_version = self.map.version
            ref = self.map.frame(self.ref_kf_id)
            local_ids = {self.ref_kf_id}
            if ref is not None:
                top = sorted(ref.connections.items(), key=lambda kv: -kv[1])
                local_ids.update(k for k, _ in top[:10])
            bound = []
            for fid in local_ids:
                fr = self.map.frame(fid)
                if fr is None or fr.kp2mp is None:
                    continue
                bound.append(fr.kp2mp[fr.kp2mp >= 0])
            pids = (np.unique(np.concatenate(bound)) if bound
                    else np.zeros(0, np.int64))
            ids, lpos, ldesc = self.map.point_arrays([int(p) for p in pids])
        if len(ids) < 30:
            self._local_stage = None
            return
        lpos_p, maskp = pad_to(lpos, LOCAL_POINT_CAP)
        ldesc_p, _ = pad_to(np.asarray(ldesc), LOCAL_POINT_CAP)
        ids_p, _ = pad_to(np.asarray(ids, np.int64), LOCAL_POINT_CAP, -1)
        stage = (self._t(lpos_p), self._t(ldesc_p), self._t(maskp), ids_p)
        with self.map.update_lock:
            # publish ONLY if no map transform landed since the locked
            # read above (every transform bumps version inside its own
            # locked critical section): assigning unconditionally would
            # REINSTATE a stale-gauge cloud that invalidate_local_stage()
            # already nulled
            self._local_stage = (stage if self.map.version == stage_version
                                 else None)

    def _track_fused(self, frame: Frame) -> bool:
        """trackLastFrame + trackLocalMap as ONE enqueued device step
        (pipeline.fused_track_packed_feats): extraction, matching, and both
        pose LMs run without a host synchronisation; the host then does
        index bookkeeping on the one packed result."""
        last = self.last_frame
        # copy-free has-features check: touching last.desc would copy the
        # device features to the host
        if last is None or last.n_kp == 0 or last.n_tracked() < 20:
            return False
        if self._local_stage is None:
            self._stage_local_map()
        cam = frame.camera
        # snapshot the staging inputs ATOMICALLY vs whole-map rewrites: the
        # stage tuple is read under the SAME lock as the version baseline
        with timer.scope("Tracker::fusedGather"), self.map.update_lock:
            map_version = self.map.version
            stage = self._local_stage
            if stage is None:   # invalidated since the restage attempt
                return False
            pos, has = self._gather_frame_points(last)
            T_pred_w2c = hse3.se3_inv(hse3.se3_mul(last.pose_c2w,
                                                   self.motion))
        radius = self.cfg.get_double("SLAM.WindowRadius", 20.0)
        r_local = self.cfg.get_double("SLAM.LocalWindowRadius", 8.0)
        lpos, ldesc, lvalid, ids_p = stage
        # previous frame's features: reuse its DEVICE tensors when present
        # (no re-upload), else upload the host copies
        fd = last.feats_dev
        if fd is not None:
            last_desc, last_valid = fd["desc"], fd["valid"]
        else:
            last_desc = self._t(last.desc)
            last_valid = self._t(last.valid)
        with timer.scope("Tracker::fusedUpload"):
            # ONE small upload for every per-frame host input
            aux = np.concatenate([
                pos.reshape(-1).astype(np.float32),
                has.astype(np.float32),
                np.asarray(T_pred_w2c, np.float32)])
            aux_dev = self._t(aux)
        with timer.scope("Tracker::fusedDispatch"):
            if frame.feats_dev is None:
                # offline mode / first frames: upload + extract now
                self.predispatch_extract(frame)
            feats = frame.feats_dev
            packed = fused_track_packed_feats(
                feats, last_desc, last_valid, aux_dev,
                lpos, ldesc, lvalid,
                fx=cam.fx, fy=cam.fy,
                cx=cam.cx, cy=cam.cy, width=cam.width, height=cam.height,
                radius=radius, radius_local=r_local, chi2_th=self.chi2_px)
            # the frame's features STAY ON THE DEVICE (keyframes copy them
            # to the host in the mapper; plain frames never do)
        with timer.scope("Tracker::fusedFetch"):
            packed = packed.cpu().numpy()   # ONE copy, one synchronisation
        if self.map.version != map_version:
            # the map changed gauge while the step was in flight: this
            # result lives in the OLD gauge
            self._log << ",staleGauge"
            return False
        return self._apply_packed(frame, last, packed, ids_p,
                                  int(lpos.shape[0]), has)

    def _apply_packed(self, frame: Frame, last: Frame, packed: np.ndarray,
                      ids_p: np.ndarray, P: int,
                      prev_has: np.ndarray) -> bool:
        """Host index bookkeeping for ONE packed result row
        (pipeline.fused_track_packed_feats layout). prev_has: mask of
        `last`'s keypoint slots that carried map points when the step's
        inputs were staged."""
        cam = frame.camera
        n = frame.n_kp
        a = packed[16:16 + 6 * n].reshape(6, n)
        b = packed[16 + 6 * n:].reshape(2, P)
        idx1 = a[0].astype(np.int64)
        ok1 = a[1] > 0.5
        chi2_1, w1, chi2_2, w2 = a[2], a[3], a[4], a[5]
        idx2 = b[0].astype(np.int64)
        ok2 = b[1] > 0.5
        T2_w2c = packed[8:15]
        th = self.chi2_px / cam.fx ** 2
        inl1 = (w1 > 0) & (chi2_1 < th)
        self._log << f",fused {int(inl1.sum())}"
        if inl1.sum() < 20:
            return False
        inl = (w2 > 0) & (chi2_2 < th)
        if inl.sum() < self.min_inliers:
            return False
        frame.pose_c2w = hse3.se3_inv(T2_w2c).astype(np.float32)
        # bind current keypoints: last-frame matches first, then local-map
        # growth matches on still-free slots (mirrors the device merge)
        frame.kp2mp[:] = -1
        okp = ok1 & prev_has & (last.kp2mp >= 0)
        src = np.nonzero(okp)[0]
        cur = idx1[src]
        keep = inl[cur]
        frame.kp2mp[cur[keep]] = last.kp2mp[src[keep]]
        for p in np.nonzero(ok2)[0]:
            ci = int(idx2[p])
            if inl[ci] and frame.kp2mp[ci] < 0 and ids_p[p] >= 0:
                frame.kp2mp[ci] = int(ids_p[p])
        frame.kp2mp[~inl] = -1
        self._n_inliers = int(inl.sum())
        return True

    def _project_host(self, frame: Frame, T_c2w, pos):
        """Points pos [P, 3] through the camera at T_c2w: (pixels [P, 2]
        f32 through the frame's camera model, in front [P] bool)."""
        pc = hse3.se3_apply(hse3.se3_inv(np.asarray(T_c2w, np.float32)),
                            pos).astype(np.float32)
        infront = pc[:, 2] > 1e-3
        uv = pc[:, :2] / np.maximum(pc[:, 2:], 1e-6)
        pix = frame.camera.project(
            np.concatenate([uv, np.ones_like(uv[:, :1])],
                           -1)).astype(np.float32)
        return pix, infront

    def _track_last_frame(self, frame: Frame) -> bool:
        last = self.last_frame
        if last.n_tracked() < 20:
            return False
        T_pred = hse3.se3_mul(last.pose_c2w, self.motion).astype(np.float32)
        pos, has = self._gather_frame_points(last)
        # project into predicted view
        pix, infront = self._project_host(frame, T_pred, pos)
        radius = self.cfg.get_double("SLAM.WindowRadius", 20.0)
        idx, ok = matching.match_descriptors_windowed(
            self._t(last.desc), self._t(has & infront & last.valid),
            self._t(pix), self._t(frame.desc), self._t(frame.valid),
            self._t(frame.xy), radius, last.desc_kind)
        idxn, okn = idx.cpu().numpy(), ok.cpu().numpy()
        if okn.sum() < 20:
            return False
        return self._solve_pose(frame, T_pred, pos, has, idxn, okn, last)

    def _solve_pose(self, frame, T_init_c2w, pos, has, idxn, okn, src_frame,
                    inliers=None):
        """Pose-only LM from (src kp -> cur kp) matches; assigns kp2mp.

        `inliers` [n_kp] bool, the current frame's PnP-RANSAC inliers,
        restricts the fit to them: every fit that starts from a PnP pose
        passes them (`_track_ref_kf`, which relocalizes, and
        `TrackerRansacPnP`). The reference fits every match there
        (tracker.py:633-662): from a PnP pose with 50 of 60 inliers its
        Huber LM walks toward the outliers and ends with fewer than
        SLAM.MinTrackInliers, so relocalization fails or succeeds by
        chance (ROADMAP queue 3)."""
        if inliers is not None:
            okn = okn & inliers[np.where(okn, idxn, 0)]
        n = frame.n_kp
        p3d = np.zeros((n, 3), np.float32)
        w = np.zeros(n, np.float32)
        src_of_cur = np.full(n, -1, np.int64)
        sel = np.nonzero(okn & has)[0]
        cur_idx = idxn[sel]
        p3d[cur_idx] = pos[sel]
        w[cur_idx] = 1.0
        src_of_cur[cur_idx] = sel
        p2n = frame.rays[:, :2]
        T, cost, chi2 = ba.optimize_pose(
            self._t(hse3.se3_inv(np.asarray(T_init_c2w, np.float32)),
                    torch.float32),
            self._t(p3d), self._t(p2n), self._t(w),
            iters=12, huber_delta=float(np.sqrt(self.chi2_px))
            / frame.camera.fx)
        # one copy for pose + residuals; invert host-side
        both = torch.cat([T, chi2]).cpu().numpy()
        T, chi2 = both[:7], both[7:]
        th = self.chi2_px / frame.camera.fx ** 2
        inl = (w > 0) & (chi2 < th)
        if inl.sum() < self.min_inliers:
            return False
        frame.pose_c2w = hse3.se3_inv(T).astype(np.float32)
        frame.kp2mp[:] = -1
        for ci in np.nonzero(inl)[0]:
            frame.kp2mp[ci] = src_frame.kp2mp[src_of_cur[ci]]
        self._n_inliers = int(inl.sum())
        return True

    def _track_ref_kf(self, frame: Frame) -> bool:
        """PnP-RANSAC against the reference keyframe
        (trackRefKeyframeRansac, :795-902); doubles as relocalization when
        we also scan recent keyframes."""
        kfs = self.map.keyframes()
        candidates = []
        ref = self.map.frame(self.ref_kf_id)
        if ref is not None:
            candidates.append(ref)
        if self.status == Status.LOST:
            # relocalization (relocalize(), :1307-1350): loop-detector
            # candidates first (BoW/appearance when a vocabulary is wired),
            # then recent keyframes, then a strided sample of the whole map
            loop_cands = []
            if self.loop_detector is not None:
                loop_cands = [self.map.frame(fid) for fid in
                              self.loop_detector.candidates(frame)[:5]]
                loop_cands = [k for k in loop_cands if k is not None]
            recent = kfs[-3:]
            stride = max(1, len(kfs) // 17)
            spread = kfs[::stride][:17]
            seen = set()
            candidates = []
            for kf in loop_cands + recent + spread:
                if kf.id not in seen:
                    seen.add(kf.id)
                    candidates.append(kf)
        self._log << f",refKF x{len(candidates)}"
        # one batched match prefilters ALL candidates (relocalize(),
        # :1307-1350). Candidate ORDER is preserved (loop-detector first,
        # then recent, then spread — the reference's priority), the
        # precomputed matches just skip hopeless candidates and feed the
        # PnP loop directly.
        points = [self._gather_frame_points(kf) for kf in candidates]
        pre_idx = pre_ok = None
        base_match = type(self)._ref_kf_match is Tracker._ref_kf_match
        if len(candidates) > 1:
            descs = self._t(np.stack([kf.desc for kf in candidates]))
            valids = self._t(np.stack(
                [h & kf.valid for kf, (_, h) in zip(candidates, points)]))
            bi, bo = matching.match_descriptors_batch(
                descs, valids, self._t(frame.desc), self._t(frame.valid),
                candidates[0].desc_kind, ratio=0.8)
            pre_idx, pre_ok = bi.cpu().numpy(), bo.cpu().numpy()
        for ci, kf in enumerate(candidates):
            pos, has = points[ci]
            if pre_ok is not None and base_match:
                # the base matcher IS the batched ratio-BF — reuse it
                idxn, okn = pre_idx[ci], pre_ok[ci]
            else:
                # conservative prefilter only: an overriding matcher
                # (demo's multiH growth) recovers matches the ratio-BF
                # kills, so skip only truly hopeless candidates
                if pre_ok is not None and pre_ok[ci].sum() < 4:
                    continue
                idx, ok = self._ref_kf_match(kf, frame, has)
                idxn, okn = idx.cpu().numpy(), ok.cpu().numpy()
            if okn.sum() < 15:
                continue
            n = frame.n_kp
            p3d = np.zeros((n, 3), np.float32)
            w = np.zeros(n, bool)
            src_of_cur = np.full(n, -1, np.int64)
            sel = np.nonzero(okn & has)[0]
            p3d[idxn[sel]] = pos[sel]
            w[idxn[sel]] = True
            src_of_cur[idxn[sel]] = sel
            res = ransac.find_pnp(self._next_key(), self._t(p3d),
                                  self._t(frame.rays[:, :2]), self._t(w),
                                  threshold=3.0 / frame.camera.fx)
            if not bool(res.ok):
                # scarce 3D: mixed epipolar + inverse-depth fallback
                # (trackRefKeyframe, TrackerOpt.cpp:904-1105)
                if self._track_ref_kf_epipolar(frame, kf):
                    # the matched candidate becomes the reference keyframe
                    # (relocalize(): the local map must re-center on it)
                    self.ref_kf_id = kf.id
                    self.invalidate_local_stage()
                    return True
                continue
            T_c2w = hse3.se3_inv(res.model.cpu().numpy())
            if self._solve_pose(frame, T_c2w, pos, has, idxn, okn, kf,
                                inliers=res.inliers.cpu().numpy()):
                self.ref_kf_id = kf.id
                self.invalidate_local_stage()
                return True
        return False

    def _get_initializer(self):
        """Lazy Initializer plugin (the reference's `Initializer?=` seam,
        Initializer.h:22-34): svd (default, H/F RANSAC + cheirality) /
        opt (joint SE3+inverse-depth epipolar LM) through INITIALIZERS."""
        if self._initializer is None:
            from .initializers import create_initializer
            self._initializer = create_initializer(self.cfg)
        return self._initializer

    def _get_matcher(self):
        """Lazy Matcher plugin (the reference's `Matcher?=` seam,
        Matcher.h): BF / multiH (default, MatcherMultiH.cpp) / BFMultiH
        through the MATCHERS registry, on the tracker's device."""
        if self.matcher is None:
            from ..core.registry import MATCHERS
            from . import matchers as _matchers               # noqa: F401
            name = self.cfg.get_string("Matcher", "multiH")
            try:
                self.matcher = MATCHERS.create(name, self.cfg,
                                               device=self.device)
            except KeyError:
                # reference configs name matcher variants this build
                # collapses; run the BF baseline instead of crashing
                # two-view init
                from ..core.glog import logger
                logger.warning(f"Matcher '{name}' unknown; using BF")
                self.matcher = MATCHERS.create("BF", self.cfg,
                                               device=self.device)
        return self.matcher

    def _ref_kf_match(self, kf: Frame, frame: Frame, has) -> tuple:
        """Keyframe-candidate matching seam: 'opt' restricts to keypoints
        WITH map points (only they constrain PnP; ratio-BF, the cheap
        choice for the up-to-25-candidate LOST sweep)."""
        return matching.match_descriptors(
            self._t(kf.desc), self._t(has & kf.valid),
            self._t(frame.desc), self._t(frame.valid),
            kf.desc_kind, ratio=0.8)

    def _track_ref_kf_epipolar(self, frame: Frame, kf: Frame) -> bool:
        """Mixed PnP + epipolar pose vs a keyframe: 2D-2D matches carry
        per-match inverse-depth unknowns, the few 3D anchors pin the scale
        (TrackerOpt::trackRefKeyframe :904-1105 + optimizePose's
        EdgeSE3InvDepth edges)."""
        idx, ok = matching.match_descriptors(
            self._t(kf.desc), self._t(kf.valid),
            self._t(frame.desc), self._t(frame.valid),
            kf.desc_kind, ratio=0.8)
        idxn, okn = idx.cpu().numpy(), ok.cpu().numpy()
        if okn.sum() < 40:
            return False
        pos, has = self._gather_frame_points(kf)
        # anchors: matched kf keypoints WITH map points
        anchor = okn & has
        if anchor.sum() < 3:
            return False
        rays_cur = frame.rays[np.where(okn, idxn, 0)][:, :2]
        w2d = (okn & ~has).astype(np.float32)
        w3d = anchor.astype(np.float32)
        # inverse-depth init: anchors use true depth, rest the median
        pc = hse3.se3_apply(hse3.se3_inv(kf.pose_c2w), pos)
        depths = np.where(has & (pc[:, 2] > 0.1), pc[:, 2], np.nan)
        med = np.nanmedian(depths) if np.isfinite(depths).any() else 1.0
        idepth0 = np.where(np.isfinite(depths), 1.0 / np.maximum(
            depths, 1e-6), 1.0 / max(med, 1e-6)).astype(np.float32)
        kf_pose = np.asarray(kf.pose_c2w, np.float32)
        T, cost, q, chi2_2d, chi2_3d = ba.optimize_pose_invdepth(
            self._t(hse3.se3_inv(kf_pose), torch.float32),
            self._t(kf_pose), self._t(kf.rays[:, :2]), self._t(rays_cur),
            self._t(w2d), self._t(idepth0),
            self._t(pos), self._t(rays_cur), self._t(w3d),
            iters=15,
            huber_delta=float(np.sqrt(self.chi2_px)) / frame.camera.fx)
        th = self.chi2_px / frame.camera.fx ** 2
        inl2 = (w2d > 0) & (chi2_2d.cpu().numpy() < th)
        inl3 = (w3d > 0) & (chi2_3d.cpu().numpy() < th)
        if inl2.sum() + 2 * inl3.sum() < self.min_inliers:
            return False
        frame.pose_c2w = hse3.se3_inv(T.cpu().numpy()).astype(np.float32)
        frame.kp2mp[:] = -1
        for s in np.nonzero(inl3)[0]:
            frame.kp2mp[idxn[s]] = kf.kp2mp[s]
        self._n_inliers = int(inl2.sum() + inl3.sum())
        return True

    def _track_local_map(self, frame: Frame) -> bool:
        """Project the local map into the frame and refine
        (trackLocalMap, :1107-1305)."""
        ref = self.map.frame(self.ref_kf_id)
        local_ids = {self.ref_kf_id}
        if ref is not None:
            top = sorted(ref.connections.items(), key=lambda kv: -kv[1])
            local_ids.update(k for k, _ in top[:10])
        pids = set()
        for fid in local_ids:
            fr = self.map.frame(fid)
            if fr is None or fr.kp2mp is None:
                continue
            pids.update(int(p) for p in fr.kp2mp[fr.kp2mp >= 0])
        ids, pos, desc = self.map.point_arrays(sorted(pids))
        if len(ids) < 30:
            return frame.n_tracked() >= self.min_inliers
        pos_p, maskp = pad_to(pos, LOCAL_POINT_CAP)
        desc_p, _ = pad_to(np.asarray(desc), LOCAL_POINT_CAP)
        ids_p, _ = pad_to(np.asarray(ids, np.int64), LOCAL_POINT_CAP, -1)
        # project with current pose
        pix, infront = self._project_host(frame, frame.pose_c2w, pos_p)
        inview = frame.camera.in_view(pix)
        pvalid = maskp & infront & inview
        radius = self.cfg.get_double("SLAM.LocalWindowRadius", 8.0)
        wmask = matching.window_mask(self._t(pix), self._t(frame.xy),
                                     radius)
        idx, ok = matching.match_descriptors(
            self._t(desc_p), self._t(pvalid),
            self._t(frame.desc), self._t(frame.valid),
            frame.desc_kind, window=wmask)
        idxn, okn = idx.cpu().numpy(), ok.cpu().numpy()
        # merge: point -> cur kp assignments (keep existing from track_last)
        n = frame.n_kp
        p3d = np.zeros((n, 3), np.float32)
        w = np.zeros(n, np.float32)
        newmp = np.full(n, -1, np.int64)
        for pi in np.nonzero(okn)[0]:
            ci = idxn[pi]
            if frame.kp2mp[ci] < 0 and newmp[ci] < 0:
                p3d[ci] = pos_p[pi]
                w[ci] = 1.0
                newmp[ci] = ids_p[pi]
        # existing assignments
        for ci in np.nonzero(frame.kp2mp >= 0)[0]:
            mp = self.map.point(int(frame.kp2mp[ci]))
            if mp is not None and not mp.bad:
                p3d[ci] = mp.position
                w[ci] = 1.0
        if (w > 0).sum() < self.min_inliers:
            return False
        T, cost, chi2 = ba.optimize_pose(
            self._t(hse3.se3_inv(frame.pose_c2w), torch.float32),
            self._t(p3d), self._t(frame.rays[:, :2]), self._t(w),
            iters=10,
            huber_delta=float(np.sqrt(self.chi2_px)) / frame.camera.fx)
        both = torch.cat([T, chi2]).cpu().numpy()
        T, chi2 = both[:7], both[7:]
        th = self.chi2_px / frame.camera.fx ** 2
        inl = (w > 0) & (chi2 < th)
        if inl.sum() < self.min_inliers:
            return False
        frame.pose_c2w = hse3.se3_inv(T).astype(np.float32)
        for ci in np.nonzero(inl)[0]:
            if frame.kp2mp[ci] < 0 and newmp[ci] >= 0:
                frame.kp2mp[ci] = newmp[ci]
        for ci in np.nonzero(~inl)[0]:
            frame.kp2mp[ci] = -1
        self._n_inliers = int(inl.sum())
        return True

    # ------------------------------------------------------------ keyframe
    def _maybe_keyframe(self, frame: Frame):
        """FOV-overlap heuristic (TrackerOpt::addKeyframeIfNeeded,
        :1420-1502): insert when the view has shifted by more than
        (1 - MaxOverlap) of the field of view."""
        ref = self.map.frame(self.ref_kf_id)
        if ref is None:       # ref KF culled: fall back to the newest KF
            kfs = self.map.keyframes()
            if not kfs:
                return
            ref = kfs[-1]
            self.ref_kf_id = ref.id
        ids, pos, _ = self.map.point_arrays(
            [int(p) for p in frame.kp2mp[frame.kp2mp >= 0]])
        med_depth = frame.median_depth(pos) if len(ids) else 1.0
        rel = hse3.se3_mul(hse3.se3_inv(ref.pose_c2w), frame.pose_c2w)
        t_shift = float(np.linalg.norm(rel[:3]))
        ang = 2.0 * np.arccos(min(abs(float(rel[6])), 1.0))
        fov = 2.0 * np.arctan(0.5 * frame.camera.width / frame.camera.fx)
        view_extent = 2.0 * np.tan(fov / 2.0) * max(med_depth, 1e-6)
        change = t_shift / view_extent + ang / fov
        if change > (1.0 - self.max_overlap):
            frame.is_keyframe = True
            self.map.insert_frame(frame)
            self.ref_kf_id = frame.id
            # observations are registered by the mapper
            if self.mapper is not None:
                self.mapper.insert_keyframe(frame)
            if self.use_fused and not (
                    self.mapper is not None
                    and getattr(self.mapper, "restage_hook", None)):
                # no mapper hook wired: refresh the fused path's stage here
                # (with the hook, the MAPPER restages at the end of keyframe
                # handling, and the stage includes the keyframe's newly
                # triangulated points)
                self._stage_local_map()

    def restage_after_kf(self):
        """Mapper hook: refresh the fused path's staged local map once a
        keyframe's triangulation/fuse/BA have committed."""
        if self.use_fused:
            self._stage_local_map()


@TRACKERS.register("demo")
class TrackerDemo(Tracker):
    """The reference's simpler 'demo' tracker cascade
    (GSLAM-DIYSLAM/src/zhaoyong/TrackerDemo.cpp): window-match the last
    frame's observed map points then pose LM (trackLastFrame :305-450),
    fall back to the configured two-view Matcher against the reference
    keyframe using ONLY existing 3D observations + PnP (trackRefKeyframe
    :452-530 — `match4initialize`, no epipolar inverse-depth recovery),
    then trackLocalMap (:532-726). Selected with `Tracker?=demo`; the
    ablation baseline vs 'opt'.

    Inherits the shared state machine and device steps and narrows the
    cascade — never the fused step, no 2D-2D fallback."""

    supports_fused = False

    def _ref_kf_match(self, kf: Frame, frame: Frame, has):
        """trackRefKeyframe matches with the FULL configured Matcher
        (match4initialize, TrackerDemo.cpp:462) — denser than opt's
        ratio-BF, one multi-H RANSAC heavier."""
        return self._get_matcher()(self._next_key(), kf, frame)

    def _track_ref_kf_epipolar(self, frame: Frame, kf: Frame) -> bool:
        return False   # TrackerDemo has no inverse-depth 2D-2D fallback


@TRACKERS.register("ransacPnP")
class TrackerRansacPnP(Tracker):
    """The reference's 'ransacPnP' tracker
    (GSLAM-DIYSLAM/src/zhaoyong/TrackerRansacPnP.cpp): NO motion model —
    last-frame observations are window-matched around their LAST-frame
    pixel locations with a wide radius (0.05 * image width, :521), the
    pose comes from findPnPRansac over those 3D-2D matches (:508-652)
    with an LM refine, then the shared trackLocalMap. Robust to erratic
    inter-frame motion at the price of a wider search; registered for
    ablation like the reference's student variants.

    Inherits the state machine; narrows trackLastFrame only (the fused
    step bakes the 'opt' motion-model design)."""

    supports_fused = False

    def _track_last_frame(self, frame: Frame) -> bool:
        last = self.last_frame
        if last.n_tracked() < 20:
            return False
        pos, has = self._gather_frame_points(last)
        radius = 0.05 * frame.camera.width          # :521
        wmask = matching.window_mask(self._t(last.xy.astype(np.float32)),
                                     self._t(frame.xy), radius)
        idx, ok = matching.match_descriptors(
            self._t(last.desc), self._t(has & last.valid),
            self._t(frame.desc), self._t(frame.valid),
            last.desc_kind, window=wmask)
        idxn, okn = idx.cpu().numpy(), ok.cpu().numpy()
        sel = np.nonzero(okn & has)[0]
        if sel.size < 20:
            return False
        # PnP-RANSAC for the initial pose (arrays of the keypoint budget's
        # fixed size)
        n = frame.n_kp
        p3d = np.zeros((n, 3), np.float32)
        val = np.zeros(n, bool)
        p3d[idxn[sel]] = pos[sel]
        val[idxn[sel]] = True
        res = ransac.find_pnp(self._next_key(), self._t(p3d),
                              self._t(frame.rays[:, :2]), self._t(val))
        if not bool(res.ok):
            return False
        T_c2w = hse3.se3_inv(res.model.cpu().numpy()).astype(np.float32)
        # shared pose-LM refine + kp2mp assignment from the RANSAC pose, on
        # its inliers
        return self._solve_pose(frame, T_c2w, pos, has, idxn, okn, last,
                                inliers=res.inliers.cpu().numpy())


@TRACKERS.register("planar")
class TrackerPlanar(Tracker):
    """The reference's 'planar' tracker
    (GSLAM-DIYSLAM/src/zhaoyong/TrackerPlanar.cpp, registered as
    `Tracker?=planar` :657): an RTSfM-style GEO-REGISTERED pair-chain
    reconstructor rather than an incremental VO chain. It never leaves
    the initializing state (track() :304-317): every >= 1 s of frame
    time (:421) it two-view-initializes the (lastKF, current) pair
    (:430-470), snaps BOTH poses onto their GPS+attitude priory poses
    with map scale from the GPS/estimated baseline ratio
    (fitGPS :319-345), refines the pair with a 2-frame GPS-prior bundle
    adjustment over the triangulated points (:530-580), and inserts the
    pair + its points directly in geo coordinates (:589-612); the pair
    reference then advances.

    Divergences (as the JAX package): poses land in the local ENU frame
    instead of ECEF-minus-`Origin` (:282, :585) — same information,
    different chart; and without GPS priors the reference clears the map
    every pair (:611 `_map->clear()`), which this build mirrors by
    replacing the previous pair.

    The per-pair success statistics the reference's Evaluater prints at
    shutdown (:55-78) are logged by `report()` (wired to SLAM.finish)."""

    supports_fused = False

    def __init__(self, wmap: WorldMap, cfg, mapper=None, device=None):
        super().__init__(wmap, cfg, mapper, device)
        self._pair_ref: Optional[Frame] = None
        self._access = 0
        self._successes: list[tuple[int, int]] = []
        self.pt_cap = cfg.get_int("Planar.PointCap", 512)
        self.min_interval = cfg.get_double("Planar.MinInterval", 1.0)

    def track(self, frame: Frame) -> bool:
        with timer.scope("Tracker::track"), \
                glog.ScopedLogger(self.cfg, bit=1) as lg:
            self._log = lg
            lg << f"frame {frame.id} [PLANAR]"
            if self._pair_ref is None:   # first frame: seed the pair chain
                self.ensure_features(frame)
                self._pair_ref = frame
                self.last_frame = frame
                # the reference returns true here (:419) but never feeds
                # the mosaic itself; SLAM feeds the mosaic for every
                # tracked frame, so the seed reports untracked to keep its
                # (not yet estimated) identity pose out of the composite
                return False
            if frame.timestamp - self._pair_ref.timestamp \
                    < self.min_interval:   # :421
                lg << ",skip(dt)"
                return False
            self.ensure_features(frame)
            ok = self._pair_initialize(frame, lg)
            if ok:
                self.last_frame = frame
                self.status = Status.TRACKING
            return ok

    def report(self):
        """Evaluater::report (:65-74): success count + mean match/point
        stats over the run."""
        if not self._successes:
            glog.logger.info(f"TrackerPlanar: 0/{self._access} pairs")
            return
        m = int(np.mean([s[0] for s in self._successes]))
        p = int(np.mean([s[1] for s in self._successes]))
        glog.logger.info(
            f"TrackerPlanar: {len(self._successes)}/{self._access} pairs, "
            f"mean matches {m}, mean points {p}")

    # ----------------------------------------------------------- pair init
    def _pair_initialize(self, frame: Frame, lg) -> bool:
        ref = self._pair_ref
        self._access += 1
        # match4initialize with the full configured Matcher (:430)
        idx, okm = self._get_matcher()(self._next_key(), ref, frame)
        idxn, okn = idx.cpu().numpy(), okm.cpu().numpy()
        n_match = int(okn.sum())
        lg << f",match {n_match}"
        if n_match < max(100, ref.n_kp // 10):   # :430
            self._pair_ref = frame
            return False
        ra = ref.rays[:, :2]
        rb = frame.rays[np.where(okn, idxn, 0)][:, :2]
        res = self._get_initializer()(
            self._next_key(), self._t(ra), self._t(rb), self._t(okn),
            sigma=max(1.0 / ref.camera.fx, 1e-4))
        if not bool(res.ok):   # :478 `_initializer->initialize` failed
            self._pair_ref = frame
            lg << ",init FAIL"
            return False
        mask = res.mask.cpu().numpy()
        pts = res.points.cpu().numpy()        # ref-camera gauge
        T_c2w = res.T_c2w.cpu().numpy()       # cur -> ref

        pr1, pr2 = ref.priory_pose(), frame.priory_pose()
        if pr1 is not None and pr2 is not None:
            pose_ref, pose_cur, pts_w, n_pts = self._fit_pair_gps(
                ref, frame, pr1[0], pr2[0], T_c2w, pts, mask, idxn)
            self.cfg.set("GPS.Fitted", "1")   # :584
        else:
            # no GPS: the reference keeps only the latest pair
            # (`_map->clear()`, :611). Clear under update_lock + version
            # bump so version-checked snapshots can't straddle it.
            with self.map.update_lock:
                for fid in [f.id for f in self.map.frames()]:
                    self.map.erase_frame(fid)
                for pid in [p.id for p in self.map.points()]:
                    self.map.erase_point(pid)
                self.map.version += 1
            pose_ref = np.array([0, 0, 0, 0, 0, 0, 1.0], np.float32)
            pose_cur = T_c2w.astype(np.float32)
            sel = np.nonzero(mask)[0][:self.pt_cap]
            pts_w, n_pts = pts[sel], len(sel)
            self._pair_sel = sel
        # insert the pair + points (:589-612)
        self._insert_pair(ref, frame, pose_ref, pose_cur, pts_w, n_pts,
                          idxn)
        lg << f",pair OK,{n_pts} pts"
        self._successes.append((n_match, n_pts))
        self._pair_ref = frame
        return True

    def _fit_pair_gps(self, ref, frame, T1, T2, T_c2w, pts, mask, idxn):
        """fitGPS (:319-345) + the 2-frame GPS-prior BA (:530-580):
        scale from the GPS/estimated baseline ratio, poses snapped to
        the priors, then joint LM over both poses and the pair's points
        with SE3 priors weighted by the GPS/attitude sigmas."""
        d_gps = float(np.linalg.norm(T2[:3] - T1[:3]))
        d_est = float(np.linalg.norm(T_c2w[:3]))
        scale = d_gps / max(d_est, 1e-9)
        # ref-gauge -> geo: fold the scale into the ESTIMATED pose before
        # composing (the reference composes prior2 o inv(unscaled est)
        # and lets its BA absorb the resulting rigid offset of the mapped
        # cloud, :337-340; scaling first places the ref camera on its
        # prior exactly, a strictly better BA start)
        T_est = T_c2w.astype(np.float64).copy()
        T_est[:3] *= scale
        l2e = hse3.se3_mul(T2, hse3.se3_inv(T_est))
        sel = np.nonzero(mask)[0][:self.pt_cap]
        self._pair_sel = sel
        pts_w = hse3.se3_apply(l2e, pts[sel] * scale).astype(np.float32)
        P = self.pt_cap
        n = len(sel)
        pts_p, pmask = pad_to(pts_w, P)
        obs_f = np.concatenate([np.zeros(n, np.int32),
                                np.ones(n, np.int32)])
        obs_p = np.concatenate([np.arange(n, dtype=np.int32)] * 2)
        obs_uv = np.concatenate(
            [ref.rays[sel][:, :2],
             frame.rays[np.where(mask, idxn, 0)][sel][:, :2]])
        obs_fp, omask = pad_to(obs_f, 2 * P)
        obs_pp, _ = pad_to(obs_p, 2 * P)
        obs_uvp, _ = pad_to(obs_uv.astype(np.float32), 2 * P)
        poses_w2c = np.stack([hse3.se3_inv(T1), hse3.se3_inv(T2)]).astype(
            np.float32)
        info = np.zeros((2, 6), np.float32)
        for i, fr in enumerate((ref, frame)):
            info[i, :3] = 1.0 / max(fr.gps_acc, 0.1) ** 2
            # attitude information: the reference's default PYR sigma is
            # (1,10,10) deg when unmeasured (:100-103); one isotropic
            # 10-deg sigma keeps the prior rotation soft
            info[i, 3:] = 1.0 / np.radians(10.0) ** 2
        prob = ba.make_problem(
            poses=poses_w2c, pose_fixed=np.zeros(2, bool), points=pts_p,
            point_fixed=~pmask, obs_frame=obs_fp, obs_point=obs_pp,
            obs_uv=obs_uvp, obs_weight=omask.astype(np.float32),
            prior_frame=np.arange(2, dtype=np.int32),
            prior_pose=poses_w2c.copy(), prior_info=info,
            device=self.device)
        new_poses, new_pts, _ = ba.optimize(
            prob, iters=self.cfg.get_int("Planar.BAIters", 15))
        new_poses, new_pts = new_poses.cpu().numpy(), new_pts.cpu().numpy()
        pose_ref = hse3.se3_inv(new_poses[0]).astype(np.float32)
        pose_cur = hse3.se3_inv(new_poses[1]).astype(np.float32)
        return pose_ref, pose_cur, new_pts[:n], n

    def _insert_pair(self, ref, frame, pose_ref, pose_cur, pts_w, n_pts,
                     idxn):
        ref.pose_c2w = np.asarray(pose_ref, np.float32)
        frame.pose_c2w = np.asarray(pose_cur, np.float32)
        color_img = ref.color if ref.color is not None else ref.image
        with self.map.update_lock:
            for fr in (ref, frame):
                if self.map.frame(fr.id) is None:
                    fr.is_keyframe = True
                    self.map.insert_frame(fr)
            sel = self._pair_sel
            for j in range(n_pts):
                i = int(sel[j])
                pid = self.map.get_pid()
                kp_ref, kp_cur = i, int(idxn[i])
                color = np.full(3, 128, np.uint8)
                if color_img is not None:
                    x, y = ref.xy[kp_ref].astype(int)
                    if 0 <= y < color_img.shape[0] \
                            and 0 <= x < color_img.shape[1]:
                        c = color_img[y, x]
                        color = (np.full(3, int(c), np.uint8)
                                 if np.ndim(c) == 0 else c.astype(np.uint8))
                mp = MapPoint(id=pid, position=pts_w[j].astype(np.float32),
                              descriptor=np.asarray(frame.desc[kp_cur]),
                              color=color, ref_frame=frame.id)
                # normal towards the observing camera (:598)
                view = pose_cur[:3] - pts_w[j]
                mp.normal = (view / max(np.linalg.norm(view), 1e-9)).astype(
                    np.float32)
                self.map.insert_point(mp)
                self.map.add_observation(pid, ref.id, kp_ref)
                self.map.add_observation(pid, frame.id, kp_cur)
            ref.connections[frame.id] = n_pts
            frame.connections[ref.id] = n_pts
            self.map.version += 1


@TRACKERS.register("liu_testInit")
@TRACKERS.register("testInit")
class TrackerInitTest(Tracker):
    """`Tracker?=liu_testInit` (liuguochen/TrackTestInitializer.cpp:680):
    an initializer EVALUATION harness, not a SLAM tracker. Every frame it
    matches against the previous frame and runs the configured
    `Initializer?=` on the pair, accumulating what the reference's
    Evaluater reports at exit — successes/attempts, mean match count,
    mean inlier count (:55-78, success() at :673). Builds no map;
    `report()` returns the stats dict (the reference LOG(INFO)s it)."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.attempts = 0
        self.successes: list = []   # (n_match, n_inliers) per accepted pair

    def track(self, frame: Frame) -> bool:
        self.ensure_features(frame)
        ref = self.ref_frame
        self.ref_frame = frame
        self.last_frame = frame
        if ref is None or ref.n_kp == 0 or frame.n_kp == 0:
            return False
        self.attempts += 1
        idx, ok = self._get_matcher()(self._next_key(), ref, frame)
        idxn, okn = idx.cpu().numpy(), ok.cpu().numpy()
        n_match = int(okn.sum())
        # match4initialize acceptance gate (:436): at least 100 matches or
        # a tenth of the reference frame's keypoints
        if n_match < max(100, ref.n_kp // 10):
            return False
        ra = ref.rays[:, :2]
        rb = frame.rays[np.where(okn, idxn, 0)][:, :2]
        res = self._get_initializer()(
            self._next_key(), self._t(ra), self._t(rb), self._t(okn),
            sigma=max(1.0 / ref.camera.fx, 1e-4))
        if not bool(res.ok):
            return False
        n_inl = int(res.mask.cpu().numpy().sum())
        self.successes.append((n_match, n_inl))
        self._n_inliers = n_inl
        return True

    def report(self) -> dict:
        """Evaluater::report (:66-77): mean matches/inliers over successes."""
        n = len(self.successes)
        return {
            "success": n, "attempts": self.attempts,
            "mean_matches": int(np.mean([m for m, _ in self.successes]))
            if n else 0,
            "mean_inliers": int(np.mean([i for _, i in self.successes]))
            if n else 0,
        }


@TRACKERS.register("testLoopDetector")
class TrackerLoopTest(Tracker):
    """`Tracker?=testLoopDetector` (zhaoyong/TrackerTestLoopDetector.cpp:
    97-169): a loop-DETECTOR evaluation harness — no pose estimation, no
    triangulation. A frame becomes a keyframe when its matches to the last
    keyframe fall under 200 (and >0.5 s passed, :116); each keyframe
    queries the wired `LoopDetector?=` and match-verifies every candidate
    (>=50 matches, :150-152). Verified (ref_id, frame_id) loop pairs land
    in `self.loops_found` (the reference LOG(INFO)s "LoopFound")."""

    supports_fused = False

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self._local_kfs: list = []    # <=6 recent keyframes (:125)
        self.loops_found: list = []   # verified (ref_id, frame_id)
        self.n_keyframes = 0

    def track(self, frame: Frame) -> bool:
        self.ensure_features(frame)
        self.last_frame = frame
        if frame.n_kp < 300:          # :103
            return False
        # is_keyframe stays False — setting it would route these
        # identity-pose frames into SLAM's loop_closer.try_close, which
        # (a) re-inserts them into the same detector (double posting-list
        # entries halve the common-words gate) and (b) attempts real SE3
        # closures on an evaluation-only map
        if not self._local_kfs:
            self.map.insert_frame(frame)
            self._local_kfs.append(frame)
            self.n_keyframes += 1
            if self.loop_detector is not None:
                self.loop_detector.insert(frame)
            return True
        last = self._local_kfs[-1]
        _, ok = self._get_matcher()(self._next_key(), last, frame)
        n_match = int(ok.sum())
        if n_match < 200 and frame.timestamp - last.timestamp > 0.5:
            self.n_keyframes += 1
            # parent connections so the detector's exclusion set mirrors
            # the reference's addParent before obtainCandidates (:117-123)
            for ref in self._local_kfs:
                frame.connections[ref.id] = n_match
            if len(self._local_kfs) > 5:
                self._local_kfs.pop(0)   # :125
            self._local_kfs.append(frame)
            cands = (self.loop_detector.candidates(frame)
                     if self.loop_detector is not None else [])
            self.map.insert_frame(frame)
            if self.loop_detector is not None:
                self.loop_detector.insert(frame)
            frame.connections = {}       # clearParents (:136)
            for fid in cands:
                ref = self.map.frame(fid)
                if ref is None:
                    continue
                _, o2 = self._get_matcher()(self._next_key(), ref, frame)
                if int(o2.sum()) < 50:   # :150-152
                    continue
                self.loops_found.append((fid, frame.id))
        return True


@TRACKERS.register("loadmap")
class TrackerLoadMap(Tracker):
    """`Tracker?=loadmap` (zhaoyong/TrackerLoadMap.cpp:18-40): a map
    VIEWER tracker — the reference loads `MapFile2Load` into the map for
    the GUI handle and its track() always returns false (no tracking at
    all). SLAM itself performs the MapFile2Load load (slam.py, the
    DIYSLAM.cpp:256-258 path, through the port's `io/maphash` for a
    `.maphash` file), so this tracker only keeps the contract: never
    track, never touch the loaded map."""

    supports_fused = False

    def __init__(self, wmap: WorldMap, cfg, mapper=None, device=None):
        super().__init__(wmap, cfg, mapper, device)
        # the reference defaults the key to "map.gmap" (:33) and loads
        # eagerly; mirror that when SLAM's own MapFile2Load didn't run
        # (standalone TRACKERS.create construction)
        path = cfg.get_string("MapFile2Load", "map.gmap")
        if self.map.frame_num() == 0 and os.path.isfile(path):
            self.map.load(path)

    def track(self, frame: Frame) -> bool:
        return False   # :25-28


@TRACKERS.register("rtsfmInit")
class TrackerRTSfMInit(TrackerPlanar):
    """`Tracker?=rtsfmInit` (zhaoyong/TrackerRTSfMInit.cpp): the
    real-time-SfM initializer tracker. Two states (track :343-363):

    * initializing — pairwise initialize against the last keyframe
      (initialize :465-558: match4initialize gate, two-view init, GPS
      SIM3 snap via fitGPS :367-460 + a 2-frame GPS-prior bundle
      adjustment :579-640, `_map->clear()` without GPS :643-648) — the
      SAME machinery as TrackerPlanar (same author, shared fitGPS), so
      this subclass reuses `_pair_initialize` wholesale; success enters
      tracking.
    * tracking — trackExistMap (:1133-1173): obtain retrieval candidates
      for the current frame and pairwise RE-initialize against up to 8 of
      them until one succeeds; failure falls back to initializing
      (:361-362).

    Divergence (as the JAX package): the reference additionally
    triangulates points against the OTHER matched candidates
    (createMapPoints :1166-1170) and runs a localOptimize over the new
    connections; this build registers the single successful pair (its
    2-frame GPS-prior BA plays the localOptimize role)."""

    def track(self, frame: Frame) -> bool:
        with timer.scope("Tracker::track"), \
                glog.ScopedLogger(self.cfg, bit=1) as lg:
            self._log = lg
            state = "RTSFM" if self.status == Status.TRACKING else "INIT"
            lg << f"frame {frame.id} [{state}]"
            self.ensure_features(frame)
            if self.status != Status.TRACKING:
                if self._pair_ref is None:   # initialize :467 (seed)
                    self._pair_ref = frame
                    self.last_frame = frame
                    return False
                if frame.timestamp - self._pair_ref.timestamp < \
                        self.min_interval:   # :468 (dt >= 1 s)
                    lg << ",skip(dt)"
                    return False
                ok = self._pair_initialize(frame, lg)
                if ok:
                    self.last_frame = frame
                    self.status = Status.TRACKING   # :352-355
                return ok
            ok = self._track_exist_map(frame, lg)
            if ok:
                self.last_frame = frame
            else:
                self.status = Status.INIT           # :361-362
                self._pair_ref = frame
            return ok

    def _track_exist_map(self, frame: Frame, lg) -> bool:
        """trackExistMap (:1133-1173): candidates -> pairwise re-init."""
        cands = []
        if self.loop_detector is not None:
            cands = list(self.loop_detector.candidates(frame))
        if not cands:
            # no detector / no candidates: recent keyframes, newest first
            # (the reference returns false on no candidates :1136-1140;
            # recency stands in for MapHash's BoW index when no
            # LoopDetector is wired)
            cands = [f.id for f in self.map.keyframes()[::-1]]
        if not cands:
            lg << ",no candidates"
            return False
        for fid in cands[:8]:                       # :1143 (i < 8)
            ref = self.map.frame(int(fid))
            if ref is None or ref.n_kp == 0 or ref.desc is None:
                continue
            self._pair_ref = ref                    # :1150 (_lastKF = ref)
            if self._pair_initialize(frame, lg):    # :1151 initialize()
                return True
        return False


@RELOCALIZERS.register("demo")
@RELOCALIZERS.register("default")
class RelocalizerDemo:
    """Default named relocalization strategy: the tracker's own LOST
    sweep (loop-detector candidates -> recent keyframes -> strided map
    sample, batched match prefilter + PnP — Tracker._track_ref_kf,
    mirroring TrackerOpt::relocalize, TrackerOpt.cpp:1307-1350). Exists
    so the reference's Relocalizer registry seam (Relocalizer.h:16-28)
    resolves by name."""

    def __init__(self, cfg=None):
        self.cfg = cfg

    def relocalize(self, tracker: "Tracker", frame: Frame) -> bool:
        return tracker._track_ref_kf(frame)
