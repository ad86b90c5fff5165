"""SLAM -> mosaic fusion consumer: the half that makes SLAM and the mosaic
ONE system.

Port of pislamfusion_tpu/models/fusion.py (Map2DFusion/Map2DFusion.cpp
TestSystem):
  * `Map2DWithSLAM` (:250-338): consume `PrepareFrameNum` tracked
    (image, pose) pairs from the `trans` queue, block on `trans_plane` for
    the mapper's dominant ground plane, `Map2D::create(Map2D.Type)` +
    `prepare(plane, PinHole(Camera.Paraments), frames)`, then the feed loop.
  * `TestMap2D` (:153-248): trajectory.txt playback — known-pose keyframes
    (the mosaic-only mode of DatasetNPUDroneMap / DroneMapKFDataset).
  * result saving on exit (:48-56, `Map.File2Save`).
  * `TrajectoryLengthCalculator` (:14-35).

`FusionSystem.start()` runs the consumer in a daemon thread on the two
`DataTrans` queues of the port's `core/messenger`, so SLAM (the producer,
in the caller's thread) and the mosaic overlap as in the reference's
thread split; `finish()` drains what is left. The engine is
`create_map2d(Map2D.Type, cfg, device)` on the system's device (None
means `cuda`, and raises without one): the consumer launches K3 and K8
and the composites there while SLAM's thread launches K1, K4 and K2.
Both threads issue on the default stream, so their work is ordered on
the card; everything that crosses the queue is host numpy (no tensor
changes threads). `_build.load` builds a kernel once under a lock when
both threads first use it. K7 (ORB's packed pyramid) keeps one counter
buffer a shape and device, so no two threads may run it at once; nothing
here does (the consumer never extracts features).

The pose-refresh chain (`_gauged`, `_note_fed`, `_drain_latest_plane`,
`_maybe_refresh`, `_rebase_canvas`) follows the JAX package except where
its branches are faulty; the port holds the behaviour those branches
should have:
  (a) `_rebase_canvas` swaps in the re-derived canvas only when at least
      one re-feed landed; with none, the old canvas stays and the gauge
      fall-through works on it (the JAX package swaps in the empty new
      canvas, reference fusion.py:533);
  (b) the fallback for fewer than 3 resolved poses brings the resolved
      new map poses into the canvas frame through the feed gauge before
      it refreshes and caches them (the JAX package feeds raw map poses,
      :442-446);
  (c) after a rebase the cache holds only the entries the new canvas was
      fed (the JAX package keeps every entry, dropped and refused ones
      too, :420-428);
  (d) every queued frame carries the count of map-transform publishes
      when SLAM queued it (`Messenger.published`), and is gauged with the
      gauge of the map epoch it was tracked in, carried through later
      rebases; the JAX package gauges frames queued before a refit with
      the post-refit gauge (:566-572). A frame without the stamp (an
      (img, pose) pair or a 3-item meta) takes the current gauge, as in
      the JAX package.
"""
from __future__ import annotations

import os
import queue
import sys
import threading
import weakref
from typing import List, Optional, Tuple

import numpy as np

from ..core.camera import Camera
from ..core.device import resolve_device
from ..core.messenger import messenger as _messenger
from ..core.messenger import trans, trans_plane
from ..core.svar import Svar
from ..core.timer import timer
from ..utils import host_se3 as hse3
from .map2d import create_map2d

# the topics whose publishes move the map under the canvas; SLAM stamps
# each queued frame with their count (models/slam.py)
TRANSFORM_TOPICS = ("map_transformed", "fitted_map")


def _sim3_mul(a, b):
    """SIM3 composition a o b, both (t, q, s)."""
    return np.concatenate([hse3.sim3_apply_se3(a, np.asarray(b)[:7]),
                           [float(a[7]) * float(b[7])]])


class TrajectoryLength:
    """TrajectoryLengthCalculator (Map2DFusion.cpp:14-35): cumulative path
    length of fed poses, printed at exit."""

    def __init__(self):
        self._last: Optional[np.ndarray] = None
        self.length = 0.0

    def feed(self, t: np.ndarray):
        t = np.asarray(t, np.float64)
        if self._last is not None:
            self.length += float(np.linalg.norm(t - self._last))
        self._last = t


class FusionSystem:
    """TestSystem equivalent. start() spawns the consumer thread; finish()
    drains the queues and returns; save() writes result.png. device: where
    the mosaic engine runs (None means `cuda`)."""

    def __init__(self, cfg: Optional[Svar] = None, camera: Camera = None,
                 trans_q=None, plane_q=None, device=None):
        from ..core.svar import svar as default_svar
        self.cfg = cfg if cfg is not None else default_svar
        self.device = resolve_device(device)
        self.camera = camera
        self.map2d = None
        self.length_calc = TrajectoryLength()
        self._trans = trans_q if trans_q is not None else trans
        self._plane_q = plane_q if plane_q is not None else trans_plane
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self._finishing = threading.Event()
        self._prepared = threading.Event()
        self.frames_fed = 0
        # items the trans queue had dropped (it drops its oldest when
        # full) when the canvas was prepared: frames lost while the
        # consumer waited for the mapper's plane
        self.dropped_before_prepare = 0
        self.error: Optional[str] = None
        # pose-refresh state: bounded cache of fed frames
        # ((fid, kf_id, rel), img, canvas_pose) + the latest map snapshot
        # published on 'map_transformed' / 'fitted_map' (loop closure,
        # GPS refit), with the publish count it came with. _feed_gauge
        # maps the current map epoch's poses into the canvas frame after
        # sub-rebase gauge-removal refreshes (see _gauged); _epoch_gauges
        # keeps [(publish count, gauge)] for every processed epoch, each
        # gauge mapping that epoch's poses into the CURRENT canvas frame.
        self._refresh_cache = []      # feed order
        self._refresh_bytes = 0
        self._feed_gauge = None       # SIM3 [t, q, s] map-world -> canvas
        self._epoch_gauges: List[Tuple[int, Optional[np.ndarray]]] = [
            (-1, None)]
        self._latest_plane = None     # newest mapper plane (current epoch)
        self._refresh_cap = int(self.cfg.get_double(
            "Fusion.RefreshCacheMB", 256.0) * 1e6)
        self._pending = None          # (WorldMap, publish count) or None
        self._pending_lock = threading.Lock()
        self.frames_refreshed = 0
        if self._refresh_cap > 0:
            # the messenger keeps its subscribers for the process's life:
            # hold this system weakly, so that a finished one (and its
            # canvas on the device) can be freed
            ref = weakref.ref(self)

            def _on_transform(wmap):
                # called in the publisher's thread, after the count rose
                fus = ref()
                if fus is not None:
                    with fus._pending_lock:
                        fus._pending = (wmap, _messenger.published(
                            *TRANSFORM_TOPICS))
            _messenger.subscribe("map_transformed", _on_transform)
            _messenger.subscribe("fitted_map", _on_transform)

    # ------------------------------------------------------------------ API
    def start(self):
        self._thread = threading.Thread(target=self.run, daemon=True)
        self._thread.start()
        return self

    def run(self):
        act = self.cfg.get_string("Map2D.Act", "Map2DWithSLAM")
        try:
            if act in ("Map2DWithSLAM", "Default"):
                self.map2d_with_slam()
            elif act == "TestMap2D":
                self.test_map2d()
            else:
                self.error = f"No act {act}"
        except Exception:  # surfaced via .error; thread must not die mute
            import traceback
            self.error = traceback.format_exc()
            raise

    def finish(self, timeout: float = 600.0):
        """Signal end-of-stream, wait for the consumer to drain and exit."""
        self._finishing.set()
        if self._thread is not None:
            self._thread.join(timeout=timeout)
        return self.error is None

    def alive(self) -> bool:
        """Whether the consumer thread is still running."""
        return self._thread is not None and self._thread.is_alive()

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=30)

    def save(self, filename: Optional[str] = None) -> bool:
        """result.png on exit (Map2DFusion.cpp:48-56)."""
        if filename is None:
            filename = self.cfg.get_string("Map.File2Save", "result.png")
        if self.map2d is None:
            return False
        return self.map2d.save(filename)

    # ------------------------------------------------------------ internals
    def _obtain_frame(self):
        """Blocking dequeue with stop/finish checks (obtainFrame :139-151).
        Accepts (img, pose) pairs or (img, pose, meta) triples — the meta
        (fid, kf_id, kf_pose[, publish count]) links the fed frame back to
        the WorldMap for pose refresh."""
        while not self._stop.is_set():
            try:
                item = self._trans.consumption(timeout=0.2)
            except queue.Empty:
                if self._finishing.is_set():
                    return None
                continue
            img, pose = item[0], item[1]
            fid = item[2] if len(item) > 2 else None
            self.length_calc.feed(np.asarray(pose)[:3])
            return img, pose, fid
        return None

    def _obtain_plane(self) -> Optional[np.ndarray]:
        # config-supplied plane wins (dataset config.cfg `Plane=`), else
        # block on the mapper's RANSAC estimate (Trans_Plane.consumption)
        p = self.cfg.get_vec("Plane")
        if len(p) == 7:
            return np.asarray(p, np.float64)
        while not self._stop.is_set():
            try:
                got = self._plane_q.consumption(timeout=0.2)
            except queue.Empty:
                if self._finishing.is_set() and self._plane_q.qsize() == 0:
                    return None
                continue
            # drain to the NEWEST publish: the mapper re-publishes the
            # plane whenever a refit transforms the map, and preparing
            # with a stale-epoch plane against current-epoch poses bends
            # the whole canvas geometry (round-5 GPS calibration)
            newer = self._plane_q.try_consume()
            while newer is not None:
                got = newer
                newer = self._plane_q.try_consume()
            return np.asarray(got, np.float64)
        return None

    def _camera(self) -> Optional[Camera]:
        if self.camera is not None:
            return self.camera
        p = self.cfg.get_vec("Camera.Paraments")
        if len(p) >= 6:
            return Camera.from_parameters(p[:6])
        return None

    def _new_map2d(self):
        return create_map2d(self.cfg.get_string("Map2D.Type", "3"),
                            self.cfg, device=self.device)

    def _prepare_and_feed(self, frames, plane: np.ndarray) -> bool:
        cam = self._camera()
        if cam is None:
            self.error = "Invalid camera parameters!"
            return False
        self.map2d = self._new_map2d()
        if os.environ.get("PISLAM_FUSION_DEBUG", "") == "1":
            from .map2d import _se3_inv_mul_np
            zs = [_se3_inv_mul_np(np.asarray(plane, np.float64),
                                  np.asarray(fr[1], np.float64))[2]
                  for fr in frames]
            print(f"fusion.prepare: plane={np.round(plane, 2)} "
                  f"frame plane-z={np.round(zs, 2)}",
                  file=sys.stderr, flush=True)
        if not self.map2d.prepare(plane, cam,
                                  [(fr[0], fr[1]) for fr in frames]):
            self.error = "Map2D.prepare failed"
            return False
        self.dropped_before_prepare = getattr(self._trans, "dropped", 0)
        self._prepared.set()
        for fr in frames:
            self._feed(fr)
        return True

    def _feed(self, fr):
        """Composite one dequeued frame under the gauge of its epoch and
        cache it for refresh."""
        gauge = self._gauge_for(fr)
        pose = self._gauged(fr[1], gauge)
        with timer.scope("Fusion::feed"):
            self.map2d.feed(fr[0], pose)
        self._note_fed(fr, canvas_pose=pose, gauge=gauge)
        self.frames_fed += 1

    # -------------------------------------------------- pose refresh
    @staticmethod
    def _stamp(fr) -> Optional[int]:
        """The publish count a queued frame was stamped with, or None."""
        meta = fr[2] if len(fr) > 2 else None
        if meta is None or len(meta) < 4 or meta[3] is None:
            return None
        return int(meta[3])

    def _gauge_for(self, fr):
        """The gauge of the map epoch the frame was tracked in: that of
        the newest processed epoch at or before its stamp (ADVICE r5 fix
        (d)); the current gauge for a frame without a stamp."""
        stamp = self._stamp(fr)
        if stamp is None:
            return self._feed_gauge
        gauge = self._epoch_gauges[0][1]
        for epoch, g in self._epoch_gauges:
            if epoch > stamp:
                break
            gauge = g
        return gauge

    @staticmethod
    def _gauged(pose, gauge):
        """Map a SLAM-world pose into the CANVAS world frame.

        After a sub-rebase gauge-removal refresh the canvas keeps its old
        world frame while SLAM publishes poses in the refit one; feeding
        raw poses then misregisters every future frame by the gauge, and
        the error COMPOUNDS across refit events (round-5 GPS calibration:
        the mosaic shattered into scattered footprints, some at the wrong
        scale). `gauge`, the one fitted at the refresh of the pose's
        epoch, brings it back into the canvas frame."""
        if gauge is None:
            return np.asarray(pose, np.float64)
        return hse3.sim3_apply_se3(gauge, np.asarray(pose, np.float64))

    def _note_fed(self, fr, canvas_pose, gauge):
        """Cache a fed frame for later pose refresh (bounded by bytes).

        Cache rows hold ((fid, kf_id, rel), img, canvas_pose): `rel` is
        the frame's pose RELATIVE to its reference keyframe at feed time
        (gauge-invariant up to the refit's scale on the small offset), so
        a refresh can reconstruct the frame's CURRENT map pose as
        kf.pose_now o rel no matter how many gauge epochs have passed;
        `canvas_pose` is the pose actually composited (`gauge`, the gauge
        it was fed under, applied)."""
        if self._refresh_cap <= 0 or len(fr) < 3 or fr[2] is None:
            return
        img = fr[0]
        nbytes = getattr(img, "nbytes", 0)
        fid, kf_id, kf_pose_feed = fr[2][:3]
        raw = np.asarray(fr[1], np.float64)
        rel = hse3.se3_mul(hse3.se3_inv(np.asarray(kf_pose_feed,
                                                   np.float64)), raw)
        # keep rel's translation in CANVAS units: map units change scale
        # at every SIM3 refit (the mono->metric snap can be 10-30x), and
        # a feed-time-unit rel reconstructed against a later keyframe
        # pose collapses frames onto their keyframes (the round-5
        # calibration's clustered shatter). Canvas units are stable for
        # the cache's lifetime; _maybe_refresh divides by the fitted
        # map->canvas scale of the moment.
        s_feed = float(gauge[7]) if gauge is not None else 1.0
        rel = rel.copy()
        rel[:3] *= s_feed
        self._refresh_cache.append(((fid, kf_id, rel), img,
                                    np.asarray(canvas_pose, np.float64)))
        self._refresh_bytes += nbytes
        while self._refresh_bytes > self._refresh_cap \
                and len(self._refresh_cache) > 1:
            old = self._refresh_cache.pop(0)
            self._refresh_bytes -= getattr(old[1], "nbytes", 0)

    def _drain_latest_plane(self):
        """Poll the plane queue for the newest mapper plane: the mapper
        republishes it after every applied SIM3, so at event-processing
        time this is the plane of the CURRENT map epoch (the rebase path
        prefers it over propagating the canvas's possibly-poisoned
        snapshot through the fitted gauge)."""
        newer = self._plane_q.try_consume()
        while newer is not None:
            self._latest_plane = np.asarray(newer, np.float64)
            newer = self._plane_q.try_consume()

    def _take_pending(self):
        """The pending (WorldMap, publish count), cleared; None if none."""
        with self._pending_lock:
            p, self._pending = self._pending, None
        return p

    def _set_gauge(self, epoch: int, S):
        """Sub-rebase: epoch `epoch`'s poses map into the canvas by S."""
        self._feed_gauge = S
        self._epoch_gauges = [e for e in self._epoch_gauges
                              if e[0] < epoch] + [(epoch, S)]

    def _rebased(self, epoch: int, S):
        """Rebase: the canvas is now epoch `epoch`'s map frame; S maps
        that frame onto the old canvas, so every older epoch's gauge gains
        S^-1 (old canvas -> new canvas)."""
        S_inv = hse3.sim3_inv(S)
        self._feed_gauge = None
        self._epoch_gauges = [
            (e, S_inv if g is None else _sim3_mul(S_inv, g))
            for e, g in self._epoch_gauges if e < epoch] + [(epoch, None)]

    def _maybe_refresh(self):
        """When the map moved (loop closure / GPS refit), re-render the
        canvas regions whose cached frames' poses changed; update the
        cache to the new poses."""
        if self._pending is None:
            return
        if self.map2d is None:
            return                    # keep the event pending until
                                      # prepare() has built a canvas
        pending = self._take_pending()
        if pending is None:
            return
        wmap, epoch = pending
        if not self._refresh_cache:
            return
        self._drain_latest_plane()
        # pass 1 — keyframe entries only: their current map pose is exact
        # (no relative reconstruction), so they anchor the map->canvas
        # scale estimate the non-keyframe entries' rel translations (held
        # in canvas units, see _note_fed) must be divided by.
        kf_rows = []
        for meta, img, canvas_pose in self._refresh_cache:
            f = wmap.frame(meta[0])
            if f is not None:
                kf_rows.append((np.asarray(f.pose_c2w, np.float64),
                                canvas_pose))
        if len(kf_rows) >= 3:
            S_kf = hse3.sim3_fit_pose_gauge(
                np.stack([r[0] for r in kf_rows]),
                np.stack([r[1] for r in kf_rows]))
            s_now = float(S_kf[7])
        elif self._feed_gauge is not None:
            s_now = float(self._feed_gauge[7])
        else:
            s_now = 1.0
        entries, metas, resolved = [], [], []
        for meta, img, canvas_pose in self._refresh_cache:
            fid, kf_id, rel = meta
            f = wmap.frame(fid)
            kf = wmap.frame(kf_id)
            if f is not None:           # keyframes: their own new pose
                new_map = np.asarray(f.pose_c2w, np.float64)
            elif kf is not None:
                # ordinary frames ride their reference keyframe: the
                # feed-time RELATIVE pose (rotation exactly, translation
                # converted to the map units of the moment) reconstructs
                # the frame's current map pose across any number of
                # refit epochs
                rel_m = rel.copy()
                rel_m[:3] /= max(s_now, 1e-12)
                new_map = hse3.se3_mul(np.asarray(kf.pose_c2w,
                                                  np.float64), rel_m)
            else:
                # reference keyframe CULLED since feed: the frame's
                # current map pose is unknowable, but its canvas
                # contribution is still valid — it rides the global
                # gauge (filled in once S is fitted below)
                new_map = None
            entries.append((img, canvas_pose, new_map))
            metas.append(meta)
            resolved.append(new_map is not None)
        if not any(resolved):
            return
        n_res = sum(resolved)
        if n_res >= 3:
            # Fit the CANVAS GAUGE: the SIM3 mapping current map-world
            # poses onto the canvas-frame poses the cache was composited
            # at (RESOLVED entries only). A global GPS refit moves map AND
            # plane together, so the plane-relative mosaic is unchanged —
            # only the RESIDUAL deformation (loop bends, local BA) after
            # removing this gauge triggers re-rendering. The pose-aware
            # Wahba fit is exact for rigid/SIM3 moves on ANY trajectory
            # shape.
            old_p = np.stack([e[1] for e, r in zip(entries, resolved)
                              if r]).astype(np.float64)
            new_p = np.stack([e[2] for e, r in zip(entries, resolved)
                              if r]).astype(np.float64)
            S = hse3.sim3_fit_pose_gauge(new_p, old_p)
            # culled-keyframe entries ride the global gauge: their map
            # pose is DEFINED as the one that keeps their canvas
            # placement, new = S^-1 o canvas
            S_inv = hse3.sim3_inv(S)
            entries = [
                (img, cp, nm if nm is not None
                 else hse3.sim3_apply_se3(S_inv, cp))
                for (img, cp, nm) in entries]
            # Rebase when the canvas frame has drifted too far from the
            # map frame: (a) median in-plane displacement at the
            # trajectory past Fusion.RebaseThresh (default 1/8 patch), or
            # (b) a SCALE mismatch past Fusion.RebaseScale. Rebasing
            # re-derives plane/min_xy/resolution in the CURRENT map frame
            # and resets the feed gauge to identity.
            plane = np.asarray(self.map2d.plane, np.float64)
            plane_inv = hse3.se3_inv(plane)

            def _plane_xy(c):
                return hse3.se3_apply(plane_inv, c)[:2]
            disp = np.median([np.linalg.norm(
                _plane_xy(hse3.sim3_apply_se3(S, p)[:3])
                - _plane_xy(p[:3])) for p in new_p])
            from ..ops.mosaic import ELE_PIXELS
            patch_m = getattr(self.map2d, "patch_tiles", 8) * ELE_PIXELS \
                * self.map2d.length_pixel
            rebase_at = self.cfg.get_double("Fusion.RebaseThresh", 0.0) \
                or 0.125 * patch_m
            scale_at = self.cfg.get_double("Fusion.RebaseScale", 1.15)
            if os.environ.get("PISLAM_FUSION_DEBUG", "") == "1":
                print(f"fusion.refresh: {len(entries)} entries "
                      f"({len(kf_rows)} kf), s_now={s_now:.4f} "
                      f"S=(t={np.round(S[:3], 2)}, s={S[7]:.4f}) "
                      f"disp={disp:.3f} rebase_at={rebase_at:.3f}",
                      file=sys.stderr, flush=True)
            if disp > rebase_at or not (1.0 / scale_at <= float(S[7])
                                        <= scale_at):
                fed = self._rebase_canvas(S, entries)
                if os.environ.get("PISLAM_FUSION_DEBUG", "") == "1":
                    print(f"fusion.refresh: REBASE re-fed {len(fed)}",
                          file=sys.stderr, flush=True)
                if fed:
                    self.frames_refreshed += len(fed)
                    self._rebased(epoch, S)     # canvas == map frame now
                    # the new canvas frame == current map frame: rel
                    # translations re-baseline to the new canvas units.
                    # Only the entries the new canvas holds stay cached
                    # (fix (c))
                    sc = 1.0 / max(s_now, 1e-12)
                    self._refresh_cache = []
                    for i in fed:
                        m, (img, _o, new_map) = metas[i], entries[i]
                        rel2 = m[2].copy()
                        rel2[:3] *= sc
                        self._refresh_cache.append(
                            ((m[0], m[1], rel2), img, new_map))
                    self._refresh_bytes = sum(
                        getattr(e[1], "nbytes", 0)
                        for e in self._refresh_cache)
                    return
                # rebase could not re-derive (prepare/feed refused): the
                # old canvas is intact (fix (a)), so fall through to gauge
                # mode on it
            # Sub-rebase: the canvas stays in its frame; remember the
            # gauge so every later feed of this epoch is brought into it
            self._set_gauge(epoch, S)
            entries = [(img, old_pose, hse3.sim3_apply_se3(S, new_map))
                       for img, old_pose, new_map in entries]
        else:
            # too few resolved poses for a gauge fit: refresh only the
            # resolved entries, brought into the canvas frame by the feed
            # gauge (fix (b)); leave the rest (and the gauge) untouched
            entries = [(img, cp, self._gauged(nm, self._feed_gauge)
                        if nm is not None else cp)
                       for img, cp, nm in entries]
        with timer.scope("Fusion::refresh"):
            n = self.map2d.refresh(entries)
        if n:
            self.frames_refreshed += n
            self._refresh_cache = [
                (m, img, pose) for m, (img, _o, pose)
                in zip(metas, entries)]

    def _rebase_canvas(self, S, entries) -> List[int]:
        """Plane-frame move: a GPS SIM3 refit / large closure moved the
        world under the canvas, so the prepare-time geometry (plane
        snapshot, min_xy, resolution) no longer matches the poses SLAM
        will feed next. Re-derive everything in the NEW world frame:
        transform the plane by the inverse gauge, re-prepare a fresh
        Map2D, and re-feed the whole cache at its current map-frame
        poses. Frames already evicted from the cache lose their
        contribution (size Fusion.RefreshCacheMB to the survey).

        S maps new-world -> old-world, so plane_new = S^-1 o plane_old
        keeps plane-relative geometry continuous for gauge-only moves.

        Returns the indices of `entries` the new canvas was fed, in feed
        order; the new canvas replaces the old one only when there is at
        least one (fix (a))."""
        cam = self._camera()
        if cam is None or self.map2d is None:
            return []
        if self._latest_plane is not None:
            # the mapper's live plane IS the current map epoch's ground
            plane_new = np.asarray(self._latest_plane, np.float64)
        else:
            plane_new = hse3.sim3_apply_se3(hse3.sim3_inv(S),
                                            np.asarray(self.map2d.plane,
                                                       np.float64))
        new_map = self._new_map2d()
        dbg = os.environ.get("PISLAM_FUSION_DEBUG", "") == "1"
        # one garbage cached pose (a tracking transient fed mid-refit)
        # must not poison the rebase forever: prepare() refuses frame
        # sets that straddle the plane, so keep only the majority side
        # at a sane height band
        from .map2d import _se3_inv_mul_np
        zs = np.asarray([_se3_inv_mul_np(plane_new,
                                         np.asarray(pose, np.float64))[2]
                         for _img, _o, pose in entries])
        z_med = float(np.median(zs))
        if dbg:
            z_old = np.asarray([_se3_inv_mul_np(
                np.asarray(self.map2d.plane, np.float64),
                np.asarray(cp, np.float64))[2]
                for _img, cp, _n in entries])
            print(f"fusion.rebase: z_old(canvas) med "
                  f"{float(np.median(z_old)):.2f} -> z_new med "
                  f"{z_med:.2f}", file=sys.stderr, flush=True)
        good = (np.sign(zs) == np.sign(z_med)) \
            & (np.abs(zs) < 10.0 * max(abs(z_med), 1e-9)) \
            & (np.abs(zs) > 0.02 * abs(z_med))
        kept = [i for i, g in enumerate(good) if g]
        if dbg and len(kept) < len(entries):
            print(f"fusion.rebase: dropped {len(entries) - len(kept)} "
                  f"off-plane/outlier entries (z med {z_med:.2f})",
                  file=sys.stderr, flush=True)
        if not kept:
            return []
        if not new_map.prepare(plane_new, cam,
                               [(entries[i][0], entries[i][2])
                                for i in kept]):
            if dbg:
                print(f"fusion.rebase: prepare REFUSED "
                      f"(plane_new={np.round(plane_new, 2)})",
                      file=sys.stderr, flush=True)
            return []
        fed = []
        for i in kept:
            img, _old, pose = entries[i]
            with timer.scope("Fusion::rebase_feed"):
                if new_map.feed(img, pose):
                    fed.append(i)
        if dbg and len(fed) < len(kept):
            print(f"fusion.rebase: {len(kept) - len(fed)}/{len(kept)} "
                  "re-feeds refused", file=sys.stderr, flush=True)
        if fed:
            self.map2d = new_map      # atomic swap; feed loop is us
        return fed

    def map2d_with_slam(self):
        """Map2DFusion.cpp:250-338."""
        cfg_path = self.cfg.get_string("Map2D.ConfigPath", "")
        if cfg_path:
            self.cfg.parse_file(cfg_path)
        frames = []
        for _ in range(self.cfg.get_int("PrepareFrameNum", 10)):
            fr = self._obtain_frame()
            if fr is None:
                break
            frames.append(fr)
        if not frames:
            self.error = "no frames arrived before finish"
            return
        plane = self._obtain_plane()
        if plane is None:
            self.error = "no ground plane arrived before finish"
            return
        if not self._prepare_and_feed(frames, plane):
            return
        # a refit that landed while the prepare frames were collecting is
        # still pending (events are never discarded before a canvas
        # exists): re-gauge before composing anything else
        self._maybe_refresh()
        # feed loop: synchronous Map2D -> no queue throttle needed
        while not self._stop.is_set():
            fr = self._obtain_frame()
            if fr is None:
                break
            # process pending refit events BEFORE composing: the gauge
            # they fit serves every frame tracked after them. The frame in
            # hand may have been queued before the refit (up to the
            # queue's 30 frames); _feed gauges it by its own stamp
            self._maybe_refresh()
            self._feed(fr)
        # a transform that landed after the last frame (end-of-run GPS
        # refit / closure) still re-renders before save()
        if self.map2d is not None:
            self._maybe_refresh()

    def test_map2d(self):
        """Trajectory-playback mode (Map2DFusion.cpp:153-248): DataPath holds
        config.cfg + trajectory.txt + rgb/ images — known-pose keyframes."""
        datapath = self.cfg.get_string("Map2D.DataPath", "")
        if not datapath:
            self.error = "Map2D.DataPath is not set"
            return
        from ..io.dataset import imread
        self.cfg.parse_file(os.path.join(datapath, "config.cfg"))
        traj = os.path.join(datapath, "trajectory.txt")
        if not os.path.isfile(traj):
            self.error = f"can't open {traj}"
            return
        entries = []
        with open(traj) as f:
            for line in f:
                parts = line.split()
                if len(parts) < 8:
                    continue
                name = parts[0]
                pose = np.asarray([float(v) for v in parts[1:8]], np.float64)
                entries.append((os.path.join(datapath, "rgb", name + ".jpg"),
                                pose))
        if not entries:
            self.error = "empty trajectory"
            return
        plane = self._obtain_plane()
        if plane is None:
            p = self.cfg.get_vec("Plane")
            if len(p) != 7:
                self.error = "Plane is not defined"
                return
            plane = np.asarray(p, np.float64)
        n_prep = min(self.cfg.get_int("PrepareFrameNum", 10), len(entries))
        frames = [(imread(p), pose) for p, pose in entries[:n_prep]]
        for _, pose in frames:
            self.length_calc.feed(pose[:3])
        if not self._prepare_and_feed(frames, plane):
            return
        for path, pose in entries[n_prep:]:
            if self._stop.is_set():
                break
            self.length_calc.feed(pose[:3])
            with timer.scope("Fusion::feed"):
                self.map2d.feed(imread(path), pose)
            self.frames_fed += 1
