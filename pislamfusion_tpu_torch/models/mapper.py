"""Keyframe mapper: triangulation, fusion, culling, local bundle adjustment,
ground-plane estimation for the mosaic.

Port of pislamfusion_tpu/models/mapper.py, the reference's default mapper
`demo` (GSLAM-DIYSLAM/src/zhaoyong/MapperDemo.cpp): handleCurrentFrame
pipeline (:311) — mapPointCulling (:464-490), makeKeyFrame/connections
(:366-432), createNewMapPoints (BoW variant :492-650 — including the
`ransac.solve(p3d)` plane feed for Map2DFusion at :617-620),
dataAssociation/fuse (:809-1011), localOptimization with GPS edges and
bad-edge pruning (:1286-1555), and updateNormAndDes (:1883-1910).

The mosaic glue matches src/RANSAC.cpp:103-116: buffer triangulated points
until 2000, fit the dominant plane once, publish it to the `trans_plane`
queue.

The numeric work (the neighbor triangulation sweep, the fuse match, local
BA, the GPS fits, the plane RANSAC) runs on the mapper's device (`device`,
None meaning `cuda`); the keyframe's results come back in ONE copy.
The plane RANSAC draws its samples from a CPU `torch.Generator` seeded
`SLAM.Seed + 1`, as the reference's key is.

Offline (`SLAM.isOnline=0`, the default) keyframes are handled in the
tracker's thread. Online (`SLAM.isOnline=1` without `SLAM.forceOffline`)
they go to a 1-worker pool (MapperDemo.cpp:77-106), whose thread alone
then draws on the mapper's generator; a keyframe skips its local BA when
a newer one is already queued (the reference's _abordBundle), and
`finish(timeout)` drains the pool. `MapperZhangMi` (`Mapper?=zhangmi`)
rations new points to one a grid cell.
"""
from __future__ import annotations

import threading
from typing import List, Optional

import numpy as np
import torch

from ..core import glog
from ..core.camera import Camera
from ..core.device import resolve_device
from ..core.messenger import messenger as _messenger
from ..core.messenger import trans_plane as _default_trans_plane
from ..core.registry import MAPPERS
from ..core.timer import timer
from ..ops import ba, lie, matching, ransac
from ..utils import host_se3 as hse3
from ..utils.padding import pad_to
from .frame import Frame, MapPoint
from .worldmap import WorldMap

# default BA capacities (saturation is LOGGED, not silent; override with
# SLAM.BAFrameCap / BAPointCap / BAObsCap). BA_F=40 matches the
# reference's ~40-KF local windows (SLAM.MaxLocalKFNum, TrackerOpt.cpp:1121)
# — the padded Schur system stays small (240x240 reduced camera block).
BA_F, BA_P, BA_O = 40, 4096, 16384
PLANE_MIN_POINTS = 2000   # src/RANSAC.cpp:103
# _fuse neighbor-point matching capacity: ONE shape (see _fuse)
FUSE_POINT_CAP = 4096
# createNewMapPoints neighbor sweep width (top-K connected keyframes,
# MapperDemo.cpp:500)
NEW_POINT_NEIGHBORS = 4

# keyframes whose tracker-staged feature buffers stay on the device so
# the triangulation sweep can read neighbors without re-uploading them
# (~0.3 MB each; see Mapper._cache_dev_kf)
DEV_KF_CACHE = 12


def _associate_triangulate_batch(desc_a, free_a, rays_a, Ta,
                                 desc_k, free_k, rays_k, Tb_k,
                                 sigma, kind: str):
    """The whole createNewMapPoints neighbor sweep (MapperDemo.cpp:492-650):
    for each (padded) top-K connected keyframe — ratio-matched free
    keypoints, epipolar gate from the known relative pose, DLT
    triangulation, depth/parallax/reprojection acceptance — enqueued
    without a host synchronisation.

    desc_a/free_a/rays_a/Ta: the new keyframe's descriptors [N,D], free
    mask [N], unit-plane rays [N,3], pose c2w [7]. desc_k/free_k/rays_k/
    Tb_k: the same, stacked [K,...] (absent neighbors: free_k all False).
    sigma: 1/fx. Returns (idx [K,N], good [K,N], X [K,N,3] world points,
    err [K,N] summed two-view reprojection error)."""
    max_dist = 80.0 if kind == "orb" else 0.2
    th = 2.0 * sigma * np.sqrt(5.991)
    Ta_inv = lie.se3_inv(Ta)
    n = rays_a.shape[0]

    def one(desc_b, free_b, rays_b, Tb):
        dist = matching.distance_matrix(desc_a, desc_b, kind)
        idx, ok = matching.match(dist, free_a, free_b, max_dist, ratio=0.8)
        rb = rays_b[torch.where(ok, idx, 0).long()]
        # EPIPOLAR GATE: on repetitive texture the unconstrained match
        # pairs different instances of the same motif; such pairs
        # triangulate to self-consistent GHOST layers. The known relative
        # pose kills them (the reference's matchers search along epipolar
        # lines instead of globally).
        T_ba = lie.se3_mul(lie.se3_inv(Tb), Ta)
        E = lie.so3_hat(T_ba[:3]) @ lie.quat_to_matrix(T_ba[3:7])
        lines = rays_a @ E.T                  # epipolar lines in view b
        epi = torch.abs(torch.sum(rb * lines, -1)) / torch.clamp(
            torch.hypot(lines[:, 0], lines[:, 1]), min=1e-12)
        ok = ok & (epi < th)
        X, da = ransac.triangulate(Ta, Tb, rays_a, rb)
        pb = lie.se3_apply(lie.se3_inv(Tb).expand(n, 7), X)
        db = pb[:, 2]
        # parallax angle between the two viewing rays (:545-560)
        va = X - Ta[None, :3]
        vb = X - Tb[None, :3]
        cosp = torch.sum(va * vb, -1) / torch.clamp(
            torch.linalg.vector_norm(va, dim=-1)
            * torch.linalg.vector_norm(vb, dim=-1), min=1e-12)
        # reprojection checks in both views (:577-616)
        pa = lie.se3_apply(Ta_inv.expand(n, 7), X)
        ea = torch.linalg.vector_norm(
            pa[:, :2] / torch.clamp(pa[:, 2:], min=1e-9) - rays_a[:, :2],
            dim=1)
        eb = torch.linalg.vector_norm(
            pb[:, :2] / torch.clamp(pb[:, 2:], min=1e-9) - rb[:, :2], dim=1)
        good = (ok & (da > 0) & (db > 0) & (cosp > 0) & (cosp < 0.9998)
                & (ea < th) & (eb < th) & torch.isfinite(X).all(1))
        return idx, good, X, ea + eb

    outs = [one(*args) for args in zip(desc_k, free_k, rays_k, Tb_k)]
    return tuple(torch.stack(o) for o in zip(*outs))


def _pack_tri(idx, good, X, err):
    """The sweep's four outputs as ONE [K, N, 6] f32 tensor (idx, good,
    X[3], err), so the keyframe path copies one buffer."""
    return torch.cat([idx.to(torch.float32)[..., None],
                      good.to(torch.float32)[..., None],
                      X.to(torch.float32),
                      err.to(torch.float32)[..., None]], -1)


def _tri_batch_packed(desc_a, free_a, rays_a, Ta, desc_k, free_k, rays_k,
                      Tb_k, sigma, kind: str):
    """_associate_triangulate_batch with its outputs packed (_pack_tri)."""
    return _pack_tri(*_associate_triangulate_batch(
        desc_a, free_a, rays_a, Ta, desc_k, free_k, rays_k, Tb_k,
        sigma, kind))


def _pinhole_rays(xy, pin):
    """[..., 3] unit-plane rays of pixels xy [..., 2], pin = (fx, fy, cx,
    cy)."""
    fx, fy, cx, cy = pin
    return torch.stack([(xy[..., 0] - cx) / fx, (xy[..., 1] - cy) / fy,
                        torch.ones_like(xy[..., 0])], -1)


def _tri_batch_packed_dev(desc_a, valid_a, kp2mp_a, xy_a, pin, Ta,
                          desc_k, free_k, rays_k, Tb_k, sigma, kind: str):
    """Device-resident-frame variant of _tri_batch_packed: the new
    keyframe's descriptors/keypoints stay in the tracker's device tensors
    (Frame.feats_dev) and the free mask + pinhole rays are computed there,
    so keyframe handling needs no host copy before the sweep."""
    rays_a = _pinhole_rays(xy_a, pin)
    free_a = valid_a & (kp2mp_a < 0)
    return _tri_batch_packed(desc_a, free_a, rays_a, Ta, desc_k, free_k,
                             rays_k, Tb_k, sigma, kind)


def _tri_batch_packed_dev2(desc_a, valid_a, kp2mp_a, xy_a, pin, Ta,
                           desc_k, valid_k, kp2mp_k, xy_k, nmask, Tb_k,
                           sigma, kind: str):
    """All-device variant: the NEIGHBOR keyframes' feature tensors are
    also still on the device (the mapper keeps the last few KFs' tensors
    alive — see _dev_kf_cache), so only the [K, N] binding tables are
    uploaded. nmask [K] masks padding rows (stacks are padded to a fixed K
    by repetition)."""
    rays_a = _pinhole_rays(xy_a, pin)
    free_a = valid_a & (kp2mp_a < 0)
    rays_k = _pinhole_rays(xy_k, pin)
    free_k = valid_k & (kp2mp_k < 0) & nmask[:, None]
    return _tri_batch_packed(desc_a, free_a, rays_a, Ta, desc_k, free_k,
                             rays_k, Tb_k, sigma, kind)


def _concat_flat(parts):
    """Flatten-and-concat results into ONE f32 tensor: the keyframe path
    then copies one buffer (one synchronisation) instead of one per
    result. All packed payloads here (descriptor bits, indices, 0/1 flags,
    f32 geometry) are exactly representable in f32."""
    return torch.cat([p.reshape(-1).to(torch.float32) for p in parts])


def _fuse_bind_packed(desc_p, pvalid, pix, desc_b, valid_b, xy_b,
                      radius, kind: str):
    """matching.match_descriptors_windowed with (idx, ok) packed into ONE
    [P, 2] int32 tensor."""
    idx, ok = matching.match_descriptors_windowed(
        desc_p, pvalid, pix, desc_b, valid_b, xy_b, radius, kind)
    return torch.stack([idx.to(torch.int32), ok.to(torch.int32)], -1)


@MAPPERS.register("demo")
class Mapper:
    def __init__(self, wmap: WorldMap, cfg, device=None):
        self.map = wmap
        self.cfg = cfg
        self.device = resolve_device(device)
        self._kf_count = 0
        self._recent_points: List[int] = []   # for culling
        self._plane_buffer: List[np.ndarray] = []
        self._plane_sent = False
        self.generator = torch.Generator().manual_seed(
            cfg.get_int("SLAM.Seed", 0) + 1)
        self.plane_se3: Optional[np.ndarray] = None
        self.ba_f = cfg.get_int("SLAM.BAFrameCap", BA_F)
        self.ba_p = cfg.get_int("SLAM.BAPointCap", BA_P)
        self.ba_o = cfg.get_int("SLAM.BAObsCap", BA_O)
        self.plane_min = cfg.get_int("Plane.MinPoints", PLANE_MIN_POINTS)
        self.plane_queue = _default_trans_plane
        # recent keyframes whose staged device feature buffers stay alive
        # (insertion-ordered fid -> Frame; see _cache_dev_kf)
        self._dev_kf_cache = {}
        # optional tracker callback run after each keyframe commits
        # (Tracker.restage_after_kf: local-map restaging off the track
        # thread, and fresher — it sees this keyframe's new points)
        self.restage_hook = None
        self.gps_fitted = False
        self.last_gps_fit_rms = None   # diagnostics for tests/logs
        # one GPS fit in flight at a time: a second trigger while a fit
        # is running is pure waste (same KF set). Non-blocking: the losing
        # trigger skips — the winner's fit covers it.
        self._fit_lock = threading.Lock()
        # capacity-saturation observability: counts of drops at the BA
        # caps; first saturation of each kind logs a warning (then counts
        # silently — per-KF spam helps nobody)
        self.ba_truncated = {"frames": 0, "points": 0, "obs": 0,
                             "fuse": 0}
        # online mode: keyframe handling on a 1-worker pool so the tracker
        # never blocks on BA (MapperDemo.cpp:77-106 ThreadPool(1) +
        # _abordBundle backpressure); a keyframe that raises there is
        # logged and counted in worker_errors
        self._online = cfg.get_bool("SLAM.isOnline", False) and \
            not cfg.get_bool("SLAM.forceOffline", False)
        self._pool = None
        self._kf_gen = 0
        self.worker_errors = 0
        if self._online:
            from ..core.messenger import ThreadPool
            self._pool = ThreadPool(1)
        # callback(S_sim3) the SLAM wires to the tracker so its motion
        # model survives the map rescale (the reference shares this via the
        # GPS.Fitted svar + shared frame objects)
        self.on_map_transformed = None
        # callback() for NON-rigid map rewrites (the gps_fitting pose-graph
        # bend): no single SIM3 exists to hand the tracker, but its staged
        # local-map cloud still moved and must be invalidated IN the locked
        # critical section with the rewrite + version bump
        self.on_map_deformed = None

    def _t(self, a, dtype=None):
        """A host array as a tensor on the mapper's device."""
        t = torch.from_numpy(np.ascontiguousarray(a))
        return t.to(self.device, dtype)

    # ------------------------------------------------------------------ API
    def on_map_initialized(self, kf0: Frame, kf1: Frame):
        self._kf_count = 2
        for mp in self.map.points():
            self._recent_points.append(mp.id)
            self._plane_buffer.append(mp.id)
        self._feed_plane()

    def insert_keyframe(self, frame: Frame):
        if self._pool is not None:
            self._kf_gen += 1
            self._pool.add(self._worker_keyframe, frame, self._kf_gen)
        else:
            self._handle_keyframe(frame, 0)

    def _worker_keyframe(self, frame: Frame, gen: int):
        """The pool's job: a keyframe that raises is logged and counted
        (the pool's future would hold the exception where nobody reads
        it)."""
        try:
            self._handle_keyframe(frame, gen)
        except Exception:                                  # noqa: BLE001
            import traceback
            self.worker_errors += 1
            glog.logger.error("mapper worker: keyframe %d raised:\n%s"
                              % (frame.id, traceback.format_exc()))

    def finish(self, timeout: float = 120.0) -> bool:
        """Drain the online worker (call('Finish') path), waiting at most
        `timeout` seconds. Returns whether the pool is empty."""
        if self._pool is None:
            return True
        import time as _time
        t0 = _time.monotonic()
        while self._pool.pending() and _time.monotonic() - t0 < timeout:
            _time.sleep(0.02)
        return self._pool.pending() == 0

    def _handle_keyframe(self, frame: Frame, gen: int = 0):
        """handleCurrentFrame (MapperDemo.cpp:311). In online mode, when a
        newer keyframe is already queued the expensive local BA is skipped
        for this one (the reference's _abordBundle, :83-85,250-251)."""
        with timer.scope("Mapper::insertKeyFrame"):
            # The tracker leaves features on the device. For pinhole
            # cameras they are USED in place: the packed host copy, the
            # neighbor triangulation sweep, and the fuse bind are enqueued
            # back-to-back and copied in ONE buffer (one synchronisation).
            # Distorted camera models (host-side unproject) take the host
            # path. Enqueue-before-copy is safe: fuse's candidate set (neighbor
            # points minus the frame's own bindings) provably excludes
            # points created THIS keyframe — they are bound in both the
            # frame and the neighbor — and both commit loops guard slot
            # collisions at commit time (the serial order's invariant).
            fd = frame.feats_dev
            pack_ctx = None
            if fd is not None and type(frame.camera) is Camera:
                with timer.scope("Mapper::hostDispatch"):
                    pack_ctx = frame.dispatch_pack()
            if pack_ctx is None:
                with timer.scope("Mapper::hostFetch"):
                    frame.ensure_host_features()
                frame.feats_dev = None
                fd = None
            else:
                fd = pack_ctx[0]
            self._kf_count += 1
            with timer.scope("Mapper::bookkeeping"):
                self._register_observations(frame)
                self._make_connections(frame)
                self._cull_map_points(frame)
            with timer.scope("Mapper::createNewMapPoints"):
                new_ctx = self._new_points_dispatch(frame, fd)
            with timer.scope("Mapper::dataAssociation"):
                fuse_ctx = self._fuse_dispatch(frame, fd)
            pending = []
            if pack_ctx is not None:
                pending.append(pack_ctx[1])
            if new_ctx is not None:
                pending.append(new_ctx[0])
            if fuse_ctx is not None:
                pending.append(fuse_ctx[0])
            if pending:
                with timer.scope("Mapper::kfFetch"):
                    # ONE flat buffer = one copy for the whole keyframe
                    # batch
                    flat = _concat_flat(tuple(pending)).cpu().numpy()
                off = 0

                def _take(shape):
                    nonlocal off
                    n = int(np.prod(shape, dtype=np.int64))
                    part = flat[off:off + n].reshape(shape)
                    off += n
                    return part

                if pack_ctx is not None:
                    frame.install_packed(pack_ctx[0],
                                         _take(pack_ctx[1].shape))
                    self._cache_dev_kf(frame)
                if new_ctx is not None:
                    with timer.scope("Mapper::newPts.insert"):
                        self._new_points_commit(frame, new_ctx[1],
                                                _take(new_ctx[0].shape))
                if fuse_ctx is not None:
                    with timer.scope("Mapper::fuse.merge"):
                        self._fuse_commit(frame, fuse_ctx[1],
                                          _take(fuse_ctx[0].shape))
            if gen == 0 or gen >= self._kf_gen:
                with timer.scope("Mapper::localOptimization"):
                    self._local_ba(frame)
            with timer.scope("Mapper::postKF"):
                with timer.scope("Mapper::postKF.normals"):
                    self._update_normals_descriptors(frame)
                with timer.scope("Mapper::postKF.cullKF"):
                    self._cull_keyframes(frame)
                with timer.scope("Mapper::postKF.fitGps"):
                    self._maybe_fit_gps()
                with timer.scope("Mapper::postKF.plane"):
                    self._feed_plane()
            hook = self.restage_hook
            if hook is not None:
                with timer.scope("Mapper::restage"):
                    hook()

    # ------------------------------------------------------------ pipeline
    def _register_observations(self, frame: Frame):
        for ci in np.nonzero(frame.kp2mp >= 0)[0]:
            self.map.add_observation(int(frame.kp2mp[ci]), frame.id, int(ci))

    def _make_connections(self, frame: Frame, min_shared: int = 10):
        """FrameConnections from shared map points (makeKeyFrame:366-432)."""
        counts = {}
        for pid in frame.kp2mp[frame.kp2mp >= 0]:
            mp = self.map.point(int(pid))
            if mp is None:
                continue
            for fid in mp.observations:
                if fid != frame.id:
                    counts[fid] = counts.get(fid, 0) + 1
        frame.connections = {fid: c for fid, c in counts.items()
                             if c >= min_shared}
        if not frame.connections and counts:
            best = max(counts, key=counts.get)
            frame.connections = {best: counts[best]}
        for fid, c in frame.connections.items():
            other = self.map.frame(fid)
            if other is not None:
                other.connections[frame.id] = c

    def _cull_map_points(self, frame: Frame):
        """Recent points must reach >= 3 observations within 3 keyframes or
        die (mapPointCulling, MapperDemo.cpp:464-490: `observationNum()<=2`
        after 3 frames -> erase). This is what kills two-view ghost points —
        wrong-instance matches on repetitive texture triangulate to coherent
        phantom layers that are geometrically self-consistent in exactly
        their two creating views."""
        keep = []
        for pid in self._recent_points:
            mp = self.map.point(pid)
            if mp is None:
                continue
            age = self._kf_count - mp.created_at_kf
            if age < 3:
                keep.append(pid)
            elif mp.n_obs() <= 2:
                self.map.erase_point(pid)
        self._recent_points = keep

    def _new_points_dispatch(self, frame: Frame, fd=None):
        """Triangulate unmatched keypoints against top connected keyframes
        (createNewMapPointsBow:492-650). The whole neighbor sweep — match,
        epipolar gate, triangulation, acceptance gates — runs on the device
        (_associate_triangulate_batch); only neighbor selection and map
        insertion run host-side. All neighbors are
        matched against the frame's INITIAL free mask (the serial version
        re-matched after each neighbor's insertions); the commit loop's
        kp2mp guards enforce the same no-double-bind invariant.

        Returns (packed device tensor [K, N, 6], neighbors) — the caller
        copies the tensor (merged with the host-copy and fuse fetches)
        and passes both to _new_points_commit — or None when no usable
        neighbor exists. With fd (the frame's device-resident feature
        buffers), the frame's inputs never touch the host."""
        top = sorted(frame.connections.items(),
                     key=lambda kv: -kv[1])[:NEW_POINT_NEIGHBORS]
        neighbors = []
        with timer.scope("Mapper::newPts.prep"):
            for fid, _ in top:
                kf = self.map.frame(fid)
                if kf is None or kf.desc is None:
                    continue
                # baseline check (:518-525): baseline / median depth > 0.01
                base = np.linalg.norm(frame.pose_c2w[:3] - kf.pose_c2w[:3])
                if base / max(self._kf_median_depth(kf), 1e-9) < 0.01:
                    continue
                neighbors.append(kf)
            if not neighbors:
                return None
            K = NEW_POINT_NEIGHBORS
            use_dev2 = (fd is not None and all(
                kf.feats_dev is not None
                and kf.feats_dev["desc"].shape == fd["desc"].shape
                for kf in neighbors))
            if not use_dev2:
                if fd is not None:
                    N, D = fd["desc"].shape
                    desc_dtype = np.uint8 \
                        if fd["desc"].dtype == torch.uint8 else np.float32
                else:
                    N, D = frame.desc.shape
                    desc_dtype = frame.desc.dtype
                    free_a = frame.valid & (frame.kp2mp < 0)
                desc_k = np.zeros((K, N, D), desc_dtype)
                free_k = np.zeros((K, N), bool)
                rays_k = np.zeros((K, N, 3), np.float32)
                Tb_k = np.tile(np.array([0, 0, 0, 0, 0, 0, 1], np.float32),
                               (K, 1))
                for i, kf in enumerate(neighbors):
                    n = min(N, len(kf.desc))
                    desc_k[i, :n] = kf.desc[:n]
                    free_k[i, :n] = (kf.valid & (kf.kp2mp < 0))[:n]
                    rays_k[i, :n] = kf.rays[:n]
                    Tb_k[i] = kf.pose_c2w
        with timer.scope("Mapper::newPts.match"):
            cam = frame.camera
            pin = (cam.fx, cam.fy, cam.cx, cam.cy)
            Ta = self._t(frame.pose_c2w, torch.float32)
            if use_dev2:
                # pad the neighbor stack to the fixed K by repetition
                # (nmask hides the copies)
                reps = neighbors + [neighbors[-1]] * (K - len(neighbors))
                packed = _tri_batch_packed_dev2(
                    fd["desc"], fd["valid"],
                    self._t(frame.kp2mp, torch.int32), fd["xy"], pin, Ta,
                    torch.stack([kf.feats_dev["desc"] for kf in reps]),
                    torch.stack([kf.feats_dev["valid"] for kf in reps]),
                    self._t(np.stack([kf.kp2mp for kf in reps]),
                            torch.int32),
                    torch.stack([kf.feats_dev["xy"] for kf in reps]),
                    self._t(np.arange(K) < len(neighbors)),
                    self._t(np.stack([kf.pose_c2w for kf in reps]),
                            torch.float32),
                    float(1.0 / cam.fx), frame.desc_kind)
            elif fd is not None:
                packed = _tri_batch_packed_dev(
                    fd["desc"], fd["valid"],
                    self._t(frame.kp2mp, torch.int32), fd["xy"], pin, Ta,
                    self._t(desc_k), self._t(free_k), self._t(rays_k),
                    self._t(Tb_k), float(1.0 / cam.fx), frame.desc_kind)
            else:
                packed = _tri_batch_packed(
                    self._t(frame.desc), self._t(free_a),
                    self._t(frame.rays), Ta,
                    self._t(desc_k), self._t(free_k), self._t(rays_k),
                    self._t(Tb_k), float(1.0 / cam.fx), frame.desc_kind)
        return packed, neighbors

    def _new_points_commit(self, frame: Frame, neighbors, fetched) -> int:
        """Insert the accepted candidates from the fetched neighbor-sweep
        results (the host half of createNewMapPointsBow:617-650). fetched:
        the packed [K, N, 6] buffer from _tri_batch_packed[_dev]."""
        buf = np.asarray(fetched)
        idx_k = buf[..., 0].astype(np.int64)
        good_k = buf[..., 1] > 0.5
        X_k = buf[..., 2:5]
        err_k = buf[..., 5]
        created = 0
        color_img = frame.color if frame.color is not None else frame.image
        for i, kf in enumerate(neighbors):
            idxn, X = idx_k[i], X_k[i]
            good = self._filter_new_points(frame, good_k[i], err_k[i])
            for j in np.nonzero(good)[0]:
                ka = int(j)
                kb = int(idxn[j])
                if frame.kp2mp[ka] >= 0 or kf.kp2mp[kb] >= 0:
                    continue
                pid = self.map.get_pid()
                color = np.full(3, 128, np.uint8)
                if color_img is not None:
                    x, y = frame.xy[ka].astype(int)
                    if 0 <= y < color_img.shape[0] and \
                            0 <= x < color_img.shape[1]:
                        c = color_img[y, x]
                        color = (np.full(3, int(c), np.uint8)
                                 if np.ndim(c) == 0
                                 else c.astype(np.uint8))
                mp = MapPoint(id=pid, position=X[j].astype(np.float32),
                              descriptor=np.asarray(frame.desc[ka]),
                              color=color, ref_frame=frame.id,
                              created_at_kf=self._kf_count)
                view = X[j] - frame.pose_c2w[:3]
                mp.normal = (view / max(np.linalg.norm(view),
                                        1e-9)).astype(np.float32)
                self.map.insert_point(mp)
                self.map.add_observation(pid, frame.id, ka)
                self.map.add_observation(pid, kf.id, kb)
                self._recent_points.append(pid)
                self._plane_buffer.append(pid)
                created += 1
        return created

    def _filter_new_points(self, frame: Frame, good, err=None):
        """Candidate-selection hook for _create_new_points; the base mapper
        keeps every candidate that passed the geometric gates. Subclasses
        (MapperZhangMi) impose spatial quotas here. err: [N] summed
        two-view reprojection error per candidate (quota tie-breaking)."""
        return good

    def _fuse_dispatch(self, frame: Frame, fd=None):
        """Project neighbors' points into this KF and dispatch the windowed
        binding match (dataAssociation:809-1011). The candidate set is
        gathered from the PRE-commit map state — points created by this
        keyframe's own triangulation are bound in both the frame and the
        neighbor, so the serial order's `pids -= own` excluded them too —
        which lets this dispatch ride the same fetch as the neighbor
        sweep. Returns (packed [P, 2] device tensor, ids) for _fuse_commit,
        or None with nothing to do. With fd, the frame's inputs come from
        the tracker's staged device buffers."""
        with timer.scope("Mapper::fuse.gather"):
            pids = set()
            for fid in frame.connections:
                kf = self.map.frame(fid)
                if kf is None:
                    continue
                pids.update(int(p) for p in kf.kp2mp[kf.kp2mp >= 0])
            own = set(int(p) for p in frame.kp2mp[frame.kp2mp >= 0])
            pids -= own
            if not pids:
                return None
            ids, pos, desc = self.map.point_arrays(sorted(pids))
        if not ids:
            return None
        # ONE fixed capacity: the padded shape is the reference's, so both
        # packages match the same candidate set; truncation past the cap
        # is noted.
        cap = FUSE_POINT_CAP
        if len(ids) > cap:
            self._note_truncation("fuse", len(ids) - cap)
            ids = ids[:cap]
        pos_p, maskp = pad_to(pos, cap)
        desc_p, _ = pad_to(np.asarray(desc), cap)
        pc = hse3.se3_apply(hse3.se3_inv(frame.pose_c2w), pos_p)
        infront = pc[:, 2] > 1e-3
        uv = pc[:, :2] / np.maximum(pc[:, 2:], 1e-6)
        pix = frame.camera.project(
            np.concatenate([uv, np.ones_like(uv[:, :1])],
                           -1)).astype(np.float32)
        inview = frame.camera.in_view(pix)
        pvalid = maskp & infront & inview
        with timer.scope("Mapper::fuse.match"):
            # window construction + distance + matching on the device
            if fd is not None:
                desc_b, valid_b, xy_b = fd["desc"], fd["valid"], fd["xy"]
            else:
                desc_b = self._t(frame.desc)
                valid_b = self._t(frame.valid)
                xy_b = self._t(frame.xy)
            packed = _fuse_bind_packed(
                self._t(desc_p), self._t(pvalid), self._t(pix),
                desc_b, valid_b, xy_b, 4.0, frame.desc_kind)
        return packed, ids

    def _fuse_commit(self, frame: Frame, ids, fetched):
        """Bind matched points to free keypoints / merge duplicates given
        the fetched match (the host half of dataAssociation:876-1011).
        A slot this keyframe's triangulation just bound is handled by the
        existing-binding branch exactly as the serial order did. fetched:
        the packed [P, 2] buffer from _fuse_bind_packed."""
        buf = np.asarray(fetched)
        idxn, okn = buf[:, 0], buf[:, 1] > 0
        for pi in np.nonzero(okn)[0]:
            ci = int(idxn[pi])
            pid = ids[pi]
            existing = int(frame.kp2mp[ci])
            if existing < 0:
                self.map.add_observation(pid, frame.id, ci)
            elif existing != pid:
                # merge: keep the point with more observations
                a = self.map.point(existing)
                b = self.map.point(pid)
                if a is None or b is None:
                    continue
                keep, drop = (a, b) if a.n_obs() >= b.n_obs() else (b, a)
                for fid, kp in list(drop.observations.items()):
                    fr = self.map.frame(fid)
                    if fr is None:
                        continue
                    if fid not in keep.observations:
                        self.map.add_observation(keep.id, fid, kp)
                    else:
                        fr.kp2mp[kp] = (keep.id
                                        if keep.observations[fid] == kp
                                        else -1)
                self.map.erase_point(drop.id)

    def _kf_median_depth(self, kf: Frame) -> float:
        """Median depth of a keyframe's bound points, cached per map
        gauge version: the neighbor-selection baseline gate re-derived it
        from a ~1k-point dict sweep for every sweep of every keyframe
        (~10 ms each); the value only moves materially when the map is
        re-gauged (GPS fit / loop closure bump map.version)."""
        ver = self.map.version
        cached = getattr(kf, "_med_depth_cache", None)
        if cached is not None and cached[0] == ver:
            return cached[1]
        ids, pos, _ = self.map.point_arrays(
            [int(p) for p in kf.kp2mp[kf.kp2mp >= 0]])
        med = kf.median_depth(pos) if len(ids) else 1.0
        kf._med_depth_cache = (ver, med)
        return med

    def _cache_dev_kf(self, frame: Frame):
        """Keep this keyframe's device feature tensors alive: it will be
        among the top connected neighbors of the next few keyframes, whose
        triangulation sweeps can then read it without re-uploading ~0.4 MB
        of descriptors/keypoints. Oldest entries past DEV_KF_CACHE are
        released (the host copy was installed first)."""
        self._dev_kf_cache[frame.id] = frame
        while len(self._dev_kf_cache) > DEV_KF_CACHE:
            fid = next(iter(self._dev_kf_cache))
            self._dev_kf_cache.pop(fid).feats_dev = None

    @staticmethod
    def solve_local_window(poses_w2c, fixed, pts, obs_f, obs_p, obs_uv,
                           caps, iters, huber_delta, tol=0.0,
                           prior_kw=None, note_truncation=None,
                           device=None):
        """Solve a local BA window that may EXCEED the point/obs caps.

        Within caps: one padded ba.optimize on `device` (None means
        `cuda`). Overflow (VERDICT r3 item 10): greedy-pack the points
        into chunks whose observations fit the caps (obs arrive
        point-major from _local_ba, so chunks are slices), sweep
        pose-free chunk solves (each warm-started on the previous
        poses), then re-solve every non-final chunk POINT-ONLY under the
        final poses — no observation is silently dropped, matching the
        reference's local windows (MapperDemo.cpp:1286-1555). Sole
        exception: a single 'monster' point whose observations ALONE
        exceed the O cap solves on an evenly-strided O-subset, and the
        remainder is reported through `note_truncation`. All chunk
        problems share one padded shape. Returns (new_poses_w2c
        [F_real], new_pts [P_real]).
        """
        F, P, O = caps
        prior_kw = prior_kw or {}
        n_pts = len(pts)
        obs_p = np.asarray(obs_p, np.int32)
        obs_f = np.asarray(obs_f, np.int32)
        obs_uv = np.asarray(obs_uv, np.float32)
        counts = np.bincount(obs_p, minlength=n_pts)
        chunks = []
        start = 0
        while start < n_pts:
            end, acc = start, 0
            while end < n_pts and (end - start) < P \
                    and acc + counts[end] <= O:
                acc += int(counts[end])
                end += 1
            if end == start:      # monster point: obs alone exceed O
                end = start + 1
                # its chunk solves see an evenly-strided O-subset (below);
                # the remainder IS dropped — account for it (ADVICE r4:
                # the docstring's 'no observation silently dropped' must
                # not hide this path)
                if note_truncation is not None:
                    note_truncation("obs", int(counts[start]) - O)
            chunks.append((start, end))
            start = end
        cut = np.searchsorted(obs_p, [c[0] for c in chunks]
                              + [chunks[-1][1]])
        poses_cur = np.asarray(poses_w2c, np.float32).copy()
        pts_cur = np.asarray(pts, np.float32).copy()
        fixed = np.asarray(fixed, bool)

        def solve(ci, pose_free: bool):
            s, e = chunks[ci]
            o0, o1 = int(cut[ci]), int(cut[ci + 1])
            if o1 - o0 > O:
                # monster point: even stride across its observations (a
                # prefix slice would keep only its earliest frames and
                # bias the point toward the window's start)
                sel = o0 + np.round(np.linspace(0, o1 - o0 - 1,
                                                O)).astype(np.int64)
                o_f, o_p, o_uv = obs_f[sel], obs_p[sel], obs_uv[sel]
            else:
                o_f, o_p, o_uv = (obs_f[o0:o1], obs_p[o0:o1],
                                  obs_uv[o0:o1])
            poses_p, fmask = pad_to(poses_cur, F)
            poses_p[~fmask] = np.array([0, 0, 0, 0, 0, 0, 1.0],
                                       np.float32)
            fx = fixed if pose_free else np.ones_like(fixed)
            fixed_p, _ = pad_to(fx, F, True)
            fixed_p[~fmask] = True
            pts_p, pmask = pad_to(pts_cur[s:e], P)
            of, omask = pad_to(o_f, O)
            op, _ = pad_to(o_p - s, O)
            ouv, _ = pad_to(o_uv, O)
            kw = prior_kw if pose_free else {}
            prob = ba.make_problem(
                poses=poses_p, pose_fixed=fixed_p, points=pts_p,
                point_fixed=~pmask, obs_frame=of, obs_point=op,
                obs_uv=ouv, obs_weight=omask.astype(np.float32),
                device=device, **kw)
            np_, npts, _ = ba.optimize(prob, iters=iters,
                                       huber_delta=huber_delta, tol=tol)
            # one copy for poses and points
            flat = torch.cat([np_[:len(poses_cur)].reshape(-1),
                              npts[:e - s].reshape(-1)]).cpu().numpy()
            nf = len(poses_cur) * 7
            return flat[:nf].reshape(-1, 7), flat[nf:].reshape(-1, 3)

        for ci in range(len(chunks)):
            new_poses, new_pts = solve(ci, pose_free=True)
            poses_cur = new_poses
            s, e = chunks[ci]
            pts_cur[s:e] = new_pts
        if len(chunks) > 1:
            # alternation pass: earlier chunks' points re-solved under
            # the FINAL poses (point-only; priors off, poses fixed)
            for ci in range(len(chunks) - 1):
                _, new_pts = solve(ci, pose_free=False)
                s, e = chunks[ci]
                pts_cur[s:e] = new_pts
        return poses_cur, pts_cur

    def _note_truncation(self, kind: str, dropped: int):
        """Record (and log on first occurrence) a drop at a BA capacity cap
        — silent truncation quietly degrades BA quality on dense scenes."""
        first = self.ba_truncated[kind] == 0
        self.ba_truncated[kind] += int(dropped)
        if first:
            cap = {"frames": self.ba_f, "points": self.ba_p,
                   "obs": self.ba_o, "fuse": FUSE_POINT_CAP}[kind]
            glog.logger.warning(
                "local BA %s window saturated (cap %d, %d dropped this KF);"
                " raise SLAM.BA%sCap to widen — further drops counted in"
                " Mapper.ba_truncated" %
                (kind, cap, dropped,
                 {"frames": "Frame", "points": "Point", "obs": "Obs",
                  "fuse": "Fuse"}[kind]))

    # --------------------------------------------------------------- BA
    def _local_ba(self, frame: Frame):
        """Local bundle: current + connected KFs free, their neighbors fixed
        (localOptimization:1286-1555). Fixed-capacity padded problem."""
        if len(frame.connections) > self.ba_f - 2:
            self._note_truncation("frames",
                                  len(frame.connections) - (self.ba_f - 2))
        free_ids = [frame.id] + sorted(frame.connections,
                                       key=frame.connections.get,
                                       reverse=True)[:self.ba_f - 2]
        free_set = set(free_ids)
        # anchor frames: neighbors of free frames, held fixed
        anchor = set()
        for fid in free_ids:
            fr = self.map.frame(fid)
            if fr is not None:
                anchor.update(fr.connections.keys())
        anchor -= free_set
        anchor = sorted(anchor)[:self.ba_f - len(free_ids)]
        frame_ids = free_ids + list(anchor)
        if len(frame_ids) < 2:
            return
        fidx = {fid: i for i, fid in enumerate(frame_ids)}
        frames = [self.map.frame(fid) for fid in frame_ids]
        # points observed by free frames
        pids = []
        seen = set()
        for fid in free_ids:
            fr = self.map.frame(fid)
            for p in fr.kp2mp[fr.kp2mp >= 0]:
                p = int(p)
                if p not in seen:
                    seen.add(p)
                    # kp2mp may hold stale ids for points culled while a
                    # non-keyframe still referenced them
                    if self.map.point(p) is not None:
                        pids.append(p)
        if len(pids) > self.ba_p:
            # logged as saturation, but no longer dropped: the window is
            # solved in point chunks (solve_local_window)
            self._note_truncation("points", len(pids) - self.ba_p)
        pidx = {pid: i for i, pid in enumerate(pids)}
        if len(pids) < 10:
            return
        obs_f, obs_p, obs_uv = [], [], []
        for pid in pids:
            mp = self.map.point(pid)
            for fid, kp in mp.observations.items():
                if fid in fidx:
                    fr = self.map.frame(fid)
                    obs_f.append(fidx[fid])
                    obs_p.append(pidx[pid])
                    obs_uv.append(fr.rays[kp][:2])
        if len(obs_f) < 30:
            return
        if len(obs_f) > self.ba_o:
            # chunked, not dropped (solve_local_window)
            self._note_truncation("obs", len(obs_f) - self.ba_o)
        obs_f = np.asarray(obs_f, np.int32)
        obs_p = np.asarray(obs_p, np.int32)
        obs_uv = np.asarray(obs_uv, np.float32)
        poses = hse3.se3_inv(np.stack([f.pose_c2w for f in frames])).astype(
            np.float32)
        fixed = np.array([fid not in free_set for fid in frame_ids])
        # gauge: with < 3 frames total keep the oldest free frame fixed too
        if fixed.sum() == 0:
            fixed[np.argmin(frame_ids)] = True
        pts = np.stack([self.map.point(p).position for p in pids])
        # GPS priors (when frames carry ENU fixes and GPS is fitted) —
        # MapperDemo.cpp:1431: `GPS.Fitted && GPS.LocalOptimize(default 1)`
        use_gps = self.gps_fitted and self.cfg.get_bool("GPS.LocalOptimize",
                                                        True)
        prior_kw = {}
        if use_gps:
            gps_f, gps_pose, gps_info = [], [], []
            for fid in free_ids:
                fr = self.map.frame(fid)
                if fr.gps_enu is not None:
                    T_prior_c2w = fr.pose_c2w.copy()
                    T_prior_c2w[:3] = fr.gps_enu
                    gps_f.append(fidx[fid])
                    gps_pose.append(hse3.se3_inv(T_prior_c2w).astype(
                        np.float32))
                    info = np.zeros(6, np.float32)
                    info[:3] = 1.0 / max(fr.gps_acc, 0.1) ** 2
                    gps_info.append(info)
            if gps_f:
                # pad priors to the frame capacity so the BA problem keeps
                # ONE shape across keyframes (padding rows: frame 0,
                # identity pose, zero information -> no effect)
                G = self.ba_f
                pfr, _ = pad_to(np.asarray(gps_f, np.int32), G)
                ppo, pm = pad_to(np.stack(gps_pose).astype(np.float32), G)
                ppo[~pm] = np.array([0, 0, 0, 0, 0, 0, 1.0], np.float32)
                pin, _ = pad_to(np.stack(gps_info).astype(np.float32), G)
                prior_kw = dict(prior_frame=pfr, prior_pose=ppo,
                                prior_info=pin)
        sigma = 1.0 / frame.camera.fx
        # SLAM.LocalBATol > 0 enables relative-improvement early
        # termination (g2o's terminate gate). Default 0 = the full
        # fixed-length LM: the round-2 default of 1e-4 measurably
        # under-converged GPS-prior windows (geo-ATE 2.95 m vs
        # <2 m on the everything-on soak survey) and even 1e-5
        # still did — GPS priors pull the window in many small
        # relative steps, so ANY relative gate stops them early.
        # The knob stays for throughput-sensitive configs; the cost
        # of 0 is bounded by SLAM.LocalBAIters
        new_poses, new_points = self.solve_local_window(
            poses, fixed, pts, obs_f, obs_p, obs_uv,
            (self.ba_f, self.ba_p, self.ba_o),
            iters=self.cfg.get_int("SLAM.LocalBAIters", 15),
            huber_delta=float(np.sqrt(5.991)) * sigma,
            tol=self.cfg.get_double("SLAM.LocalBATol", 0.0),
            prior_kw=prior_kw, note_truncation=self._note_truncation,
            device=self.device)
        new_c2w = hse3.se3_inv(new_poses).astype(np.float32)
        with self.map.update_lock:
            for fid in free_ids:
                self.map.frame(fid).pose_c2w = new_c2w[fidx[fid]]
            for pid in pids:
                self.map.point(pid).position = \
                    new_points[pidx[pid]].astype(np.float32)
        # prune high-error observations (:1504-1549)
        self._prune_observations(frame_ids, pids, sigma)

    def _prune_observations(self, frame_ids, pids, sigma):
        """Erase observations whose reprojection error exceeds the chi2 gate
        (localOptimization bad-edge pruning, MapperDemo.cpp:1504-1549) —
        over EVERY observing frame of the window's points, fully vectorized
        in numpy (no per-observation device work). Stale points that
        lag behind GPS refits / BA camera motion are caught here."""
        th = 5.991 * sigma * sigma * 4.0
        obs_pid, obs_fid, obs_kp = [], [], []
        for pid in pids:
            mp = self.map.point(pid)
            if mp is None:
                continue
            for fid, kp in mp.observations.items():
                obs_pid.append(pid)
                obs_fid.append(fid)
                obs_kp.append(kp)
        if not obs_pid:
            return
        # per-frame rotation matrices (w2c) + centers, indexed per obs
        frames = {}
        for fid in set(obs_fid):
            fr = self.map.frame(fid)
            if fr is None:
                continue
            q = fr.pose_c2w[3:7]
            x, y, z, w = q
            R = np.array([
                [1 - 2 * (y * y + z * z), 2 * (x * y - z * w),
                 2 * (x * z + y * w)],
                [2 * (x * y + z * w), 1 - 2 * (x * x + z * z),
                 2 * (y * z - x * w)],
                [2 * (x * z - y * w), 2 * (y * z + x * w),
                 1 - 2 * (x * x + y * y)]])
            frames[fid] = (R.T, fr.pose_c2w[:3], fr)
        keep = [i for i, fid in enumerate(obs_fid) if fid in frames]
        if not keep:
            return
        obs_pid = [obs_pid[i] for i in keep]
        obs_fid = [obs_fid[i] for i in keep]
        obs_kp = [obs_kp[i] for i in keep]
        P = np.stack([self.map.point(p).position for p in obs_pid])
        Rw2c = np.stack([frames[f][0] for f in obs_fid])
        C = np.stack([frames[f][1] for f in obs_fid])
        rays = np.stack([frames[f][2].rays[k][:2]
                         for f, k in zip(obs_fid, obs_kp)])
        pc = np.einsum("oij,oj->oi", Rw2c, P - C)
        z = pc[:, 2]
        uv = pc[:, :2] / np.maximum(z[:, None], 1e-9)
        e2 = np.sum((uv - rays) ** 2, -1)
        bad = (z <= 0) | (e2 > th)
        for i in np.nonzero(bad)[0]:
            self.map.erase_observation(obs_pid[i], obs_fid[i])
        for pid in set(obs_pid):
            mp = self.map.point(pid)
            if mp is not None and mp.n_obs() < 2:
                self.map.erase_point(pid)

    def _update_normals_descriptors(self, frame: Frame):
        """Mean viewing normal (updateNormAndDes:1883-1910). The descriptor
        stays the creating frame's — for binary descriptors the reference's
        Vocabulary::meanValue medoid adds little; revisit with BoW.

        One vectorized pass: per-observation tiny-vector numpy (norm of a
        [3] array, one at a time) cost ~90 ms/KF of pure interpreter
        overhead at ~3k observations — the loops below only COLLECT
        (point, observing-center) rows; all arithmetic is batched."""
        mps, positions = [], []
        seg, centers_r = [], []
        centers = {}
        for ci in np.nonzero(frame.kp2mp >= 0)[0]:
            mp = self.map.point(int(frame.kp2mp[ci]))
            if mp is None:
                continue
            row = len(mps)
            used = False
            for fid in mp.observations:
                c = centers.get(fid)
                if c is None:
                    fr = self.map.frame(fid)
                    if fr is None:
                        continue
                    c = centers[fid] = fr.pose_c2w[:3]
                seg.append(row)
                centers_r.append(c)
                used = True
            if used:
                mps.append(mp)
                positions.append(mp.position)
        if not mps:
            return
        V = np.asarray(positions, np.float32)[seg] - np.asarray(
            centers_r, np.float32)
        n = np.linalg.norm(V, axis=1, keepdims=True)
        V = np.where(n > 1e-9, V / np.maximum(n, 1e-9), 0.0)
        sums = np.zeros((len(mps), 3), np.float32)
        np.add.at(sums, np.asarray(seg), V)
        sums /= np.maximum(np.linalg.norm(sums, axis=1, keepdims=True),
                           1e-9)
        nonzero = np.abs(sums).sum(1) > 0
        for i, mp in enumerate(mps):
            if nonzero[i]:
                mp.normal = sums[i]

    def _cull_keyframes(self, frame: Frame):
        """Erase redundant connected keyframes: >= 90% of their map points
        are observed by >= 4 other keyframes (mapFrameCulling,
        MapperDemo.cpp:434-462; same 0.9/4 thresholds). Keeps long-horizon
        maps, loop scans, and the SE3 graph bounded. Enabled by
        Mapper.MapFrameCulling (reference default 0; ours 1 — without the
        GUI there is no reason to keep redundant frames)."""
        if not self.cfg.get_bool("Mapper.MapFrameCulling", True):
            return
        for fid in list(frame.connections.keys()):
            kf = self.map.frame(fid)
            if kf is None or not kf.is_keyframe:
                continue
            if kf.id == self.map.keyframes()[0].id or fid == frame.id:
                continue    # never cull the gauge anchor
            n_mps = 0
            n_redundant = 0
            for pid in kf.kp2mp[kf.kp2mp >= 0]:
                mp = self.map.point(int(pid))
                if mp is None:
                    continue
                n_mps += 1
                if mp.n_obs() >= 4:
                    n_redundant += 1
            if n_mps > 0 and n_redundant > 0.9 * n_mps:
                self.map.erase_frame(fid)

    # ---------------------------------------------------------------- GPS
    def _maybe_fit_gps(self):
        """SIM3 geo-registration of the map (DIYSLAM::tryFitGPS semantics,
        DIYSLAM.cpp:442-485; we fit map -> local ENU instead of ECEF so
        everything stays float32-friendly — the lla -> ENU geodesy runs in
        float64 in core/gps.py).

        First fit happens once enough GPS-tagged keyframes with genuine 2D
        spread exist; after that the fit is REFRESHED every GPS.RefitEvery
        keyframes (the reference's full-trajectory Mapper::fitGps,
        MapperDemo.cpp:1557-1625) — a single early fit on a near-collinear
        trajectory locks in a tilt that windowed BA can never rotate out."""
        if not self.cfg.get_bool("GPS.EnableFitGPS", True):
            return
        kfs = [f for f in self.map.keyframes() if f.gps_enu is not None]
        if not self.gps_fitted:
            # attitude-assisted early fit needs no trajectory spread
            if self.fit_gps_priory():
                return
            if len(kfs) < self.cfg.get_int("GPS.MinFrames2Fit", 5):
                return
            self.fit_gps_all(min_frames=len(kfs), check_spread=True)
        elif self._kf_count % self.cfg.get_int("GPS.RefitEvery", 4) == 0:
            self.fit_gps_all()

    def fit_gps_priory(self) -> bool:
        """Two-frame attitude-assisted geo-registration — the reference's
        `SIM3WithPYR` branch of Tracker::fitGPS (TrackerOpt.cpp:388-431):
        when two keyframes carry full GPS+IMU priors (getPrioryPose), the
        map->ENU SIM3 is S.se3 = priory1 * est1^-1 with scale =
        |enu2 - enu1| / |est2 - est1|, validated by the second frame's
        center landing within 1 m (scaled by GPS accuracy) of its prior."""
        kfs = [f for f in self.map.keyframes()
               if f.priory_pose() is not None]
        if len(kfs) < 2:
            return False
        f1, f2 = kfs[0], kfs[-1]
        P1, _ = f1.priory_pose()
        P2, _ = f2.priory_pose()
        d_gps = float(np.linalg.norm(P2[:3] - P1[:3]))
        sigma = np.linalg.norm([f2.gps_acc] * 3)
        min_d = max(sigma, self.cfg.get_double("GPS.MinDistance2Fit", 10.0))
        if d_gps < min_d:
            return False
        d_est = float(np.linalg.norm(f2.pose_c2w[:3] - f1.pose_c2w[:3]))
        if d_est < 1e-9:
            return False
        scale = d_gps / d_est
        se3_part = hse3.se3_mul(P1, hse3.se3_inv(f1.pose_c2w))
        S = np.concatenate([se3_part, [scale]]).astype(np.float32)
        err = np.linalg.norm(
            lie.sim3_apply(self._t(S), self._t(f2.pose_c2w[:3], torch.float32)
                           ).cpu().numpy() - P2[:3])
        if err > max(1.0, 0.3 * sigma):   # reference: error.norm() > 1.
            return False
        self.apply_sim3(S)
        self.gps_fitted = True
        self.last_gps_fit_rms = float(err)
        self.cfg.set("GPS.Fitted", "1")
        _messenger.advertise("fitted_map").publish(self.map)
        return True

    def fit_gps_all(self, min_frames: int = 3, check_spread: bool = False):
        """SIM3 Horn fit of all GPS-tagged keyframe centers to their ENU
        fixes, then rigid+scale transform of the whole map (tryFitGPS /
        Mapper::fitGps, MapperDemo.cpp:1557-1625). Returns True on fit.

        At most one fit runs at a time (see _fit_lock); a trigger landing
        while another thread's fit is in flight returns False — the
        in-flight fit covers the same keyframe set."""
        if not self._fit_lock.acquire(blocking=False):
            return False
        try:
            return self._fit_gps_all_locked(min_frames, check_spread)
        finally:
            self._fit_lock.release()

    def _fit_gps_all_locked(self, min_frames: int, check_spread: bool):
        kfs = [f for f in self.map.keyframes() if f.gps_enu is not None]
        if len(kfs) < max(min_frames, 3):
            return False
        est = np.stack([f.pose_c2w[:3] for f in kfs]).astype(np.float32)
        enu = np.stack([f.gps_enu for f in kfs]).astype(np.float32)
        if check_spread:
            # need 2D spread or the rotation about the track is undetermined
            sv = np.linalg.svd(est - est.mean(0), compute_uv=False)
            if sv[1] < 0.1 * sv[0] or sv[0] < 1e-6:
                return False
        # pad to a capacity quantum (the reference's padded problem)
        cap = max(32, 1 << int(np.ceil(np.log2(len(est)))))
        est_p, wmask = pad_to(est, cap)
        enu_p, _ = pad_to(enu, cap)
        S_t = ransac.sim3_horn(self._t(est_p), self._t(enu_p),
                               self._t(wmask, torch.float32))
        fit = lie.sim3_apply(S_t, self._t(est_p))[:len(est)].cpu().numpy()
        S = S_t.cpu().numpy()
        rms = float(np.sqrt(np.mean(np.sum((fit - enu) ** 2, -1))))
        self.last_gps_fit_rms = rms
        sigma = np.mean([f.gps_acc for f in kfs])
        max_err = max(3.0 * sigma,
                      self.cfg.get_double("GPS.MaxFitError", 15.0))
        if not np.isfinite(rms) or rms > max_err:
            return False
        self.apply_sim3(S)
        self.gps_fitted = True
        self.cfg.set("GPS.Fitted", "1")
        # bend residual monocular drift onto the GPS fixes: the Horn fit
        # is rigid+scale only (gpsFitting's role in the reference)
        self.gps_fitting()
        # `fitted_map` topic (DIYSLAM.cpp:204 advertise + tryFitGPS publish)
        _messenger.advertise("fitted_map").publish(self.map)
        return True

    def gps_fitting(self, iters: int = 20) -> bool:
        """The reference's gpsFitting (MapperDemo.cpp:1627-1737): an SE3
        pose graph over every keyframe — consecutive + covisibility
        odometry edges preserve local shape while per-keyframe GPS
        POSITION priors bend the accumulated monocular drift onto the geo
        frame, which the rigid Horn similarity cannot do. Points follow
        their reference keyframe's correction (rigid per-refKF update,
        like the loop closer's write-back)."""
        kfs = [f for f in self.map.keyframes()]
        if len(kfs) < 8:
            return False
        if len(kfs) > self.cfg.get_int("GPS.FittingMaxKFs", 512):
            # the dense SE3 graph assembles [F,F,6,6]; beyond ~512 KFs
            # route through the CG pose graph instead (future work) —
            # local BA's GPS priors still bound drift meanwhile
            glog.logger.warning(
                "gps_fitting skipped: %d KFs > GPS.FittingMaxKFs"
                % len(kfs))
            return False
        ids = [f.id for f in kfs]
        kidx = {fid: i for i, fid in enumerate(ids)}
        c2w = np.stack([f.pose_c2w for f in kfs]).astype(np.float32)
        w2c = np.stack([hse3.se3_inv(p) for p in c2w]).astype(np.float32)
        rel_i, rel_j, rel_meas, rel_w = [], [], [], []

        def add_edge(i, j, w):
            rel_i.append(i)
            rel_j.append(j)
            rel_meas.append(hse3.se3_mul(w2c[i], hse3.se3_inv(w2c[j])))
            rel_w.append(w)

        for i in range(len(kfs) - 1):
            add_edge(i, i + 1, 100.0)
        for k in kfs:
            for cid in list(k.connections):
                if cid in kidx and cid > k.id:
                    add_edge(kidx[k.id], kidx[cid], 50.0)
        gps_f, gps_pose, gps_info = [], [], []
        for i, fr in enumerate(kfs):
            if fr.gps_enu is None:
                continue
            T_prior_c2w = c2w[i].copy()
            T_prior_c2w[:3] = fr.gps_enu
            gps_f.append(i)
            gps_pose.append(hse3.se3_inv(T_prior_c2w).astype(np.float32))
            info = np.zeros(6, np.float32)
            info[:3] = 1.0 / max(fr.gps_acc, 0.1) ** 2
            gps_info.append(info)
        if len(gps_f) < 4:
            return False
        prob = ba.make_problem(
            device=self.device,
            poses=w2c, pose_fixed=np.zeros(len(kfs), bool),
            rel_i=np.asarray(rel_i, np.int32),
            rel_j=np.asarray(rel_j, np.int32),
            rel_meas=np.stack(rel_meas).astype(np.float32),
            rel_weight=np.asarray(rel_w, np.float32),
            prior_frame=np.asarray(gps_f, np.int32),
            prior_pose=np.stack(gps_pose),
            prior_info=np.stack(gps_info))
        new_w2c, _, _cost = ba.optimize(prob, iters=iters)
        new_c2w_t = lie.se3_inv(new_w2c)
        corr = lie.se3_mul(new_c2w_t, lie.se3_inv(self._t(c2w)))   # [F, 7]
        new_c2w = new_c2w_t.cpu().numpy().astype(np.float32)
        with self.map.update_lock:
            pts = self.map.points()
            if pts:
                ridx = np.asarray(
                    [kidx.get(mp.ref_frame, 0) for mp in pts], np.int32)
                pos = np.stack([mp.position for mp in pts])
                newpos = lie.se3_apply(
                    corr[self._t(ridx).long()],
                    self._t(pos, torch.float32)).cpu().numpy()
                for mp, x in zip(pts, newpos):
                    mp.position = x.astype(np.float32)
            for fid in ids:
                fr = self.map.frame(fid)
                if fr is None:   # culled concurrently
                    continue
                fr.pose_c2w = new_c2w[kidx[fid]]
            self.map.version += 1
            # the point cloud moved (non-rigidly): the tracker's staged
            # local map is stale — invalidate inside the lock so the stage
            # can never be observed non-None alongside the bumped version
            if self.on_map_deformed is not None:
                self.on_map_deformed()
        return True

    def apply_sim3(self, S: np.ndarray):
        """Transform every frame pose and point by the SIM3 (the reference's
        `fr->setPose(sim3*fr->getPoseScale())` loop). Holds the map's
        update_lock for the whole rewrite: in online mode this runs on the
        mapper worker while the tracker stages inputs — a transform landing
        mid-stage mixes gauges and loses tracking."""
        with self.map.update_lock:
            self._apply_sim3_locked(S)
            # bump inside the critical section: a tracker snapshotting
            # between the rewrite and the bump would otherwise compute a
            # valid new-gauge result that the version check then discards
            self.map.version += 1

    def _apply_sim3_locked(self, S: np.ndarray):
        Sj = self._t(S, torch.float32)
        frames = self.map.frames()
        if frames:
            poses = self._t(np.stack([f.pose_c2w for f in frames]),
                            torch.float32)
            new_poses = lie.sim3_to_se3(lie.sim3_mul(
                Sj, lie.sim3_from_se3(poses))).cpu().numpy()
            for f, p in zip(frames, new_poses):
                f.pose_c2w = np.asarray(p, np.float32)
        points = self.map.points()
        if points:
            pos = self._t(np.stack([p.position for p in points]),
                          torch.float32)
            new_pos = lie.sim3_apply(Sj, pos).cpu().numpy()
            for p, x in zip(points, new_pos):
                p.position = np.asarray(x, np.float32)
        # (the plane buffer holds point IDS — positions resolve live)
        if self.plane_se3 is not None:
            newp = lie.sim3_mul(Sj, lie.sim3_from_se3(
                self._t(self.plane_se3, torch.float32)))
            self.plane_se3 = lie.sim3_to_se3(newp).cpu().numpy().astype(
                np.float32)
            if self._plane_sent:
                # keep the mosaic's plane feed in the CURRENT epoch: a
                # refit between the plane publish and the consumer's
                # prepare() otherwise mixes a stale-gauge plane with
                # current-gauge frame poses (fusion drains the queue to
                # the newest entry at prepare time)
                self.plane_queue.product(self.plane_se3)
        if self.on_map_transformed is not None:
            self.on_map_transformed(np.asarray(S))

    # -------------------------------------------------------------- plane
    def force_plane(self):
        """Fit+publish the plane now from whatever points exist (used by the
        app driver at end-of-stream when the run never crossed
        Plane.MinPoints; the reference would simply never blend)."""
        if not self._plane_sent:
            if len(self._plane_buffer) < 50:  # buffer lost/short: use map
                self._plane_buffer = [p.id for p in self.map.points()]
            self._feed_plane(min_points=50)
        return self.plane_se3

    def _feed_plane(self, min_points: Optional[int] = None):
        """Dominant ground plane for the mosaic (src/RANSAC.cpp:103-116)."""
        if min_points is None:
            min_points = self.plane_min
        if self._plane_sent:
            return
        live = []
        for pid in self._plane_buffer:
            mp = self.map.point(pid)
            if mp is not None and not mp.bad:
                live.append(mp.position)
            if len(live) >= self.plane_min * 2:
                break
        if len(live) < min_points:
            return
        # failed attempts back off (every 4th keyframe): each try costs a
        # RANSAC and a synchronisation, and geometry that just rejected a
        # plane rarely accepts one a single KF later
        self._plane_tries = getattr(self, "_plane_tries", 0) + 1
        if (self._plane_tries - 1) % 4 != 0:
            return
        # pad to the FIXED buffer capacity (the reference's padded
        # problem, so both packages draw the same samples)
        pts, mask = pad_to(np.stack(live), self.plane_min * 2)
        # SCALE-AWARE sigma: the reference's 0.15 (src/RANSAC.cpp:52) lives
        # in a map normalized to median depth ~1; after GPS fitting our map
        # is metric, so the threshold must scale with the scene depth or
        # the RANSAC prefers thin aliased ghost layers over the (noisier,
        # thicker) true ground
        kfs = self.map.keyframes()
        med = kfs[-1].median_depth(pts[mask]) if kfs else 1.0
        sigma = self.cfg.get_double("Plane.Sigma", 0.15) * max(med, 1e-6)
        res = ransac.find_plane(self.generator,
                                self._t(pts, torch.float32),
                                self._t(mask), sigma=float(sigma))
        if bool(res.ok):
            self.plane_se3 = res.model.cpu().numpy()
            self.plane_queue.product(self.plane_se3)
            self._plane_sent = True


@MAPPERS.register("zhangmi")
class MapperZhangMi(Mapper):
    """`Mapper?=zhangmi` (zhangmi/MapperZhangMi.cpp): same pipeline as demo
    — identical 3-KF/2-obs recent-point culling (:190-211), parent fusion
    (:375-422) and current+parents-free local BA (:424+) — but new-point
    triangulation is SPATIALLY RATIONED: the reference walks the 32x32
    feature grid and triangulates at most one match per cell, only in
    cells holding no mapped keypoint yet (:228-246, "triangulate one
    mappoint for one grid"). Even coverage at a fraction of the points —
    the ablation counterpart to demo's take-everything policy. The guided
    window match it uses per cell is subsumed by the base's batched
    epipolar-gated matching; the quota is applied to the surviving
    candidates, preferring the lowest-reprojection match per cell. Host
    numpy, as the JAX package's."""

    GRID = 32   # FRAME_GRID_COLS == FRAME_GRID_ROWS == 32 (MapFrame.h:7-8)

    def _filter_new_points(self, frame: Frame, good, err=None):
        if not np.any(good):
            return good
        g = self.GRID
        w = max(float(frame.camera.width), 1.0)
        h = max(float(frame.camera.height), 1.0)
        cx = np.clip((frame.xy[:, 0] * g / w).astype(np.int64), 0, g - 1)
        cy = np.clip((frame.xy[:, 1] * g / h).astype(np.int64), 0, g - 1)
        cell = cy * g + cx
        # cells already holding a mapped keypoint never triangulate
        # (needTriangulate=false, :234-241); kp2mp reflects points from
        # earlier reference-keyframe passes too, so the quota holds
        # across the whole _create_new_points call
        occupied = set(cell[np.asarray(frame.kp2mp) >= 0].tolist())
        out = np.zeros_like(good)
        cand = np.nonzero(good)[0]
        if err is not None:     # lowest reprojection error wins its cell
            cand = cand[np.argsort(np.asarray(err)[cand], kind="stable")]
        for j in cand:
            c = int(cell[j])
            if c in occupied:
                continue
            occupied.add(c)
            out[j] = True
        return out
