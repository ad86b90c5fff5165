"""Loop detection and closing.

Port of pislamfusion_tpu/models/loopclose.py: the reference's
LoopDetectorGPS (zhaoyong/LoopDetectorGPS.cpp: candidates = keyframes
within SLAM.MaxLoopDistance of the current position), LoopDetectorBoW
(inverted-file scoring over the vocabulary's words) and LoopCloserSE3Graph
(LoopCloserDemo.cpp:253-420: match + PnP to the best candidate, whole-map
SE3 pose graph with the reference side fixed, rigid update of frames and
points). The matching, PnP and pose graph run on the module's device; the
PnP's samples come from the reference's own key 7, split a candidate as
the reference splits it (`threefry.Key`), so the port draws the
reference's samples, and a run on the card and one on the CPU draw the
same. Which loop a survey closes turns on these draws: a wrong-instance
PnP passes the inlier bar under some keys (ROADMAP.md, the reference's
known faults).
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from ..core.device import resolve_device
from ..core.registry import LOOP_DETECTORS, LOOP_CLOSERS
from ..ops import ba, lie, matching, ransac, threefry
from ..utils import host_se3 as hse3
from .frame import Frame
from .worldmap import WorldMap


@LOOP_DETECTORS.register("GPS")
@LOOP_DETECTORS.register("distance")
class LoopDetectorDistance:
    """Distance-based candidates (LoopDetectorGPS.cpp:28-56): keyframes whose
    camera center lies within max_distance of the query, excluding the
    query's own covisibility neighborhood and recent frames."""

    def __init__(self, wmap: WorldMap, cfg, device=None):
        self.map = wmap
        self.cfg = cfg
        self.device = resolve_device(device)
        self.max_distance = cfg.get_double("SLAM.MaxLoopDistance", 400.0)
        self.min_gap = cfg.get_int("SLAM.LoopMinFrameGap", 20)
        self.min_overlap = cfg.get_double("SLAM.MinLoopOverlap", 0.4)

    def _median_depth(self, frame: Frame) -> float:
        """Scene depth proxy: |camera - median map point| along z (cheap
        stand-in for MapFrame::getMedianDepth over observed points).
        Samples <=256 point positions via the map's strided accessor —
        no full object-list materialization on the per-KF path."""
        sample = self.map.point_position_sample(256)
        if len(sample) < 8:
            return 0.0
        med_z = float(np.median(sample[:, 2]))
        return abs(float(frame.pose_c2w[2]) - med_z)

    def insert(self, frame: Frame):
        pass

    def candidates(self, frame: Frame) -> List[int]:
        out = []
        excluded = set(list(frame.connections)) | {frame.id}
        max_d = self.max_distance
        # once GPS-fitted the reference shrinks the search radius to the
        # frame's own footprint (LoopDetectorGPS.cpp:36-39: corner-ray
        # norm * 2 * medianDepth * (1 - MinLoopOverlap)) — without this,
        # every keyframe of a small survey is a perpetual loop candidate
        if self.cfg.get_bool("GPS.Fitted", False):
            depth = self._median_depth(frame)
            if depth > 0:
                ray = np.linalg.norm([
                    (0 - frame.camera.cx) / frame.camera.fx,
                    (0 - frame.camera.cy) / frame.camera.fy, 1.0])
                max_d = ray * 2.0 * depth * (1.0 - self.min_overlap)
        # one vectorized sweep over the cached center array — no
        # per-candidate Python loop (LoopDetectorGPS.cpp:28-56 semantics)
        ids, ctr = self.map.keyframe_center_arrays()
        if len(ids) == 0:
            return []
        d = np.linalg.norm(ctr - np.asarray(frame.pose_c2w[:3],
                                            np.float32)[None], axis=1)
        ok = (d < max_d) & (frame.id - ids >= self.min_gap)
        if excluded:
            ok &= ~np.isin(ids, np.fromiter(excluded, np.int64))
        sel = np.flatnonzero(ok)
        return [int(i) for i in ids[sel[np.argsort(d[sel])]]]


@LOOP_DETECTORS.register("BoW")
class LoopDetectorBoW:
    """Appearance-based candidates via a BoW inverted file
    (zhaoyong/LoopDetectorBoW.cpp:49-89): keyframes sharing vocabulary words
    with the query, scored 1/commonWords ascending (most-common first).
    Requires a `vocabulary` (ops/vocabulary.Vocabulary); the SLAM system
    wires it from the `Vocabulary` config key."""

    def __init__(self, wmap: WorldMap, cfg, vocabulary=None, device=None):
        self.map = wmap
        self.cfg = cfg
        self.device = resolve_device(device)
        self.vocabulary = vocabulary
        self.min_gap = cfg.get_int("SLAM.LoopMinFrameGap", 20)
        self._inverted: dict = {}          # word -> [frame ids]

    def _words(self, frame: Frame):
        if frame.bow_words is None:
            if self.vocabulary is None or self.vocabulary.empty():
                return None
            wid, w, _ = self.vocabulary.transform_arrays(
                _t(frame.desc, self.device), _t(frame.valid, self.device))
            wid = wid.cpu().numpy()
            frame.bow_words = np.unique(wid[wid >= 0])
        return frame.bow_words

    def insert(self, frame: Frame):
        words = self._words(frame)
        if words is None:
            return
        for w in words:
            self._inverted.setdefault(int(w), []).append(frame.id)

    def candidates(self, frame: Frame) -> List[int]:
        words = self._words(frame)
        if words is None:
            return []
        counts: dict = {}
        excluded = set(list(frame.connections)) | {frame.id}
        for w in words:
            for fid in self._inverted.get(int(w), ()):
                if fid in excluded or frame.id - fid < self.min_gap:
                    continue
                counts[fid] = counts.get(fid, 0) + 1
        # LoopCandidate(score=1/commonWords) sorted ascending == most common
        # words first (LoopDetectorBoW.cpp:83-88)
        ranked = sorted(counts.items(), key=lambda kv: 1.0 / kv[1])
        min_common = self.cfg.get_int("SLAM.LoopMinCommonWords", 8)
        return [fid for fid, c in ranked if c >= min_common]


@LOOP_CLOSERS.register("se3graph")
class LoopCloserSE3Graph:
    def __init__(self, wmap: WorldMap, cfg, detector=None, device=None):
        self.map = wmap
        self.cfg = cfg
        self.device = resolve_device(device)
        self.detector = detector or LoopDetectorDistance(wmap, cfg,
                                                         device=device)
        self._key = threefry.Key(7)
        self.closed_loops = 0
        self.consistent_loops = 0   # verified but already-closed (skipped)
        self._last_close_id = -10 ** 9
        # re-closure cooldown (keyframes) and the correction magnitude
        # below which a verified loop is ALREADY consistent: a whole-map
        # rewrite for a near-identity correction only churns the gauge
        # (every rewrite bumps map.version and invalidates the tracker's
        # staged local map — repeated consistent "closures" on a dense
        # survey were costing ~2/3 of tracked frames in the soak)
        self.min_interval = cfg.get_int("LoopCloser.MinInterval", 5)
        self.min_correction = cfg.get_double("LoopCloser.MinCorrection",
                                             0.25)
        # PnP inlier bar for accepting a loop: 25 matches the reference's
        # LoopCloserDemo verification scale, but REPETITIVE scenes
        # (apartment blocks, row crops) can produce 25-inlier
        # wrong-instance fits - raise on such surveys
        self.min_inliers = cfg.get_double("LoopCloser.MinInliers", 25.0)
        # callback() fired INSIDE the locked rewrite, with the version
        # bump: the tracker's staged local map must be invalidated in the
        # same critical section (same invariant as Mapper.on_map_deformed)
        # so a tracker snapshot can never pair a stale-gauge stage with a
        # post-bump version baseline
        self.on_map_deformed = None

    def try_close(self, frame: Frame) -> bool:
        cands = self.detector.candidates(frame)
        self.detector.insert(frame)     # index the new KF (inverted file)
        if not cands:
            return False
        if frame.id - self._last_close_id < self.min_interval:
            return False                # cooldown after a real closure
        best = self._verify(frame, cands)
        if best is None:
            return False
        kf_id, T_corr = best
        # near-identity correction: the loop is verified AND the map is
        # already metrically consistent there — nothing to close
        dt = float(np.linalg.norm(T_corr[:3] - frame.pose_c2w[:3]))
        dq = float(min(np.linalg.norm(T_corr[3:7] - frame.pose_c2w[3:7]),
                       np.linalg.norm(T_corr[3:7] + frame.pose_c2w[3:7])))
        if dt < self.min_correction and dq < 0.02:
            self.consistent_loops += 1
            return False
        self._close(frame, kf_id, T_corr)
        self.closed_loops += 1
        self._last_close_id = frame.id
        return True

    def _verify(self, frame: Frame, cands: List[int]):
        """Match + PnP against the best candidate
        (LoopCloserDemo.cpp:253-320)."""
        for cid in cands:
            kf = self.map.frame(cid)
            if kf is None:
                continue
            pos = np.zeros((kf.n_kp, 3), np.float32)
            has = np.zeros(kf.n_kp, bool)
            for i in np.nonzero(kf.kp2mp >= 0)[0]:
                mp = self.map.point(int(kf.kp2mp[i]))
                if mp is not None and not mp.bad:
                    pos[i] = mp.position
                    has[i] = True
            if has.sum() < 30:
                continue
            dev = self.device
            idx, ok = matching.match_descriptors(
                _t(kf.desc, dev), _t(has & kf.valid, dev),
                _t(frame.desc, dev), _t(frame.valid, dev),
                kf.desc_kind, ratio=0.8)
            okn = ok.cpu().numpy()
            if okn.sum() < 20:
                continue
            idxn = idx.cpu().numpy()
            n = frame.n_kp
            p3d = np.zeros((n, 3), np.float32)
            w = np.zeros(n, bool)
            sel = np.nonzero(okn & has)[0]
            p3d[idxn[sel]] = pos[sel]
            w[idxn[sel]] = True
            self._key, key = self._key.split()
            res = ransac.find_pnp(key, _t(p3d, dev),
                                  _t(frame.rays[:, :2], dev), _t(w, dev),
                                  threshold=3.0 / frame.camera.fx)
            if bool(res.ok) and float(res.score) >= self.min_inliers:
                # loop-corrected pose of `frame` in world coords
                T_c2w_corr = lie.se3_inv(res.model).cpu().numpy()
                return cid, T_c2w_corr
        return None

    def _close(self, frame: Frame, loop_kf_id: int, T_c2w_corr: np.ndarray):
        """Whole-map SE3 graph (LoopCloserDemo.cpp:327-420): odometry edges
        between consecutive/covisible keyframes + the loop edge; reference
        keyframe (and its parents) fixed; rigid per-refKF update of points."""
        kfs = self.map.keyframes()
        ids = [k.id for k in kfs]
        kidx = {fid: i for i, fid in enumerate(ids)}
        poses_before = np.stack([k.pose_c2w for k in kfs])
        ei, ej, meas, wgt = [], [], [], []

        def add_edge(a, b, Ta, Tb, w=1.0):
            ei.append(kidx[a])
            ej.append(kidx[b])
            meas.append(hse3.se3_mul(np.asarray(Ta, np.float32),
                                     hse3.se3_inv(np.asarray(Tb, np.float32))))
            wgt.append(w)

        for i in range(len(kfs) - 1):
            add_edge(ids[i], ids[i + 1],
                     kfs[i].pose_c2w, kfs[i + 1].pose_c2w)
        for k in kfs:
            # snapshot: the mapper worker refreshes connection dicts
            # concurrently (RuntimeError: dict changed size otherwise)
            for cid in list(k.connections):
                if cid in kidx and cid > k.id:
                    # read through the SNAPSHOT (kfs), not the live map:
                    # the mapper worker can cull a keyframe concurrently
                    add_edge(k.id, cid, k.pose_c2w,
                             kfs[kidx[cid]].pose_c2w, 1.0)
        # the loop edge uses the PnP-corrected pose
        add_edge(loop_kf_id, frame.id,
                 kfs[kidx[loop_kf_id]].pose_c2w, T_c2w_corr, w=5.0)
        fixed = np.zeros(len(kfs), bool)
        fixed[kidx[loop_kf_id]] = True
        if len(kfs) > 1:
            fixed[0] = True
        # pad the graph to the reference's capacity quanta (the same
        # problem in both packages); padded poses are fixed identities,
        # padded edges weight 0
        from ..utils.padding import pad_to, round_capacity
        F = round_capacity(len(kfs), 64)
        E = round_capacity(len(ei), 256)
        poses_p, pm = pad_to(poses_before.astype(np.float32), F)
        poses_p[~pm] = np.array([0, 0, 0, 0, 0, 0, 1.0], np.float32)
        fixed_p, _ = pad_to(fixed, F, True)
        fixed_p[~pm] = True
        ei_p, _ = pad_to(np.asarray(ei, np.int32), E)
        ej_p, _ = pad_to(np.asarray(ej, np.int32), E)
        meas_p, em = pad_to(np.stack(meas).astype(np.float32), E)
        meas_p[~em] = np.array([0, 0, 0, 0, 0, 0, 1.0], np.float32)
        wgt_p, _ = pad_to(np.asarray(wgt, np.float32), E)
        iters = self.cfg.get_int("SLAM.LoopGraphIters", 30)
        # whole-map graphs beyond ~96 KFs use the matrix-free CG solver
        # (O(E) memory); small graphs use the exact dense Schur path
        dev = self.device
        solve = (ba.optimize_se3_graph_cg
                 if F > self.cfg.get_int("SLAM.LoopGraphDenseMax", 96)
                 else ba.optimize_se3_graph)
        new_poses, cost = solve(
            _t(poses_p, dev), _t(fixed_p, dev), _t(ei_p, dev),
            _t(ej_p, dev), _t(meas_p, dev), _t(wgt_p, dev), iters=iters)
        new_poses_t = new_poses[:len(kfs)]
        new_poses = new_poses_t.cpu().numpy()
        # rigid update of points via their reference keyframe's correction,
        # BATCHED (one call for all corrections, one for all points) and
        # under the map's update_lock so the tracker never sees a
        # half-moved map
        corr = lie.se3_mul(new_poses_t, lie.se3_inv(
            _t(poses_before.astype(np.float32), dev)))        # [F, 7]
        with self.map.update_lock:
            pts = self.map.points()
            if pts:
                ridx = np.asarray(
                    [kidx.get(mp.ref_frame, 0) for mp in pts], np.int32)
                pos = np.stack([mp.position for mp in pts])
                newpos = lie.se3_apply(
                    corr[torch.from_numpy(ridx).to(dev).long()],
                    _t(pos.astype(np.float32), dev)).cpu().numpy()
                for mp, x in zip(pts, newpos):
                    mp.position = x.astype(np.float32)
            for fid in ids:
                fr = self.map.frame(fid)
                if fr is None:
                    # the mapper worker CULLED this keyframe between the
                    # graph snapshot and this write-back (keyframe culling
                    # runs concurrently in online mode) — nothing to move
                    continue
                fr.pose_c2w = new_poses[kidx[fid]].astype(np.float32)
            # bump inside the lock so a tracker snapshot between rewrite
            # and bump isn't spuriously discarded by the version check
            self.map.version += 1
            if self.on_map_deformed is not None:
                self.on_map_deformed()


def _t(a, device):
    """A host array as a tensor on `device`."""
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)
