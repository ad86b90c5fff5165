"""Pluggable two-view matchers behind the MATCHERS registry.

Port of pislamfusion_tpu/models/matchers.py. The reference ships a family
of Matcher plugins selected by `Matcher?=` (GSLAM-DIYSLAM/src/Matcher.h +
zhaoyong/MatcherMultiH.cpp, MatcherBFMultiH.cpp, MatcherBF variants);
DIYSLAM's two-view initialization and relocalization call whichever is
configured. Each entry wraps ops on the matcher's device with the uniform
signature

    matcher(key, frame_a, frame_b) -> (idx [Na] int32, ok [Na] bool)

where idx maps a-keypoints to b-keypoints (tensors on the matcher's
device) and `key` is the reference's own key (`threefry.Key`, the
tracker's), which the matchers that draw RANSAC samples (multiH, bowH,
BFMultiH) split as the reference does; the others ignore it.

Selection: `MATCHERS.create(cfg.get_string("Matcher", "multiH"), cfg,
device=...)`; `device` None means `cuda`.
"""
from __future__ import annotations

import torch

from ..core.device import resolve_device
from ..core.registry import MATCHERS
from ..ops import matching, multih


def _arrays(frame, device):
    """The frame's (desc, valid, xy, angle) as tensors on `device`: its
    device features where they are there, else its host copies."""
    fd = frame.feats_dev
    if fd is not None and all(k in fd for k in ("desc", "valid", "xy",
                                                "angle")) \
            and fd["xy"].device == device:
        return fd["desc"], fd["valid"], fd["xy"], fd["angle"]
    return tuple(torch.from_numpy(getattr(frame, k)).to(device)
                 for k in ("desc", "valid", "xy", "angle"))


@MATCHERS.register("BF")
class MatcherBF:
    """Plain cross-checked brute-force match + ratio test + rotation
    histogram — the reference's baseline Matcher (MatcherBF variants;
    ratio 0.8 per MatcherBoW.cpp:133-174 thresholds)."""

    def __init__(self, cfg=None, device=None):
        self.device = resolve_device(device)
        self.ratio = cfg.get_double("Matcher.Ratio", 0.8) if cfg else 0.8

    def __call__(self, key, fa, fb):
        desc_a, valid_a, _, ang_a = _arrays(fa, self.device)
        desc_b, valid_b, _, ang_b = _arrays(fb, self.device)
        idx, ok = matching.match_descriptors(
            desc_a, valid_a, desc_b, valid_b, fa.desc_kind,
            ratio=self.ratio)
        ok = matching.rotation_consistency_mask(ang_a, ang_b, idx, ok)
        return idx, ok


@MATCHERS.register("BoW")
@MATCHERS.register("bow")
@MATCHERS.register("liu_bow")
@MATCHERS.register("hybird")
class MatcherBoW:
    """FeatureVector-aligned BF (MatcherBoW.cpp:186-300): candidates
    restricted to features sharing the vocabulary node `levelsup` levels
    above the leaves, then cross-check + ratio. The bucket walk becomes a
    dense node-equality mask on the distance matrix — identical candidate
    set. Falls back to plain
    BF when no (compatible) vocabulary is available (the reference
    crashes instead; a silent-degrade matches DIYSLAM's vocab-optional
    spirit, logged once). The `hybird` registration (MatcherHybird.cpp —
    a bow attempt with FLANN fallback whose bow branch is commented out)
    and the `liu_bow` student variant collapse here: bucketed-with-
    fallback IS this class's behavior."""

    def __init__(self, cfg=None, vocabulary=None, device=None):
        self.device = resolve_device(device)
        self.ratio = cfg.get_double("Matcher.Ratio", 0.8) if cfg else 0.8
        self.levelsup = cfg.get_int("Matcher.LevelsUp", 4) if cfg else 4
        self._cfg = cfg
        self._vocab = vocabulary
        self._vocab_tried = vocabulary is not None
        self._nids: dict = {}                # frame id -> node ids
        self._warned = False

    def _vocabulary(self, kind: str = "orb"):
        if not self._vocab_tried:
            self._vocab_tried = True
            import os
            # accept the SLAM.Vocabulary alias here too — relying on
            # SLAM.__init__ to have resolved it first breaks standalone
            # MATCHERS.create(cfg) construction
            from .slam import resolve_vocab_path
            path = resolve_vocab_path(self._cfg) if self._cfg else ""
            # both loaders are memoized, so this shares ONE instance (and
            # one set of device descent tables) with SLAM's BoW detector
            from .slam import _default_vocabulary, _load_vocabulary_cached
            if path and os.path.isfile(path):
                self._vocab = _load_vocabulary_cached(path)
            if self._vocab is None:
                self._vocab = _default_vocabulary(
                    "sift" if kind == "sift" else "orb")
        return self._vocab

    def _node_ids(self, frame):
        nid = self._nids.get(frame.id)
        if nid is None:
            vocab = self._vocabulary(getattr(frame, "desc_kind", "orb"))
            # clamp to the vocab depth: levelsup >= L would bucket at the
            # root (node level L - levelsup <= 0 -> one bucket == plain
            # BF); keep at least one branching level
            lvl = min(self.levelsup, vocab.L - 1)
            desc, valid = _arrays(frame, self.device)[:2]
            _, _, nid = vocab.transform_arrays(desc, valid, lvl)
            if len(self._nids) > 16:        # two-view + reloc working set
                self._nids.clear()
            self._nids[frame.id] = nid
        return nid

    def __call__(self, key, fa, fb):
        vocab = self._vocabulary(getattr(fa, "desc_kind", "orb"))
        desc_a, valid_a, _, ang_a = _arrays(fa, self.device)
        desc_b, valid_b, _, ang_b = _arrays(fb, self.device)
        if vocab is None or (vocab.is_binary != (fa.desc_kind == "orb")):
            if not self._warned:
                from ..core.glog import logger
                logger.warning("Matcher=BoW: no compatible vocabulary; "
                               "matching unbucketed (BF)")
                self._warned = True
            idx, ok = matching.match_descriptors(
                desc_a, valid_a, desc_b, valid_b, fa.desc_kind,
                ratio=self.ratio)
        else:
            idx, ok = matching.match_descriptors_bucketed(
                desc_a, valid_a, self._node_ids(fa),
                desc_b, valid_b, self._node_ids(fb),
                fa.desc_kind, ratio=self.ratio)
        ok = matching.rotation_consistency_mask(ang_a, ang_b, idx, ok)
        return idx, ok


@MATCHERS.register("flann")
@MATCHERS.register("flanntest")
@MATCHERS.register("SiftGPU")
@MATCHERS.register("liu_SiftGPU")
class MatcherFlann(MatcherBF):
    """The reference's MatcherFlann (FLANN cross-check, MatcherFlann.cpp)
    — FLANN's approximate NN exists to dodge CPU brute-force cost; on the
    device the exact distance matrix IS the cheap path, so this is exact BF
    with the same cross-check/ratio gates (a strict quality upper bound
    of the approximate search). The `SiftGPU` matcher registrations
    (SiftMatchCU.cpp's GPU brute force) collapse here for the same
    reason; `flanntest` was its debug twin."""


@MATCHERS.register("multiH")
@MATCHERS.register("flannH")
@MATCHERS.register("flann_multiH")
@MATCHERS.register("bf_knn_multiH")
class MatcherMultiH:
    """The reference's DEFAULT matcher: conservative BF base + multi-
    homography window growth (MatcherMultiH.cpp:197-450). The
    `flannH`/`flann_multiH`/`bf_knn_multiH` registrations (FLANN or
    knn-ratio BF base + the same growth) collapse here: the exact
    distance matrix already IS the knn-ratio base, so the variants
    differ only in the approximate-NN engine this build doesn't need."""

    def __init__(self, cfg=None, device=None):
        self.device = resolve_device(device)
        self.n_h = cfg.get_int("Matcher.MaxHomographies", 4) if cfg else 4
        self.window = cfg.get_double("Matcher.Window", 8.0) if cfg else 8.0

    def __call__(self, key, fa, fb):
        desc_a, valid_a, xy_a, ang_a = _arrays(fa, self.device)
        desc_b, valid_b, xy_b, ang_b = _arrays(fb, self.device)
        idx, ok, _ = multih.match_multih(
            key, desc_a, valid_a, xy_a, desc_b, valid_b, xy_b,
            kind=fa.desc_kind, n_h=self.n_h, window=self.window)
        ok = matching.rotation_consistency_mask(ang_a, ang_b, idx, ok)
        return idx, ok


@MATCHERS.register("bowH")
@MATCHERS.register("bow_homography")
class MatcherBoWH(MatcherBoW):
    """BoW-bucketed base + multi-homography window growth — the
    reference's `bowH`/`bow_homography` registrations (MatcherMultiH's
    growth over MatcherBoW's FeatureVector-aligned base; MatcherMultiH.cpp
    itself buckets its base by FeatureVector when one exists, :197-270).
    The node-equality mask narrows the BASE candidates; the homography
    growth pass stays unrestricted, recovering cross-bucket matches the
    bucketing would drop. Falls back to the plain multiH base when no
    compatible vocabulary is available (logged once by the parent)."""

    def __init__(self, cfg=None, vocabulary=None, device=None):
        super().__init__(cfg, vocabulary, device)
        self.n_h = cfg.get_int("Matcher.MaxHomographies", 4) if cfg else 4
        self.window = cfg.get_double("Matcher.Window", 8.0) if cfg else 8.0

    def __call__(self, key, fa, fb):
        vocab = self._vocabulary(getattr(fa, "desc_kind", "orb"))
        desc_a, valid_a, xy_a, ang_a = _arrays(fa, self.device)
        desc_b, valid_b, xy_b, ang_b = _arrays(fb, self.device)
        base_mask = None
        if vocab is not None and (vocab.is_binary == (fa.desc_kind == "orb")):
            nid_a, nid_b = self._node_ids(fa), self._node_ids(fb)
            base_mask = (nid_a[:, None] == nid_b[None, :]) \
                & (nid_a >= 0)[:, None]
        elif not self._warned:
            from ..core.glog import logger
            logger.warning("Matcher=bowH: no compatible vocabulary; "
                           "base match unbucketed (multiH)")
            self._warned = True
        idx, ok, _ = multih.match_multih(
            key, desc_a, valid_a, xy_a, desc_b, valid_b, xy_b,
            kind=fa.desc_kind, n_h=self.n_h, window=self.window,
            base_mask=base_mask)
        ok = matching.rotation_consistency_mask(ang_a, ang_b, idx, ok)
        return idx, ok


@MATCHERS.register("BFMultiH")
@MATCHERS.register("bf_multiH")
@MATCHERS.register("zy_bfMultiH")
class MatcherBFMultiH:
    """MatcherBFMultiH.cpp:296-490: cross-check BF, best-run rotation
    vote, F-RANSAC prune, peel <=5 homographies, epipolar-guided window
    re-match. Stricter base than multiH (F gate), denser growth."""

    def __init__(self, cfg=None, device=None):
        self.device = resolve_device(device)
        self.n_h = cfg.get_int("Matcher.MaxHomographies", 5) if cfg else 5
        self.window = cfg.get_double("Matcher.Window", 8.0) if cfg else 8.0

    def __call__(self, key, fa, fb):
        desc_a, valid_a, xy_a, ang_a = _arrays(fa, self.device)
        desc_b, valid_b, xy_b, ang_b = _arrays(fb, self.device)
        idx, ok, _ = multih.match_bf_multih(
            key, desc_a, valid_a, xy_a, ang_a,
            desc_b, valid_b, xy_b, ang_b,
            kind=fa.desc_kind, n_h=self.n_h,
            window=max(self.window, fa.camera.width / 64.0
                       if fa.camera is not None else self.window))
        return idx, ok
