"""Pluggable two-view initializers behind the INITIALIZERS registry.

Port of pislamfusion_tpu/models/initializers.py: the reference selects its
bootstrap geometry with `Initializer?=` (GSLAM-DIYSLAM/src/Initializer.h:
22-34): `svd` (InitializerSVD.cpp, the parallel H/F RANSAC with model
selection and cheirality reconstruction), `opt` (InitializerOpt.cpp, a
joint SE3 + per-match inverse-depth LM from the identity), and `eigen` /
`svdzm`, numerically `svd`. Every entry has the signature

    initializer(key, rays_a [N,2], rays_b [N,2], valid [N], sigma)
        -> TwoViewResult  (ok, T_c2w of the second camera, points in the
                           first camera's frame, inlier mask, used_h)

on the rays' device; `key` is the reference's own key (`threefry.Key`,
the tracker's, split as the reference splits its JAX key).
`InitializerOpt` reads its counts back to the host for its gates, as the
reference does. Selection:
`create_initializer(cfg)` with the port's `Svar` as the config.
"""
from __future__ import annotations

import torch

from ..core.registry import ESTIMATORS, INITIALIZERS
from ..ops import ba, init2view, lie

# --- Estimator?= seam (GSLAM/core/Estimator.h plugin): the backends differ
# only in the RANSAC local-optimization policy, so a profile resolves to
# the lo_topk passed to ops.ransac.
ESTIMATORS.register("OpenCV", lambda cfg=None: 1)       # EstimatorOpenCV.cpp
ESTIMATORS.register("opencv", lambda cfg=None: 1)
ESTIMATORS.register(                                     # liuguochen/
    "LORANSAC",                                          # EstimatorLORANSAC.cpp
    lambda cfg=None: cfg.get_int("Estimator.LOTopK", 8) if cfg else 8)
ESTIMATORS.register(
    "loransac",
    lambda cfg=None: cfg.get_int("Estimator.LOTopK", 8) if cfg else 8)


def estimator_lo_topk(cfg) -> int:
    """Resolve `Estimator?=` to the LO-RANSAC top-K (1 = plain best-refit)."""
    name = cfg.get_string("Estimator", "OpenCV") if cfg else "OpenCV"
    try:
        return ESTIMATORS.create(name, cfg)
    except KeyError:
        from ..core.glog import logger
        logger.warning(f"Estimator '{name}' unknown; using OpenCV")
        return 1


@INITIALIZERS.register("svd")
@INITIALIZERS.register("eigen")
@INITIALIZERS.register("svdzm")
class InitializerSVD:
    """InitializerSVD.cpp: parallel H (4-point DLT) / F (8-point) RANSAC,
    score ratio RH > 0.40 model selection, ReconstructH/ReconstructF
    cheirality (`ops.init2view.initialize_two_view`)."""

    def __init__(self, cfg=None):
        self.iters = cfg.get_int("Initializer.RansacIters", 256) \
            if cfg else 256
        self.lo_topk = estimator_lo_topk(cfg)

    def __call__(self, key, ra, rb, valid, sigma: float = 0.004):
        return init2view.initialize_two_view(key, ra, rb, valid,
                                             sigma=sigma, iters=self.iters,
                                             lo_topk=self.lo_topk)

    def from_samples(self, idx_h, idx_f, ra, rb, valid,
                     sigma: float = 0.004):
        """The same on drawn samples: idx_h [iters, 4], idx_f [iters, 8]."""
        return init2view._initialize_two_view_from_samples(
            idx_h, idx_f, ra, rb, valid, sigma=sigma, lo_topk=self.lo_topk)


@INITIALIZERS.register("opt")
@INITIALIZERS.register("opt_svd")
class InitializerOpt:
    """InitializerOpt.cpp: no model selection; one joint SE3 + per-match
    inverse-depth epipolar LM from the identity pose
    (`ops.ba.optimize_pose_invdepth`), with the reference's gates: ray
    disparity > 0.05 for >= 20% of the matches (:52-60), translation >
    0.03 after the solve (:69-73), depth in (1/20, 10) with squared
    reprojection < 1e-5 and in front of the second camera (:79-88), and
    > 50 points that are over half of the valid matches (:90-95). The
    key is not used: the solve draws nothing."""

    def __init__(self, cfg=None):
        self.iters = cfg.get_int("Initializer.OptIters", 24) if cfg else 24

    def __call__(self, key, ra, rb, valid, sigma: float = 0.004):
        dev = ra.device
        ra = ra.to(torch.float32)
        rb = rb.to(torch.float32)
        valid = valid.to(torch.bool)
        n = ra.shape[0]
        n_valid = int(valid.sum())
        disp = torch.linalg.vector_norm(rb - ra, dim=-1)
        n_base = int((valid & (disp > 0.05)).sum())
        ident = lie.se3_identity(device=dev)
        false_res = init2view.TwoViewResult(
            ok=torch.tensor(False, device=dev), T_c2w=ident,
            points=torch.zeros((n, 3), device=dev),
            mask=torch.zeros(n, dtype=torch.bool, device=dev),
            used_h=torch.tensor(False, device=dev))
        if n_base * 5 < n_valid or n_valid < 8:   # :52-60
            return false_res
        T_w2c, _, idepth, chi2_2d, _ = ba.optimize_pose_invdepth(
            ident, ident, ra, rb, valid.to(torch.float32),
            torch.ones(n, device=dev), torch.zeros((1, 3), device=dev),
            torch.zeros((1, 2), device=dev), torch.zeros(1, device=dev),
            iters=self.iters, huber_delta=3.0 * max(sigma, 1e-4))
        T_c2w = lie.se3_inv(T_w2c)
        if float(torch.linalg.vector_norm(T_c2w[:3])) < 0.03:   # :69-73
            return false_res
        ray3 = torch.cat([ra, torch.ones_like(ra[:, :1])], -1)
        points = ray3 / torch.clamp(idepth, min=1e-6)[:, None]
        # :79-88, and in front of the second camera (a residual there is
        # zeroed, so chi2 alone would pass a match behind it)
        pc2 = lie.se3_apply(T_w2c, points)
        mask = (valid & (idepth > 0.1) & (idepth < 20.0)
                & (chi2_2d < 1e-5) & (pc2[:, 2] > 1e-6))
        n_pts = int(mask.sum())
        ok = (n_pts > 50) and (2 * n_pts > n_valid)    # :90-95
        return init2view.TwoViewResult(
            ok=torch.tensor(ok, device=dev), T_c2w=T_c2w, points=points,
            mask=mask, used_h=torch.tensor(False, device=dev))


def create_initializer(cfg):
    """The tracker-facing factory: `Initializer?=`, an unknown name warned
    about and replaced by `svd` (the reference LOG(FATAL)s,
    TrackerOpt.cpp:295)."""
    name = cfg.get_string("Initializer", "svd") if cfg else "svd"
    try:
        return INITIALIZERS.create(name, cfg)
    except KeyError:
        from ..core.glog import logger
        logger.warning(f"Initializer '{name}' unknown; using svd")
        return InitializerSVD(cfg)
