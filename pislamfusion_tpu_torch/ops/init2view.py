"""Two-view initialization: parallel H/F RANSAC scoring, model selection,
motion recovery, initial triangulation.

Port of pislamfusion_tpu/ops/init2view.py (the ORB-SLAM-style initializer
of InitializerSVD.cpp): H (4-point DLT) and F (8-point) hypothesis
batches, the score ratio RH > 0.40 choosing the homography (:167-174),
the 8 Faugeras motions of H (ReconstructH) and the 4 of the essential
matrix (ReconstructF), all 12 put through one batched cheirality and
reprojection test (CheckRT :380-520). Normalized camera coordinates
throughout, so F is the essential matrix.

SVD signs differ between LAPACK builds and cuSOLVER, and a sign flip
permutes the 8 H motions and the 4 E motions; the chosen motion (the
first with the most good points) and its mask do not change with it.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from . import lie, ransac, threefry


class TwoViewResult(NamedTuple):
    ok: torch.Tensor          # scalar bool
    T_c2w: torch.Tensor       # [7] second camera pose (first = identity)
    points: torch.Tensor      # [N, 3] triangulated (garbage where ~mask)
    mask: torch.Tensor        # [N] bool triangulated inliers
    used_h: torch.Tensor      # scalar bool: homography model chosen


def _score(errs, th, gamma):
    """ORB-SLAM CheckHomography/CheckFundamental scoring: sum of
    (gamma - e) over inliers."""
    return torch.where(errs < th, gamma - errs, 0.0).sum(-1)


def _decompose_e(E):
    """4 motion candidates (R, t) from an essential matrix."""
    U, _, Vh = torch.linalg.svd(E)
    # enforce det +1
    U = U * torch.sign(torch.linalg.det(U))
    Vh = Vh * torch.sign(torch.linalg.det(Vh))
    W = torch.tensor([[0.0, -1, 0], [1, 0, 0], [0, 0, 1]], dtype=E.dtype,
                     device=E.device)
    R1 = U @ W @ Vh
    R2 = U @ W.T @ Vh
    t = U[:, 2]
    t = t / torch.clamp(torch.linalg.vector_norm(t), min=1e-12)
    return torch.stack([R1, R1, R2, R2]), torch.stack([t, -t, t, -t])


def _decompose_h(H):
    """Faugeras SVD decomposition of a (normalized-coords) homography into
    8 motion hypotheses (InitializerSVD::ReconstructH)."""
    U, S, Vh = torch.linalg.svd(H)
    d1, d2, d3 = S[0], S[1], S[2]
    s = torch.linalg.det(U) * torch.linalg.det(Vh)
    d2c = torch.clamp(d2, min=1e-9)
    den = torch.clamp(d1 * d1 - d3 * d3, min=1e-12)
    aux1 = torch.sqrt(torch.clamp((d1 * d1 - d2 * d2) / den, min=0.0))
    aux3 = torch.sqrt(torch.clamp((d2 * d2 - d3 * d3) / den, min=0.0))
    x1s = torch.stack([aux1, aux1, -aux1, -aux1])
    x3s = torch.stack([aux3, -aux3, aux3, -aux3])
    root = torch.sqrt(torch.clamp((d1 * d1 - d2 * d2) * (d2 * d2 - d3 * d3),
                                  min=0.0))
    st_signs = torch.tensor([1.0, -1.0, -1.0, 1.0], dtype=H.dtype,
                            device=H.device)
    zero, one = torch.zeros_like(d1), torch.ones_like(d1)
    Rs, ts = [], []
    # case d' > 0
    aux_st = root / torch.clamp((d1 + d3) * d2c, min=1e-12)
    ct = (d2 * d2 + d1 * d3) / torch.clamp((d1 + d3) * d2c, min=1e-12)
    for i in range(4):
        st = st_signs[i] * aux_st
        Rp = torch.stack([ct, zero, -st, zero, one, zero, st, zero, ct]
                         ).reshape(3, 3)
        tp = (d1 - d3) * torch.stack([x1s[i], zero, -x3s[i]])
        Rs.append(s * U @ Rp @ Vh)
        ts.append(U @ tp)
    # case d' < 0
    aux_sp = root / torch.clamp((d1 - d3) * d2c, min=1e-12)
    cp = (d1 * d3 - d2 * d2) / torch.clamp((d1 - d3) * d2c, min=1e-12)
    for i in range(4):
        sp = st_signs[i] * aux_sp
        Rp = torch.stack([cp, zero, sp, zero, -one, zero, sp, zero, -cp]
                         ).reshape(3, 3)
        tp = (d1 + d3) * torch.stack([x1s[i], zero, x3s[i]])
        Rs.append(s * U @ Rp @ Vh)
        ts.append(U @ tp)
    ts = torch.stack(ts)
    ts = ts / torch.clamp(torch.linalg.vector_norm(ts, dim=-1, keepdim=True),
                          min=1e-12)
    return torch.stack(Rs), ts


def _check_rt(Rs, ts, ra, rb, valid, reproj_th2: float,
              min_parallax_cos: float = 0.99998):
    """Cheirality + reprojection test of candidates (Rs [C, 3, 3], ts
    [C, 3]) (InitializerSVD::CheckRT). ra, rb: [N, 3] normalized rays
    (z=1). Camera a at the origin; b: x_b = R x_a + t. Returns (ngood [C],
    good [C, N], points [C, N, 3])."""
    T_b_w2c = lie.se3(ts, lie.quat_from_matrix(Rs))
    T_a_c2w = lie.se3_identity(dtype=ra.dtype, device=ra.device)
    T_b_c2w = lie.se3_inv(T_b_w2c)
    X, depth_a = ransac.triangulate(T_a_c2w.expand(T_b_c2w.shape), T_b_c2w,
                                    ra, rb)
    pb = lie.se3_apply(T_b_w2c[:, None, :], X)

    def reproj(p, r):
        z = torch.where(torch.abs(p[..., 2:]) < 1e-9, 1e-9, p[..., 2:])
        return torch.sum((p[..., :2] / z - r[:, :2]) ** 2, -1)

    ea, eb = reproj(X, ra), reproj(pb, rb)
    cosp = ransac.parallax_cos(T_a_c2w.expand(T_b_c2w.shape), T_b_c2w, X)
    finite = torch.all(torch.isfinite(X), -1)
    good = (valid & finite & (depth_a > 0) & (pb[..., 2] > 0)
            & (ea < reproj_th2) & (eb < reproj_th2)
            & (cosp < min_parallax_cos) & (cosp > 0.0))
    return good.sum(-1), good, X


def _initialize_two_view_from_samples(idx_h, idx_f, ra_xy, rb_xy, valid,
                                      sigma: float = 0.004,
                                      lo_topk: int = 1):
    """`initialize_two_view` on drawn samples: idx_h [iters, 4] for H,
    idx_f [iters, 8] for F."""
    sig = ransac._f32(sigma, ra_xy)
    resH = ransac._find_homography_from_samples(
        idx_h, ra_xy, rb_xy, valid, threshold=2.447 * sig, lo_topk=lo_topk)
    resF = ransac._find_fundamental_from_samples(
        idx_f, ra_xy, rb_xy, valid, threshold=1.96 * sig, lo_topk=lo_topk)
    s2 = sig * sig
    # ORB-SLAM: thH = 5.99 sigma^2 per direction; F: 3.84, gamma 5.99
    eh = ransac._h_transfer_err(resH.model, ra_xy, rb_xy)
    ef = ransac._f_epipolar_err(resF.model, ra_xy, rb_xy)
    sh = _score(torch.where(valid, eh / s2, torch.inf), 2 * 5.991, 2 * 5.991)
    sf = _score(torch.where(valid, ef / s2, torch.inf), 2 * 3.841, 2 * 5.991)
    use_h = sh / torch.clamp(sh + sf, min=1e-9) > 0.40

    # candidate motions from both models; all 12 evaluated together
    RsH, tsH = _decompose_h(resH.model)
    RsF, tsF = _decompose_e(resF.model)
    Rs = torch.cat([RsH, RsF], 0)
    ts = torch.cat([tsH, tsF], 0)
    from_h = torch.arange(12, device=Rs.device) < 8
    cand_ok = torch.where(use_h, from_h, ~from_h)
    ra = torch.cat([ra_xy, torch.ones_like(ra_xy[:, :1])], -1)
    rb = torch.cat([rb_xy, torch.ones_like(rb_xy[:, :1])], -1)
    model_inliers = torch.where(use_h, resH.inliers, resF.inliers)
    reproj_th2 = 4.0 * s2 * 5.991
    ngood, good, X = _check_rt(Rs, ts, ra, rb, model_inliers, reproj_th2)
    ngood = torch.where(cand_ok, ngood, -1)
    best = lie.first_argmax(ngood)
    n1 = ngood.max()
    # the runner-up must be clearly worse (ORB-SLAM: nsimilar < 0.7 nGood)
    second = torch.where(torch.arange(12, device=Rs.device) == best, -1,
                         ngood).max()
    nin = model_inliers.sum()
    ok = (n1 >= 8) & (n1 > 0.5 * nin) & (second < 0.8 * n1)
    T_w2c = lie.se3(ts[best], lie.quat_from_matrix(Rs[best]))
    return TwoViewResult(ok=ok, T_c2w=lie.se3_inv(T_w2c), points=X[best],
                         mask=good[best], used_h=use_h)


def initialize_two_view(key: threefry.Key, ra_xy, rb_xy, valid,
                        sigma: float = 0.004, iters: int = 256,
                        lo_topk: int = 1):
    """Full two-view bootstrap. ra_xy, rb_xy: [N, 2] normalized coords of
    matched keypoints in frames a/b; sigma: measurement noise in
    normalized units (~1 px / f). Returns TwoViewResult; the translation
    has unit norm (the monocular scale gauge)."""
    n = ra_xy.shape[0]
    k_h, k_f = key.split()              # as the reference splits its key
    idx_h = ransac.sample_indices(k_h, n, valid, iters, 4)
    idx_f = ransac.sample_indices(k_f, n, valid, iters, 8)
    return _initialize_two_view_from_samples(idx_h, idx_f, ra_xy, rb_xy,
                                             valid, sigma, lo_topk)
