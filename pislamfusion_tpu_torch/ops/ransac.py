"""Robust geometric estimators as fixed-budget batched RANSAC.

Port of pislamfusion_tpu/ops/ransac.py (the Estimator plugin,
EstimatorOpenCV.cpp; the two-view RANSAC of InitializerSVD.cpp:150-520;
the 3-point plane RANSAC of src/RANSAC.cpp:52-101). A sweep samples
[iters, k] minimal sets, solves every hypothesis in one batched SVD or
eigh, scores all of them against all points in one [iters, N] residual
matrix and takes the first hypothesis with the most inliers. Everything is
padded and masked, and nothing is read back to the host: the result's
`ok` stays a tensor.

Randomness: each public estimator takes a `torch.Generator` and draws its
samples as the reference does, with a Gumbel top-k a hypothesis (uniform
without replacement over the valid points), on the generator's device.
`find_pnp` also takes a `threefry.Key`, and then draws the reference's own
samples for that key (its Gumbel noise made on the CPU).
Each also has a `_..._from_samples` variant that takes the drawn indices
[iters, k], so that the same samples can be handed to two runs (the JAX
package's and this one, or the card's and the CPU's).

Ties: the best hypothesis is the first of equal inlier counts, and
LO-RANSAC's top-k of counts orders equal counts by index, as
`jnp.argmax` and `jax.lax.top_k` do (a stable descending sort).

SVD and eigh signs differ between LAPACK builds and cuSOLVER. Every model
here is invariant to them (H, P and the plane's normal are normalised or
sign-fixed; a null vector enters only through a ratio), except F, which
is normalised by its norm and so is defined up to sign.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from . import lie, threefry


class RansacResult(NamedTuple):
    model: torch.Tensor     # model parameters (shape depends on estimator)
    inliers: torch.Tensor   # [N] bool
    score: torch.Tensor     # scalar: inlier count
    ok: torch.Tensor        # scalar bool


# ---------------------------------------------------------------------------
# sampling
# ---------------------------------------------------------------------------

def gumbel(generator, shape, dtype=torch.float32):
    """Standard Gumbel noise of `shape`, drawn on the generator's device
    (a `threefry.Key`'s float32 noise, on the CPU)."""
    if isinstance(generator, threefry.Key):
        return generator.gumbel(shape)
    u = torch.rand(shape, generator=generator, dtype=dtype,
                   device=generator.device)
    tiny = torch.finfo(dtype).tiny
    return -torch.log(-torch.log(u.clamp(tiny, 1.0 - 1e-7)))


def top_k_indices(g, valid, k: int):
    """[iters, k] indices of each row's k largest noise values among the
    valid points: the Gumbel top-k trick, uniform without replacement."""
    g = torch.where(valid[None, :].to(g.device), g,
                    torch.full_like(g, -math.inf))
    return torch.topk(g, k, -1).indices


def sample_indices(generator, n_pts: int, valid, iters: int, k: int):
    """[iters, k] indices drawn uniformly from the valid points, on
    `valid`'s device."""
    g = gumbel(generator, (iters, n_pts))
    return top_k_indices(g, valid, k).to(valid.device)


def _top_k_stable(x, k: int):
    """Indices of the k largest of a 1-D tensor, equal values by index."""
    return torch.sort(x, descending=True, stable=True).indices[:k]


def _f32(x, like):
    return torch.as_tensor(x, dtype=torch.float32, device=like.device)


# ---------------------------------------------------------------------------
# minimal and all-point solvers, batched over leading dims
# ---------------------------------------------------------------------------

def _homog(p):
    return torch.cat([p, torch.ones_like(p[..., :1])], -1)


def _normalize_2d(pts, valid):
    """Hartley normalization over valid points: T s.t. mean 0, rms
    sqrt(2)."""
    n = torch.clamp(valid.sum(), min=1)
    mean = torch.where(valid[:, None], pts, 0.0).sum(0) / n
    d = torch.sqrt(torch.sum((pts - mean) ** 2, -1))
    md = torch.where(valid, d, 0.0).sum() / n
    s = math.sqrt(2.0) / torch.clamp(md, min=1e-9)
    z = torch.zeros_like(s)
    o = torch.ones_like(s)
    T = torch.stack([s, z, -s * mean[0], z, s, -s * mean[1], z, z, o]
                    ).reshape(3, 3)
    return (pts - mean) * s, T


def _h_rows(pa, pb):
    x, y = pa[..., 0], pa[..., 1]
    u, v = pb[..., 0], pb[..., 1]
    z = torch.zeros_like(x)
    o = torch.ones_like(x)
    r1 = torch.stack([x, y, o, z, z, z, -u * x, -u * y, -u], -1)
    r2 = torch.stack([z, z, z, x, y, o, -v * x, -v * y, -v], -1)
    return r1, r2


def _f_rows(pa, pb):
    x, y = pa[..., 0], pa[..., 1]
    u, v = pb[..., 0], pb[..., 1]
    o = torch.ones_like(x)
    return torch.stack([u * x, u * y, u, v * x, v * y, v, x, y, o], -1)


def _null_vector(A, full: bool):
    """The right singular vector of A's smallest singular value."""
    return torch.linalg.svd(A, full_matrices=full).Vh[..., -1, :]


def _h_from_4pt(pa, pb):
    """DLT homography from 4 correspondences. pa, pb: [..., 4, 2] ->
    [..., 3, 3]."""
    r1, r2 = _h_rows(pa, pb)
    A = torch.cat([r1, r2], -2)                  # [..., 8, 9]
    return _null_vector(A, True).reshape(A.shape[:-2] + (3, 3))


def _h_dlt_weighted(pa, pb, w):
    """All-point weighted DLT homography (inlier refit); w [..., N]."""
    r1, r2 = _h_rows(pa, pb)
    wf = w.to(pa.dtype)[..., None]
    A = torch.cat([r1 * wf, r2 * wf], -2)
    return _null_vector(A, False).reshape(A.shape[:-2] + (3, 3))


def _rank2(F):
    U, S, Vh = torch.linalg.svd(F)
    S = torch.cat([S[..., :2], torch.zeros_like(S[..., 2:])], -1)
    return U @ torch.diag_embed(S) @ Vh


def _f_dlt_weighted(pa, pb, w):
    """All-point weighted 8-point refit with rank-2 projection."""
    A = _f_rows(pa, pb) * w.to(pa.dtype)[..., None]
    return _rank2(_null_vector(A, False).reshape(A.shape[:-2] + (3, 3)))


def _f_from_8pt(pa, pb):
    """8-point fundamental. pa, pb: [..., 8, 2] -> rank-2 [..., 3, 3]."""
    A = _f_rows(pa, pb)                          # [..., 8, 9]
    return _rank2(_null_vector(A, True).reshape(A.shape[:-2] + (3, 3)))


def _h_transfer_err(H, pa, pb):
    """Symmetric transfer error of H [..., 3, 3] (a->b), [..., N]."""
    def fwd(H, p, q):
        d = H @ _homog(p).T                      # [..., 3, N]
        w = torch.where(torch.abs(d[..., 2, :]) < 1e-12, 1e-12,
                        d[..., 2, :])
        return torch.sum((d[..., :2, :] / w[..., None, :] - q.T) ** 2, -2)
    Hinv = torch.linalg.inv_ex(H)[0]
    return fwd(H, pa, pb) + fwd(Hinv, pb, pa)


def _f_epipolar_err(F, pa, pb):
    """Symmetric epipolar (per-direction) distance^2 of F [..., 3, 3],
    [..., N]."""
    A = _homog(pa)
    B = _homog(pb)
    l_b = A @ F.mT                               # line in b for each a
    l_a = B @ F                                  # line in a for each b
    num = torch.sum(B * l_b, -1) ** 2
    d_b = num / torch.clamp(l_b[..., 0] ** 2 + l_b[..., 1] ** 2, min=1e-12)
    d_a = num / torch.clamp(l_a[..., 0] ** 2 + l_a[..., 1] ** 2, min=1e-12)
    return d_a + d_b


def _lo_refine(counts, inl, valid, k: int, th, fit, err_of):
    """LO-RANSAC: refit the top-k hypotheses by inlier count on their
    inlier sets, rescore, return the winner's (model, inliers); winners
    ordered by (count desc, truncated inlier error asc)."""
    cand = _top_k_stable(counts, k)
    Ms = fit(inl[cand])                          # [k, 3, 3]
    err = err_of(Ms)                             # [k, N]
    m = (err < th) & valid
    cc = m.sum(-1)
    sc = torch.where(m, err, 0.0).sum(-1)
    keyv = cc.to(torch.float32) - sc / (th * valid.shape[0] + 1.0)
    M = Ms[lie.first_argmax(keyv)]
    return M, (err_of(M) < th) & valid


def _two_view_sweep(idx, pa, pb, valid, threshold, lo_topk, minimal, fit,
                    err_of):
    """The sweep, LO step and two all-inlier refits shared by H and F, in
    normalized coordinates. Returns (model_n, inliers, Ta, Tb)."""
    na, Ta = _normalize_2d(pa, valid)
    nb, Tb = _normalize_2d(pb, valid)
    Ms = minimal(na[idx], nb[idx])
    errs = err_of(Ms, na, nb)                    # [iters, N]
    s2 = 0.5 * (Ta[0, 0] ** 2 + Tb[0, 0] ** 2)
    th = 2.0 * _f32(threshold, pa) ** 2 * s2
    inl = (errs < th) & valid[None, :]
    counts = inl.sum(-1)
    best = lie.first_argmax(counts)
    inliers = inl[best]
    Mn = Ms[best]
    if lo_topk > 1:
        Mn, inliers = _lo_refine(
            counts, inl, valid, min(lo_topk, idx.shape[0]), th,
            lambda m: fit(na, nb, m), lambda M: err_of(M, na, nb))
    for _ in range(2):
        Mn = fit(na, nb, inliers)
        inliers = (err_of(Mn, na, nb) < th) & valid
    return Mn, inliers, Ta, Tb


def _find_homography_from_samples(idx, pa, pb, valid, threshold: float = 3.0,
                                  lo_topk: int = 1):
    """`find_homography` on drawn samples idx [iters, 4]."""
    Hn, inliers, Ta, Tb = _two_view_sweep(
        idx, pa, pb, valid, threshold, lo_topk, _h_from_4pt,
        _h_dlt_weighted, _h_transfer_err)
    H = torch.linalg.inv_ex(Tb)[0] @ Hn @ Ta
    H = H / torch.where(torch.abs(H[2, 2]) < 1e-12, 1e-12, H[2, 2])
    count = inliers.sum()
    return RansacResult(H, inliers, count.to(torch.float32), count >= 8)


def find_homography(generator, pa, pb, valid, threshold: float = 3.0,
                    iters: int = 256, lo_topk: int = 1):
    """RANSAC H: pa -> pb (pixels). threshold in px (symmetric transfer).
    lo_topk > 1 enables LO-RANSAC (EstimatorLORANSAC.cpp:363-398): the
    top-K hypotheses of the sweep are refit on their inlier sets."""
    idx = sample_indices(generator, pa.shape[0], valid, iters, 4)
    return _find_homography_from_samples(idx, pa, pb, valid, threshold,
                                         lo_topk)


def _find_fundamental_from_samples(idx, pa, pb, valid,
                                   threshold: float = 3.0, lo_topk: int = 1):
    """`find_fundamental` on drawn samples idx [iters, 8]."""
    Fn, inliers, Ta, Tb = _two_view_sweep(
        idx, pa, pb, valid, threshold, lo_topk, _f_from_8pt,
        _f_dlt_weighted, _f_epipolar_err)
    F = Tb.T @ Fn @ Ta
    nrm = torch.linalg.matrix_norm(F)
    F = F / torch.where(nrm < 1e-12, 1e-12, nrm)
    count = inliers.sum()
    return RansacResult(F, inliers, count.to(torch.float32), count >= 12)


def find_fundamental(generator, pa, pb, valid, threshold: float = 3.0,
                     iters: int = 256, lo_topk: int = 1):
    """RANSAC F (8-point): pb^T F pa = 0. threshold in px. lo_topk: see
    find_homography."""
    idx = sample_indices(generator, pa.shape[0], valid, iters, 8)
    return _find_fundamental_from_samples(idx, pa, pb, valid, threshold,
                                          lo_topk)


# ---------------------------------------------------------------------------
# PnP
# ---------------------------------------------------------------------------

def _pose_from_projection(P):
    """P [..., 3, 4] ~ s[R|t] up to sign -> SE3 [..., 7]; s = cbrt(det M)
    makes it invariant to the DLT's P/-P and keeps det(R) = +1."""
    M = P[..., :3]
    detM = torch.linalg.det(M)
    s = torch.sign(detM) * torch.abs(detM) ** (1.0 / 3.0)
    s = torch.where(torch.abs(s) < 1e-12, 1e-12, s)
    U, _, Vh = torch.linalg.svd(M / s[..., None, None])
    d = torch.linalg.det(U @ Vh)
    D = torch.diag_embed(torch.stack([torch.ones_like(d), torch.ones_like(d),
                                      d], -1))
    R = U @ D @ Vh
    t = P[..., 3] / s[..., None]
    return lie.se3(t, lie.quat_from_matrix(R))


def _pnp_dlt(p3d, p2n):
    """DLT camera pose from 6 points. p3d [..., 6, 3] world, p2n [..., 6,
    2] normalized image coords. Returns SE3 [..., 7] (world->camera)."""
    X, Y, Z = p3d[..., 0], p3d[..., 1], p3d[..., 2]
    u, v = p2n[..., 0], p2n[..., 1]
    o = torch.ones_like(X)
    z = torch.zeros_like(X)
    r1 = torch.stack([X, Y, Z, o, z, z, z, z, -u * X, -u * Y, -u * Z, -u],
                     -1)
    r2 = torch.stack([z, z, z, z, X, Y, Z, o, -v * X, -v * Y, -v * Z, -v],
                     -1)
    A = torch.cat([r1, r2], -2)                  # [..., 12, 12]
    P = _null_vector(A, True).reshape(A.shape[:-2] + (3, 4))
    return _pose_from_projection(P)


def _pnp_planar_h(p3d, p2n):
    """Pose from 4 (near-)coplanar points via homography decomposition
    (Zhang's method); p3d [..., 4, 3], p2n [..., 4, 2]. Returns SE3
    [..., 7] world->camera."""
    c = p3d.mean(-2)
    X = p3d - c[..., None, :]
    Vh = torch.linalg.svd(X, full_matrices=True).Vh
    e1, e2 = Vh[..., 0, :], Vh[..., 1, :]
    uv = torch.stack([torch.einsum("...nj,...j->...n", X, e1),
                      torch.einsum("...nj,...j->...n", X, e2)], -1)
    H = _h_from_4pt(uv, p2n)

    def unit(a):
        return a / torch.clamp(torch.linalg.vector_norm(a, dim=-1,
                                                        keepdim=True),
                               min=1e-12)

    lam = 1.0 / torch.clamp(torch.linalg.vector_norm(H[..., :, 0], dim=-1),
                            min=1e-12)
    # resolve the sign so the plane origin sits in front of the camera
    lam = (lam * torch.sign(H[..., 2, 2] + 1e-30))[..., None]
    a1, a2, a3 = lam * H[..., :, 0], lam * H[..., :, 1], lam * H[..., :, 2]
    r1 = unit(a1)
    a2o = a2 - torch.sum(r1 * a2, -1, keepdim=True) * r1
    r2 = unit(a2o)
    r3 = torch.linalg.cross(r1, r2, dim=-1)
    B = torch.stack([e1, e2, torch.linalg.cross(e1, e2, dim=-1)], -1)
    R = torch.stack([r1, r2, r3], -1) @ B.mT
    t = a3 - torch.einsum("...ij,...j->...i", R, c)
    # flip if the points land behind the camera
    z = torch.einsum("...nj,...j->...n", p3d, R[..., 2, :]) + t[..., 2:3]
    flip = ((z < 0).sum(-1) > (z >= 0).sum(-1))[..., None]
    R_flip = torch.stack([-r1, -r2, r3], -1) @ B.mT
    t_flip = -a3 - torch.einsum("...ij,...j->...i", R_flip, c)
    R = torch.where(flip[..., None], R_flip, R)
    t = torch.where(flip, t_flip, t)
    return lie.se3(t, lie.quat_from_matrix(R))


def _reproj_err_norm(T_w2c, p3d, p2n):
    """Squared reprojection error in normalized image coords, [..., N] for
    poses [..., 1, 7]."""
    pc = lie.se3_apply(T_w2c, p3d)
    zc = torch.where(torch.abs(pc[..., 2]) < 1e-9, 1e-9, pc[..., 2])
    err = torch.sum((pc[..., :2] / zc[..., None] - p2n) ** 2, -1)
    return torch.where(pc[..., 2] > 0, err, math.inf)


def _find_pnp_from_samples(idx6, idx4, p3d, p2n, valid,
                           threshold: float = 0.01, refine_iters: int = 2):
    """`find_pnp` on drawn samples: idx6 [iters // 2, 6] for the DLT,
    idx4 [iters - iters // 2, 4] for the planar solver."""
    from . import ba as _ba
    Ts = torch.cat([_pnp_dlt(p3d[idx6], p2n[idx6]),
                    _pnp_planar_h(p3d[idx4], p2n[idx4])], 0)
    errs = _reproj_err_norm(Ts[:, None, :], p3d, p2n)
    th = threshold ** 2
    inl = (errs < th) & valid[None, :]
    best = lie.first_argmax(inl.sum(-1))
    T = Ts[best]
    inliers = inl[best]
    # LM pose refinement on all inliers (the DLT refit is planar-degenerate)
    for _ in range(refine_iters):
        T, _, _ = _ba.optimize_pose(T, p3d, p2n, inliers.to(torch.float32),
                                    iters=6, huber_delta=threshold)
        inliers = (_reproj_err_norm(T, p3d, p2n) < th) & valid
    n = inliers.sum()
    return RansacResult(T, inliers, n.to(torch.float32), n >= 10)


def find_pnp(generator, p3d, p2n, valid, threshold: float = 0.01,
             iters: int = 256, refine_iters: int = 2):
    """PnP RANSAC (EstimatorOpenCV::findPnPRansac). p3d [N, 3] world
    points; p2n [N, 2] normalized image coords; threshold in normalized
    units. Returns RansacResult with model = SE3 [7] world->camera.
    Half the hypotheses are 6-point DLTs, half 4-point planar solves (the
    DLT is degenerate on a plane, aerial mapping's common case)."""
    n = p3d.shape[0]
    g6 = g4 = generator
    if isinstance(generator, threefry.Key):
        g6, g4 = generator.split()      # as the reference splits its key
    idx6 = sample_indices(g6, n, valid, iters // 2, 6)
    idx4 = sample_indices(g4, n, valid, iters - iters // 2, 4)
    return _find_pnp_from_samples(idx6, idx4, p3d, p2n, valid, threshold,
                                  refine_iters)


# ---------------------------------------------------------------------------
# SIM3 (Horn) — EstimatorOpenCV::findSIM3 (:94-160)
# ---------------------------------------------------------------------------

def sim3_horn(pa, pb, w=None):
    """Closed-form similarity aligning pa -> pb (Horn, quaternion method).
    pa, pb: [..., N, 3]; w: optional [..., N] weights. Returns SIM3
    [..., 8].

    Rank guard (the reference's): when the centered source cloud is rank
    <= 1 (collinear, e.g. a straight survey strip), Horn's rotation about
    the line is unconstrained; the fallback is the minimal rotation
    aligning the two principal directions (oriented by the
    correspondence), and the identity when there is no spread at all."""
    if w is None:
        w = torch.ones(pa.shape[:-1], dtype=pa.dtype, device=pa.device)
    w = w.to(pa.dtype)
    wn = w[..., None]
    sw = torch.clamp(w.sum(-1), min=1e-9)[..., None]
    ca = torch.sum(pa * wn, -2) / sw
    cb = torch.sum(pb * wn, -2) / sw
    A = pa - ca[..., None, :]
    B = pb - cb[..., None, :]
    M = (A * wn).mT @ B                          # [..., 3, 3]
    S = [[M[..., i, j] for j in range(3)] for i in range(3)]
    (Sxx, Sxy, Sxz), (Syx, Syy, Syz), (Szx, Szy, Szz) = S
    N = torch.stack([
        Sxx + Syy + Szz, Syz - Szy, Szx - Sxz, Sxy - Syx,
        Syz - Szy, Sxx - Syy - Szz, Sxy + Syx, Szx + Sxz,
        Szx - Sxz, Sxy + Syx, -Sxx + Syy - Szz, Syz + Szy,
        Sxy - Syx, Szx + Sxz, Syz + Szy, -Sxx - Syy + Szz,
    ], -1).reshape(M.shape[:-2] + (4, 4))
    qwxyz = torch.linalg.eigh(N)[1][..., :, -1]   # largest eigenvalue
    q = torch.cat([qwxyz[..., 1:], qwxyz[..., :1]], -1)   # -> (x,y,z,w)
    q = q * torch.where(q[..., 3:4] < 0, -1.0, 1.0)
    # --- rank guard on the source scatter
    eva, veca = torch.linalg.eigh((A * wn).mT @ A)
    _, vecb = torch.linalg.eigh((B * wn).mT @ B)
    rank1 = eva[..., 1] <= 1e-5 * torch.clamp(eva[..., 2], min=1e-12)
    rank0 = eva[..., 2] <= 1e-12
    da = veca[..., :, 2]
    db = vecb[..., :, 2]
    # eigenvector signs are arbitrary: orient both by the correspondence
    corr = torch.sum(w * torch.einsum("...nj,...j->...n", A, da)
                     * torch.einsum("...nj,...j->...n", B, db), -1)
    db = db * torch.where(corr < 0, -1.0, 1.0)[..., None]
    c = torch.sum(da * db, -1, keepdim=True)
    qf = torch.cat([torch.linalg.cross(da, db, dim=-1), 1.0 + c], -1)
    qf = qf / torch.clamp(torch.linalg.vector_norm(qf, dim=-1, keepdim=True),
                          min=1e-9)
    q_id = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=q.dtype, device=q.device)
    # antipodal principal directions (1+c ~ 0) leave qf meaningless too
    qf = torch.where(1.0 + c < 1e-6, q_id, qf)
    q = torch.where(rank1[..., None], torch.where(rank0[..., None], q_id, qf),
                    q)
    Ra = lie.quat_rotate(q[..., None, :].expand(A.shape[:-1] + (4,)), A)
    s = torch.sum(wn * B * Ra, (-2, -1)) / torch.clamp(
        torch.sum(wn * Ra * Ra, (-2, -1)), min=1e-12)
    t = cb - s[..., None] * lie.quat_rotate(q, ca)
    return lie.sim3(t, q, s)


def _find_sim3_from_samples(idx, pa, pb, valid, threshold: float = 0.1):
    """`find_sim3` on drawn samples idx [iters, 3]."""
    Ss = sim3_horn(pa[idx], pb[idx])             # [iters, 8]
    errs = torch.sum((lie.sim3_apply(Ss[:, None, :], pa) - pb) ** 2, -1)
    th = _f32(threshold, pa) ** 2
    inl = (errs < th) & valid[None, :]
    best = lie.first_argmax(inl.sum(-1))
    S = sim3_horn(pa, pb, inl[best].to(pa.dtype))
    err = torch.sum((lie.sim3_apply(S, pa) - pb) ** 2, -1)
    inliers = (err < th) & valid
    n = inliers.sum()
    return RansacResult(S, inliers, n.to(torch.float32), n >= 3)


def find_sim3(generator, pa, pb, valid, threshold: float = 0.1,
              iters: int = 128):
    """RANSAC SIM3 from 3-point Horn hypotheses + all-inlier refit."""
    idx = sample_indices(generator, pa.shape[0], valid, iters, 3)
    return _find_sim3_from_samples(idx, pa, pb, valid, threshold)


# ---------------------------------------------------------------------------
# plane RANSAC — src/RANSAC.cpp:52-116 (the SLAM->mosaic glue)
# ---------------------------------------------------------------------------

def _find_plane_from_samples(idx, pts, valid, sigma: float = 0.15):
    """`find_plane` on drawn samples idx [iters, 3]."""
    p0, p1, p2 = pts[idx[:, 0]], pts[idx[:, 1]], pts[idx[:, 2]]
    n = torch.linalg.cross(p1 - p0, p2 - p0, dim=-1)
    n = n / torch.clamp(torch.linalg.vector_norm(n, dim=-1, keepdim=True),
                        min=1e-12)
    d = -torch.sum(n * p0, -1)
    dist = torch.abs(pts @ n.T + d[None, :]).T   # [iters, N]
    sig = _f32(sigma, pts)
    inl = (dist < sig) & valid[None, :]
    w = inl[lie.first_argmax(inl.sum(-1))].to(pts.dtype)
    # least-squares refit: smallest eigenvector of the covariance
    c = torch.sum(pts * w[:, None], 0) / torch.clamp(w.sum(), min=1e-9)
    X = (pts - c) * w[:, None]
    normal = torch.linalg.eigh(X.T @ X)[1][:, 0]
    normal = normal * torch.where(normal[2] < 0, -1.0, 1.0)  # z-up
    # SE3: z-axis = normal, origin = centroid
    e = torch.eye(3, dtype=pts.dtype, device=pts.device)
    up = torch.where(torch.abs(normal[0]) < 0.9, e[0], e[1])
    xax = torch.linalg.cross(up, normal, dim=-1)
    xax = xax / torch.clamp(torch.linalg.vector_norm(xax), min=1e-12)
    yax = torch.linalg.cross(normal, xax, dim=-1)
    T = lie.se3(c, lie.quat_from_matrix(torch.stack([xax, yax, normal], -1)))
    inliers = (torch.abs((pts - c) @ normal) < sig) & valid
    n_in = inliers.sum()
    ok = n_in >= torch.clamp(0.3 * valid.sum(), min=3)
    return RansacResult(T, inliers, n_in.to(torch.float32), ok)


def find_plane(generator, pts, valid, sigma: float = 0.15, iters: int = 256):
    """3-point plane RANSAC + inlier least-squares refit. model = SE3 [7]
    "plane pose": origin at the inlier centroid, z-axis = the plane normal
    (z-up), the convention Map2DFusion expects for its `plane`."""
    idx = sample_indices(generator, pts.shape[0], valid, iters, 3)
    return _find_plane_from_samples(idx, pts, valid, sigma)


# ---------------------------------------------------------------------------
# triangulation — SVD DLT (MapperDemo.cpp:1832-1881), batched
# ---------------------------------------------------------------------------

def _projection_from_pose(T_c2w):
    """[..., 3, 4] matrix projecting world homogeneous points into the
    camera's normalized image plane: P = [R^T | -R^T t]."""
    Tinv = lie.se3_inv(T_c2w)
    R = lie.quat_to_matrix(lie.se3_q(Tinv))
    return torch.cat([R, lie.se3_t(Tinv)[..., None]], -1)


def triangulate(T_a2w, T_b2w, rays_a, rays_b):
    """Two-view DLT triangulation of N correspondences. T_a2w, T_b2w: SE3
    [..., 7] camera->world poses; rays_a/b [N, 3] normalized (x, y, 1).
    Returns (points_w [..., N, 3], depth_a [..., N])."""
    Pa = _projection_from_pose(T_a2w)[..., None, :, :]   # [..., 1, 3, 4]
    Pb = _projection_from_pose(T_b2w)[..., None, :, :]
    ra, rb = rays_a[..., None], rays_b[..., None]        # [N, 3, 1]
    A = torch.stack([ra[:, 0] * Pa[..., 2, :] - Pa[..., 0, :],
                     ra[:, 1] * Pa[..., 2, :] - Pa[..., 1, :],
                     rb[:, 0] * Pb[..., 2, :] - Pb[..., 0, :],
                     rb[:, 1] * Pb[..., 2, :] - Pb[..., 1, :]], -2)
    Xh = torch.linalg.svd(A).Vh[..., -1, :]              # [..., N, 4]
    w = Xh[..., 3]
    w = torch.where(torch.abs(w) < 1e-12, 1e-12, w)
    X = Xh[..., :3] / w[..., None]
    depth = lie.se3_apply(lie.se3_inv(T_a2w)[..., None, :], X)[..., 2]
    return X, depth


def parallax_cos(T_a2w, T_b2w, points_w):
    """cos of the ray parallax angle per point (MapperDemo checks
    parallax in (0, 0.9998))."""
    ra = points_w - lie.se3_t(T_a2w)[..., None, :]
    rb = points_w - lie.se3_t(T_b2w)[..., None, :]
    num = torch.sum(ra * rb, -1)
    den = (torch.linalg.vector_norm(ra, dim=-1)
           * torch.linalg.vector_norm(rb, dim=-1))
    return num / torch.clamp(den, min=1e-12)
