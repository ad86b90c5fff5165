"""Bundle adjustment: Schur-complement Levenberg-Marquardt on tensors.

Port of pislamfusion_tpu/ops/ba.py (the reference's g2o stack,
GSLAM-DIYSLAM/src/zhaoyong/optimizerG2O/Optimizer.cpp):

- `BAProblem` / `make_problem`: keyframe poses with fixed masks, map
  points, reprojection edges, SE3 relative edges and SE3 pose priors
  (GSLAM's BundleGraph, Optimizer.h:150-172), padded to fixed shapes.
- `optimize`: the Schur-complement LM. Per-point 3x3 blocks are inverted
  in closed form, the reduced camera system (6F x 6F) is assembled
  densely and solved. Every scatter sums in a fixed order (`_index_add_`,
  and `index_put_` with accumulate, which sorts its indices on CUDA), so
  the same inputs give the same bits on every run, on the card too.
  `tol == 0` runs a fixed number of steps with no host synchronisation
  (accept/reject is a `torch.where`, the solves `*_ex` variants that do
  not check errors); `tol > 0` reads one flag a step and stops early.
- `optimize_pose` (OptimizerG2O::optimizePnP, Optimizer.cpp:18-165),
  `optimize_pose_invdepth` (EdgeSE3InvDepth), the SE3 and Sim3 pose
  graphs (dense and matrix-free CG), `optimize_icp` and `fit_sim3`.

Jacobians, where the reference takes `jax.jacfwd` of its residuals: the
reprojection edge's in closed form (the pose half `Jp [I | -hat(pc)]`
and the point half `Jp R` through the pinhole projection); the relative
and prior edges' through SE3's adjoint and inverse left Jacobian (a few
dozen operations a family, where forward-mode differentiation through
log and exp took ~1500); the Sim3 edges' by forward-mode
differentiation, in one dual-tensor pass (`_jacobians`).
Residuals are in normalized image coordinates; the Huber kernel's
default delta is the reference's chi2 5.991 at a 400 px focal length.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch
import torch.autograd.forward_ad as fwAD

from ..core.device import resolve_device
from . import lie


class BAProblem(NamedTuple):
    """Padded, fixed-shape bundle graph. F frames, P points, O
    observations, E relative edges, G pose priors (the reference's field
    order)."""
    poses: torch.Tensor        # [F, 7] SE3 world->camera
    pose_fixed: torch.Tensor   # [F] bool
    points: torch.Tensor       # [P, 3]
    point_fixed: torch.Tensor  # [P] bool (or padding)
    obs_frame: torch.Tensor    # [O] int64
    obs_point: torch.Tensor    # [O] int64
    obs_uv: torch.Tensor       # [O, 2] normalized image coords
    obs_weight: torch.Tensor   # [O] float (0 = invalid/padding)
    # SE3 relative edges: residual = log(meas^-1 * (Ti * Tj^-1))
    rel_i: torch.Tensor        # [E] int64
    rel_j: torch.Tensor        # [E] int64
    rel_meas: torch.Tensor     # [E, 7]
    rel_weight: torch.Tensor   # [E] float (scalar info; 0 = padding)
    # pose priors (GPS): residual = log(T * prior^-1)
    prior_frame: torch.Tensor  # [G] int64
    prior_pose: torch.Tensor   # [G, 7]
    prior_info: torch.Tensor   # [G, 6] diagonal information


def make_problem(poses, pose_fixed, points=None, point_fixed=None,
                 obs_frame=None, obs_point=None, obs_uv=None, obs_weight=None,
                 rel_i=None, rel_j=None, rel_meas=None, rel_weight=None,
                 prior_frame=None, prior_pose=None, prior_info=None,
                 device=None):
    """A BAProblem on `device` (None means `cuda`) from arrays or tensors,
    filling absent edge families with one zero-weight padded row (an
    absent `point_fixed` means all points free; absent points, one fixed
    padded point)."""
    dev = resolve_device(device)

    def arr(x, shape, dtype=torch.float32):
        if x is None:
            return torch.zeros(shape, dtype=dtype, device=dev)
        if isinstance(x, torch.Tensor):
            return x.to(device=dev, dtype=dtype)
        return torch.as_tensor(np.asarray(x), dtype=dtype, device=dev)

    P = 1 if points is None else len(points)
    O = 1 if obs_uv is None else len(obs_uv)
    E = 1 if rel_meas is None else len(rel_meas)
    G = 1 if prior_pose is None else len(prior_pose)
    idx = torch.int64
    if point_fixed is None:
        point_fixed = (np.zeros(P, bool) if points is not None
                       else np.ones(P, bool))
    rel_meas_t = arr(rel_meas, (E, 7))
    if rel_meas is None:
        rel_meas_t[:, 6] = 1.0
    prior_pose_t = arr(prior_pose, (G, 7))
    if prior_pose is None:
        prior_pose_t[:, 6] = 1.0
    return BAProblem(
        poses=arr(poses, (0, 7)), pose_fixed=arr(pose_fixed, (0,), torch.bool),
        points=arr(points, (P, 3)),
        point_fixed=arr(point_fixed, (P,), torch.bool),
        obs_frame=arr(obs_frame, (O,), idx),
        obs_point=arr(obs_point, (O,), idx),
        obs_uv=arr(obs_uv, (O, 2)), obs_weight=arr(obs_weight, (O,)),
        rel_i=arr(rel_i, (E,), idx), rel_j=arr(rel_j, (E,), idx),
        rel_meas=rel_meas_t, rel_weight=arr(rel_weight, (E,)),
        prior_frame=arr(prior_frame, (G,), idx), prior_pose=prior_pose_t,
        prior_info=arr(prior_info, (G, 6)))


# ---------------------------------------------------------------------------
# residuals + jacobians
# ---------------------------------------------------------------------------

def _projection(pc, uv):
    """At camera-frame points pc [N, 3]: the residual [N, 2] against uv
    (zero behind the camera), the pinhole projection's Jacobian Jp
    [N, 2, 3], its pose Jacobian Jc [N, 2, 6] for a LEFT se3 perturbation
    (Jp [I | -hat(pc)]: lie.se3_exp is (rho, w) with V -> I at 0), and the
    in-front mask [N, 1, 1]."""
    x, y, z = pc.unbind(-1)
    zs = torch.where(z.abs() < 1e-9, torch.full_like(z, 1e-9), z)
    good = (z > 1e-6)[:, None, None]
    r = torch.where(good[:, 0], pc[..., :2] / zs[..., None] - uv,
                    torch.zeros_like(uv))
    iz = 1.0 / zs
    iz2 = iz * iz
    zr = torch.zeros_like(iz)
    Jp = torch.stack([torch.stack([iz, zr, -x * iz2], -1),
                      torch.stack([zr, iz, -y * iz2], -1)], -2)  # [N, 2, 3]
    Jrot = -torch.einsum("nij,njk->nik", Jp, lie.so3_hat(pc))
    return r, Jp, torch.cat([Jp, Jrot], -1), good


def _pose_jac_analytic(T_w2c, p3d, uv):
    """(residual [N,2], J [N,2,6]) wrt a LEFT se3 perturbation of one pose
    T_w2c [7], closed form through the pinhole projection (the
    reference's, on T as given)."""
    r, _, Jc, good = _projection(
        lie.se3_apply(T_w2c.expand(p3d.shape[0], 7), p3d), uv)
    return r, torch.where(good, Jc, torch.zeros_like(Jc))


def _at_zero(T):
    """exp(0) * T, the reference's residuals' pose at delta 0, without the
    exponential: its translation unchanged and its quaternion normalised
    (the same numbers: rotating by the identity quaternion and multiplying
    by it are exact)."""
    return lie.se3(lie.se3_t(T), lie.quat_normalize(lie.se3_q(T)))


def _reproj_terms(T_w2c, X, uv):
    """(residual [N, 2], J_pose [N, 2, 6], J_point [N, 2, 3]) of
    reprojection edges at poses T_w2c [N, 7] and points X [N, 3], in
    closed form: the reference's `_reproj_residual` at delta 0 (exp(0) *
    T, so the rotation of the normalised quaternion), its pose Jacobian
    and its point Jacobian Jp R."""
    T = _at_zero(T_w2c)
    r, Jp, Jc, good = _projection(lie.se3_apply(T, X), uv)
    Jx = Jp @ lie.quat_to_matrix(lie.se3_q(T))
    return r, torch.where(good, Jc, 0.0), torch.where(good, Jx, 0.0)


def _reproj_val(T_w2c, X, uv):
    """Residuals [N, 2] of reprojection edges at delta 0."""
    pc = lie.se3_apply(_at_zero(T_w2c), X)
    z = pc[:, 2]
    zs = torch.where(z.abs() < 1e-9, torch.full_like(z, 1e-9), z)
    r = pc[:, :2] / zs[:, None] - uv
    return torch.where((z > 1e-6)[:, None], r, 0.0)


def _rel_val(Ti, Tj, meas):
    return lie.se3_log(lie.se3_mul(lie.se3_inv(meas), lie.se3_mul(
        _at_zero(Ti), lie.se3_inv(_at_zero(Tj)))))


def _jacobians(fn, n_delta: int, dim: int, *args):
    """Jacobians [E, m, dim] of the edge residuals fn(d_1, .., d_n, *args)
    [E, m] with respect to each delta [E, dim] at 0, in one forward-mode
    pass (`torch.autograd.forward_ad` dual tensors, which cost less host
    time than `torch.func`'s transforms): the n * dim unit tangents ride a
    leading batch axis, against which the edges' arguments broadcast.
    Equal to `jax.jacfwd` under `jax.vmap`, the reference's way."""
    E = args[0].shape[0]
    nb = n_delta * dim
    eye = torch.eye(nb, dtype=args[0].dtype, device=args[0].device)
    zeros = torch.zeros((nb, E, dim), dtype=eye.dtype, device=eye.device)
    with fwAD.dual_level():
        deltas = [fwAD.make_dual(zeros, eye[:, None, i * dim:(i + 1) * dim]
                                 .expand(nb, E, dim).contiguous())
                  for i in range(n_delta)]
        t = fwAD.unpack_dual(fn(*deltas, *args)).tangent
    J = t.permute(1, 2, 0)                                   # [E, m, nb]
    return tuple(J[..., i * dim:(i + 1) * dim] for i in range(n_delta))


def _se3_adjoint(T):
    """Adjoint [..., 6, 6] of SE3 [..., 7] on (rho, w) twists:
    exp(Ad_T xi) = T exp(xi) T^-1, Ad_T = [[R, hat(t) R], [0, R]]."""
    R = lie.quat_to_matrix(lie.se3_q(T))
    tR = lie.so3_hat(lie.se3_t(T)) @ R
    return torch.cat([torch.cat([R, tR], -1),
                      torch.cat([torch.zeros_like(R), R], -1)], -2)


def _se3_left_jacobian_inv(xi):
    """d log(exp(d) T) / dd at d = 0 for T = exp(xi), xi [..., 6] = (rho,
    w): the inverse left Jacobian [[J^-1, -J^-1 Q J^-1], [0, J^-1]] of
    SE3 (Barfoot, State Estimation for Robotics, section 7.1.5), its
    coefficients as series below theta = 1, where their closed forms
    cancel in f32."""
    rho, phi = xi[..., :3], xi[..., 3:]
    t2 = torch.sum(phi * phi, -1)[..., None, None]
    small = t2 < 1.0
    th = torch.sqrt(torch.clamp(t2, min=1.0))
    sn, cs = torch.sin(th), torch.cos(th)
    a = torch.where(small, 1 / 12 + t2 / 720 + t2 ** 2 / 30240
                    + t2 ** 3 / 1209600, 1 / t2 - (1 + cs) / (2 * th * sn))
    c1 = torch.where(small, 1 / 6 - t2 / 120 + t2 ** 2 / 5040
                     - t2 ** 3 / 362880, (th - sn) / (th * t2))
    c2 = torch.where(small, 1 / 24 - t2 / 720 + t2 ** 2 / 40320
                     - t2 ** 3 / 3628800, (t2 / 2 + cs - 1) / (t2 * t2))
    c3 = torch.where(small, 1 / 120 - t2 / 2520 + t2 ** 2 / 120960
                     - t2 ** 3 / 9979200,
                     (2 * th - 3 * sn + th * cs) / (2 * th * t2 * t2))
    P, Rh = lie.so3_hat(phi), lie.so3_hat(rho)
    PP, PRP = P @ P, P @ Rh @ P
    eye = torch.eye(3, dtype=xi.dtype, device=xi.device)
    Jinv = eye - 0.5 * P + a * PP
    Q = (0.5 * Rh + c1 * (P @ Rh + Rh @ P + PRP)
         + c2 * (PP @ Rh + Rh @ PP - 3 * PRP) + c3 * (PRP @ P + P @ PRP))
    return torch.cat([torch.cat([Jinv, -Jinv @ Q @ Jinv], -1),
                      torch.cat([torch.zeros_like(Jinv), Jinv], -1)], -2)


def _rel_jac(Ti, Tj, meas):
    """(J_i, J_j) [E, 6, 6] of the relative edges at delta 0, in closed
    form: with Z = meas^-1 Ti Tj^-1, exp(di) moves Z to exp(Ad_{meas^-1}
    di) Z and exp(dj) to exp(-Ad_Z dj) Z, so J_i = Jl^-1(log Z)
    Ad_{meas^-1} and J_j = -Jl^-1(log Z) Ad_Z."""
    minv = lie.se3_inv(meas)
    Z = lie.se3_mul(minv, lie.se3_mul(_at_zero(Ti), lie.se3_inv(
        _at_zero(Tj))))
    Jl = _se3_left_jacobian_inv(lie.se3_log(Z))
    return Jl @ _se3_adjoint(minv), -Jl @ _se3_adjoint(Z)


def _prior_val(T, prior):
    return lie.se3_log(lie.se3_mul(_at_zero(T), lie.se3_inv(prior)))


def _prior_jac(T, prior):
    """J [G, 6, 6] of the prior edges at delta 0: exp(d) moves T prior^-1
    to exp(d) T prior^-1, so J = Jl^-1(log(T prior^-1))."""
    return _se3_left_jacobian_inv(_prior_val(T, prior))


def _huber_cost(r2, d):
    return torch.where(r2 <= d * d, r2,
                       2 * d * torch.sqrt(torch.clamp(r2, min=1e-18)) - d * d)


def _huber_weight(r2, delta):
    """IRLS weight for the Huber kernel at squared residual r2."""
    r = torch.sqrt(torch.clamp(r2, min=1e-18))
    return torch.where(r <= delta, torch.ones_like(r), delta / r)


def optimize_pose(T_w2c, p3d, p2n, weight, iters: int = 10,
                  huber_delta: float = 0.0061):
    """Pose-only LM. T_w2c [7]; p3d [N, 3]; p2n [N, 2] normalized image
    coords; weight [N] (0 = invalid). Returns (T, cost, per-point chi2)."""
    dev, dt = T_w2c.device, T_w2c.dtype

    def residuals(T):
        return _reproj_val(T.expand(p3d.shape[0], 7), p3d, p2n)

    def cost_fn(T):
        return torch.sum(weight * _huber_cost(
            torch.sum(residuals(T) ** 2, -1), huber_delta))

    eye6 = torch.eye(6, dtype=dt, device=dev)
    T = T_w2c
    lam = torch.full((), 1e-4, dtype=dt, device=dev)
    cost = cost_fn(T)
    for _ in range(iters):
        r, Jc = _pose_jac_analytic(T, p3d, p2n)
        r2 = torch.sum(r * r, -1)
        w = weight * _huber_weight(r2, huber_delta)
        H = torch.einsum("oki,ok,okj->ij", Jc, w[:, None].expand(-1, 2), Jc)
        b = -torch.einsum("oki,ok->i", Jc, r * w[:, None])
        Hd = H + lam * eye6 * torch.clamp(torch.trace(H) / 6.0, min=1e-6)
        d = torch.linalg.solve_ex(Hd + 1e-9 * eye6, b)[0]
        T_new = lie.se3_mul(lie.se3_exp(d), T)
        new_cost = cost_fn(T_new)
        accept = new_cost < cost
        T = torch.where(accept, T_new, T)
        lam = torch.where(accept, lam * 0.5, lam * 4.0).clamp(1e-9, 1e6)
        cost = torch.where(accept, new_cost, cost)
    chi2 = torch.sum(residuals(T) ** 2, -1)
    z = lie.se3_apply(T.expand(p3d.shape[0], 7), p3d)[..., 2]
    chi2 = torch.where(z > 1e-6, chi2, torch.full_like(chi2, float("inf")))
    return T, cost, chi2


# ---------------------------------------------------------------------------
# full BA: one LM step (Schur complement)
# ---------------------------------------------------------------------------

def _eye(n, like):
    return torch.eye(n, dtype=like.dtype, device=like.device)


def _index_add_(out, index, src):
    """out.index_add_(0, index, src), summed in a fixed order. On the CPU
    `index_add_` is a loop in index order. On CUDA it adds by float atomics
    in no fixed order, so two runs of one BA part in their last bits and a
    whole SLAM run drifts apart from itself; there `index_put_` with
    accumulate, which sorts the indices first (a stable radix sort) and
    sums each index's rows in one fixed order. Returns out."""
    if out.device.type == "cpu":
        return out.index_add_(0, index, src)
    return out.index_put_((index,), src, accumulate=True)


def _reproj_normal_terms(problem: BAProblem, huber_delta: float):
    """Partial normal-equation terms of the reprojection edges: per-point
    blocks Hpp [P,3,3], bp [P,3]; camera blocks Hcc [F,6,6], bc [F,6];
    cross blocks U [F,P,6,3]."""
    F = problem.poses.shape[0]
    P = problem.points.shape[0]
    of, op = problem.obs_frame, problem.obs_point
    r, Jc, Jp = _reproj_terms(problem.poses[of], problem.points[op],
                              problem.obs_uv)
    w = problem.obs_weight * _huber_weight(torch.sum(r * r, -1), huber_delta)
    freef = (~problem.pose_fixed[of]).to(w.dtype)
    freep = (~problem.point_fixed[op]).to(w.dtype)
    Jc = Jc * ((w * freef) ** 0.5)[:, None, None]
    Jp = Jp * ((w * freep) ** 0.5)[:, None, None]
    rw = r * torch.sqrt(w)[:, None]
    dt, dev = r.dtype, r.device
    Hpp = _index_add_(torch.zeros((P, 3, 3), dtype=dt, device=dev), op,
                      Jp.mT @ Jp)
    bp = _index_add_(torch.zeros((P, 3), dtype=dt, device=dev), op,
                     -torch.einsum("oki,ok->oi", Jp, rw))
    Hcc = _index_add_(torch.zeros((F, 6, 6), dtype=dt, device=dev), of,
                      Jc.mT @ Jc)
    bc = _index_add_(torch.zeros((F, 6), dtype=dt, device=dev), of,
                     -torch.einsum("oki,ok->oi", Jc, rw))
    U = torch.zeros((F, P, 6, 3), dtype=dt, device=dev).index_put_(
        (of, op), Jc.mT @ Jp, accumulate=True)
    return Hpp, bp, Hcc, bc, U


def _graph_terms(problem: BAProblem, Hcc, bc):
    """Relative-SE3 and prior edges: the frame-frame coupling S_full
    [F,F,6,6] plus their additions to the camera diagonal and rhs."""
    F = problem.poses.shape[0]
    ri, rj = problem.rel_i, problem.rel_j
    Ti, Tj = problem.poses[ri], problem.poses[rj]
    rr = _rel_val(Ti, Tj, problem.rel_meas)                       # [E, 6]
    Ji, Jj = _rel_jac(Ti, Tj, problem.rel_meas)
    wr = problem.rel_weight
    fi = (~problem.pose_fixed[ri]).to(wr.dtype)
    fj = (~problem.pose_fixed[rj]).to(wr.dtype)
    Ji = Ji * ((wr * fi) ** 0.5)[:, None, None]
    Jj = Jj * ((wr * fj) ** 0.5)[:, None, None]
    rrw = rr * torch.sqrt(wr)[:, None]
    S_full = torch.zeros((F, F, 6, 6), dtype=Hcc.dtype, device=Hcc.device)
    S_full.index_put_((ri, ri), Ji.mT @ Ji, accumulate=True)
    S_full.index_put_((rj, rj), Jj.mT @ Jj, accumulate=True)
    S_full.index_put_((ri, rj), Ji.mT @ Jj, accumulate=True)
    S_full.index_put_((rj, ri), Jj.mT @ Ji, accumulate=True)
    bc = _index_add_(bc.clone(), ri, -torch.einsum("eki,ek->ei", Ji, rrw))
    bc = _index_add_(bc, rj, -torch.einsum("eki,ek->ei", Jj, rrw))
    # pose priors (GPS), diagonal information weighting each residual row
    pf = problem.prior_frame
    Tg = problem.poses[pf]
    rg = _prior_val(Tg, problem.prior_pose)                       # [G, 6]
    Jg = _prior_jac(Tg, problem.prior_pose)                       # [G, 6, 6]
    fg = (~problem.pose_fixed[pf]).to(rg.dtype)
    sqrt_info = torch.sqrt(torch.clamp(problem.prior_info, min=0.0)) \
        * fg[:, None]
    Jg = Jg * sqrt_info[:, :, None]
    rgw = rg * sqrt_info
    Hcc = _index_add_(Hcc.clone(), pf, Jg.mT @ Jg)
    bc = _index_add_(bc, pf, -torch.einsum("gki,gk->gi", Jg, rgw))
    return S_full, Hcc, bc


def _schur_solve(problem: BAProblem, Hpp, bp, Hcc, bc, U, S_full, lam):
    """The reduced camera system, solved; then the points back-solved.
    Fixed frames get identity rows, fixed points a zero step."""
    F = problem.poses.shape[0]
    eye3, eye6 = _eye(3, Hpp), _eye(6, Hpp)
    tr3 = torch.diagonal(Hpp, dim1=-2, dim2=-1).sum(-1)
    Hpp_d = Hpp + lam * eye3 * torch.clamp(tr3 / 3.0, min=1e-6)[:, None,
                                                                None]
    Vinv = torch.linalg.inv_ex(Hpp_d + 1e-9 * eye3)[0]
    tr6 = torch.diagonal(Hcc, dim1=-2, dim2=-1).sum(-1)
    Hcc_d = Hcc + lam * eye6 * torch.clamp(tr6 / 6.0, min=1e-6)[:, None,
                                                                None]
    ar = torch.arange(F, device=Hpp.device)
    S_full = S_full.index_put((ar, ar), Hcc_d, accumulate=True)
    UV = torch.einsum("fpab,pbc->fpac", U, Vinv)                  # [F,P,6,3]
    S_full = S_full - torch.einsum("ipac,jpbc->ijab", UV, U)
    b_red = bc - torch.einsum("fpab,pb->fa", UV, bp)
    S_mat = S_full.permute(0, 2, 1, 3).reshape(6 * F, 6 * F)
    mask = (~problem.pose_fixed).repeat_interleave(6).to(S_mat.dtype)
    S_mat = S_mat * mask[:, None] * mask[None, :] + torch.diag(1.0 - mask)
    dc = torch.linalg.solve_ex(S_mat + 1e-9 * _eye(6 * F, S_mat),
                               b_red.reshape(-1) * mask)[0].reshape(F, 6)
    dp = torch.einsum("pab,pb->pa", Vinv,
                      bp - torch.einsum("fpab,fa->pb", U, dc))
    return dc, dp * (~problem.point_fixed)[:, None]


def _assemble_and_solve(problem: BAProblem, lam, huber_delta: float):
    Hpp, bp, Hcc, bc, U = _reproj_normal_terms(problem, huber_delta)
    S_full, Hcc, bc = _graph_terms(problem, Hcc, bc)
    return _schur_solve(problem, Hpp, bp, Hcc, bc, U, S_full, lam)


def _reproj_cost(problem: BAProblem, huber_delta: float):
    r = _reproj_val(problem.poses[problem.obs_frame],
                    problem.points[problem.obs_point], problem.obs_uv)
    return torch.sum(problem.obs_weight
                     * _huber_cost(torch.sum(r * r, -1), huber_delta))


def _graph_cost(problem: BAProblem):
    rr = _rel_val(problem.poses[problem.rel_i], problem.poses[problem.rel_j],
                  problem.rel_meas)
    cost = torch.sum(problem.rel_weight * torch.sum(rr * rr, -1))
    rg = _prior_val(problem.poses[problem.prior_frame], problem.prior_pose)
    return cost + torch.sum(problem.prior_info * rg * rg)


def _total_cost(problem: BAProblem, huber_delta: float):
    return _reproj_cost(problem, huber_delta) + _graph_cost(problem)


def optimize(problem: BAProblem, iters: int = 20,
             huber_delta: float = 0.0061, tol: float = 0.0, stats=None):
    """Full BA (OptimizerG2O::optimize). Returns (poses, points,
    final_cost), on the problem's device. huber_delta default =
    sqrt(5.991)/400, in normalized coords.

    tol == 0 runs `iters` LM steps with no host synchronisation. tol > 0
    stops once an accepted step improves the cost by less than `tol`
    relative, after at least two accepted steps (the reference's rule),
    reading one flag a step; `stats` (a dict), when given, receives
    "steps" and "host_syncs"."""

    def lm_step(poses, points, lam, cost):
        p = problem._replace(poses=poses, points=points)
        dc, dp = _assemble_and_solve(p, lam, huber_delta)
        new_poses = lie.se3_mul(lie.se3_exp(dc), poses)
        new_poses = torch.where(problem.pose_fixed[:, None], poses,
                                new_poses)
        new_points = points + dp
        new_cost = _total_cost(problem._replace(poses=new_poses,
                                                points=new_points),
                               huber_delta)
        accept = new_cost < cost
        poses = torch.where(accept, new_poses, poses)
        points = torch.where(accept, new_points, points)
        lam = torch.where(accept, lam * 0.5, lam * 4.0).clamp(1e-9, 1e6)
        rel = (cost - new_cost) / torch.clamp(cost, min=1e-12)
        cost = torch.where(accept, new_cost, cost)
        return poses, points, lam, cost, accept, rel

    poses, points = problem.poses, problem.points
    lam = torch.full((), 1e-4, dtype=poses.dtype, device=poses.device)
    cost = _total_cost(problem, huber_delta)
    steps = syncs = 0
    n_acc = torch.zeros((), dtype=torch.int32, device=poses.device)
    for _ in range(iters):
        poses, points, lam, cost, accept, rel = lm_step(poses, points, lam,
                                                        cost)
        steps += 1
        if tol > 0.0:
            n_acc = n_acc + accept.to(torch.int32)
            syncs += 1
            if bool(accept & (rel < tol) & (n_acc >= 2)):
                break
    if stats is not None:
        stats.update(steps=steps, host_syncs=syncs)
    return poses, points, cost


def optimize_pose_invdepth(T_cur_w2c, T_ref_c2w, rays_ref, rays_cur, w2d,
                           idepth0, p3d, p2n, w3d, iters: int = 12,
                           huber_delta: float = 0.0061):
    """Mixed pose optimization (optimizerG2O/Optimizer.cpp:445-492,
    EdgeSE3InvDepth): PnP edges on known 3D points plus epipolar 2D-2D
    edges with a per-match inverse depth q, X_world = T_ref_c2w (ray_ref /
    q); each q is a 1x1 block, eliminated by a division.

    rays_ref/rays_cur [M, 2] normalized coords; w2d [M] edge weights (0 =
    invalid); idepth0 [M] initial inverse depths; p3d/p2n/w3d pose-only PnP
    edges (points fixed). Returns (T_w2c, cost, idepth, chi2_2d [M],
    chi2_3d [N]). The Jacobians are closed forms; q = max(q + dq, 1e-6)
    takes the reference's derivative of the max (0.5 at the floor)."""
    dt, dev = T_cur_w2c.dtype, T_cur_w2c.device
    M = rays_ref.shape[0]
    ray3 = torch.cat([rays_ref, torch.ones_like(rays_ref[:, :1])], -1)
    R_ref = lie.quat_to_matrix(lie.se3_q(T_ref_c2w))

    def terms_2d(T, q):
        qq = torch.clamp(q, min=1e-6)
        Xw = lie.se3_apply(T_ref_c2w, ray3 / qq[:, None])
        r, Jc, _ = _reproj_terms(T.expand(M, 7), Xw, rays_cur)
        Tn = lie.se3_mul(lie.se3_exp(torch.zeros(6, dtype=dt, device=dev)),
                         T)
        R = lie.quat_to_matrix(lie.se3_q(Tn))
        dmax = torch.where(q > 1e-6, 1.0, torch.where(q == 1e-6, 0.5, 0.0))
        dX = (R_ref @ ray3.T).T * (-dmax / (qq * qq))[:, None]   # [M, 3]
        Jp = Jc[..., :3]                                         # d r/d pc
        Jq = torch.einsum("mij,jk,mk->mi", Jp, R, dX)            # [M, 2]
        return r, Jc, Jq

    def cost_fn(T, q):
        Xw = lie.se3_apply(T_ref_c2w, ray3 / torch.clamp(q, min=1e-6)[:, None])
        r2 = torch.sum(_reproj_val(T.expand(M, 7), Xw, rays_cur) ** 2, -1)
        r3 = torch.sum(_reproj_val(T.expand(p3d.shape[0], 7), p3d, p2n) ** 2,
                       -1)
        return (torch.sum(w2d * _huber_cost(r2, huber_delta))
                + torch.sum(w3d * _huber_cost(r3, huber_delta)))

    eye6 = _eye(6, T_cur_w2c)
    T = T_cur_w2c
    q = torch.clamp(idepth0.to(dt), min=1e-6)
    lam = torch.full((), 1e-4, dtype=dt, device=dev)
    cost = cost_fn(T, q)
    for _ in range(iters):
        r, Jp, Jq = terms_2d(T, q)
        sw = torch.sqrt(w2d * _huber_weight(torch.sum(r * r, -1),
                                            huber_delta))[:, None]
        Jp = Jp * sw[..., None]
        Jq = Jq * sw
        rw = r * sw
        r3, J3, _ = _reproj_terms(T.expand(p3d.shape[0], 7), p3d, p2n)
        sw3 = torch.sqrt(w3d * _huber_weight(torch.sum(r3 * r3, -1),
                                             huber_delta))[:, None]
        J3 = J3 * sw3[..., None]
        r3w = r3 * sw3
        # normal equations with the scalar Schur elimination of each q
        Hpp = (torch.einsum("mki,mkj->ij", Jp, Jp)
               + torch.einsum("mki,mkj->ij", J3, J3))
        bp = (-torch.einsum("mki,mk->i", Jp, rw)
              - torch.einsum("mki,mk->i", J3, r3w))
        Hqq_d = torch.sum(Jq * Jq, -1) * (1.0 + lam) + 1e-9
        bq = -torch.sum(Jq * rw, -1)
        Hpq = torch.einsum("mki,mk->mi", Jp, Jq)
        S = Hpp - torch.einsum("mi,mj->ij", Hpq / Hqq_d[:, None], Hpq)
        b_red = bp - torch.sum(Hpq * (bq / Hqq_d)[:, None], 0)
        Sd = S + lam * eye6 * torch.clamp(torch.trace(S) / 6.0, min=1e-6)
        dp = torch.linalg.solve_ex(Sd + 1e-9 * eye6, b_red)[0]
        dq = (bq - Hpq @ dp) / Hqq_d
        T_new = lie.se3_mul(lie.se3_exp(dp), T)
        q_new = torch.clamp(q + dq, min=1e-6)
        new_cost = cost_fn(T_new, q_new)
        accept = new_cost < cost
        T = torch.where(accept, T_new, T)
        q = torch.where(accept, q_new, q)
        lam = torch.where(accept, lam * 0.5, lam * 4.0).clamp(1e-9, 1e6)
        cost = torch.where(accept, new_cost, cost)
    Xw = lie.se3_apply(T_ref_c2w, ray3 / torch.clamp(q, min=1e-6)[:, None])
    chi2_2d = torch.sum(_reproj_val(T.expand(M, 7), Xw, rays_cur) ** 2, -1)
    chi2_3d = torch.sum(_reproj_val(T.expand(p3d.shape[0], 7), p3d, p2n)
                        ** 2, -1)
    z3d = lie.se3_apply(T, p3d)[..., 2]
    chi2_3d = torch.where(z3d > 1e-6, chi2_3d, math.inf)
    return T, cost, q, chi2_2d, chi2_3d


def optimize_se3_graph(poses, fixed, rel_i, rel_j, rel_meas, rel_weight,
                       iters: int = 30):
    """SE3 pose-graph optimization (LoopCloserSE3Graph's whole-map graph;
    Sophus EdgeSE3), dense [F,F,6,6] on the poses' device. Returns
    (poses, cost)."""
    prob = make_problem(poses=poses, pose_fixed=fixed, rel_i=rel_i,
                        rel_j=rel_j, rel_meas=rel_meas,
                        rel_weight=rel_weight, device=poses.device)
    new_poses, _, cost = optimize(prob, iters=iters)
    return new_poses, cost


def _sim3_residual(di, dj, Si, Sj, meas):
    Si = lie.sim3_mul(lie.sim3_exp(di), Si)
    Sj = lie.sim3_mul(lie.sim3_exp(dj), Sj)
    return lie.sim3_log(lie.sim3_mul(
        lie.sim3_inv(meas), lie.sim3_mul(lie.sim3_inv(Si), Sj)))


def optimize_sim3_graph(sims, fixed, rel_i, rel_j, rel_meas, rel_weight,
                        iters: int = 30):
    """7-DoF SIM3 pose-graph LM (BundleGraph.sim3Graph, Optimizer.h:165:
    edges measure SIM3_1^{-1} * SIM3_2), the monocular scale-drift
    correcting loop closure: the dense structure of the SE3 graph with
    sim3 exp/log and 7x7 blocks. Returns (sims, cost)."""
    F = sims.shape[0]
    dt, dev = sims.dtype, sims.device
    z7 = torch.zeros(7, dtype=dt, device=dev)
    rel_i, rel_j = rel_i.long(), rel_j.long()

    def val(S):
        return _sim3_residual(z7, z7, S[rel_i], S[rel_j], rel_meas)

    def cost_fn(S):
        r = val(S)
        return torch.sum(rel_weight * torch.sum(r * r, -1))

    sw = torch.sqrt(rel_weight)
    fi = (~fixed[rel_i]).to(dt)[:, None, None]
    fj = (~fixed[rel_j]).to(dt)[:, None, None]
    mask = (~fixed).repeat_interleave(7).to(dt)
    ar = torch.arange(F, device=dev)
    eye7 = _eye(7, sims)
    S = sims
    lam = torch.full((), 1e-4, dtype=dt, device=dev)
    cost = cost_fn(S)
    for _ in range(iters):
        r = val(S)
        Ji, Jj = _jacobians(_sim3_residual, 2, 7, S[rel_i], S[rel_j],
                            rel_meas)
        Ji = Ji * sw[:, None, None] * fi
        Jj = Jj * sw[:, None, None] * fj
        rw = r * sw[:, None]
        Hm = torch.zeros((F, F, 7, 7), dtype=dt, device=dev)
        Hm.index_put_((rel_i, rel_i), Ji.mT @ Ji, accumulate=True)
        Hm.index_put_((rel_j, rel_j), Jj.mT @ Jj, accumulate=True)
        Hm.index_put_((rel_i, rel_j), Ji.mT @ Jj, accumulate=True)
        Hm.index_put_((rel_j, rel_i), Jj.mT @ Ji, accumulate=True)
        b = torch.zeros((F, 7), dtype=dt, device=dev)
        _index_add_(b, rel_i, -torch.einsum("eki,ek->ei", Ji, rw))
        _index_add_(b, rel_j, -torch.einsum("eki,ek->ei", Jj, rw))
        tr = torch.diagonal(Hm[ar, ar], dim1=-2, dim2=-1).sum(-1)
        Hm.index_put_((ar, ar), lam * eye7 * torch.clamp(
            tr / 7.0, min=1e-6)[:, None, None], accumulate=True)
        Hmat = Hm.permute(0, 2, 1, 3).reshape(7 * F, 7 * F)
        Hmat = Hmat * mask[:, None] * mask[None, :] + torch.diag(1.0 - mask)
        dx = torch.linalg.solve_ex(Hmat + 1e-9 * _eye(7 * F, Hmat),
                                   b.reshape(-1) * mask)[0].reshape(F, 7)
        S_new = torch.where(fixed[:, None], S,
                            lie.sim3_mul(lie.sim3_exp(dx), S))
        new_cost = cost_fn(S_new)
        accept = new_cost < cost
        S = torch.where(accept, S_new, S)
        lam = torch.where(accept, lam * 0.5, lam * 4.0).clamp(1e-9, 1e6)
        cost = torch.where(accept, new_cost, cost)
    return S, cost


def optimize_icp(pa, pb, weight, iters: int = 8, huber_delta: float = 0.5,
                 fix_scale: bool = False):
    """SIM3/SE3 from 3D-3D correspondences (Optimizer::optimizeICP,
    Optimizer.h:210-217): the closed-form weighted Horn fit, re-weighted
    by the Huber kernel each iteration. pa -> pb. Returns (SIM3 [8],
    inlier_chi2 [N])."""
    from .ransac import sim3_horn
    w_huber = torch.ones(pa.shape[0], dtype=pa.dtype, device=pa.device)
    for _ in range(iters):
        S = sim3_horn(pa, pb, weight * w_huber)
        if fix_scale:
            S = lie.sim3(lie.sim3_t(S), lie.sim3_q(S),
                         torch.ones_like(lie.sim3_s(S)))
        r2 = torch.sum((lie.sim3_apply(S, pa) - pb) ** 2, -1)
        w_huber = _huber_weight(r2, huber_delta)
    return S, torch.sum((lie.sim3_apply(S, pa) - pb) ** 2, -1)


def fit_sim3(T1s, T2s, weight=None):
    """SIM3 between two synchronized trajectories (Optimizer::fitSim3,
    Optimizer.h:220-225) from the camera centres (Horn's closed form, as
    EstimatorOpenCV::findSIM3)."""
    from .ransac import sim3_horn
    return sim3_horn(T1s[..., :3], T2s[..., :3], weight)


def optimize_se3_graph_cg(poses, fixed, rel_i, rel_j, rel_meas, rel_weight,
                          iters: int = 15, cg_iters: int = 40):
    """Matrix-free SE3 pose-graph LM: H @ x edge by edge (gather, 6x6
    products, scatter-add) and the damped system solved by
    block-Jacobi-preconditioned CG; O(E) memory instead of the dense
    [F,F,6,6] assembly. Returns (poses, cost)."""
    F = poses.shape[0]
    dt, dev = poses.dtype, poses.device
    rel_i, rel_j = rel_i.long(), rel_j.long()
    freei = (~fixed[rel_i]).to(dt)[:, None, None]
    freej = (~fixed[rel_j]).to(dt)[:, None, None]
    free_all = (~fixed).to(dt)[:, None]
    sw = torch.sqrt(rel_weight)
    eye6 = _eye(6, poses)

    def cost_fn(p):
        r = _rel_val(p[rel_i], p[rel_j], rel_meas)
        return torch.sum(rel_weight * torch.sum(r * r, -1))

    def scatter(vi, vj):
        out = torch.zeros((F, 6), dtype=dt, device=dev)
        return _index_add_(_index_add_(out, rel_i, vi), rel_j, vj)

    p = poses
    lam = torch.full((), 1e-4, dtype=dt, device=dev)
    cost = cost_fn(p)
    for _ in range(iters):
        Ti, Tj = p[rel_i], p[rel_j]
        rw = _rel_val(Ti, Tj, rel_meas) * sw[:, None]
        Ji, Jj = _rel_jac(Ti, Tj, rel_meas)
        Ji = Ji * sw[:, None, None] * freei
        Jj = Jj * sw[:, None, None] * freej
        b = scatter(-torch.einsum("eki,ek->ei", Ji, rw),
                    -torch.einsum("eki,ek->ei", Jj, rw)) * free_all
        # the block diagonal of H (damping and preconditioner)
        D = torch.zeros((F, 6, 6), dtype=dt, device=dev)
        _index_add_(_index_add_(D, rel_i, Ji.mT @ Ji), rel_j, Jj.mT @ Jj)
        tr = torch.clamp(torch.diagonal(D, dim1=-2, dim2=-1).sum(-1) / 6.0,
                         min=1e-6)[:, None, None]
        damp = lam * tr * eye6 + 1e-8 * eye6
        Minv = torch.linalg.inv_ex(D + damp)[0]

        def Hx(x):
            x = x * free_all
            ye = (torch.einsum("eab,eb->ea", Ji, x[rel_i])
                  + torch.einsum("eab,eb->ea", Jj, x[rel_j]))
            out = scatter(torch.einsum("eab,ea->eb", Ji, ye),
                          torch.einsum("eab,ea->eb", Jj, ye))
            return (out + torch.einsum("fab,fb->fa", damp, x)) * free_all

        def prec(r):
            return torch.einsum("fab,fb->fa", Minv, r) * free_all

        x = torch.zeros((F, 6), dtype=dt, device=dev)
        r = b
        z = prec(b)
        pdir = z
        for _ in range(cg_iters):
            Hp = Hx(pdir)
            rz = torch.sum(r * z)
            alpha = rz / torch.clamp(torch.sum(pdir * Hp), min=1e-20)
            x = x + alpha * pdir
            r = r - alpha * Hp
            z = prec(r)
            beta = torch.sum(r * z) / torch.clamp(rz, min=1e-20)
            pdir = z + beta * pdir
        new_p = torch.where(fixed[:, None], p,
                            lie.se3_mul(lie.se3_exp(x), p))
        new_cost = cost_fn(new_p)
        accept = new_cost < cost
        p = torch.where(accept, new_p, p)
        lam = torch.where(accept, lam * 0.5, lam * 4.0).clamp(1e-9, 1e6)
        cost = torch.where(accept, new_cost, cost)
    return p, cost
