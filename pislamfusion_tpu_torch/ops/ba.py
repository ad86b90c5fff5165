"""Pose-only Levenberg-Marquardt with a Huber kernel.

Port of pislamfusion_tpu/ops/ba.py `optimize_pose` (:399-444) with
`_reproj_residual`, `_pose_jac_analytic` and `_huber_weight`
(:108-146, :171-174) — OptimizerG2O::optimizePnP (Optimizer.cpp:18-165):
a 6x6 system, points fixed. The rest of ba.py is not ported yet.

The LM loop runs on the tensors' device without reading anything back:
accept/reject is a `torch.where`, and the 6x6 solve is `solve_ex`, which
does not wait on an error check.
"""
from __future__ import annotations

import torch

from . import lie


def _reproj_residual(T_w2c, X, uv):
    """Residuals [N, 2] at the unperturbed pose (the reference's residual
    at delta = 0: T = exp(0) * T)."""
    z6 = torch.zeros(6, dtype=T_w2c.dtype, device=T_w2c.device)
    T = lie.se3_mul(lie.se3_exp(z6), T_w2c)
    pc = lie.se3_apply(T.expand(X.shape[0], 7), X)
    z = pc[:, 2]
    zs = torch.where(z.abs() < 1e-9, torch.full_like(z, 1e-9), z)
    r = pc[:, :2] / zs[:, None] - uv
    return torch.where((z > 1e-6)[:, None], r, torch.zeros_like(r))


def _pose_jac_analytic(T_w2c, p3d, uv):
    """(residual [N,2], J [N,2,6]) wrt a LEFT se3 perturbation, closed
    form through the pinhole projection."""
    pc = lie.se3_apply(T_w2c.expand(p3d.shape[0], 7), p3d)
    x, y, z = pc.unbind(-1)
    zs = torch.where(z.abs() < 1e-9, torch.full_like(z, 1e-9), z)
    good = z > 1e-6
    r = torch.where(good[:, None], pc[..., :2] / zs[..., None] - uv,
                    torch.zeros_like(uv))
    iz = 1.0 / zs
    iz2 = iz * iz
    zr = torch.zeros_like(iz)
    Jp = torch.stack([torch.stack([iz, zr, -x * iz2], -1),
                      torch.stack([zr, iz, -y * iz2], -1)], -2)  # [N, 2, 3]
    Jrot = -torch.einsum("nij,njk->nik", Jp, lie.so3_hat(pc))
    Jc = torch.cat([Jp, Jrot], -1)                               # [N, 2, 6]
    return r, torch.where(good[:, None, None], Jc, torch.zeros_like(Jc))


def _huber_weight(r2, delta):
    """IRLS weight for the Huber kernel at squared residual r2."""
    r = torch.sqrt(torch.clamp(r2, min=1e-18))
    return torch.where(r <= delta, torch.ones_like(r), delta / r)


def optimize_pose(T_w2c, p3d, p2n, weight, iters: int = 10,
                  huber_delta: float = 0.0061):
    """Pose-only LM. T_w2c [7]; p3d [N, 3]; p2n [N, 2] normalized image
    coords; weight [N] (0 = invalid). Returns (T, cost, per-point chi2)."""
    dev, dt = T_w2c.device, T_w2c.dtype

    def cost_fn(T):
        r2 = torch.sum(_reproj_residual(T, p3d, p2n) ** 2, -1)
        d = huber_delta
        c = torch.where(r2 <= d * d, r2,
                        2 * d * torch.sqrt(torch.clamp(r2, min=1e-18))
                        - d * d)
        return torch.sum(weight * c)

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
    chi2 = torch.sum(_reproj_residual(T, p3d, p2n) ** 2, -1)
    z = lie.se3_apply(T.expand(p3d.shape[0], 7), p3d)[..., 2]
    chi2 = torch.where(z > 1e-6, chi2, torch.full_like(chi2, float("inf")))
    return T, cost, chi2
