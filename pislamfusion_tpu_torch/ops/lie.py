"""Batched quaternion SO3 / SE3 ops on tensors.

Port of the parts of pislamfusion_tpu/ops/lie.py:39-230 that FastVO and
the pose-only LM use. Layouts are the reference's: a quaternion is
[..., 4] (x, y, z, w); an SE3 is [..., 7] (tx, ty, tz, qx, qy, qz, qw)
acting as x' = R x + t. Every op takes arbitrary leading batch dims and
runs in the dtype it is given.
"""
from __future__ import annotations

import torch

_EPS = 1e-8


def quat_mul(q1, q2):
    """Hamilton product q1*q2, both [..., 4] (x,y,z,w)."""
    x1, y1, z1, w1 = q1.unbind(-1)
    x2, y2, z2, w2 = q2.unbind(-1)
    return torch.stack([
        w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
        w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
        w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
        w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
    ], -1)


def quat_conj(q):
    return torch.cat([-q[..., :3], q[..., 3:]], -1)


def quat_normalize(q):
    return q / torch.linalg.vector_norm(q, dim=-1, keepdim=True).clamp(
        min=_EPS)


def quat_rotate(q, p):
    """Rotate points p [..., 3] by quaternions q [..., 4]."""
    v = q[..., :3]
    w = q[..., 3:4]
    t = 2.0 * torch.linalg.cross(v, p, dim=-1)
    return p + w * t + torch.linalg.cross(v, t, dim=-1)


def quat_to_matrix(q):
    """[..., 4] -> [..., 3, 3] rotation matrices."""
    x, y, z, w = q.unbind(-1)
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    m = torch.stack([
        1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy),
        2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx),
        2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy),
    ], -1)
    return m.reshape(m.shape[:-1] + (3, 3))


def so3_hat(w):
    """[..., 3] -> skew matrices [..., 3, 3]."""
    z = torch.zeros_like(w[..., 0])
    wx, wy, wz = w.unbind(-1)
    m = torch.stack([z, -wz, wy, wz, z, -wx, -wy, wx, z], -1)
    return m.reshape(m.shape[:-1] + (3, 3))


def so3_exp(w):
    """so3 vector [..., 3] -> quaternion [..., 4]."""
    theta2 = torch.sum(w * w, -1, keepdim=True)
    theta = torch.sqrt(theta2.clamp(min=_EPS * _EPS))
    small = theta2 < _EPS
    half = 0.5 * theta
    k = torch.where(small, 0.5 - theta2 / 48.0, torch.sin(half) / theta)
    qw = torch.where(small, 1.0 - theta2 / 8.0, torch.cos(half))
    return torch.cat([w * k, qw], -1)


def se3(t, q):
    return torch.cat([t, q], -1)


def se3_apply(T, p):
    """Apply SE3 [..., 7] to points p [..., 3]."""
    return quat_rotate(T[..., 3:7], p) + T[..., :3]


def se3_mul(T1, T2):
    """Composition: (T1*T2)(x) = T1(T2(x))."""
    q1, q2 = T1[..., 3:7], T2[..., 3:7]
    t = quat_rotate(q1, T2[..., :3]) + T1[..., :3]
    return se3(t, quat_normalize(quat_mul(q1, q2)))


def se3_inv(T):
    qi = quat_conj(T[..., 3:7])
    return se3(-quat_rotate(qi, T[..., :3]), qi)


def _v_matrix(w, theta2):
    """Left-Jacobian V of SO3 for se3 exp: V = I + B*hat + C*hat^2."""
    theta = torch.sqrt(theta2.clamp(min=_EPS * _EPS))
    small = theta2 < _EPS
    B = torch.where(small, 0.5 - theta2 / 24.0,
                    (1.0 - torch.cos(theta)) / theta2.clamp(min=_EPS))
    C = torch.where(small, 1.0 / 6.0 - theta2 / 120.0,
                    (theta - torch.sin(theta))
                    / (theta2 * theta).clamp(min=_EPS))
    H = so3_hat(w)
    eye = torch.eye(3, dtype=w.dtype, device=w.device).expand(H.shape)
    return eye + B[..., None] * H + C[..., None] * (H @ H)


def se3_exp(xi):
    """twist [..., 6] = (rho, w) -> SE3 [..., 7]."""
    rho, w = xi[..., :3], xi[..., 3:6]
    theta2 = torch.sum(w * w, -1, keepdim=True)
    q = so3_exp(w)
    V = _v_matrix(w, theta2)
    t = torch.einsum("...ij,...j->...i", V, rho)
    return se3(t, q)
