"""Batched Lie-group ops on tensors: SO3 / SE3 / SIM3.

Port of pislamfusion_tpu/ops/lie.py. Layouts are the reference's: a
quaternion is [..., 4] (x, y, z, w); an SE3 is [..., 7] (tx, ty, tz, qx,
qy, qz, qw) acting as x' = R x + t; a SIM3 is [..., 8] (t, q, s) acting as
x' = s R x + t. Every op takes arbitrary leading batch dims and runs in
the dtype and on the device it is given (the identities take `device`,
None meaning `cuda`).

Small-angle branches are `torch.where`s between Taylor series and the
closed forms, with the closed forms' arguments clamped, so values and
forward-mode tangents (`torch.func.jacfwd`, which BA's graph edges take
through `se3_log` and `sim3_log`) stay finite at theta == 0.
"""
from __future__ import annotations

import torch

from ..core.device import resolve_device

_EPS = 1e-8


def quat_identity(shape=(), dtype=torch.float32, device=None):
    q = torch.zeros(tuple(shape) + (4,), dtype=dtype,
                    device=resolve_device(device))
    q[..., 3] = 1.0
    return q


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
    """Rotate points p [..., 3] by quaternions q [..., 4] (broadcast)."""
    v, p = torch.broadcast_tensors(q[..., :3], p)
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


def quat_from_matrix(m):
    """[..., 3, 3] -> [..., 4] (x,y,z,w). Branch-free Shepperd's method:
    the candidate of the largest of (trace, m00, m11, m22), the first of
    equal ones, as the reference's argmax takes it."""
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    tr = m00 + m11 + m22
    # one (x, y, z, w) candidate per dominant component: w, x, y, z
    cand = torch.stack([
        torch.stack([m21 - m12, m02 - m20, m10 - m01, 1.0 + tr], -1),
        torch.stack([1.0 + m00 - m11 - m22, m01 + m10, m02 + m20,
                     m21 - m12], -1),
        torch.stack([m01 + m10, 1.0 - m00 + m11 - m22, m12 + m21,
                     m02 - m20], -1),
        torch.stack([m02 + m20, m12 + m21, 1.0 - m00 - m11 + m22,
                     m10 - m01], -1)], -2)
    scores = torch.stack([tr, m00, m11, m22], -1)
    best = first_argmax(scores)
    q = torch.gather(cand, -2, best[..., None, None].expand(
        best.shape + (1, 4)))[..., 0, :]
    q = quat_normalize(q)
    # canonical sign: w >= 0
    return q * torch.where(q[..., 3:4] < 0, -1.0, 1.0)


def first_argmax(x):
    """argmax over the last axis, the first of equal maxima, as
    `jnp.argmax` takes it (torch.argmax promises no order among ties)."""
    n = x.shape[-1]
    idx = torch.arange(n, device=x.device).expand(x.shape)
    top = torch.amax(x, -1, keepdim=True)
    return torch.where(x == top, idx, n).amin(-1)


def so3_log(q):
    """quaternion [..., 4] -> so3 vector [..., 3]."""
    q = q * torch.where(q[..., 3:4] < 0, -1.0, 1.0)  # shortest arc
    v = q[..., :3]
    w = q[..., 3:4].clamp(-1.0, 1.0)
    n2 = torch.sum(v * v, -1, keepdim=True)
    small = n2 < _EPS * _EPS
    # the norm of a clamped square: its tangent is finite at v == 0
    n = torch.sqrt(n2.clamp(min=_EPS * _EPS))
    theta = 2.0 * torch.atan2(n, w)
    k = torch.where(small, 2.0 / w.clamp(min=_EPS), theta / n)
    return v * k


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


def so3_from_euler(pitch, yaw, roll):
    """Euler (radians) -> quaternion [x, y, z, w], as the reference's
    SO3::FromEuler (GSLAM/GSLAM/core/SO3.h:391-412)."""
    cp, sp = torch.cos(pitch * 0.5), torch.sin(pitch * 0.5)
    cy, sy = torch.cos(yaw * 0.5), torch.sin(yaw * 0.5)
    cr, sr = torch.cos(roll * 0.5), torch.sin(roll * 0.5)
    return torch.stack([
        sr * cp * cy - cr * sp * sy,
        cr * sp * cy + sr * cp * sy,
        cr * cp * sy - sr * sp * cy,
        cr * cp * cy + sr * sp * sy,
    ], -1)


def se3(t, q):
    return torch.cat([t, q], -1)


def se3_identity(shape=(), dtype=torch.float32, device=None):
    dev = resolve_device(device)
    return se3(torch.zeros(tuple(shape) + (3,), dtype=dtype, device=dev),
               quat_identity(shape, dtype, dev))


def se3_t(T):
    return T[..., :3]


def se3_q(T):
    return T[..., 3:7]


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


def se3_matrix(T):
    """[..., 7] -> homogeneous [..., 4, 4]."""
    R = quat_to_matrix(se3_q(T))
    top = torch.cat([R, se3_t(T)[..., None]], -1)
    bottom = torch.zeros_like(top[..., :1, :])
    bottom[..., 0, 3] = 1.0
    return torch.cat([top, bottom], -2)


def se3_from_matrix(M):
    return se3(M[..., :3, 3], quat_from_matrix(M[..., :3, :3]))


def se3_log(T):
    """SE3 [..., 7] -> twist [..., 6] = (rho, w)."""
    w = so3_log(se3_q(T))
    theta2 = torch.sum(w * w, -1, keepdim=True)
    theta = torch.sqrt(theta2.clamp(min=_EPS * _EPS))
    small = theta2 < _EPS
    # V^{-1} = I - hat/2 + D * hat^2
    D = torch.where(small, 1.0 / 12.0 + theta2 / 720.0,
                    (1.0 - 0.5 * theta * torch.cos(0.5 * theta)
                     / torch.sin(0.5 * theta).clamp(min=_EPS))
                    / theta2.clamp(min=_EPS))
    H = so3_hat(w)
    eye = torch.eye(3, dtype=w.dtype, device=w.device).expand(H.shape)
    Vinv = eye - 0.5 * H + D[..., None] * (H @ H)
    rho = torch.einsum("...ij,...j->...i", Vinv, se3_t(T))
    return torch.cat([rho, w], -1)


# ---------------------------------------------------------------------------
# SIM3 (t, q, s) — x' = s * R x + t
# ---------------------------------------------------------------------------

def sim3(t, q, s):
    if s.ndim == t.ndim - 1:
        s = s[..., None]
    return torch.cat([t, q, s], -1)


def sim3_identity(shape=(), dtype=torch.float32, device=None):
    dev = resolve_device(device)
    return sim3(torch.zeros(tuple(shape) + (3,), dtype=dtype, device=dev),
                quat_identity(shape, dtype, dev),
                torch.ones(tuple(shape) + (1,), dtype=dtype, device=dev))


def sim3_t(S):
    return S[..., :3]


def sim3_q(S):
    return S[..., 3:7]


def sim3_s(S):
    return S[..., 7:8]


def sim3_apply(S, p):
    return sim3_s(S) * quat_rotate(sim3_q(S), p) + sim3_t(S)


def sim3_mul(S1, S2):
    q1, q2 = sim3_q(S1), sim3_q(S2)
    s1 = sim3_s(S1)
    t = s1 * quat_rotate(q1, sim3_t(S2)) + sim3_t(S1)
    return sim3(t, quat_normalize(quat_mul(q1, q2)), s1 * sim3_s(S2))


def sim3_inv(S):
    qi = quat_conj(sim3_q(S))
    si = 1.0 / sim3_s(S)
    return sim3(-si * quat_rotate(qi, sim3_t(S)), qi, si)


def sim3_from_se3(T, s=None):
    if s is None:
        s = torch.ones_like(T[..., :1])
    elif s.ndim == T.ndim - 1:
        s = s[..., None]
    return torch.cat([T, s], -1)


def sim3_to_se3(S):
    """Drop scale (keep rotation+translation)."""
    return S[..., :7]


def _sim3_w_coeffs(phi, sigma):
    """The W-matrix coefficients (C, A, B) of Sim3 exp such that
    W = C I + A hat(phi) + B hat(phi)^2 (Strasdat's thesis / Sophus
    sim3.hpp calc_W), every branch a `torch.where` on safe arguments."""
    theta2 = torch.sum(phi * phi, -1, keepdim=True)
    theta = torch.sqrt(theta2.clamp(min=_EPS * _EPS))
    s = torch.exp(sigma)
    sig_small = torch.abs(sigma) < 1e-5
    th_small = theta2 < _EPS
    sig_safe = torch.where(sig_small, 1.0, sigma)
    th_safe = torch.where(th_small, 1.0, theta)
    C = torch.where(sig_small, 1.0 + sigma / 2.0, (s - 1.0) / sig_safe)
    a = s * torch.sin(theta)
    b = s * torch.cos(theta)
    s2t2 = sig_safe * sig_safe + th_safe * th_safe
    # sigma ~ 0 (pure rotation)
    A0 = (1.0 - torch.cos(theta)) / th_safe ** 2
    B0 = (theta - torch.sin(theta)) / th_safe ** 3
    # general
    A1 = (a * sig_safe + (1.0 - b) * th_safe) / (th_safe * s2t2)
    B1 = (C - ((b - 1.0) * sig_safe + a * th_safe) / s2t2) / th_safe ** 2
    # theta ~ 0, sigma != 0
    A2 = torch.where(sig_small, 0.5,
                     ((sig_safe - 1.0) * s + 1.0) / (sig_safe ** 2))
    B2 = torch.where(
        sig_small, 1.0 / 6.0,
        (s * 0.5 * sig_safe ** 2 + s - 1.0 - sig_safe * s)
        / (sig_safe ** 3))
    A = torch.where(th_small, A2, torch.where(sig_small, A0, A1))
    B = torch.where(th_small, B2, torch.where(sig_small, B0, B1))
    return C, A, B


def _sim3_w(phi, sigma):
    C, A, B = _sim3_w_coeffs(phi, sigma)
    H = so3_hat(phi)
    eye = torch.eye(3, dtype=phi.dtype, device=phi.device).expand(H.shape)
    return C[..., None] * eye + A[..., None] * H + B[..., None] * (H @ H)


def sim3_exp(xi):
    """Sim3 exponential: xi [..., 7] = (rho, phi, sigma) -> SIM3 [..., 8]
    (Sophus sim3.hpp expmap; SIM3.h of the reference)."""
    rho, phi, sigma = xi[..., :3], xi[..., 3:6], xi[..., 6:7]
    t = torch.einsum("...ij,...j->...i", _sim3_w(phi, sigma), rho)
    return sim3(t, so3_exp(phi), torch.exp(sigma))


def sim3_log(S):
    """Sim3 log: SIM3 [..., 8] -> (rho, phi, sigma) [..., 7]."""
    phi = so3_log(sim3_q(S))
    sigma = torch.log(sim3_s(S).clamp(min=_EPS))
    # W^-1 t through the inverse: `torch.linalg.solve`'s forward-mode
    # tangents come out NaN under `torch.func.vmap` for some inputs, and
    # the graph LM takes its Jacobian that way
    rho = torch.einsum("...ij,...j->...i",
                       torch.linalg.inv_ex(_sim3_w(phi, sigma))[0],
                       sim3_t(S))
    return torch.cat([rho, phi, sigma], -1)


# ---------------------------------------------------------------------------
# misc
# ---------------------------------------------------------------------------

def se3_interpolate(T0, T1, alpha):
    """Geodesic interpolation between two SE3s (for GPS timestamp interp)."""
    d = se3_mul(se3_inv(T0), T1)
    return se3_mul(T0, se3_exp(alpha * se3_log(d)))
