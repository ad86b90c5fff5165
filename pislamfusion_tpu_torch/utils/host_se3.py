"""Host-side (pure numpy) SE3 helpers for the tracker/mapper bookkeeping.

A copy of pislamfusion_tpu/utils/host_se3.py. The lie ops in ops/lie.py
run on tensors, and each call on the card is a launch and, read back, a
synchronisation: per-frame host bookkeeping stays in numpy. These mirror lie.py's conventions exactly: quaternion (x,y,z,w),
SE3 [t(3), q(4)], x' = R x + t.
"""
from __future__ import annotations

import numpy as np


def quat_conj(q):
    q = np.asarray(q)
    return np.concatenate([-q[..., :3], q[..., 3:4]], -1)


def quat_mul(a, b):
    ax, ay, az, aw = a[..., 0], a[..., 1], a[..., 2], a[..., 3]
    bx, by, bz, bw = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
    return np.stack([
        aw * bx + ax * bw + ay * bz - az * by,
        aw * by - ax * bz + ay * bw + az * bx,
        aw * bz + ax * by - ay * bx + az * bw,
        aw * bw - ax * bx - ay * by - az * bz,
    ], -1)


def quat_rotate(q, p):
    v, w = q[..., :3], q[..., 3:4]
    t = 2.0 * np.cross(v, p)
    return p + w * t + np.cross(v, t)


def se3_mul(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    t = quat_rotate(a[..., 3:7], b[..., :3]) + a[..., :3]
    q = quat_mul(a[..., 3:7], b[..., 3:7])
    q = q / np.linalg.norm(q, axis=-1, keepdims=True)
    return np.concatenate([t, q], -1)


def se3_inv(T):
    T = np.asarray(T, np.float64)
    qi = quat_conj(T[..., 3:7])
    return np.concatenate([-quat_rotate(qi, T[..., :3]), qi], -1)


def se3_apply(T, p):
    T = np.asarray(T, np.float64)
    return quat_rotate(T[..., 3:7], np.asarray(p, np.float64)) + T[..., :3]


def quat_to_matrix(q):
    x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return np.stack([
        np.stack([1 - 2 * (y * y + z * z), 2 * (x * y - z * w),
                  2 * (x * z + y * w)], -1),
        np.stack([2 * (x * y + z * w), 1 - 2 * (x * x + z * z),
                  2 * (y * z - x * w)], -1),
        np.stack([2 * (x * z - y * w), 2 * (y * z + x * w),
                  1 - 2 * (x * x + y * y)], -1),
    ], -2)


def sim3_fit_pose_gauge(poses_a, poses_b, w_axis: float = 1.0,
                        irls_iters: int = 3):
    """Robust least-squares SIM3 gauge (t, q(xyzw), s) mapping frame-a
    poses onto frame-b poses: c_b ~= s R c_a + t, R_b ~= R R_a.

    Unlike a Horn fit on camera CENTERS only (rotation about the track
    axis is unconstrained when the centers are collinear — every straight
    survey strip), this solves Wahba's problem over the centered center
    offsets PLUS each camera's rotation axes, so the gauge is fully
    constrained by a single pose pair and exact for rigid/similarity map
    moves (GPS SIM3 refits move all poses by one gauge transform).

    IRLS (Cauchy weights on the center residuals) downweights pose pairs
    from a DIFFERENT feed epoch — e.g. frames fed between a refit event
    and its processing carry no delta and would otherwise drag the fit
    off the majority gauge.

    poses_*: [N, 7] SE3 c2w rows. Returns np.float64 [8] = (t, q, s).
    Reference role: EstimatorOpenCV::findSIM3 (:94-160) feeds Horn with
    GPS-vs-map trajectories; the refresh gauge needs the pose-aware form.
    """
    Pa = np.asarray(poses_a, np.float64).reshape(-1, 7)
    Pb = np.asarray(poses_b, np.float64).reshape(-1, 7)
    ca, cb = Pa[:, :3], Pb[:, :3]
    Ra = quat_to_matrix(Pa[:, 3:7])          # [N, 3, 3]
    Rb = quat_to_matrix(Pb[:, 3:7])
    n = len(Pa)
    w = np.ones(n)

    def _fit(w):
        sw = max(w.sum(), 1e-12)
        ma = (ca * w[:, None]).sum(0) / sw
        mb = (cb * w[:, None]).sum(0) / sw
        A, B = ca - ma, cb - mb
        na = float(np.sqrt((w[:, None] * A ** 2).sum()))
        nb = float(np.sqrt((w[:, None] * B ** 2).sum()))
        s = nb / na if na > 1e-9 else 1.0
        # Wahba pairs: centered center offsets (rms-normalized so a long
        # trajectory doesn't drown the axes) + three camera axes per pose.
        M = np.zeros((3, 3))
        if na > 1e-9 and nb > 1e-9:
            M += (w[:, None] * A / na).T @ (B / nb)
        for k in range(3):
            M += (w_axis / max(sw, 1.0)) * (w[:, None] * Ra[:, :, k]).T \
                @ Rb[:, :, k]
        Sxx, Sxy, Sxz = M[0]
        Syx, Syy, Syz = M[1]
        Szx, Szy, Szz = M[2]
        N = np.array([
            [Sxx + Syy + Szz, Syz - Szy, Szx - Sxz, Sxy - Syx],
            [Syz - Szy, Sxx - Syy - Szz, Sxy + Syx, Szx + Sxz],
            [Szx - Sxz, Sxy + Syx, -Sxx + Syy - Szz, Syz + Szy],
            [Sxy - Syx, Szx + Sxz, Syz + Szy, -Sxx - Syy + Szz],
        ])
        _, evecs = np.linalg.eigh(N)
        qw, qx, qy, qz = evecs[:, -1]
        q = np.array([qx, qy, qz, qw])
        if q[3] < 0:
            q = -q
        q = q / np.linalg.norm(q)
        t = mb - s * quat_rotate(q, ma)
        return np.concatenate([t, q, [s]])

    S = _fit(w)
    spread = float(np.sqrt(((cb - cb.mean(0)) ** 2).sum(-1).mean()))
    for _ in range(irls_iters if n >= 4 else 0):
        r = np.linalg.norm(S[7] * quat_rotate(
            np.broadcast_to(S[3:7], (n, 4)), ca) + S[:3] - cb, axis=-1)
        sigma = max(1.4826 * float(np.median(r)), 1e-3 * max(spread, 1e-6))
        w = 1.0 / (1.0 + (r / sigma) ** 2)
        S = _fit(w)
    return S


def sim3_apply_se3(S, T):
    """Compose a SIM3 gauge with an SE3 pose: the SE3 part of S o T
    (scale folds into the translation, rotation composes)."""
    S = np.asarray(S, np.float64)
    T = np.asarray(T, np.float64)
    t = S[7] * quat_rotate(S[3:7], T[:3]) + S[:3]
    q = quat_mul(S[3:7], T[3:7])
    q = q / np.linalg.norm(q)
    return np.concatenate([t, q])


def sim3_inv(S):
    """Inverse of a SIM3 (t, q, s): x = s R y + t  =>  y = (1/s) R^-1 (x - t)."""
    S = np.asarray(S, np.float64)
    qi = quat_conj(S[3:7])
    si = 1.0 / S[7]
    return np.concatenate([-si * quat_rotate(qi, S[:3]), qi, [si]])
