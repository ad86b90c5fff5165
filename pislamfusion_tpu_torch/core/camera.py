"""Polymorphic camera models, batched over pixels.

Port of pislamfusion_tpu/core/camera.py (GSLAM/GSLAM/core/Camera.h:
parameter vector [w, h] -> Ideal, [w,h,fx,fy,cx,cy] -> PinHole,
[w,h,fx,fy,cx,cy,d] -> ATAN/PTAM, [w,h,fx,fy,cx,cy,k1,k2,p1,p2,k3] ->
OpenCV, and the self-describing OCAM vector). A Camera is a small frozen
dataclass of Python scalars; `project` / `unproject` map [..., 3] <->
[..., 2] arrays. The reference's `_xp` chooses numpy or jax.numpy; here
`_xp` chooses numpy or torch: numpy in, numpy out (host bookkeeping never
touches the device); a tensor in, a tensor out, on the tensor's device.

Projection conventions (identical to the reference):
  PinHole : (x,y) = (fx*X/Z + cx, fy*Y/Z + cy)
  ATAN    : r' = atan(r * 2*tan(w/2)) / w        (Camera.h:80-90)
  OpenCV  : radial k1,k2,k3 + tangential p1,p2   (Camera.h:116-122)
`unproject` returns normalized image-plane coordinates (X/Z, Y/Z, 1)
(OCAM: unit-norm rays).
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from .device import resolve_device


class _TorchXP:
    """The numpy functions the camera models call, on tensors."""
    stack = staticmethod(torch.stack)
    sqrt = staticmethod(torch.sqrt)
    tan = staticmethod(torch.tan)
    arctan = staticmethod(torch.atan)
    arctan2 = staticmethod(torch.atan2)
    ones_like = staticmethod(torch.ones_like)
    zeros_like = staticmethod(torch.zeros_like)
    where = staticmethod(torch.where)

    @staticmethod
    def maximum(a, b):
        return torch.clamp(a, min=b)


def _xp(a):
    """Array module of `a`: numpy in, numpy out; a tensor in, a tensor out
    (on the tensor's device)."""
    return _TorchXP if isinstance(a, torch.Tensor) else np


@dataclasses.dataclass(frozen=True)
class Camera:
    """Base pinhole camera. width/height/intrinsics are static Python scalars."""
    width: int
    height: int
    fx: float = 1.0
    fy: float = 1.0
    cx: float = 0.0
    cy: float = 0.0

    # -- factory ------------------------------------------------------------
    @staticmethod
    def from_parameters(p: Sequence[float]) -> "Camera":
        p = [float(v) for v in p]
        if len(p) == 2:
            return Camera(int(p[0]), int(p[1]))
        if len(p) == 6:
            return Camera(int(p[0]), int(p[1]), *p[2:6])
        if len(p) == 7:
            return CameraATAN(int(p[0]), int(p[1]), *p[2:7])
        if len(p) == 11:
            return CameraOpenCV(int(p[0]), int(p[1]), *p[2:11])
        # self-describing OCAM vector (>= 12 entries; a degenerate
        # 1+1-coefficient OCAM would collide with OpenCV's 11 and loses —
        # real Scaramuzza calibs carry 4+ pol and 6+ invpol coefficients)
        if len(p) >= 12:
            cam = CameraOCAM._from_parameter_vector(p)
            if cam is not None:
                return cam
        raise ValueError(f"unsupported camera parameter count {len(p)}")

    def parameters(self):
        return [float(self.width), float(self.height),
                self.fx, self.fy, self.cx, self.cy]

    @property
    def name(self):
        return "PinHole" if (self.fx != 1.0 or self.cx != 0.0) else "Ideal"

    def is_valid(self):
        return self.width > 0 and self.height > 0 and self.fx != 0 and self.fy != 0

    def scaled(self, s: float) -> "Camera":
        return dataclasses.replace(self, width=int(self.width * s),
                                   height=int(self.height * s),
                                   fx=self.fx * s, fy=self.fy * s,
                                   cx=self.cx * s, cy=self.cy * s)

    def downsampled(self, s: int) -> "Camera":
        """Camera for an s*s box-downsampled image.

        Downsampled pixel j covers original pixels [j*s, j*s+s), so its
        center sits at original coordinate j*s + (s-1)/2 -- the principal
        point maps to (c - (s-1)/2)/s, not c/s.  `dataclasses.replace`
        preserves the subclass: ATAN/OpenCV distortion acts on NORMALIZED
        coordinates, which intrinsic scaling leaves untouched, so the
        coefficients carry over unchanged (OCAM distorts in pixel space
        and overrides this)."""
        off = (s - 1) / 2.0
        return dataclasses.replace(self, width=int(self.width // s),
                                   height=int(self.height // s),
                                   fx=self.fx / s, fy=self.fy / s,
                                   cx=(self.cx - off) / s,
                                   cy=(self.cy - off) / s)

    # -- distortion hooks (identity for pinhole) -----------------------------
    def _distort(self, xn, yn):
        return xn, yn

    def _undistort(self, xd, yd):
        return xd, yd

    # -- project / unproject --------------------------------------------------
    def project(self, p3d):
        """[..., 3] camera-frame points -> [..., 2] pixels."""
        xp = _xp(p3d)
        z_inv = 1.0 / p3d[..., 2]
        xn, yn = self._distort(p3d[..., 0] * z_inv, p3d[..., 1] * z_inv)
        return xp.stack([self.fx * xn + self.cx, self.fy * yn + self.cy], -1)

    def unproject(self, p2d):
        """[..., 2] pixels -> [..., 3] normalized rays (X/Z, Y/Z, 1)."""
        xp = _xp(p2d)
        xn, yn = self._undistort((p2d[..., 0] - self.cx) / self.fx,
                                 (p2d[..., 1] - self.cy) / self.fy)
        return xp.stack([xn, yn, xp.ones_like(xn)], -1)

    def in_view(self, p2d, margin: float = 0.0):
        """Boolean mask of pixels inside the image."""
        x, y = p2d[..., 0], p2d[..., 1]
        return ((x >= margin) & (x < self.width - margin)
                & (y >= margin) & (y < self.height - margin))


@dataclasses.dataclass(frozen=True)
class CameraATAN(Camera):
    """PTAM FOV model (Camera.h:91-112): one distortion coefficient d."""
    d: float = 0.0

    def parameters(self):
        return super().parameters() + [self.d]

    @property
    def name(self):
        return "ATAN"

    def _distort(self, xn, yn):
        if self.d == 0.0:
            return xn, yn
        xp = _xp(xn)
        tan2w = 2.0 * float(np.tan(self.d / 2.0))
        r = xp.sqrt(xn * xn + yn * yn).clip(1e-12)
        rd = xp.arctan(r * tan2w) / self.d
        k = rd / r
        return xn * k, yn * k

    def _undistort(self, xd, yd):
        if self.d == 0.0:
            return xd, yd
        xp = _xp(xd)
        tan2w = 2.0 * float(np.tan(self.d / 2.0))
        rd = xp.sqrt(xd * xd + yd * yd).clip(1e-12)
        r = xp.tan(rd * self.d) / tan2w
        k = r / rd
        return xd * k, yd * k


@dataclasses.dataclass(frozen=True)
class CameraOpenCV(Camera):
    """OpenCV distortion model (Camera.h:116-143): k1,k2,p1,p2,k3."""
    k1: float = 0.0
    k2: float = 0.0
    p1: float = 0.0
    p2: float = 0.0
    k3: float = 0.0

    def parameters(self):
        return super().parameters() + [self.k1, self.k2, self.p1, self.p2, self.k3]

    @property
    def name(self):
        return "OpenCV"

    def _distort(self, x, y):
        r2 = x * x + y * y
        radial = 1.0 + r2 * (self.k1 + r2 * (self.k2 + r2 * self.k3))
        xy2 = 2.0 * x * y
        xd = x * radial + self.p1 * xy2 + self.p2 * (r2 + 2.0 * x * x)
        yd = y * radial + self.p2 * xy2 + self.p1 * (r2 + 2.0 * y * y)
        return xd, yd

    def _undistort(self, xd, yd, iters: int = 8):
        # fixed-point inversion of the distortion (fixed iteration count —
        # compiler-friendly; matches cv::undistortPoints' iterative scheme)
        x, y = xd, yd
        for _ in range(iters):
            r2 = x * x + y * y
            radial = 1.0 + r2 * (self.k1 + r2 * (self.k2 + r2 * self.k3))
            xy2 = 2.0 * x * y
            dx = self.p1 * xy2 + self.p2 * (r2 + 2.0 * x * x)
            dy = self.p2 * xy2 + self.p1 * (r2 + 2.0 * y * y)
            x = (xd - dx) / radial
            y = (yd - dy) / radial
        return x, y


@dataclasses.dataclass(frozen=True)
class CameraOCAM(Camera):
    """Scaramuzza omnidirectional (fisheye/catadioptric) model.

    Reference: PIL/src/hardware/Camera/CameraImpl.cpp:360-418 and
    CameraOCAM.cpp:9-75 (calib-file loader). `pol` maps pixel radius ->
    mirror-axis component (unprojection); `invpol` maps incidence angle
    theta -> pixel radius (projection); (c, d, e) is the affine
    stretch matrix and (cx, cy) the distortion center. Unlike the
    pinhole family, `unproject` returns UNIT-NORM rays (the reference
    convention — the z component can be negative for >180-degree FOV)
    and `project` consumes camera-frame points directly.
    """
    pol: tuple = ()
    invpol: tuple = ()
    c: float = 1.0
    d: float = 0.0
    e: float = 0.0

    @property
    def name(self):
        return "OCAM"

    def is_valid(self):
        return (self.width > 0 and self.height > 0
                and len(self.pol) > 0 and len(self.invpol) > 0)

    def parameters(self):
        return [float(self.width), float(self.height), self.cx, self.cy,
                self.c, self.d, self.e,
                float(len(self.pol)), *self.pol,
                float(len(self.invpol)), *self.invpol]

    @staticmethod
    def _from_parameter_vector(p) -> "CameraOCAM | None":
        """Inverse of parameters(): [w, h, cx, cy, c, d, e, npol, pol...,
        ninvpol, invpol...]. Returns None unless the embedded counts are
        self-consistent (used by Camera.from_parameters dispatch, e.g.
        when a checkpointed map reloads its cameras)."""
        if len(p) < 10:
            return None
        npol = int(p[7])
        if npol < 1 or p[7] != npol or len(p) < 9 + npol:
            return None
        ninv = int(p[8 + npol])
        if ninv < 1 or p[8 + npol] != ninv or len(p) != 9 + npol + ninv:
            return None
        return CameraOCAM(width=int(p[0]), height=int(p[1]),
                          cx=p[2], cy=p[3], c=p[4], d=p[5], e=p[6],
                          pol=tuple(p[8:8 + npol]),
                          invpol=tuple(p[9 + npol:9 + npol + ninv]))

    @staticmethod
    def from_file(path: str) -> "CameraOCAM":
        """Parse the Scaramuzza toolbox calib_results.txt layout the
        reference loads (CameraOCAM.cpp:9-75): pol, invpol, center
        (row, col), affine (c, d, e), image size (height, width)."""
        rows = []
        with open(path) as f:
            for line in f:
                s = line.strip()
                if not s or s.startswith("#"):
                    continue
                rows.append([float(v) for v in s.split()])
        pol = tuple(rows[0][1:1 + int(rows[0][0])])
        invpol = tuple(rows[1][1:1 + int(rows[1][0])])
        xc, yc = rows[2]             # row, col of center (Matlab order)
        c, d, e = rows[3]
        height, width = int(rows[4][0]), int(rows[4][1])
        return CameraOCAM(width=width, height=height, cx=yc, cy=xc,
                          pol=pol, invpol=invpol, c=c, d=d, e=e)

    def downsampled(self, s: int) -> "CameraOCAM":
        """OCAM distorts in PIXEL space, so the polynomials rescale with
        the image: the sensor-plane radius r and components (xi, yp)
        all shrink by s, so pol'(r') = pol(s*r')/s (coefficient a_k ->
        a_k * s^(k-1)) keeps rays parallel, and invpol's output radius
        divides by s (all coefficients / s)."""
        off = (s - 1) / 2.0
        return dataclasses.replace(
            self, width=int(self.width // s), height=int(self.height // s),
            cx=(self.cx - off) / s, cy=(self.cy - off) / s,
            pol=tuple(a * float(s) ** (k - 1)
                      for k, a in enumerate(self.pol)),
            invpol=tuple(a / s for a in self.invpol))

    def project(self, p3d):
        """[..., 3] camera-frame points -> [..., 2] pixels
        (CameraImpl.cpp:360-396)."""
        xp = _xp(p3d)
        x, y, z = p3d[..., 0], p3d[..., 1], p3d[..., 2]
        norm = xp.sqrt(x * x + y * y)
        theta = xp.arctan2(-z, norm)     # atan(-z/norm), norm >= 0
        rho = xp.zeros_like(theta) + self.invpol[0]
        t_i = xp.ones_like(theta)
        for k in self.invpol[1:]:
            t_i = t_i * theta
            rho = rho + t_i * k
        invn = 1.0 / xp.maximum(norm, 1e-12)
        xi = x * invn * rho
        yi = y * invn * rho
        u = yi * self.e + xi + self.cx
        v = yi * self.c + xi * self.d + self.cy
        degenerate = norm < 1e-12
        u = xp.where(degenerate, self.cx + 0.0 * u, u)
        v = xp.where(degenerate, self.cy + 0.0 * v, v)
        return xp.stack([u, v], -1)

    def unproject(self, p2d):
        """[..., 2] pixels -> [..., 3] unit-norm rays
        (CameraImpl.cpp:398-418)."""
        xp = _xp(p2d)
        invdet = 1.0 / (self.c - self.d * self.e)
        du = p2d[..., 0] - self.cx
        dv = p2d[..., 1] - self.cy
        yp = invdet * (dv - self.d * du)
        xi = invdet * (-self.e * dv + self.c * du)
        r = xp.sqrt(xi * xi + yp * yp)
        zp = xp.zeros_like(r) + self.pol[0]
        r_i = xp.ones_like(r)
        for k in self.pol[1:]:
            r_i = r_i * r
            zp = zp + r_i * k
        invn = 1.0 / xp.sqrt(xi * xi + yp * yp + zp * zp)
        return xp.stack([invn * xi, invn * yp, -invn * zp], -1)


def undistort_map(cam: Camera, target: Camera | None = None, device=None):
    """Dense remap grid for image undistortion (reference Undistorter.h).

    Returns [H, W, 2] float32 source-pixel coordinates on `device` (None
    means `cuda`) such that `undistorted[y, x] = src[map[y, x, 1],
    map[y, x, 0]]` (bilinear; `ops.image.remap`).
    """
    dev = resolve_device(device)
    if target is None:
        target = Camera(cam.width, cam.height, cam.fx, cam.fy, cam.cx, cam.cy)
    ys, xs = torch.meshgrid(
        torch.arange(target.height, dtype=torch.float32, device=dev),
        torch.arange(target.width, dtype=torch.float32, device=dev),
        indexing="ij")
    rays = target.unproject(torch.stack([xs, ys], -1))
    return cam.project(rays)
