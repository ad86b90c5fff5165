"""WGS84 geodesy: LLA <-> ECEF <-> local ENU, plus timestamped GPS
interpolation.

Equivalent of GSLAM/GSLAM/core/GPS.h (GPS2XYZ / XYZ2GPS ECEF conversion at
GPS.h:55-90, GPSArray interpolation) — but HOST-SIDE numpy float64 by design.

TPU-first precision split: ECEF magnitudes (~6.4e6 m) destroy float32, and the
TPU has no fast float64. The reference keeps double SE3 everywhere; we instead
anchor a local East-North-Up (ENU) frame at the first GPS fix and hand only
small-magnitude ENU coordinates (float32-safe) to device code. All math in this
module is numpy float64 and never traced by JAX.
"""
from __future__ import annotations

import numpy as np

# WGS84 constants
_A = 6378137.0              # semi-major axis
_F = 1.0 / 298.257223563    # flattening
_B = _A * (1.0 - _F)        # semi-minor axis
_E2 = _F * (2.0 - _F)       # first eccentricity^2
_EP2 = (_A * _A - _B * _B) / (_B * _B)  # second eccentricity^2


def lla_to_ecef(lon, lat, alt):
    """degrees, degrees, meters -> ECEF xyz (meters). Arrays or scalars."""
    lon = np.deg2rad(np.asarray(lon, np.float64))
    lat = np.deg2rad(np.asarray(lat, np.float64))
    alt = np.asarray(alt, np.float64)
    sin_lat, cos_lat = np.sin(lat), np.cos(lat)
    n = _A / np.sqrt(1.0 - _E2 * sin_lat * sin_lat)
    x = (n + alt) * cos_lat * np.cos(lon)
    y = (n + alt) * cos_lat * np.sin(lon)
    z = (n * (1.0 - _E2) + alt) * sin_lat
    return np.stack([x, y, z], axis=-1)


def ecef_to_lla(xyz):
    """ECEF xyz (meters) -> (lon_deg, lat_deg, alt_m). Bowring's closed form."""
    xyz = np.asarray(xyz, np.float64)
    x, y, z = xyz[..., 0], xyz[..., 1], xyz[..., 2]
    lon = np.arctan2(y, x)
    p = np.hypot(x, y)
    theta = np.arctan2(z * _A, p * _B)
    st, ct = np.sin(theta), np.cos(theta)
    lat = np.arctan2(z + _EP2 * _B * st ** 3, p - _E2 * _A * ct ** 3)
    sin_lat = np.sin(lat)
    n = _A / np.sqrt(1.0 - _E2 * sin_lat * sin_lat)
    alt = p / np.cos(lat) - n
    return np.stack([np.rad2deg(lon), np.rad2deg(lat), alt], axis=-1)


def enu_rotation(lon_deg, lat_deg):
    """Rotation matrix R such that enu = R @ (ecef - origin_ecef)."""
    lon = np.deg2rad(float(lon_deg))
    lat = np.deg2rad(float(lat_deg))
    sl, cl = np.sin(lon), np.cos(lon)
    sp, cp = np.sin(lat), np.cos(lat)
    return np.array([
        [-sl, cl, 0.0],
        [-sp * cl, -sp * sl, cp],
        [cp * cl, cp * sl, sp],
    ], np.float64)


class LocalFrame:
    """Local ENU tangent frame anchored at a (lon, lat, alt) origin.

    Device code works entirely in this frame (float32-safe magnitudes); ECEF
    appears only inside this class.
    """

    def __init__(self, lon_deg: float, lat_deg: float, alt: float = 0.0):
        self.origin_lla = np.array([lon_deg, lat_deg, alt], np.float64)
        self.origin_ecef = lla_to_ecef(lon_deg, lat_deg, alt)
        self.r_e2l = enu_rotation(lon_deg, lat_deg)   # ecef -> local

    def to_local(self, lon, lat, alt):
        ecef = lla_to_ecef(lon, lat, alt)
        return (ecef - self.origin_ecef) @ self.r_e2l.T

    def ecef_to_local(self, ecef):
        return (np.asarray(ecef, np.float64) - self.origin_ecef) @ self.r_e2l.T

    def local_to_ecef(self, enu):
        return np.asarray(enu, np.float64) @ self.r_e2l + self.origin_ecef

    def local_to_lla(self, enu):
        return ecef_to_lla(self.local_to_ecef(enu))


def lnglat_from_distance(lng0, lat0, dx_east, dy_north):
    """Offset a lon/lat by meters east/north (small-distance approximation,
    parity with PIL/src/hardware/Gps/utils_GPS calcLngLatFromDistance)."""
    lat = lat0 + np.rad2deg(dy_north / _A)
    lng = lng0 + np.rad2deg(dx_east / (_A * np.cos(np.deg2rad(lat0))))
    return lng, lat


def distance_from_lnglat(lng0, lat0, lng1, lat1):
    """Inverse of lnglat_from_distance: meters east/north from p0 to p1."""
    dy = np.deg2rad(lat1 - lat0) * _A
    dx = np.deg2rad(lng1 - lng0) * _A * np.cos(np.deg2rad(lat0))
    return dx, dy


class GPSArray:
    """Timestamped GPS track with linear interpolation (GPS.h GPSArray)."""

    def __init__(self):
        self._t = []
        self._lla = []  # (lon, lat, alt)
        self._frozen = None

    def add(self, t: float, lon: float, lat: float, alt: float):
        self._t.append(float(t))
        self._lla.append((float(lon), float(lat), float(alt)))
        self._frozen = None

    def __len__(self):
        return len(self._t)

    def _freeze(self):
        if self._frozen is None:
            order = np.argsort(np.asarray(self._t))
            self._frozen = (np.asarray(self._t, np.float64)[order],
                            np.asarray(self._lla, np.float64)[order])
        return self._frozen

    def at(self, t: float):
        """Interpolated (lon, lat, alt) at time t; None outside the track."""
        ts, lla = self._freeze()
        if len(ts) == 0 or t < ts[0] - 1.0 or t > ts[-1] + 1.0:
            return None
        i = int(np.clip(np.searchsorted(ts, t), 1, len(ts) - 1))
        t0, t1 = ts[i - 1], ts[i]
        a = 0.0 if t1 <= t0 else float(np.clip((t - t0) / (t1 - t0), 0.0, 1.0))
        return (1.0 - a) * lla[i - 1] + a * lla[i]


# ---------------------------------------------------------------------------
# attitude priors (GPS+IMU priory pose)
# ---------------------------------------------------------------------------

def _quat_from_euler(pitch: float, yaw: float, roll: float) -> np.ndarray:
    """numpy twin of SO3::FromEuler (radians; GSLAM/core/SO3.h:391-412):
    x = sr*cp*cy - cr*sp*sy, y = cr*sp*cy + sr*cp*sy,
    z = cr*cp*sy - sr*sp*cy, w = cr*cp*cy + sr*sp*sy."""
    cp, sp = np.cos(pitch * 0.5), np.sin(pitch * 0.5)
    cy, sy = np.cos(yaw * 0.5), np.sin(yaw * 0.5)
    cr, sr = np.cos(roll * 0.5), np.sin(roll * 0.5)
    return np.array([sr * cp * cy - cr * sp * sy,
                     cr * sp * cy + sr * cp * sy,
                     cr * cp * sy - sr * sp * cy,
                     cr * cp * cy + sr * sp * sy], np.float64)


def pyr_to_rotation(pitch: float, yaw: float, roll: float) -> np.ndarray:
    """Drone attitude (pitch/yaw/roll, DEGREES) -> camera-to-ENU quaternion
    [x, y, z, w].

    Mirrors PYR2Rotation (GSLAM-DIYSLAM/src/MapFrame.cpp:360-367): gimbal
    roll near ±180 is folded, the IMU->world rotation is FromEulerAngle
    (-pitch, 90-yaw, roll), and camera axes map to IMU axes through the
    fixed quaternion (-0.5, 0.5, -0.5, 0.5). The reference then places this
    "local" frame into ECEF with east/north/up columns (MapFrame.cpp:387-396)
    — i.e. its local frame IS the ENU frame this build uses, so the output
    composes directly with gps ENU fixes."""
    from ..utils import host_se3 as hse3
    if abs(180.0 - abs(roll)) < 10.0:
        roll = roll + 180.0
    d2r = np.pi / 180.0
    imu2world = _quat_from_euler(-pitch * d2r, (90.0 - yaw) * d2r,
                                 roll * d2r)
    cam2imu = np.array([-0.5, 0.5, -0.5, 0.5], np.float64)
    q = hse3.quat_mul(imu2world, cam2imu)
    return (q / np.linalg.norm(q)).astype(np.float64)


# ---------------------------------------------------------------------------
# Chinese map datum shifts (GCJ-02 "Mars", BD-09 Baidu). The reference's
# tile stack carries these converters for serving mosaics over Chinese
# basemaps (GSLAM/GSLAM/core/TileProjection.h:90-240 GPSConverter and the
# identical copy in thirdparty/opmapcontrol mercatorprojection.cpp). The
# formulas below are the standard published GCJ-02/BD-09 transforms — the
# constants ARE the datum definition, so they match the reference's (and
# everyone else's) bit for bit.
# ---------------------------------------------------------------------------

_GCJ_A = 6378245.0
_GCJ_EE = 0.00669342162296594323


def _out_of_china(lat, lon):
    return not (72.004 <= lon <= 137.8347 and 0.8293 <= lat <= 55.8271)


def _transform_lat(x, y):
    ret = (-100.0 + 2.0 * x + 3.0 * y + 0.2 * y * y + 0.1 * x * y
           + 0.2 * np.sqrt(abs(x)))
    ret += (20.0 * np.sin(6.0 * x * np.pi)
            + 20.0 * np.sin(2.0 * x * np.pi)) * 2.0 / 3.0
    ret += (20.0 * np.sin(y * np.pi)
            + 40.0 * np.sin(y / 3.0 * np.pi)) * 2.0 / 3.0
    ret += (160.0 * np.sin(y / 12.0 * np.pi)
            + 320.0 * np.sin(y * np.pi / 30.0)) * 2.0 / 3.0
    return ret


def _transform_lon(x, y):
    ret = (300.0 + x + 2.0 * y + 0.1 * x * x + 0.1 * x * y
           + 0.1 * np.sqrt(abs(x)))
    ret += (20.0 * np.sin(6.0 * x * np.pi)
            + 20.0 * np.sin(2.0 * x * np.pi)) * 2.0 / 3.0
    ret += (20.0 * np.sin(x * np.pi)
            + 40.0 * np.sin(x / 3.0 * np.pi)) * 2.0 / 3.0
    ret += (150.0 * np.sin(x / 12.0 * np.pi)
            + 300.0 * np.sin(x / 30.0 * np.pi)) * 2.0 / 3.0
    return ret


def wgs84_to_gcj02(lat: float, lon: float):
    """WGS-84 -> GCJ-02 (TileProjection.h gps84_To_Gcj02)."""
    if _out_of_china(lat, lon):
        return lat, lon
    dlat = _transform_lat(lon - 105.0, lat - 35.0)
    dlon = _transform_lon(lon - 105.0, lat - 35.0)
    radlat = lat / 180.0 * np.pi
    magic = 1 - _GCJ_EE * np.sin(radlat) ** 2
    sqrtmagic = np.sqrt(magic)
    dlat = (dlat * 180.0) / ((_GCJ_A * (1 - _GCJ_EE))
                             / (magic * sqrtmagic) * np.pi)
    dlon = (dlon * 180.0) / (_GCJ_A / sqrtmagic * np.cos(radlat) * np.pi)
    return lat + dlat, lon + dlon


def gcj02_to_wgs84(lat: float, lon: float):
    """GCJ-02 -> WGS-84 (one-step inverse, gcj_To_Gps84)."""
    glat, glon = wgs84_to_gcj02(lat, lon)
    return lat * 2 - glat, lon * 2 - glon


# BD-09 uses x_pi = pi*3000/180 in its perturbation terms (the reference's
# opmapcontrol copy spells it `pi` but the published Baidu transform — and
# correct placement on Baidu tiles — requires x_pi; using plain pi lands
# ~25 m off in Beijing)
_X_PI = np.pi * 3000.0 / 180.0


def gcj02_to_bd09(lat: float, lon: float):
    """GCJ-02 -> BD-09 (gcj02_To_Bd09)."""
    z = np.sqrt(lon * lon + lat * lat) + 0.00002 * np.sin(lat * _X_PI)
    theta = np.arctan2(lat, lon) + 0.000003 * np.cos(lon * _X_PI)
    return z * np.sin(theta) + 0.006, z * np.cos(theta) + 0.0065


def bd09_to_gcj02(lat: float, lon: float):
    """BD-09 -> GCJ-02 (bd09_To_Gcj02)."""
    x, y = lon - 0.0065, lat - 0.006
    z = np.sqrt(x * x + y * y) - 0.00002 * np.sin(y * _X_PI)
    theta = np.arctan2(y, x) - 0.000003 * np.cos(x * _X_PI)
    return z * np.sin(theta), z * np.cos(theta)


def wgs84_to_bd09(lat: float, lon: float):
    return gcj02_to_bd09(*wgs84_to_gcj02(lat, lon))


def bd09_to_wgs84(lat: float, lon: float):
    return gcj02_to_wgs84(*bd09_to_gcj02(lat, lon))


def datum_shift(lat: float, lon: float, datum: str = "wgs84"):
    """Map a WGS-84 fix into the serving datum ('wgs84'|'gcj02'|'bd09') —
    the choice the reference's map widget makes per basemap provider."""
    if datum == "gcj02":
        return wgs84_to_gcj02(lat, lon)
    if datum == "bd09":
        return wgs84_to_bd09(lat, lon)
    if datum == "wgs84":
        return lat, lon
    raise ValueError(f"unknown datum {datum!r}")
