"""Pinhole camera: the intrinsics FastVO and the Map2D engines read.

Port of the fields and `is_valid` of pislamfusion_tpu/core/camera.py:34-73
(the `Camera` base class, GSLAM/GSLAM/core/Camera.h PinHole). The ATAN,
OpenCV and OCAM models and the camera's projection methods are not ported
yet.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class Camera:
    """Pinhole camera; width/height/intrinsics are Python scalars."""
    width: int
    height: int
    fx: float = 1.0
    fy: float = 1.0
    cx: float = 0.0
    cy: float = 0.0

    def is_valid(self):
        return (self.width > 0 and self.height > 0 and self.fx != 0
                and self.fy != 0)
