"""PyTorch + CUDA port of pislamfusion_tpu for NVIDIA Hopper (sm_90a).

The JAX package (`pislamfusion_tpu`) is the reference; this package mirrors
its layout module by module and imports nothing of it (nor of JAX). Every
Pallas TPU kernel on a ported path is a hand-written CUDA kernel here
(`csrc/`), built at first use by `_build.py`, with a plain PyTorch version
of the same function beside it. A wrapper takes the plain version only
for a tensor on the CPU; for a CUDA tensor it launches its kernel or
raises.

Ported so far: the FastVO track+fuse path (`models/fastvo.py`), with the
ORB and the SIFT detector, the Map2D orthomosaic engines
(`models/map2d.py`, Map2D.Type 1-4, `create_map2d`), SLAM's geometric
base (the camera models, the host modules of `core/`, `utils/`, `io/`,
and the solvers), SLAM itself in its offline configuration
(`models/slam.py`) and the fused system: the fusion consumer
(`models/fusion.py`), the exporters, tiles and viz, the binary
`python -m pislamfusion_tpu_torch` (`app.py`), and the scale-out layer
over a mesh of devices in one process (`parallel/`).
"""
from .core.camera import Camera
from .core.device import resolve_device
from .models.fastvo import FastVO
from .models.map2d import create_map2d

__all__ = ["Camera", "FastVO", "create_map2d", "resolve_device"]
