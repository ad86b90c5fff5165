"""Scale-out over a mesh of devices in one process (port of
pislamfusion_tpu/parallel/): `mesh` (the mesh, `psum`, `all_gather`),
`batch` (batched detectors and matching over `dp`), `dist_ba`
(observation-sharded BA), `dist_ransac` (hypotheses over the mesh),
`dist_mosaic` (a row-striped canvas) and `dist_vo` (segment-parallel
FastVO)."""
from .mesh import make_mesh, default_mesh_shape
from . import dist_ba, batch


def __getattr__(name):   # lazy: dist_mosaic/dist_ransac pull heavy deps
    if name in ("dist_mosaic", "dist_ransac", "dist_vo"):
        import importlib
        return importlib.import_module(f".{name}", __name__)
    raise AttributeError(name)
