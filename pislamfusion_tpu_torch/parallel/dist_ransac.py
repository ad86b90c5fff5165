"""Mesh-sharded RANSAC: the hypothesis search fanned out over every shard.

Port of pislamfusion_tpu/parallel/dist_ransac.py:35-97. Each shard draws
its own hypothesis set from a generator of its own on its device, seeded
from one draw of the caller's generator a shard, and scores it with the
single-device estimator (`ops/ransac`); the global best is the gathered
results' `argmax(where(ok, score, -1))`, the first shard on a tie. D
shards buy D x the hypothesis budget. The draws differ from the JAX
package's by construction (its keys are not torch generators).
"""
from __future__ import annotations

import torch

from ..ops import ransac
from ..ops.ransac import RansacResult
from .mesh import Mesh, gather, on


def _shard_generators(generator: torch.Generator, mesh: Mesh):
    """One generator a shard on its device, seeded from one draw a shard
    of the caller's generator."""
    seeds = torch.randint(0, 2 ** 62, (mesh.size,), generator=generator,
                          device=generator.device).tolist()
    return [torch.Generator(device=d).manual_seed(int(s))
            for d, s in zip(mesh.flat, seeds)]


def _sharded(estimate, generator, inputs, mesh: Mesh) -> RansacResult:
    results = []
    for d, g in zip(mesh.flat, _shard_generators(generator, mesh)):
        with on(d):
            results.append(estimate(g, *[x.to(d) for x in inputs]))
    # global best by inlier count across the flattened mesh
    models, inls, counts, oks = gather(
        [(r.model, r.inliers, r.score, r.ok) for r in results])
    best = torch.argmax(torch.where(oks, counts, torch.full_like(counts,
                                                                 -1.0)))
    return RansacResult(models[best], inls[best], counts[best], oks[best])


def find_pnp_sharded(generator, p3d, p2n, valid, mesh: Mesh,
                     threshold: float = 0.01,
                     iters_per_device: int = 256) -> RansacResult:
    """PnP RANSAC with D x iters_per_device hypotheses (D = mesh size).
    Returns a RansacResult like ops.ransac.find_pnp's, on the first shard's
    device."""
    return _sharded(
        lambda g, a, b, v: ransac.find_pnp(g, a, b, v, threshold=threshold,
                                           iters=iters_per_device),
        generator, (p3d, p2n, valid), mesh)


def find_homography_sharded(generator, pa, pb, valid, mesh: Mesh,
                            threshold: float = 3.0,
                            iters_per_device: int = 256) -> RansacResult:
    """Homography RANSAC over the mesh (the same reduction as
    find_pnp_sharded)."""
    return _sharded(
        lambda g, a, b, v: ransac.find_homography(
            g, a, b, v, threshold=threshold, iters=iters_per_device),
        generator, (pa, pb, valid), mesh)
