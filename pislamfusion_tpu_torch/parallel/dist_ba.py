"""Distributed bundle adjustment: observation-sharded normal equations.

Port of pislamfusion_tpu/parallel/dist_ba.py:42-112. Each shard holds a
contiguous block of the reprojection observations and computes its
partial normal-equation terms (Hpp, bp, Hcc, bc, U: sums over
observations, `ops/ba._reproj_normal_terms`) on its device; one sum over
the shards an iteration (`mesh.reduce_sum`, the sum of `psum`) adds them
in shard order on the first shard's device. The small Schur-complement
solve, the graph terms (relative SE3 edges, GPS priors) and the LM accept
rule run once there, where the reference runs them replicated on every
device. No step reads back to the host: the loop runs `iters` LM steps.
"""
from __future__ import annotations

import torch

from ..ops import ba, lie
from .mesh import Mesh, blocks, on, reduce_sum


def _pad_obs_to(problem: ba.BAProblem, multiple: int) -> ba.BAProblem:
    """Pad the observations to a multiple of `multiple` with weight-0 rows
    (frame 0, point 0, uv 0), which add nothing to any sum."""
    O = problem.obs_uv.shape[0]
    pad = (-O) % multiple
    if pad == 0:
        return problem

    def padded(x):
        return torch.cat([x, x.new_zeros((pad,) + tuple(x.shape[1:]))])
    return problem._replace(
        obs_frame=padded(problem.obs_frame),
        obs_point=padded(problem.obs_point),
        obs_uv=padded(problem.obs_uv),
        obs_weight=padded(problem.obs_weight))


_OBS = ("obs_frame", "obs_point", "obs_uv", "obs_weight")


def _shards(problem: ba.BAProblem, mesh: Mesh):
    """One problem a shard on its device: the whole problem with that
    shard's contiguous block of observations."""
    out = []
    for dev, (a, b) in zip(mesh.flat, blocks(problem.obs_uv.shape[0],
                                             mesh.size)):
        p = problem._replace(**{k: getattr(problem, k)[a:b] for k in _OBS})
        out.append(ba.BAProblem(*[t.to(dev) for t in p]))
    return out


def optimize_sharded(problem: ba.BAProblem, mesh: Mesh, iters: int = 15,
                     huber_delta: float = 0.0061):
    """LM bundle adjustment with the observations sharded over every mesh
    device. Returns (poses, points, cost) on the first shard's device."""
    problem = _pad_obs_to(problem, mesh.size)
    shards = _shards(problem, mesh)
    p0 = shards[0]

    def with_state(p, poses, points):
        return p._replace(poses=poses.to(p.poses.device),
                          points=points.to(p.points.device))

    def dist_cost(poses, points):
        # only the observation shard is local: sum the reprojection cost
        # over the shards; the graph terms are whole, so add them once
        parts = []
        for p in shards:
            with on(p.poses.device):
                parts.append(ba._reproj_cost(with_state(p, poses, points),
                                             huber_delta))
        return reduce_sum(parts) + ba._graph_cost(with_state(p0, poses,
                                                             points))

    poses, points = p0.poses, p0.points
    lam = torch.full((), 1e-4, dtype=poses.dtype, device=poses.device)
    cost = dist_cost(poses, points)
    for _ in range(iters):
        terms = []
        for p in shards:
            with on(p.poses.device):
                terms.append(ba._reproj_normal_terms(
                    with_state(p, poses, points), huber_delta))
        # the only collective of the iteration: sum the partial terms
        Hpp, bp, Hcc, bc, U = reduce_sum(terms)
        pp = with_state(p0, poses, points)
        S_full, Hcc, bc = ba._graph_terms(pp, Hcc, bc)
        dc, dpt = ba._schur_solve(pp, Hpp, bp, Hcc, bc, U, S_full, lam)
        new_poses = lie.se3_mul(lie.se3_exp(dc), poses)
        new_poses = torch.where(p0.pose_fixed[:, None], poses, new_poses)
        new_points = points + dpt
        new_cost = dist_cost(new_poses, new_points)
        accept = new_cost < cost
        poses = torch.where(accept, new_poses, poses)
        points = torch.where(accept, new_points, points)
        lam = torch.where(accept, lam * 0.5, lam * 4.0).clamp(1e-9, 1e6)
        cost = torch.where(accept, new_cost, cost)
    return poses, points, cost
