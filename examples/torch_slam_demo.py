"""Demo: monocular SLAM tracking on a synthetic drone survey, on the
PyTorch port (`pislamfusion_tpu_torch`).

The port's twin of examples/slam_demo.py, with the same survey, config and
printed lines: ORB features, two-view initialization, motion-model
tracking + local-map refinement, keyframe mapping with triangulation and
local bundle adjustment, dominant ground-plane estimation — then the
trajectory accuracy (ATE after SIM3 alignment, the monocular gauge), and
trajectory.txt / map.ply.

Usage: python examples/torch_slam_demo.py [out_dir] [--device cuda|cpu]
(the device defaults to cuda).
"""
import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np
import torch

from pislamfusion_tpu_torch.core.camera import Camera
from pislamfusion_tpu_torch.core.svar import Svar
from pislamfusion_tpu_torch.models.slam import create_slam
from pislamfusion_tpu_torch.ops import image as im, lie, ransac, mosaic as M

GROUND_SCALE = 0.1


def make_ground(rng, n=1024):
    g = np.full((n, n, 3), 120.0, np.float32)
    g += rng.normal(0, 4, (n, n, 3)).astype(np.float32)
    for _ in range(600):
        y, x = rng.integers(10, n - 40, 2)
        h, w = rng.integers(6, 36, 2)
        g[y:y + h, x:x + w] = rng.uniform(20, 235, 3)
    return np.clip(g, 0, 255)


def nadir_pose(x, y, z):
    return np.array([x, y, z, 1.0, 0.0, 0.0, 0.0])


def render_view(ground, cam, pose):
    """The view of the ground tensor from pose, as a numpy image."""
    H = M.homography_canvas_to_image_np(pose, cam, (0.0, 0.0), GROUND_SCALE)
    h = torch.from_numpy(np.linalg.inv(H).astype(np.float32)).to(
        ground.device)
    img, _ = im.warp_perspective(ground, h, (cam.height, cam.width),
                                 border="replicate")
    return img.cpu().numpy()


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("out_dir", nargs="?", default=".")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    out_dir = args.out_dir
    os.makedirs(out_dir, exist_ok=True)
    rng = np.random.default_rng(11)
    ground = torch.from_numpy(make_ground(rng)).to(args.device)
    cam = Camera(320, 240, 260.0, 260.0, 160.0, 120.0)
    poses = []
    for iy, y in enumerate(np.arange(30.0, 62.0, 8.0)):
        xs = np.arange(25.0, 70.0, 3.0)
        for x in (xs if iy % 2 == 0 else xs[::-1]):
            poses.append(nadir_pose(x, y, 25.0))
    gt = np.stack(poses)
    print(f"{len(poses)} frames, camera {cam.width}x{cam.height}")

    cfg = Svar()
    cfg.set("FeatureDetector", "ORB")
    cfg.set("SLAM.nFeature", "600")
    slam = create_slam(cfg, cam, device=args.device)
    t0 = time.perf_counter()
    for i, p in enumerate(poses):
        slam.track(render_view(ground, cam, p), float(i))
        if i == 2:
            t0 = time.perf_counter()  # after the first frames' set-up
    dt = time.perf_counter() - t0
    n = len(poses) - 2
    print(f"tracked {slam.frames_tracked}/{slam.frames_total} frames, "
          f"{n / dt:.2f} fps after warmup")
    print(f"map: {slam.map.point_num()} points, "
          f"{len(slam.map.keyframes())} keyframes, "
          f"plane {'estimated' if slam.plane is not None else 'pending'}")

    frames = [f for f in slam.map.frames()]
    est = torch.from_numpy(np.stack([f.pose_c2w[:3] for f in frames]))
    ids = np.asarray([f.id for f in frames])
    gt_pos = gt[ids][:, :3]
    S = ransac.sim3_horn(est.to(torch.float32),
                         torch.from_numpy(gt_pos.astype(np.float32)))
    est_aligned = lie.sim3_apply(S, est.to(torch.float32)).numpy()
    ate = float(np.sqrt(np.mean(np.sum((est_aligned - gt_pos) ** 2, -1))))
    span = float(np.linalg.norm(gt_pos.max(0) - gt_pos.min(0)))
    print(f"ATE {ate * 100:.2f} cm over a {span:.0f} m trajectory "
          f"({ate / span * 100:.3f}% of span)")

    slam.map.export_trajectory(f"{out_dir}/trajectory.txt")
    slam.map.export_ply(f"{out_dir}/map.ply")
    print(f"wrote {out_dir}/trajectory.txt, {out_dir}/map.ply")


if __name__ == "__main__":
    main()
