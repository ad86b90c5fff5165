"""Demo: the FULL fused pipeline — SLAM -> plane -> orthomosaic — on the
PyTorch port (`pislamfusion_tpu_torch`).

The port's twin of examples/pipeline_demo.py, with the same survey,
config, printed lines and bars: a synthetic drone survey is tracked by
the monocular SLAM, the mapper's RANSAC plane crosses the Trans_Plane
queue, and the FusionSystem consumes the tracker's (image, pose) stream
into the multiband mosaic in its own thread (src/main.cpp Act=SLAM +
Map2DFusion TestSystem Map2DWithSLAM).

Writes result.png / trajectory.txt / map.ply to out_dir and prints
metrics: tracked ratio, SIM3-aligned ATE, and mosaic PSNR against the
ground-truth texture (resampled through the estimated similarity, so the
monocular gauge does not penalize the comparison); then PIPELINE OK when
more than 85 % of frames tracked, ATE is under 3 % of the span, the PSNR
over 14 dB and the fusion consumer raised nothing.

The scene families of pipeline_demo.py's `fixture` (the ablation axes of
doc/ABLATION.md): "flat", the procedural planar texture; "parallax", the
3D world of raised slabs with an exposure drift a frame
(scripts/torch_e2e_scenes.py, tests/synth_survey.py's counterparts);
"real", the aerial photograph turned and mirrored by the seed, with
sensor noise. `--gps SIGMA` adds a noisy GPS fix a frame, the reference's
deployment mode, which drives the mosaic's refresh/rebase chain.

Usage: python examples/torch_pipeline_demo.py [out_dir] [--device cuda|cpu]
    [--fixture flat|parallax|real] [--seed N] [--gps SIGMA]
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
from pislamfusion_tpu_torch.core.messenger import DataTrans
from pislamfusion_tpu_torch.core.svar import Svar
from pislamfusion_tpu_torch.models.fusion import FusionSystem
from pislamfusion_tpu_torch.models.map2d import _write_png
from pislamfusion_tpu_torch.models.slam import create_slam
from pislamfusion_tpu_torch.ops import image as im, lie, ransac, mosaic as M

GROUND_SCALE = 0.1  # m per ground-texture pixel


def make_ground(rng, n=1024, rects=900):
    """pipeline_demo.py's corner-rich APERIODIC texture: per-rect
    gradients + broadband noise."""
    g = np.full((n, n, 3), 120.0, np.float32)
    g += rng.normal(0, 8, (n, n, 3)).astype(np.float32)
    ramp = np.linspace(-14.0, 14.0, 64, dtype=np.float32)
    for _ in range(rects):
        y, x = rng.integers(10, n - 40, 2)
        h, w = rng.integers(6, 36, 2)
        base = rng.uniform(20, 235, 3).astype(np.float32)
        patch = base[None, None, :] + ramp[:h, None, None] \
            * rng.uniform(-1, 1) + ramp[:w][None, :, None] \
            * rng.uniform(-1, 1)
        patch = patch + rng.normal(0, 6, (h, w, 3))
        g[y:y + h, x:x + w] = patch
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


def survey_poses(alt=25.0, y0=28.0, y1=56.0, dy=7.0, x0=24.0, x1=62.0,
                 dx=3.0):
    poses = []
    for iy, y in enumerate(np.arange(y0, y1, dy)):
        xs = np.arange(x0, x1, dx)
        for x in (xs if iy % 2 == 0 else xs[::-1]):
            poses.append(nadir_pose(x, y, alt))
    return np.stack(poses)


def _f32(a):
    return torch.from_numpy(np.asarray(a, np.float32))


def mosaic_psnr_vs_truth(map2d, ground, S_gt2est, plane=None,
                         ground_scale=GROUND_SCALE):
    """pipeline_demo.py's measure: resample the blended mosaic onto the
    ground-texture grid (every second texel) through the estimated
    similarity and the canvas's plane, then PSNR over the covered
    pixels. Returns (PSNR dB, covered share of the texels)."""
    out, covered = map2d.blended()
    lp = map2d.length_pixel
    min_xy = map2d.min_xy
    if plane is None:
        plane = np.asarray(map2d.plane, np.float64)
    step = 2
    vs, us = np.meshgrid(np.arange(0, ground.shape[0], step),
                         np.arange(0, ground.shape[1], step), indexing="ij")
    world = np.stack([us * ground_scale, vs * ground_scale,
                      np.zeros_like(us, np.float64)], -1).reshape(-1, 3)
    est = lie.sim3_apply(_f32(S_gt2est), _f32(world))
    local = lie.se3_apply(lie.se3_inv(_f32(plane)), est).numpy()
    px = (local[:, 0] - min_xy[0]) / lp
    py = (local[:, 1] - min_xy[1]) / lp
    H, W = covered.shape
    x0 = np.clip(np.floor(px).astype(int), 0, W - 2)
    y0 = np.clip(np.floor(py).astype(int), 0, H - 2)
    inb = (px >= 0) & (px < W - 1) & (py >= 0) & (py < H - 1)
    cov = covered[y0, x0] & covered[y0 + 1, x0] & covered[y0, x0 + 1] \
        & covered[y0 + 1, x0 + 1] & inb
    fx = np.clip(px - x0, 0, 1)[:, None]
    fy = np.clip(py - y0, 0, 1)[:, None]
    sample = (out[y0, x0] * (1 - fx) * (1 - fy) + out[y0, x0 + 1] * fx
              * (1 - fy) + out[y0 + 1, x0] * (1 - fx) * fy
              + out[y0 + 1, x0 + 1] * fx * fy)
    gt = ground[vs.reshape(-1), us.reshape(-1)]
    if cov.sum() < 1000:
        return 0.0, 0.0
    err = sample[cov] - gt[cov]
    mse = float(np.mean(err ** 2))
    psnr = 10.0 * np.log10(255.0 ** 2 / max(mse, 1e-12))
    return psnr, float(cov.mean())


def _e2e_scenes():
    """scripts/torch_e2e_scenes.py: the parallax world and the photo."""
    scripts = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "scripts")
    if scripts not in sys.path:
        sys.path.insert(0, scripts)
    import torch_e2e_scenes
    return torch_e2e_scenes


def fixture_scene(fixture, rng, seed):
    """pipeline_demo.run_demo's scene of `fixture`, drawn from `rng` in its
    order: (ground truth texture [n, n, 3] float32, the parallax world or
    None)."""
    if fixture == "parallax":
        e2e = _e2e_scenes()
        world = e2e.make_world(rng)
        return e2e.true_ortho(world), world
    if fixture == "real":
        # the photo is deterministic: the seed turns and mirrors it and
        # draws the sensor noise
        ground = np.rot90(_e2e_scenes().real_ground(), int(seed) % 4).copy()
        if (int(seed) // 4) % 2:
            ground = ground[:, ::-1].copy()
        ground = np.clip(ground + rng.normal(0, 3.0, ground.shape), 0,
                         255).astype(np.float32)
        return ground, None
    if fixture != "flat":
        raise ValueError(f"unknown fixture {fixture!r}")
    return make_ground(rng), None


def run_demo(out_dir=".", seed=11, n_feats=600, loop_close=True,
             cam=None, poses=None, device="cuda", verbose=True,
             overrides=None, fixture="flat", gps_sigma=None):
    """pipeline_demo.run_demo on the port: `fixture` "flat", "parallax"
    (frames rendered with illumination drift 0.08, PSNR against the true
    orthophoto) or "real"; `gps_sigma` (meters) adds a noisy GPS fix a
    frame."""
    os.makedirs(out_dir, exist_ok=True)
    rng = np.random.default_rng(seed)
    ground, world = fixture_scene(fixture, rng, seed)
    if cam is None:
        cam = Camera(320, 240, 260.0, 260.0, 160.0, 120.0)
    if poses is None:
        poses = survey_poses()

    cfg = Svar()
    cfg.set("FeatureDetector", "ORB")
    cfg.set("SLAM.nFeature", str(n_feats))
    cfg.set("SLAM.MaxOverlap", "0.95")
    cfg.set("SLAM.LoopClose", "1" if loop_close else "0")
    cfg.set("SLAM.BAFrameCap", "8")
    cfg.set("SLAM.BAPointCap", "1024")
    cfg.set("SLAM.BAObsCap", "4096")
    cfg.set("SLAM.LocalBAIters", "8")
    cfg.set("Plane.MinPoints", "400")
    cfg.set("PrepareFrameNum", "8")
    cfg.set("Map2D.BandNumber", "4")
    for k, v in (overrides or {}).items():
        cfg.set(k, str(v))

    # fresh queues so repeated runs in one process don't cross-feed
    trans_q = DataTrans(30)
    plane_q = DataTrans(30)

    slam = create_slam(cfg, cam, device=device)
    slam.trans_queue = trans_q
    slam.plane_queue = plane_q
    fusion = FusionSystem(cfg, cam, trans_q=trans_q, plane_q=plane_q,
                          device=device).start()

    local = None
    if gps_sigma is not None:
        from pislamfusion_tpu_torch.core.gps import LocalFrame
        local = LocalFrame(108.9, 34.0, 0.0)   # arbitrary survey origin

    if world is not None:
        e2e = _e2e_scenes()
        world_t = e2e.world_on(world, slam.device)

        def render(pose, k):
            return e2e.render_view_3d(world_t, cam, pose, k=k, illum=0.08)
    else:
        ground_t = torch.from_numpy(ground).to(slam.device)

        def render(pose, k):
            return render_view(ground_t, cam, pose)
    t0 = time.perf_counter()
    for i, p in enumerate(poses):
        img = render(p, i)
        gps = None
        if local is not None:
            noisy = p[:3] + rng.normal(0, gps_sigma, 3)
            gps = local.local_to_lla(noisy)
        slam.track(img, float(i), gps_lla=gps,
                   gps_acc=gps_sigma if gps_sigma else 5.0)
        if verbose and (i + 1) % 10 == 0:
            print(f"  frame {i + 1}/{len(poses)} tracked="
                  f"{slam.frames_tracked} kf={len(slam.map.keyframes())} "
                  f"pts={slam.map.point_num()} fed={fusion.frames_fed}",
                  flush=True)
    slam.finish()
    slam.mapper.force_plane()
    fusion.finish()
    wall = time.perf_counter() - t0

    ratio = slam.frames_tracked / max(slam.frames_total, 1)
    # ATE: SIM3-align estimated keyframe centers to ground truth
    frames = [f for f in slam.map.frames()
              if f.n_tracked() > 0 or f.is_keyframe]
    est = np.stack([f.pose_c2w[:3] for f in frames])
    ids = np.asarray([f.id for f in frames])
    gt_pos = poses[ids][:, :3]
    S = ransac.sim3_horn(_f32(est), _f32(gt_pos))
    aligned = lie.sim3_apply(S, _f32(est)).numpy()
    ate = float(np.sqrt(np.mean(np.sum((aligned - gt_pos) ** 2, -1))))
    span = float(np.linalg.norm(gt_pos.max(0) - gt_pos.min(0)))

    psnr, coverage = 0.0, 0.0
    if fusion.map2d is not None and slam.plane is not None:
        S_gt2est = ransac.sim3_horn(_f32(gt_pos), _f32(est))
        psnr, coverage = mosaic_psnr_vs_truth(fusion.map2d, ground,
                                              S_gt2est.numpy())
        fusion.save(os.path.join(out_dir, "result.png"))
    slam.map.export_trajectory(os.path.join(out_dir, "trajectory.txt"))
    slam.map.export_ply(os.path.join(out_dir, "map.ply"))
    _write_png(os.path.join(out_dir, "ground_truth.png"),
               ground.astype(np.uint8))

    metrics = dict(
        frames=int(slam.frames_total), tracked_ratio=float(ratio),
        keyframes=len(slam.map.keyframes()),
        points=int(slam.map.point_num()),
        loops_closed=int(slam.loop_closer.closed_loops
                         if slam.loop_closer else 0),
        ate=ate, span=span, ate_pct=100.0 * ate / span,
        mosaic_frames=int(fusion.frames_fed), psnr=psnr, coverage=coverage,
        fusion_error=fusion.error, fusion_alive=fusion.alive(),
        wall_s=wall, fps=slam.frames_total / max(wall, 1e-9),
        gps_fitted=bool(slam.mapper.gps_fitted if slam.mapper else False),
        frames_refreshed=int(fusion.frames_refreshed))
    if verbose:
        print(f"tracked {metrics['frames']} frames at "
              f"{100 * ratio:.1f}% | {metrics['keyframes']} KFs, "
              f"{metrics['points']} points")
        print(f"ATE {ate:.3f} m over span {span:.1f} m "
              f"({metrics['ate_pct']:.2f}%)")
        print(f"mosaic: {fusion.frames_fed} frames blended, PSNR "
              f"{psnr:.2f} dB over {100 * coverage:.0f}% coverage")
        print(f"wall {wall:.1f}s ({metrics['fps']:.1f} fps)")
        if fusion.error:
            print(f"FUSION ERROR: {fusion.error}")
    return metrics


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("out_dir", nargs="?", default=".")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--fixture", default="flat",
                    choices=("flat", "parallax", "real"))
    ap.add_argument("--seed", type=int, default=11)
    ap.add_argument("--gps", type=float, default=None, metavar="SIGMA",
                    help="a GPS fix a frame with this noise (m)")
    args = ap.parse_args()
    m = run_demo(args.out_dir, seed=args.seed, device=args.device,
                 fixture=args.fixture, gps_sigma=args.gps)
    # pipeline_demo.py's bars
    ok = (m["tracked_ratio"] > 0.85 and m["ate_pct"] < 3.0
          and m["psnr"] > 14.0 and not m["fusion_error"]
          and not m["fusion_alive"])
    print("PIPELINE", "OK" if ok else "FAILED")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
