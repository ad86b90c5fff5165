"""Demo: FastVO, the batch track+fuse path, on the PyTorch port
(`pislamfusion_tpu_torch`).

The port's twin of examples/fastvo_demo.py, with the same survey and
printed lines: a synthetic nadir survey goes through ORB extraction,
windowed Hamming matching against the previous frame's ground-plane
points, pose-only LM, homography warp, Laplacian pyramid and max-weight
composite, with nothing read back inside the batch. Reports the recovered
pose error, throughput and mosaic PSNR against the ground texture, and
writes result.png. Usage:

    python examples/torch_fastvo_demo.py [out_dir] [--frames N]
        [--segments K [--correct] [--nogps] [--shards D]]
        [--device cuda|cpu]

--segments runs the segment-parallel survey (parallel/dist_vo.py) over a
mesh of D shards (default: every card with more than one, else none; on
the CPU, D shards of it). The device defaults to cuda.
"""
import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np
import torch

from pislamfusion_tpu_torch.core.camera import Camera
from pislamfusion_tpu_torch.models.fastvo import FastVO
from pislamfusion_tpu_torch.models.map2d import _write_png
from pislamfusion_tpu_torch.ops import image as im
from pislamfusion_tpu_torch.ops import mosaic as M

GROUND_SCALE = 0.1  # m per ground-texture pixel


def make_ground(rng, n=1024, rects=700):
    """tests/synth_survey.py's aperiodic, corner-rich ground texture."""
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


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("out_dir", nargs="?", default=".")
    ap.add_argument("--frames", type=int, default=24)
    ap.add_argument("--segments", type=int, default=0)
    ap.add_argument("--correct", action="store_true")
    ap.add_argument("--nogps", action="store_true")
    ap.add_argument("--shards", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    out_dir = args.out_dir
    os.makedirs(out_dir, exist_ok=True)
    n_frames = args.frames
    # GPS-free coarse-pass anchors only exist on the --segments path
    nogps = bool(args.segments) and args.nogps

    rng = np.random.default_rng(7)
    ground_np = make_ground(rng)
    ground = torch.from_numpy(ground_np).to(args.device)
    cam = Camera(320, 240, 260.0, 260.0, 160.0, 120.0)
    poses = []
    for i in range(n_frames):
        row, col = divmod(i, 12)
        x = 28.0 + 2.5 * (col if row % 2 == 0 else 11 - col)
        poses.append(nadir_pose(x, 38.0 + 4.0 * row, 25.0))
    poses = np.stack(poses)
    frames = np.stack([render_view(ground, cam, p) for p in poses])
    print(f"{len(poses)} frames, camera {cam.width}x{cam.height}")

    lp, _ = M.auto_resolution(cam, 25.0, 0.5)
    es = M.ELE_PIXELS * lp
    min_xy = poses[:, :2].min(0) - 1.0 * es
    span = poses[:, :2].max(0) - min_xy + 1.0 * es
    tiles = int(np.ceil(span.max() / es)) + 2
    vo = FastVO(cam, min_xy, tiles, lp, bands=3, n_features=512,
                n_levels=4, window_radius=80.0, warp_mode="",
                device=args.device)
    print(f"canvas {tiles}x{tiles} tiles, GSD {lp:.3f} m/px")

    if args.segments:
        # GPS-anchored scale-out (parallel/dist_vo.py): overlapping
        # segments, each anchored by a (noisy) GPS fix, run in parallel
        # over the mesh
        from types import SimpleNamespace
        from pislamfusion_tpu_torch.parallel import dist_vo, make_mesh
        seg_len = args.segments
        segs, firsts = dist_vo.segments_from_frames(frames, seg_len,
                                                    overlap=1)
        if nogps:
            # GPS-free: anchor segments on a 2x-downsampled serial
            # track-only coarse pass instead of GPS fixes
            anchors, _ = dist_vo.anchors_from_coarse(
                vo, frames, firsts, poses[0], scale=2)
        else:
            gps_noise = rng.normal(0, 0.05, (len(firsts), 3))
            metas = [SimpleNamespace(gps_enu=poses[s, :3] + gps_noise[i],
                                     pyr=None) for i, s in enumerate(firsts)]
            anchors = dist_vo.anchors_from_gps(metas)
        dev = torch.device(args.device)
        n_dev = args.shards or (torch.cuda.device_count()
                                if dev.type == "cuda" else 1)
        if dev.type == "cuda":
            devices = [torch.device("cuda", i) for i in range(n_dev)]
        else:
            devices = [dev] * n_dev
        mesh = make_mesh(devices) if n_dev > 1 else None
        # --correct: the two-pass drift-corrected variant, each segment's
        # chain bent onto the next segment's anchor before compositing
        kw = dict(correct_drift=True, anchor_stride=seg_len - 1) \
            if args.correct else {}
        print(f"{segs.shape[0]} segments x {seg_len} frames over "
              f"{n_dev} device(s), "
              + ("coarse-pass anchors" if nogps else "GPS-derived anchors")
              + (", drift-corrected" if kw else ""))
        est_s, nm = dist_vo.process_survey(vo, segs, anchors, mesh, **kw)
        t0 = time.perf_counter()
        est_s, nm = dist_vo.process_survey(vo, segs, anchors, mesh, **kw)
        dt = time.perf_counter() - t0
        est = np.zeros_like(poses)
        n_match = np.zeros(len(poses), np.int32)
        for i, s in enumerate(firsts):
            take = min(seg_len, len(poses) - s)
            est[s:s + take] = est_s[i][:take]
            n_match[s:s + take] = nm[i][:take]
    else:
        est, n_match = vo.process(frames, poses[0])      # warm-up
        vo = FastVO(cam, min_xy, tiles, lp, bands=3, n_features=512,
                    n_levels=4, window_radius=80.0, warp_mode="",
                    device=args.device)
        t0 = time.perf_counter()
        est, n_match = vo.process(frames, poses[0])
        dt = time.perf_counter() - t0
    err = np.linalg.norm(est[:, :3] - poses[:, :3], axis=1)
    print(f"batch of {len(poses)} frames in {dt * 1e3:.1f} ms "
          f"({len(poses) / dt:.1f} fps), matches "
          f"{int(n_match[1:].min())}-{int(n_match[1:].max())}, "
          f"max pose error {err.max():.3f} m")

    img, covered = vo.blended()
    ys, xs = np.nonzero(covered)
    gx = np.clip(((min_xy[0] + (xs + 0.5) * lp) / 0.1).astype(int), 0,
                 ground_np.shape[1] - 1)
    gy = np.clip(((min_xy[1] + (ys + 0.5) * lp) / 0.1).astype(int), 0,
                 ground_np.shape[0] - 1)
    d = img[ys, xs].astype(np.float64) - ground_np[gy, gx]
    psnr = 10 * np.log10(255.0 ** 2 / max((d ** 2).mean(), 1e-12))
    cov = 100.0 * covered.mean()
    print(f"mosaic: {cov:.1f}% coverage, PSNR vs ground truth "
          f"{psnr:.2f} dB")
    path = os.path.join(out_dir, "result.png")
    _write_png(path, np.clip(img, 0, 255).astype(np.uint8))
    print(f"wrote {path}")
    # GPS-free anchors inherit the coarse serial chain's drift, so the
    # absolute-pose gate widens; with GPS fixes (or the plain batch path)
    # the tight gate applies
    err_gate, psnr_gate = (2.0, 14.0) if nogps else (0.6, 20.0)
    ok = err.max() < err_gate and psnr > psnr_gate
    print("FASTVO OK" if ok else "FASTVO FAIL")
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
