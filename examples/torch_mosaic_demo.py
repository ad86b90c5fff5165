"""Demo: synthetic drone survey -> incremental multiband orthomosaic, on
the PyTorch port (`pislamfusion_tpu_torch`).

The port's twin of examples/mosaic_demo.py, with the same survey and
printed lines: a virtual nadir camera flies a lawnmower pattern over a
textured ground plane; each rendered view is fed to the Map2D engine with
its known pose; the blended mosaic is written to result.png beside the
ground truth, with a PSNR line against it.

Usage: python examples/torch_mosaic_demo.py [out_dir] [--type 1|3]
    [--device cuda|cpu] [Key=value ...]
(the device defaults to cuda).
"""
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np
import torch

from pislamfusion_tpu_torch.core.camera import Camera
from pislamfusion_tpu_torch.core.svar import Svar
from pislamfusion_tpu_torch.models.map2d import _write_png, create_map2d
from pislamfusion_tpu_torch.ops import image as im
from pislamfusion_tpu_torch.ops import mosaic as M

GROUND_SCALE = 0.1  # m per ground-texture pixel


def make_ground(rng, device, n=1024):
    g = rng.uniform(0, 255, size=(n, n, 3)).astype(np.float32)
    g = im.gaussian_blur(torch.from_numpy(g).to(device), 6.0).cpu().numpy()
    g = 96 + (g - g.mean()) * 10.0
    # add some sharp "buildings"
    for _ in range(40):
        x, y = rng.integers(50, n - 50, 2)
        w, h = rng.integers(8, 30, 2)
        g[y:y + h, x:x + w] = rng.uniform(30, 220, 3)
    return np.clip(g, 0, 255).astype(np.float32)


def nadir_pose(x, y, z):
    return np.array([x, y, z, 1.0, 0.0, 0.0, 0.0])  # 180deg about x: down


def render_view(ground, cam, pose):
    H = M.homography_canvas_to_image_np(pose, cam, (0.0, 0.0), GROUND_SCALE)
    h = torch.from_numpy(np.linalg.inv(H).astype(np.float32)).to(
        ground.device)
    img, _ = im.warp_perspective(ground, h, (cam.height, cam.width),
                                 border="replicate")
    return img.cpu().numpy()


def main():
    argv = sys.argv[1:]
    out_dir = argv[0] if argv and not argv[0].startswith("-") \
        and "=" not in argv[0] else "."
    os.makedirs(out_dir, exist_ok=True)
    m2d_type = 3
    if "--type" in argv:
        m2d_type = int(argv[argv.index("--type") + 1])
    device = "cuda"
    if "--device" in argv:
        device = argv[argv.index("--device") + 1]

    rng = np.random.default_rng(7)
    ground_np = make_ground(rng, device)
    ground = torch.from_numpy(ground_np).to(device)
    cam = Camera(320, 240, 260.0, 260.0, 160.0, 120.0)

    poses = []
    for iy, y in enumerate(np.arange(15.0, 90.0, 9.0)):
        xs = np.arange(15.0, 90.0, 6.0)
        for x in (xs if iy % 2 == 0 else xs[::-1]):
            poses.append(nadir_pose(x, y, 25.0))
    print(f"{len(poses)} frames, camera {cam.width}x{cam.height}")

    cfg = Svar()
    cfg.set("Map2D.Scale", "0.5")
    cfg.set("Map2D.BandNumber", "5")
    for a in argv:          # extra key=value overrides
        if "=" in a and not a.startswith("-"):
            k, v = a.split("=", 1)
            cfg.set(k, v)
    engine = create_map2d(m2d_type, cfg, device=device)
    plane = np.array([0, 0, 0, 0, 0, 0, 1.0])
    assert engine.prepare(plane, cam, [(None, p) for p in poses])
    print(f"canvas {engine.w_tiles}x{engine.h_tiles} tiles, "
          f"GSD {engine.length_pixel:.3f} m/px, patch "
          f"{engine.patch_tiles} tiles")

    t0 = time.perf_counter()
    for i, p in enumerate(poses):
        img = render_view(ground, cam, p)
        engine.feed(img, p)
        if i == 0:
            t0 = time.perf_counter()  # skip the first frame's set-up
    dt = time.perf_counter() - t0
    n = len(poses) - 1
    print(f"fed {n} frames in {dt:.2f}s = {n / dt:.1f} fps "
          f"(rendered {engine.frames_rendered}, skipped "
          f"{engine.frames_skipped})")

    out, covered = engine.blended()
    ys, xs = np.nonzero(covered)
    gx = (engine.min_xy[0] + xs * engine.length_pixel) / GROUND_SCALE
    gy = (engine.min_xy[1] + ys * engine.length_pixel) / GROUND_SCALE
    xy = torch.from_numpy(np.stack([gx, gy], -1).astype(np.float32))
    gt, _ = im.bilinear_sample(torch.from_numpy(ground_np), xy,
                               border="replicate")
    mse = float(np.mean((out[ys, xs] - gt.numpy()) ** 2))
    print(f"coverage {covered.mean() * 100:.1f}% ({covered.sum()} px), "
          f"PSNR vs ground truth {10 * np.log10(255 ** 2 / mse):.2f} dB")

    engine.save(f"{out_dir}/result.png")
    _write_png(f"{out_dir}/ground_truth.png", ground_np.astype(np.uint8))
    print(f"wrote {out_dir}/result.png")


if __name__ == "__main__":
    main()
