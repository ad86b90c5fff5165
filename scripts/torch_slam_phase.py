"""chip_smoke.py's SLAM phases alone, on one CUDA GPU.

Run from the repository root on the card's machine:

    python3 scripts/torch_slam_phase.py [--skip-cpu] [--profile]

It builds the port's kernels, then runs phase 2d (`create_slam` offline
through `SLAM.track` at 1920x1080 on bench.py's strip: ORB-1000 over 36
frames, SIFT-1000 over 18, with chip_smoke.py's gates, timings and launch
counts) and, unless --skip-cpu, phase 3's SLAM check (the survey of
tests/test_slam.py, 320x240, on the CPU and on the card). --profile adds a
torch.profiler pass over 6 ORB frames after the map is set up: device time
and launches a frame by kernel, and the device's busy share.
"""
from __future__ import annotations

import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402


def profile_orb(frames, fx, dev):
    """6 frames (frames 12-17 of the strip) under torch.profiler after the
    SLAM has tracked frames 0-11: device ms a frame by kernel, launches a
    frame and the busy share of the host clock."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from pislamfusion_tpu_torch.core.camera import Camera
    from pislamfusion_tpu_torch.models.slam import create_slam
    K, H, W = frames.shape[:3]
    host = frames.cpu().numpy()
    slam = create_slam(cs.slam_full_cfg("ORB"),
                       Camera(W, H, fx, fx, W / 2.0, H / 2.0), device=dev)
    for i in range(12):
        slam.track(host[i], float(i))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for i in range(12, 18):
            slam.track(host[i], float(i))
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    ev = [e for e in prof.events() if e.device_type.name == "CUDA"
          and not getattr(e, "is_user_annotation", False)]
    busy = sum(e.device_time_total for e in ev) / 1e3
    by = {}
    for e in ev:
        n, t = by.get(e.name, (0, 0.0))
        by[e.name] = (n + 1, t + e.device_time_total / 1e3)
    top = sorted(by.items(), key=lambda kv: -kv[1][1])[:12]
    print(f"SLAM ORB profile, frames 12-17: {wall * 1e3 / 6:.1f} ms a frame "
          f"(host clock), device busy {busy / 6:.2f} ms a frame "
          f"({busy / (wall * 1e3) * 100:.1f} % of the host clock), "
          f"{len(ev) / 6:.0f} device activities a frame")
    print("SLAM ORB profile, device ms a frame by kernel (launches a "
          "frame): " + "; ".join(f"{k[:60]} {t / 6:.3f} ({n / 6:.1f})"
                                 for k, (n, t) in top))


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("torch_slam_phase: no CUDA device", file=sys.stderr)
        return 2
    from pislamfusion_tpu_torch import _build
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    print(smi.stdout.strip())
    t0 = time.perf_counter()
    _build.build_all()
    print(f"built in {time.perf_counter() - t0:.1f} s")
    dev = torch.device("cuda")
    wrappers = _build.kernel_wrappers()
    H, W, fx = 1080, 1920, 1200.0
    frames, poses = cs.render_strip(36, H, W, fx, 0.12, 6144, dev)
    t0 = time.perf_counter()
    cs.run_slam_phase("ORB", frames, poses, fx, dev, wrappers,
                      ("flatpyr", "fastselect", "patchgather"),
                      cs.SLAM_MIN_KEYFRAMES)
    print(f"phase 2d ORB: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    cs.run_slam_phase("Sift", frames[:18], poses[:18], fx, dev, wrappers,
                      ("bandedstack", "bilineargrid"))
    print(f"phase 2d SIFT: {time.perf_counter() - t0:.1f} s")
    if "--profile" in sys.argv:
        profile_orb(frames, fx, dev)
    if "--skip-cpu" not in sys.argv:
        t0 = time.perf_counter()
        cs.slam_card_vs_cpu(dev)
        print(f"phase 3 SLAM: {time.perf_counter() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
