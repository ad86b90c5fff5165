"""chip_smoke.py's fused-system phases alone, on one CUDA GPU.

Run from the repository root on the card's machine:

    python3 scripts/torch_fused_phase.py [--skip-cpu] [--profile]

It builds the port's kernels, then runs phase 2e (`python -m
pislamfusion_tpu_torch` through `app.main` on the two-row 1080p survey
with GPS: `Act=SLAM` twice, `Act=TestMap2D` over the exported
Map2DFusion folder, `Act=Survey`, with chip_smoke.py's gates, timings,
scopes and launch counts) and, unless --skip-cpu, phase 3's FusionSystem
check (tests/test_refresh.py's three cases and the geo tiles, on the CPU
and on the card). --profile adds one more Act=SLAM call under
torch.profiler: device time and launches by kernel over the call (both
threads), and the device's busy share of the call's host clock.
"""
from __future__ import annotations

import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402


def profile_fused(dev, wrappers):
    """One Act=SLAM call of phase 2e under torch.profiler (CUDA activity,
    both threads): ms a frame, device busy ms a frame and its share of
    the host clock, activities a frame, the largest kernels."""
    import shutil
    import tempfile
    from torch.profiler import ProfilerActivity, profile
    root = tempfile.mkdtemp(prefix="psf_fused_prof_")
    try:
        ds, poses, _ = cs.write_fused_dataset(os.path.join(root, "ds"), dev)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            _, _, wall, _, _, _ = cs.run_fused_slam(
                ds, os.path.join(root, "out"), wrappers)
        K = len(poses)
        ev = [e for e in prof.events() if e.device_type.name == "CUDA"
              and not getattr(e, "is_user_annotation", False)]
        busy = sum(e.device_time_total for e in ev) / 1e3
        by = {}
        for e in ev:
            n, t = by.get(e.name, (0, 0.0))
            by[e.name] = (n + 1, t + e.device_time_total / 1e3)
        top = sorted(by.items(), key=lambda kv: -kv[1][1])[:12]
        print(f"fused Act=SLAM profile, {K} frames: {wall * 1e3 / K:.1f} ms "
              f"a frame (host clock, profiler on), device busy "
              f"{busy / K:.2f} ms a frame ({busy / (wall * 1e3) * 100:.1f} "
              f"% of the host clock), {len(ev) / K:.0f} device activities "
              "a frame")
        print("fused Act=SLAM profile, device ms a frame by kernel "
              "(launches a frame): " + "; ".join(
                  f"{k[:60]} {t / K:.3f} ({n / K:.1f})"
                  for k, (n, t) in top))
    finally:
        shutil.rmtree(root, ignore_errors=True)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("torch_fused_phase: no CUDA device", file=sys.stderr)
        return 2
    from pislamfusion_tpu_torch import _build
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(card)
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}")
    t0 = time.perf_counter()
    _build.build_all()
    print(f"built in {time.perf_counter() - t0:.1f} s")
    dev = torch.device("cuda")
    wrappers = _build.kernel_wrappers()
    t0 = time.perf_counter()
    cs.run_fused_phase(dev, wrappers, card)
    print(f"phase 2e: {time.perf_counter() - t0:.1f} s")
    if "--profile" in sys.argv:
        profile_fused(dev, wrappers)
    if "--skip-cpu" not in sys.argv:
        t0 = time.perf_counter()
        cs.fusion_card_vs_cpu(dev)
        print(f"phase 3 FusionSystem: {time.perf_counter() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
