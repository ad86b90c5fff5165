"""chip_smoke.py's online SLAM phase alone, on one CUDA GPU.

Run from the repository root on the card's machine:

    python3 scripts/torch_online_phase.py [--skip-phase3] [--profile]
        [--no-app]

It builds the port's kernels, renders the first 24 frames of bench.py's
1080p strip, then runs phase 2f (bench.py's SLAM pass on the port:
ORB-1000 online over frames 0-11 out and back (23 frames; bench.py's
pass is 47, chip_smoke.ONLINE_FRAMES) in the four (TrackChain,
TrackScale) configurations, one round each; SIFT-1000 chained
over frames 0-17; the synchronising calls of one chain; and, unless
--no-app, `app.main(["Act=SLAM", ...])` online with TrackChain 8 over
phase 2e's two-row dataset), with chip_smoke.py's lines and gates.
Unless --skip-phase3 it then runs phase 3's SLAM check (the survey twice
on the card, equal; the whole runs at tests/test_slam.py's bars; the
tracking steps, local BA windows and both chain functions card against
CPU). --profile adds the ORB TrackChain 8 configuration once more under
torch.profiler (CUDA activity, every thread): ms a frame with the
profiler on, the device's busy ms a frame and its share of the host
clock, device activities a frame and the largest kernels.
"""
from __future__ import annotations

import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402


def profile_online(frames, poses, fx, dev, wrappers, chain=8, scale=1):
    """One ORB online call of phase 2f under torch.profiler."""
    from torch.profiler import ProfilerActivity, profile
    k = min(len(poses), cs.ONLINE_FRAMES)
    order = cs.online_order(k)
    gray = cs.bench_gray(frames[:k].cpu().numpy())[order]
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        r = cs.run_online_slam(gray, poses[:k][order], fx, dev, wrappers,
                               chain, scale)
    K = len(order)
    ev = [e for e in prof.events() if e.device_type.name == "CUDA"
          and not getattr(e, "is_user_annotation", False)]
    busy = sum(e.device_time_total for e in ev) / 1e3
    by = {}
    for e in ev:
        n, t = by.get(e.name, (0, 0.0))
        by[e.name] = (n + 1, t + e.device_time_total / 1e3)
    top = sorted(by.items(), key=lambda kv: -kv[1][1])[:12]
    print(f"online profile, ORB TrackChain {chain} TrackScale {scale}, {K} "
          f"frames: {r['ms']:.1f} ms a frame (host clock, profiler on), "
          f"device busy {busy / K:.2f} ms a frame "
          f"({busy / (r['ms'] * K) * 100:.1f} % of the host clock), "
          f"{len(ev) / K:.0f} device activities a frame, chains "
          f"{r['chains']} (mean length {r['mean_chain']:.2f}), tracked "
          f"{r['tracked']}/{r['total']}")
    print("online profile, device ms a frame by kernel (launches a frame): "
          + "; ".join(f"{k[:60]} {t / K:.3f} ({n / K:.1f})"
                      for k, (n, t) in top))


def main() -> int:
    import shutil
    import tempfile
    import torch
    if not torch.cuda.is_available():
        print("torch_online_phase: no CUDA device", file=sys.stderr)
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
    H, W, fx = 1080, 1920, 1200.0
    frames, poses = cs.render_strip(24, H, W, fx, 0.12, 6144, dev)
    t0 = time.perf_counter()
    cs.run_online_phase(frames, poses, fx, dev, wrappers, card)
    print(f"phase 2f strip: {time.perf_counter() - t0:.1f} s")
    if "--no-app" not in sys.argv:
        t0 = time.perf_counter()
        root = tempfile.mkdtemp(prefix="psf_online_")
        try:
            ds, fposes, _ = cs.write_fused_dataset(os.path.join(root, "ds"),
                                                   dev)
            cs.run_online_app(ds, fposes, root, wrappers, card)
        finally:
            shutil.rmtree(root, ignore_errors=True)
        print(f"phase 2f Act=SLAM: {time.perf_counter() - t0:.1f} s")
    if "--profile" in sys.argv:
        profile_online(frames, poses, fx, dev, wrappers)
    if "--skip-phase3" not in sys.argv:
        t0 = time.perf_counter()
        cs.slam_card_vs_cpu(dev)
        print(f"phase 3 SLAM: {time.perf_counter() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
