"""chip_smoke.py's scale-out phase alone, on one CUDA GPU.

Run from the repository root on the card's machine:

    python3 scripts/torch_scaleout_phase.py [--skip-phase3] [--profile]

It builds the port's kernels, renders 25 frames of bench.py's 1080p
strip, runs phase 2c's solver chain on frames 0-6 (for its BA problem),
then phase 2g (the parallel/ modules over a mesh of 4 shards on the
card: process_survey plain and drift-corrected beside the serial
FastVO.process, dist_ba, dist_mosaic, dist_ransac and the batched
detectors) with chip_smoke.py's lines and gates. Unless --skip-phase3 it
then runs phase 3's continuous-angle BRIEF and process_survey checks
(card against CPU). --profile runs the plain process_survey once more
under torch.profiler: the device's busy ms a survey frame and its share
of the host clock, device activities a frame, the largest kernels.
"""
from __future__ import annotations

import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402


def profile_survey(frames, poses, fx, dev):
    """The plain process_survey of phase 2g under torch.profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from pislamfusion_tpu_torch.parallel import dist_vo, make_mesh
    n = cs.SCALEOUT_FRAMES
    H, W = frames.shape[1:3]
    segs, anchors, _ = cs.survey_segments(frames[:n], poses[:n],
                                          cs.SCALEOUT_SEG_LEN, dev)
    mesh = make_mesh([dev] * cs.SCALEOUT_SHARDS)
    vo = cs.make_fastvo(H, W, fx, poses[:n], 1000, 8, 5, dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        dist_vo.process_survey(vo, segs, anchors, mesh)
        torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    ev = [e for e in prof.events() if e.device_type.name == "CUDA"
          and not getattr(e, "is_user_annotation", False)]
    busy = sum(e.device_time_total for e in ev) / 1e3
    by = {}
    for e in ev:
        k, t = by.get(e.name, (0, 0.0))
        by[e.name] = (k + 1, t + e.device_time_total / 1e3)
    top = sorted(by.items(), key=lambda kv: -kv[1][1])[:10]
    print(f"scale-out profile, process_survey plain, {n} survey frames: "
          f"{wall / n:.1f} ms a frame (host clock, profiler on), device "
          f"busy {busy / n:.2f} ms a frame ({busy / wall * 100:.1f} % of "
          f"the host clock), {len(ev) / n:.0f} device activities a frame")
    print("scale-out profile, device ms a frame by kernel (launches a "
          "frame): " + "; ".join(f"{k[:60]} {t / n:.3f} ({c / n:.1f})"
                                 for k, (c, t) in top))


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("torch_scaleout_phase: no CUDA device", file=sys.stderr)
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
    frames, poses = cs.render_strip(36, H, W, fx, 0.12, 6144, dev)
    chain = cs.solver_chain(frames[:7], poses[:7], fx)
    t0 = time.perf_counter()
    cs.run_scaleout_phase(frames, poses, fx, dev, wrappers, card,
                          (chain["ba_problem"], chain["ba"]))
    print(f"phase 2g: {time.perf_counter() - t0:.1f} s")
    if "--profile" in sys.argv:
        profile_survey(frames, poses, fx, dev)
    if "--skip-phase3" not in sys.argv:
        t0 = time.perf_counter()
        cs.brief_card_vs_cpu(dev)
        cs.survey_card_vs_cpu(dev)
        print(f"phase 3 BRIEF and process_survey: "
              f"{time.perf_counter() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
