"""FastVO ORB at 1080p from one checkout of the port, for A/B runs.

    python3 scripts/torch_fastvo_ab.py ROOT [ROOT ...]

For each ROOT (a checkout of this repository, say the parent commit
unpacked with `git archive` beside the working tree), in a fresh process
of its own, imports that checkout's `pislamfusion_tpu_torch` and
`chip_smoke`, builds its kernels, renders bench.py's 1080p strip (24
frames) and runs `FastVO.process` (ORB-1000, 8 levels, 5 bands): a
warm-up pass, a pass timed with CUDA events, and 8 frames under
torch.profiler for the device activities a frame and the device's busy
share. Prints one JSON line a ROOT, in the order given: give the roots
as A B B A to see the spread beside the difference. Needs a CUDA device.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys


def one(root: str) -> dict:
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    root = os.path.abspath(root)
    sys.path.insert(0, root)
    import chip_smoke as cs
    from pislamfusion_tpu_torch import _build
    _build.build_all()
    dev = torch.device("cuda")
    H, W, fx, K = 1080, 1920, 1200.0, 24
    frames, poses = cs.render_strip(K, H, W, fx, 0.12, 6144, dev)
    make = lambda: cs.make_fastvo(H, W, fx, poses, 1000, 8, 5, dev)  # noqa
    make().process(frames, poses[0])                      # warm-up pass
    vo = make()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    _, n_match = vo.process(frames, poses[0])
    e1.record()
    e1.synchronize()
    ms = e0.elapsed_time(e1) / K
    vo = make()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        vo.process(frames[:8], poses[0])
        torch.cuda.synchronize()
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events() if e.device_type.name == "CUDA"
                   and not getattr(e, "is_user_annotation", False))
    busy, end = 0.0, float("-inf")
    for s, t in spans:
        if t > end:
            busy += t - max(s, end)
            end = t
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    return {"root": root, "card": card, "ms_per_frame": ms,
            "device_activities_per_frame": len(spans) / 8,
            "device_busy": busy / (spans[-1][1] - spans[0][0]),
            "min_n_match": int(np.min(n_match[1:]))}


def main() -> int:
    if len(sys.argv) == 3 and sys.argv[1] == "--one":
        print(json.dumps(one(sys.argv[2])), flush=True)
        return 0
    if len(sys.argv) < 2:
        print(__doc__, file=sys.stderr)
        return 2
    for root in sys.argv[1:]:
        out = subprocess.run([sys.executable, os.path.abspath(__file__),
                              "--one", root], capture_output=True,
                             text=True)
        if out.returncode != 0:
            print(out.stdout + out.stderr, file=sys.stderr)
            return out.returncode
        print(out.stdout.strip().splitlines()[-1], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
