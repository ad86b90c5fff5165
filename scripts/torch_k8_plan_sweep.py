"""K8's launch plan against the other tile shapes it could launch.

    python3 scripts/torch_k8_plan_sweep.py [--out PATH]

On the card, at the seven K8 shapes `chip_smoke.py` checks
(`torch_kernel_ab.K8_CASES`), launches the kernel under every tile shape
of 4, 8, 16 or 32 output rows by 4-256 output columns (a multiple of 4,
no wider than the output) whose shared memory fits a block
(`stencil.tile_plan`, launched with `stencil.launch_plan`, so each shape
runs as given), checks each equal to the plain version, and times it
(seeded 0..255 input, device time of one call from 10 captured in a CUDA
graph). Prints one JSON line a shape: the plan `stencil.sandwich_plan`
picks and its time, the fastest tile shape and its time, their ratio,
and the fastest shape that keeps 4 blocks an SM. `--out` writes every
timing as JSON. Needs a CUDA device.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    out_path = sys.argv[sys.argv.index("--out") + 1] \
        if "--out" in sys.argv else None
    sys.path.insert(0, ROOT)
    import numpy as np
    import torch
    from chip_smoke import graph_ms
    from pislamfusion_tpu_torch import _build
    from pislamfusion_tpu_torch.ops import image as im
    from pislamfusion_tpu_torch.ops import stencil as st
    from torch_kernel_ab import K8_CASES
    if not torch.cuda.is_available():
        print("torch_k8_plan_sweep: needs a CUDA device", file=sys.stderr)
        return 2
    _build.build_all(("bandedsandwich",))
    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    rng = np.random.default_rng(0)
    every = {}
    for label, kind, h, w, oh, ow, C in K8_CASES:
        tabs = im.pyr_tables(kind, h, w, oh, ow)
        K = st.tap_bound(tabs, C)
        x = torch.from_numpy(rng.uniform(0, 255, (1, h, w, C)).astype(
            np.float32)).to(dev)
        out = torch.empty((1, oh, ow, C), dtype=torch.float32, device=dev)
        plain = st.banded_sandwich_plain(x, tabs)

        def run(plan):
            on = st.plan_on_device(plan, dev)
            out.zero_()
            st.launch_plan(x, out, on)
            if not torch.equal(out, plain):
                raise AssertionError(f"{label} tile {plan.tr}x{plan.tc}: "
                                     "kernel != plain")
            return (graph_ms(lambda: st.launch_plan(x, out, on), 10),
                    plan.tr, plan.tc, plan.smem, on[2])
        rows = []
        for tr in (4, 8, 16, 32):
            for tc in range(4, min(256, -(-ow // 4) * 4) + 1, 4):
                plan = st.tile_plan(tabs, C, K, tr, tc)
                if plan is not None:
                    rows.append(run(plan))
        pick = st.sandwich_plan(tabs, C)
        ms = run(pick)[0]
        best = min(rows)
        best4 = min(r for r in rows if r[4] >= st.K8_BLOCKS)
        every[label] = rows
        print(json.dumps({"shape": label, "card": card,
                          "pick": [pick.tr, pick.tc, ms],
                          "fastest": [best[1], best[2], best[0], best[4]],
                          "fastest_4_blocks": [best4[1], best4[2], best4[0]],
                          "pick_over_fastest": ms / best[0],
                          "shapes_timed": len(rows)}), flush=True)
    if out_path:
        with open(out_path, "w") as f:
            json.dump(every, f)
    return 0


if __name__ == "__main__":
    sys.exit(main())
