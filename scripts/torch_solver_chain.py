"""SLAM's solver chain at 1080p on the CPU and on the card, and the cost
of its batched small SVDs on the card.

    python3 scripts/torch_solver_chain.py [OUT.npz]

Renders chip_smoke.py's 1080p strip (frames 0-6), runs
`chip_smoke.solver_chain` (ORB-1000, 8 levels, 256 hypotheses, multih 4
planes x 192) with the port's plain versions on the CPU and then on the
card, prints each run's results and errors against the true poses
(`chip_smoke.chain_line`), and saves the CPU run's ORB features and the
true poses to OUT.npz (default chiprun_out/solver_chain_1080p.npz), which
`PYTHONPATH=. python tests/torch_port_reference.py solver-chain OUT.npz`
runs the JAX package's chain on (on the CPU, where JAX is). These are
the runs phase 2c's gates were set from.
Then it times, on the card, the batched SVDs and eigh the solvers issue:
each shape's device ms a call (CUDA events around 20 calls after a
synchronize, warm) and its host ms a call.
"""
from __future__ import annotations

import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402


def svd_costs(dev):
    """Device and host ms a call of the solvers' batched decompositions at
    the full card phase's shapes."""
    import torch
    g = torch.Generator(device=dev).manual_seed(0)
    cases = [
        ("H 4-point DLT: svd [256, 8, 9] full", "svd", (256, 8, 9), True),
        ("F 8-point: svd [256, 8, 9] full", "svd", (256, 8, 9), True),
        ("F rank-2: svd [256, 3, 3]", "svd", (256, 3, 3), False),
        ("H/F refit: svd [2000, 9] reduced", "svd", (2000, 9), False),
        ("PnP DLT: svd [128, 12, 12] full", "svd", (128, 12, 12), True),
        ("PnP planar: svd [128, 4, 3] full", "svd", (128, 4, 3), True),
        ("triangulate: svd [1000, 4, 4]", "svd", (1000, 4, 4), True),
        ("init2view check: svd [12, 1000, 4, 4]", "svd", (12, 1000, 4, 4),
         True),
        ("plane / Horn: eigh [128, 4, 4]", "eigh", (128, 4, 4), None),
    ]
    out = []
    for label, kind, shape, full in cases:
        a = torch.randn(shape, generator=g, device=dev)
        if kind == "eigh":
            a = a @ a.mT

            def fn():
                return torch.linalg.eigh(a)
        else:
            def fn():
                return torch.linalg.svd(a, full_matrices=full)
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        e0.record()
        for _ in range(20):
            fn()
        e1.record()
        e1.synchronize()
        host = (time.perf_counter() - t0) * 1e3 / 20
        out.append((label, e0.elapsed_time(e1) / 20, host))
    return out


def main(argv):
    import torch
    out = argv[0] if argv else os.path.join(ROOT, "chiprun_out",
                                            "solver_chain_1080p.npz")
    if not torch.cuda.is_available():
        print("torch_solver_chain: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    print(smi.stdout.strip().splitlines()[0])
    from pislamfusion_tpu_torch import _build
    _build.build_all()
    H, W, fx, K = 1080, 1920, 1200.0, 7
    frames, poses = chip_smoke.render_strip(K, H, W, fx, 0.12, 6144, dev)
    kw = dict(n_features=1000, n_levels=8, iters=256, mh_iters=192,
              ba_iters=10)
    t0 = time.perf_counter()
    cpu = chip_smoke.solver_chain(frames.cpu(), poses, fx, **kw)
    print(f"port CPU ({torch.get_num_threads()} threads, "
          f"{time.perf_counter() - t0:.1f} s): "
          + chip_smoke.chain_line(chip_smoke.chain_summary(cpu, poses)))
    chip_smoke.solver_chain(frames, poses, fx, **kw)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    card = chip_smoke.solver_chain(frames, poses, fx, **kw)
    torch.cuda.synchronize()
    print(f"port card ({time.perf_counter() - t0:.2f} s host clock): "
          + chip_smoke.chain_line(chip_smoke.chain_summary(card, poses)))
    os.makedirs(os.path.dirname(out), exist_ok=True)
    arrays = {"poses": poses, "K": K, "fx": fx, "W": W, "H": H,
              "iters": kw["iters"], "mh_iters": kw["mh_iters"],
              "ba_iters": kw["ba_iters"]}
    for i, f in enumerate(cpu["feats"]):
        for k in ("xy", "angle", "desc", "valid"):
            arrays[f"{k}{i}"] = f[k].numpy()
    np.savez_compressed(out, **arrays)
    print(f"saved the CPU run's features to {out}")
    for label, ms, host in svd_costs(dev):
        print(f"  {label}: device {ms:.4f} ms, host {host:.4f} ms a call")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
