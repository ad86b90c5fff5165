"""The JAX package's end-to-end SLAM suites on the PyTorch port, on one CUDA
GPU: chip_smoke.py's phase 2h and the cases that run beside it.

Run from the repository root on the card's machine:

    python3 scripts/torch_e2e_phase.py [CASE ...] [--device cpu]

CASE is a key of `torch_e2e_scenes.CARD_CASES` (loop, gps, circuit,
parallax, blur, soak, race1, race3, sequence); with none it runs all of
them. It builds the port's kernels, runs each case through
`create_slam(cfg, cam, device=...)` (and `FusionSystem` where the
reference test uses one) with every kernel's launch count set to 0 before
the case and read after it, and prints chip_smoke.py's phase-2h lines:
each case's ms a frame, its measurements, every bar of its reference test
beside its value, its launches and peak device memory, then the launches
summed over the cases and the cases that missed a bar. It exits 1 if any
bar was missed. `--device cpu` runs the same cases on the CPU (the plain
versions of the kernels).
"""
from __future__ import annotations

import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "scripts"))

import chip_smoke as cs  # noqa: E402
import torch_e2e_scenes as e2e  # noqa: E402


def main(argv) -> int:
    import torch
    device = "cuda"
    if "--device" in argv:
        i = argv.index("--device")
        device = argv[i + 1]
        argv = argv[:i] + argv[i + 2:]
    names = argv or list(e2e.CARD_CASES)
    unknown = [n for n in names if n not in e2e.CARD_CASES]
    if unknown:
        raise SystemExit(f"unknown cases {unknown}\n{__doc__}")
    if device == "cuda":
        if not torch.cuda.is_available():
            print("torch_e2e_phase: no CUDA device", file=sys.stderr)
            return 2
        from pislamfusion_tpu_torch import _build
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=True).stdout.strip().splitlines()[0]
        t0 = time.perf_counter()
        _build.build_all()
        print(f"built in {time.perf_counter() - t0:.1f} s")
    else:
        card = "the CPU"
    print(card)
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}")
    t0 = time.perf_counter()
    cases, total = e2e.run_cases(names, torch.device(device),
                                 _build.kernel_wrappers(), card)
    print("e2e (phase 2h) launches over the cases: " + ", ".join(
        f"{k} {v}" for k, v in total.items())
        + f"; {time.perf_counter() - t0:.1f} s")
    missed = [c.name for c in cases if not c.ok]
    print(f"e2e (phase 2h) bars missed in: {missed or 'none'}")
    return 1 if missed else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
