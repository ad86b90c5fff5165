"""The vocabulary trainers and the ablation harness on the PyTorch port,
on one CUDA GPU: chip_smoke.py's phase 2i alone.

Run from the repository root on the card's machine:

    python3 scripts/torch_ablation_phase.py [--device cpu]

It builds the port's kernels, then runs `chip_smoke.run_ablation_phase`:
both vocabulary trainers (scripts/torch_train_default_vocab.py,
scripts/torch_train_sift_vocab.py) at chip_smoke.TRAINER_VIEWS views, with
their gates (words and nodes, the .gbow's round trip, the kernels
launched), and one combination of doc/ABLATION.md's v3 grid through
scripts/torch_batch_evaluate.py in a subprocess, with its gates (tracked
share, a mosaic that is not blank, the kernels launched), printing
chip_smoke.py's phase-2i lines. It exits 1 if a gate failed. `--device
cpu` runs the same on the CPU (the plain versions of the kernels; the
harness's run takes minutes there).
"""
from __future__ import annotations

import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402


def main(argv) -> int:
    import torch
    device = argv[argv.index("--device") + 1] if "--device" in argv \
        else "cuda"
    if device == "cuda":
        if not torch.cuda.is_available():
            print("torch_ablation_phase: no CUDA device", file=sys.stderr)
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
    t0 = time.perf_counter()
    try:
        cs.run_ablation_phase(torch.device(device), _build.kernel_wrappers(),
                              card)
    except AssertionError as e:
        print(f"torch_ablation_phase: {e}", file=sys.stderr)
        return 1
    finally:
        print(f"ablation (phase 2i) {time.perf_counter() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
