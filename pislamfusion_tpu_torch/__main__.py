"""`python -m pislamfusion_tpu_torch` — the pislamfusion binary (src/main.cpp)
on a CUDA device (`Device=cpu` for the plain PyTorch versions)."""
import sys

from .app import main

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
