"""The JAX package's TPU path, run on the CPU, as the reference for the
PyTorch port's tests (`test_torch_*.py`).

`forced_tpu_path` does what tests/test_orb_fused_path.py does: it turns
on the Pallas gates (the flat ORB pyramid K1, the patch gather K2, the
shear warp K3; the round-2 extraction kernels stay off, as they ship),
runs every Pallas kernel through the interpreter, and clears the
`orb_detect` jit cache on the way in and out so that no trace made under
the forced gates reaches another test of the same worker.
"""
import contextlib

from pislamfusion_tpu.ops import image as im
from pislamfusion_tpu.ops.features import orb


@contextlib.contextmanager
def forced_tpu_path(monkeypatch):
    from jax.experimental.pallas import tpu as pltpu

    monkeypatch.setattr(im, "use_tpu_pallas", lambda: True)
    monkeypatch.setattr(orb, "_flat_gate", lambda: True)
    monkeypatch.setattr(orb, "_extract_kernels_on", lambda: False)
    # restored afterwards whatever a gate cached meanwhile
    monkeypatch.setattr(im, "_PALLAS_STENCIL", im._PALLAS_STENCIL)
    monkeypatch.setenv("PISLAM_PAIR_STEP", "0")
    orb.orb_detect.clear_cache()
    try:
        with pltpu.force_tpu_interpret_mode():
            yield
    finally:
        orb.orb_detect.clear_cache()
