"""The JAX package's TPU path, run on the CPU, as the reference for the
PyTorch port's tests (`test_torch_*.py`).

`forced_tpu_path` does what tests/test_orb_fused_path.py does: it turns
on the Pallas gates (the flat ORB pyramid K1, the patch gather K2, the
shear warp K3, SIFT's stack kernel K5 and grid sampler K6; the round-2
extraction kernels and the banded sandwich stay off, as they ship, unless
the caller sets the two ORB front-end gates otherwise: `flat=False,
extract=True` is the packed pyramid K7 with the fused FAST+select K4), runs
every Pallas kernel in interpret mode (`interpret=True`, as the package's
own kernel tests run them: the kernel is discharged into XLA operations
and compiled, which runs the kernels many times faster than the TPU
interpreter of `pltpu.force_tpu_interpret_mode`), and clears the jit
caches of `orb_detect`, `sift_detect`, the mosaic composites (which
reach the shear-warp kernel) and the two extraction kernels on the way in
and out so that no trace made under the forced gates reaches another test
of the same worker.
"""
import contextlib
import pickle

import numpy as np
import pytest
import torch

from pislamfusion_tpu.ops import image as im
from pislamfusion_tpu.ops import mosaic
from pislamfusion_tpu.ops.features import fastselect, orb, pyramid_pallas, sift


@contextlib.contextmanager
def forced_tpu_path(monkeypatch, flat=True, extract=False):
    """flat: orb._flat_gate (K1); extract: orb._extract_kernels_on (K7
    where K1 is off, and K4)."""
    from jax.experimental import pallas as pl

    pallas_call = pl.pallas_call

    def interpreted(*args, **kwargs):
        kwargs["interpret"] = True
        return pallas_call(*args, **kwargs)

    monkeypatch.setattr(pl, "pallas_call", interpreted)
    monkeypatch.setattr(im, "use_tpu_pallas", lambda: True)
    monkeypatch.setattr(orb, "_flat_gate", lambda: flat)
    monkeypatch.setattr(orb, "_extract_kernels_on", lambda: extract)
    # the stencil gates as they ship on a TPU (image.py:245), restored
    # afterwards whatever a gate cached meanwhile
    monkeypatch.setattr(im, "_PALLAS_STENCIL",
                        {"sandwich": False, "stack": True})
    monkeypatch.setenv("PISLAM_PAIR_STEP", "0")
    jitted = (orb.orb_detect, sift.sift_detect, mosaic.composite_frame,
              mosaic.composite_frames_batch,
              mosaic.composite_frames_batch_seamed,
              fastselect._winners_kernel_call,
              pyramid_pallas.build_packed_pyramid)
    for fn in jitted:
        fn.clear_cache()
    try:
        yield
    finally:
        for fn in jitted:
            fn.clear_cache()


def seed_canvas(canvas_tiles, bands, rng):
    """A canvas that already holds a mosaic in its left third: Laplacian
    bands of smooth content, weights 0.3."""
    n = canvas_tiles * 256
    lap, w = [], []
    for i in range(bands + 1):
        s = n >> i
        a = np.zeros((s, s, 3), np.float32)
        b = np.zeros((s, s, 1), np.float32)
        a[:, :s // 3] = rng.normal(0, 4.0, (s, s // 3, 3))
        if i == bands:
            a[:, :s // 3] += 120.0
        b[:, :s // 3] = 0.3
        lap.append(a)
        w.append(b)
    return lap, w


def once_per_session(name, make, tmp_path_factory, worker_id):
    """make(), computed once per test session. Under pytest-xdist the first
    worker that needs it computes it and pickles it into the session's
    shared temporary directory; a worker that needs it meanwhile waits on
    the lock and loads it (a module-scoped fixture alone is computed again
    by every worker that runs a test of the module)."""
    if worker_id == "master":
        return make()
    from filelock import FileLock
    path = tmp_path_factory.getbasetemp().parent / f"{name}.pkl"
    with FileLock(f"{path}.lock"):
        if path.is_file():
            with open(path, "rb") as f:
                return pickle.load(f)
        out = make()
        with open(path, "wb") as f:
            pickle.dump(out, f)
        return out


def jax_fastvo_run(frames, poses, fx, canvas, detector, n_features,
                   n_levels, bands, flat=True, extract=False):
    """The JAX FastVO on its TPU path (`forced_tpu_path` with the ORB gates
    `flat` and `extract`) over frames [K, H, W, 3] (numpy) from the canvas
    (lap, w), with bench.py's geometry. Returns numpy:
    poses, n_match, the blended mosaic and its coverage, the canvas
    weights, and frame 0's gray image and features (the ones its initial
    carry is built from), read out of the compiled program by a debug
    callback."""
    import jax
    import jax.numpy as jnp

    import chip_smoke
    from pislamfusion_tpu.core.camera import Camera
    from pislamfusion_tpu.models.fastvo import FastVO

    _, H, W = frames.shape[:3]
    lp, patch_tiles, canvas_tiles, min_xy = chip_smoke.strip_geometry(
        H, W, fx, poses)
    vo = FastVO(Camera(W, H, fx, fx, W / 2.0, H / 2.0), min_xy,
                canvas_tiles, lp, bands=bands, n_features=n_features,
                n_levels=n_levels, window_radius=60.0,
                patch_tiles=patch_tiles, warp_mode="shear",
                detector=detector)
    vo.canvas_lap = [jnp.asarray(a) for a in canvas[0]]
    vo.canvas_w = [jnp.asarray(a) for a in canvas[1]]
    frame0 = {}
    detect = vo._detect

    def spy(gray):
        feats = detect(gray)
        if not frame0:        # the first call traced: frame 0's detection
            frame0["traced"] = True
            jax.debug.callback(
                lambda g, f: frame0.update(gray=np.asarray(g), feats={
                    k: np.asarray(v) for k, v in f.items()}), gray, feats)
        return feats

    vo._detect = spy
    with pytest.MonkeyPatch.context() as mp, \
            forced_tpu_path(mp, flat, extract):
        p, n = vo.process(jnp.asarray(frames), poses[0])
        jax.effects_barrier()
        img, cov = vo.blended()
    return {"poses": p, "n_match": n, "img": img, "cov": cov,
            "canvas_w": [np.asarray(a) for a in vo.canvas_w],
            "gray0": frame0["gray"], "feats0": frame0["feats"]}


@pytest.fixture(autouse=True, scope="module")
def torch_one_thread():
    """One intra-op thread for the port's CPU runs while a module's tests
    run. The port's frame step is thousands of small operations; with
    XLA's CPU threads in the same process (and pytest-xdist workers beside
    it) every extra thread only adds contention: the 600x640 FastVO slice
    runs ~5x faster on one thread than on eight."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
