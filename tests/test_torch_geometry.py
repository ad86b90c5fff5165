"""The PyTorch port's geometry, matching and pose LM against the JAX package.

Same numpy inputs (from a seed) through `pislamfusion_tpu` and
`pislamfusion_tpu_torch` on the CPU. Tolerances: Lie ops and the pose LM
1e-5 (float32 with a different operation order); Hamming distances and
match indices exact (integer-valued distances).
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pislamfusion_tpu.core import camera as jcam
from pislamfusion_tpu.ops import ba as jba
from pislamfusion_tpu.ops import lie as jlie
from pislamfusion_tpu.ops import matching as jmatch
from pislamfusion_tpu_torch.core import camera as tcam
from pislamfusion_tpu_torch.ops import ba as tba
from pislamfusion_tpu_torch.ops import lie as tlie
from pislamfusion_tpu_torch.ops import matching as tmatch
from torch_port_reference import torch_one_thread  # noqa: F401


def _quats(rng, n):
    q = rng.normal(size=(n, 4)).astype(np.float32)
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


def _poses(rng, n):
    t = rng.normal(size=(n, 3)).astype(np.float32)
    return np.concatenate([t, _quats(rng, n)], -1)


def _both(fn_name, *args):
    j = np.asarray(getattr(jlie, fn_name)(*[jnp.asarray(a) for a in args]))
    t = getattr(tlie, fn_name)(*[torch.from_numpy(a) for a in args]).numpy()
    return j, t


@pytest.mark.parametrize("fn_name, kinds", [
    ("quat_mul", ("q", "q")),
    ("quat_rotate", ("q", "p")),
    ("quat_to_matrix", ("q",)),
    ("so3_hat", ("p",)),
    ("so3_exp", ("p",)),
    ("so3_exp", ("tiny",)),
    ("se3_exp", ("xi",)),
    ("se3_exp", ("xi_tiny",)),
    ("se3_mul", ("T", "T")),
    ("se3_inv", ("T",)),
    ("se3_apply", ("T", "p")),
])
def test_lie_matches_reference(fn_name, kinds):
    rng = np.random.default_rng(1)
    n = 64
    make = {
        "q": lambda: _quats(rng, n),
        "p": lambda: rng.normal(size=(n, 3)).astype(np.float32),
        "tiny": lambda: (1e-5 * rng.normal(size=(n, 3))).astype(np.float32),
        "xi": lambda: rng.normal(size=(n, 6)).astype(np.float32),
        "xi_tiny": lambda: (1e-5 * rng.normal(size=(n, 6))).astype(
            np.float32),
        "T": lambda: _poses(rng, n),
    }
    j, t = _both(fn_name, *[make[k]() for k in kinds])
    assert t.shape == j.shape
    np.testing.assert_allclose(t, j, atol=1e-5, rtol=1e-5)


def test_camera_fields_match_reference():
    p = (1920, 1080, 1200.0, 1190.0, 960.5, 540.25)
    j = jcam.Camera(*p)
    t = tcam.Camera(*p)
    assert dataclasses.astuple(t) == dataclasses.astuple(j) == p
    assert [f.name for f in dataclasses.fields(t)] == \
        [f.name for f in dataclasses.fields(j)]
    assert tcam.Camera(640, 480) == tcam.Camera(640, 480, 1.0, 1.0, 0.0,
                                                0.0)


def _bits(rng, n):
    return (rng.random((n, 256)) < 0.5).astype(np.uint8)


def test_hamming_distance_exact():
    rng = np.random.default_rng(2)
    a, b = _bits(rng, 70), _bits(rng, 90)
    j = np.asarray(jmatch.distance_matrix(jnp.asarray(a), jnp.asarray(b),
                                          "orb"))
    t = tmatch.distance_matrix(torch.from_numpy(a), torch.from_numpy(b),
                               "orb").numpy()
    np.testing.assert_array_equal(t, j)
    np.testing.assert_array_equal(
        t, (a[:, None, :] != b[None, :, :]).sum(-1))


@pytest.mark.parametrize("ratio, cross_check, windowed", [
    (1.0, True, True), (1.0, False, False), (0.8, True, False),
])
def test_match_indices_exact(ratio, cross_check, windowed):
    rng = np.random.default_rng(3)
    n, m = 80, 100
    a = _bits(rng, n)
    # b holds noisy copies of a's rows, shuffled, plus distractors
    perm = rng.permutation(m)[:n]
    b = _bits(rng, m)
    flips = rng.random((n, 256)) < 0.08
    b[perm] = np.where(flips, 1 - a, a)
    va = rng.random(n) < 0.9
    vb = rng.random(m) < 0.9
    xa = rng.uniform(0, 200, (n, 2)).astype(np.float32)
    xb = rng.uniform(0, 200, (m, 2)).astype(np.float32)
    xb[perm] = xa + rng.normal(0, 5, (n, 2)).astype(np.float32)
    jargs = [jnp.asarray(x) for x in (a, b, va, vb, xa, xb)]
    targs = [torch.from_numpy(x) for x in (a, b, va, vb, xa, xb)]
    outs = []
    for mod, (A, B, VA, VB, XA, XB) in ((jmatch, jargs), (tmatch, targs)):
        d = mod.distance_matrix(A, B, "orb")
        wm = mod.window_mask(XA, XB, 30.0) if windowed else None
        idx, ok = mod.match(d, VA, VB, max_dist=80.0, ratio=ratio,
                            window_mask=wm, cross_check=cross_check)
        outs.append((np.asarray(idx), np.asarray(ok),
                     np.asarray(mod._masked(d, VA, VB, wm))))
    (ji, jo, jm), (ti, to, tm) = outs
    assert jo.sum() > 20
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_array_equal(to, jo)
    np.testing.assert_array_equal(tm, jm)


@pytest.mark.parametrize("outliers", [0.0, 0.2])
def test_optimize_pose_matches_reference(outliers):
    """The pose-only Huber LM (8 iterations, as FastVO runs it) from a
    perturbed start, with some weights zero and some gross outliers."""
    rng = np.random.default_rng(4)
    n = 200
    T_true = np.array([0.3, -0.2, 5.0, 0.05, -0.03, 0.02, 1.0], np.float32)
    T_true[3:] /= np.linalg.norm(T_true[3:])
    X = np.concatenate([rng.uniform(-3, 3, (n, 2)),
                        rng.uniform(-1, 1, (n, 1))], -1).astype(np.float32)
    pc = np.asarray(jlie.se3_apply(jnp.asarray(T_true), jnp.asarray(X)))
    uv = (pc[:, :2] / pc[:, 2:3]).astype(np.float32)
    uv += rng.normal(0, 1e-3, uv.shape).astype(np.float32)
    bad = rng.random(n) < outliers
    uv[bad] += rng.normal(0, 0.2, (int(bad.sum()), 2)).astype(np.float32)
    w = (rng.random(n) < 0.9).astype(np.float32)
    T0 = T_true.copy()
    T0[:3] += np.array([0.05, -0.04, 0.1], np.float32)
    T0[3:] = np.asarray(jlie.quat_mul(jnp.asarray(T0[3:]), jnp.asarray(
        np.array([0.01, 0.0, -0.01, 1.0], np.float32))))
    T0[3:] /= np.linalg.norm(T0[3:])
    jT, jc, jchi = jba.optimize_pose(jnp.asarray(T0), jnp.asarray(X),
                                     jnp.asarray(uv), jnp.asarray(w),
                                     iters=8, huber_delta=2.45 / 600.0)
    tT, tc, tchi = tba.optimize_pose(torch.from_numpy(T0),
                                     torch.from_numpy(X),
                                     torch.from_numpy(uv),
                                     torch.from_numpy(w), iters=8,
                                     huber_delta=2.45 / 600.0)
    np.testing.assert_allclose(tT.numpy(), np.asarray(jT), atol=1e-5)
    np.testing.assert_allclose(float(tc), float(jc), rtol=1e-4, atol=1e-9)
    np.testing.assert_allclose(tchi.numpy(), np.asarray(jchi), rtol=1e-3,
                               atol=1e-8)
    assert np.abs(tT.numpy()[:3] - T_true[:3]).max() < 2e-2
