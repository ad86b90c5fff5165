"""The port's SLAM solvers against the JAX package's, on the CPU.

The same seeded numpy inputs go through `pislamfusion_tpu` and
`pislamfusion_tpu_torch`. Each RANSAC of the port is fed the sample
indices (or, where a sweep samples over points that earlier sweeps left,
the Gumbel noise) that the JAX function draws from its key, through the
port's `_..._from_samples` / `_..._from_noise` variants, so the two run
the same hypotheses. The JAX side of each module runs once a session
(`once_per_session`), jitted as the package ships it.

Tolerances (f32 on both sides, other operation orders and other LAPACK
builds, whose SVD and eigh signs differ):

- Lie ops: 1e-5 absolute and relative; Jacobians of the relative, prior,
  Sim3 and reprojection edges 1e-4 (the relative, prior and reprojection
  edges' closed forms and the Sim3 edge's forward-mode pass against
  `jax.jacfwd`), at the identity residual, small and large ones.
- Matching: indices, masks and histograms exact.
- RANSAC (H, F, PnP, Sim3, plane), init2view and multih: the same
  inliers, matches and decisions exactly; H (normalised by H[2,2]) within
  1e-3 relative to its largest entry, F (normalised by its norm) within
  1e-4 up to sign, poses 1e-4, Sim3 1e-4, plane pose 1e-5, triangulated
  points 1e-3 relative to their distance.
- BA: poses 1e-4, points 1e-3, costs 1e-3 relative (the LM's
  accept/reject decisions are the same); the graph solvers 1e-4; the
  reference's own g2o output (tests/data/golden/ref_ba_expect.txt) to
  tests/test_golden_ba.py's bars.
- The slice (the card phase's chain on the small strip): the JAX chain
  on the port's matches and the JAX package's draws, with the tolerances
  above, the plane's also within 2e-5 relative (its world coordinates
  are ~100 m, where an f32 step is 7.6e-6 m), `fit_sim3` on its scale
  (1e-4) and aligned centres (1 mm), the PnP and BA
  poses within 1e-4 relative (their LMs fix depth along the 120 m
  viewing axis to ~5e-5 in f32).
"""
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pislamfusion_tpu.ops import ba as jba
from pislamfusion_tpu.ops import image as jim
from pislamfusion_tpu.ops import init2view as jinit
from pislamfusion_tpu.ops import lie as jlie
from pislamfusion_tpu.ops import matching as jmatch
from pislamfusion_tpu.ops import multih as jmh
from pislamfusion_tpu.ops import ransac as jr
from pislamfusion_tpu_torch import convert
from pislamfusion_tpu_torch.ops import ba as tba
from pislamfusion_tpu_torch.ops import image as tim
from pislamfusion_tpu_torch.ops import init2view as tinit
from pislamfusion_tpu_torch.ops import lie as tlie
from pislamfusion_tpu_torch.ops import matching as tmatch
from pislamfusion_tpu_torch.ops import multih as tmh
from pislamfusion_tpu_torch.ops import ransac as tr
from pislamfusion_tpu_torch.ops import threefry
from torch_port_reference import once_per_session, torch_one_thread  # noqa

GOLDEN = os.path.join(os.path.dirname(__file__), "data", "golden",
                      "ref_ba_expect.txt")
ITERS = 64


def T(x):
    return torch.from_numpy(np.array(x))


def J(x):
    return jnp.asarray(np.asarray(x))


def N(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _quats(rng, n):
    q = rng.normal(size=(n, 4)).astype(np.float32)
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


def _poses(rng, n, tscale=1.0):
    t = (rng.normal(size=(n, 3)) * tscale).astype(np.float32)
    return np.concatenate([t, _quats(rng, n)], -1)


def _sims(rng, n):
    return np.concatenate([_poses(rng, n), rng.uniform(
        0.5, 2.0, (n, 1)).astype(np.float32)], -1)


class _HostLie:
    """The port's Lie ops on numpy, to build test inputs without eager JAX
    compiles (the inputs only need to be the same for both packages)."""

    def __getattr__(self, name):
        fn = getattr(tlie, name)
        return lambda *a: N(fn(*[torch.as_tensor(np.asarray(x)) for x in a]))


hl = _HostLie()


def _draw(key, n, valid, iters, k):
    return np.asarray(jr._sample_indices(key, n, J(valid), iters, k))


# ---------------------------------------------------------------------------
# Lie ops and the edge Jacobians
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fn_name, kinds", [
    ("quat_from_matrix", ("R",)), ("so3_log", ("q",)),
    ("so3_log", ("q_tiny",)), ("se3_log", ("T",)), ("se3_log", ("T_tiny",)),
    ("se3_matrix", ("T",)), ("se3_from_matrix", ("M",)),
    ("so3_from_euler", ("a", "a", "a")), ("sim3_exp", ("xi7",)),
    ("sim3_exp", ("xi7_tiny_phi",)), ("sim3_exp", ("xi7_tiny_sigma",)),
    ("sim3_log", ("S",)), ("sim3_mul", ("S", "S")), ("sim3_inv", ("S",)),
    ("sim3_apply", ("S", "p")), ("se3_interpolate", ("T", "T", "alpha")),
])
def test_lie_matches_reference(fn_name, kinds):
    rng = np.random.default_rng(11)
    n = 64
    tiny_q = np.concatenate([1e-6 * rng.normal(size=(n, 3)),
                             np.ones((n, 1))], -1).astype(np.float32)
    make = {
        "q": lambda: _quats(rng, n),
        "q_tiny": lambda: tiny_q,
        "T": lambda: _poses(rng, n),
        "T_tiny": lambda: np.concatenate([rng.normal(size=(n, 3)).astype(
            np.float32), tiny_q], -1),
        "R": lambda: np.array(hl.quat_to_matrix(J(_quats(rng, n)))),
        "M": lambda: np.array(hl.se3_matrix(J(_poses(rng, n)))),
        "a": lambda: rng.uniform(-3, 3, n).astype(np.float32),
        "xi7": lambda: rng.normal(size=(n, 7)).astype(np.float32),
        "xi7_tiny_phi": lambda: np.concatenate([
            rng.normal(size=(n, 3)), 1e-6 * rng.normal(size=(n, 3)),
            rng.normal(size=(n, 1))], -1).astype(np.float32),
        "xi7_tiny_sigma": lambda: np.concatenate([
            rng.normal(size=(n, 6)), 1e-7 * rng.normal(size=(n, 1))],
            -1).astype(np.float32),
        "S": lambda: _sims(rng, n),
        "p": lambda: rng.normal(size=(n, 3)).astype(np.float32),
        "alpha": lambda: rng.uniform(0, 1, (n, 1)).astype(np.float32),
    }
    args = [make[k]() for k in kinds]
    j = np.asarray(jax.jit(getattr(jlie, fn_name))(*[J(a) for a in args]))
    t = N(getattr(tlie, fn_name)(*[T(a) for a in args]))
    assert t.shape == j.shape
    np.testing.assert_allclose(t, j, atol=1e-5, rtol=1e-5)


def test_lie_identities_and_host_devices():
    for jf, tf, shape in ((jlie.quat_identity, tlie.quat_identity, (3,)),
                          (jlie.se3_identity, tlie.se3_identity, (2, 2)),
                          (jlie.sim3_identity, tlie.sim3_identity, ())):
        np.testing.assert_array_equal(N(tf(shape, device="cpu")),
                                      np.asarray(jf(shape)))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            tlie.se3_identity()
    S = _sims(np.random.default_rng(2), 4)
    np.testing.assert_array_equal(N(tlie.sim3_to_se3(T(S))), S[:, :7])
    np.testing.assert_allclose(
        N(tlie.sim3_from_se3(T(S[:, :7]), T(S[:, 7]))), S)


def _edge_inputs(rng, n=16):
    """Relative-edge inputs: half of them at the identity residual (the
    small-angle branches of se3_log), then small residuals (the series of
    the port's closed form), then large ones (its closed form)."""
    Ti, Tj = _poses(rng, n), _poses(rng, n)
    meas = np.array(hl.se3_mul(J(Ti), hl.se3_inv(J(Tj))))
    noisy = np.array(hl.se3_mul(J(meas), hl.se3_exp(J(
        0.1 * rng.normal(size=(n, 6)).astype(np.float32)))))
    meas[n // 2:] = noisy[n // 2:]
    meas[-3:] = _poses(rng, 3)
    return Ti, Tj, meas


def test_rel_and_prior_jacobians_match_jax():
    rng = np.random.default_rng(12)
    Ti, Tj, meas = _edge_inputs(rng)
    z6 = jnp.zeros(6, jnp.float32)
    jJi, jJj = jax.jit(jba._rel_jac)(z6, z6, J(Ti), J(Tj), J(meas))
    tJi, tJj = tba._rel_jac(T(Ti), T(Tj), T(meas))
    for a, b in ((tJi, jJi), (tJj, jJj)):
        assert np.isfinite(N(a)).all()
        np.testing.assert_allclose(N(a), np.asarray(b), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(N(tba._rel_val(T(Ti), T(Tj), T(meas))),
                               np.asarray(jax.jit(jba._rel_val)(
                                   z6, z6, J(Ti), J(Tj), J(meas))), atol=1e-5)
    # priors: at the prior itself (log at identity) and away from it
    prior = Ti.copy()
    prior[8:] = Tj[8:]
    jG = jax.jit(jba._prior_jac)(z6, J(Ti), J(prior))
    tG = tba._prior_jac(T(Ti), T(prior))
    assert np.isfinite(N(tG)).all()
    np.testing.assert_allclose(N(tG), np.asarray(jG), atol=1e-4, rtol=1e-4)


def test_sim3_edge_jacobian_matches_jax():
    rng = np.random.default_rng(13)
    n = 12
    Si, Sj = _sims(rng, n), _sims(rng, n)
    meas = np.array(hl.sim3_mul(hl.sim3_inv(J(Si)), J(Sj)))
    meas[n // 2:] = _sims(rng, n - n // 2)

    def jres(di, dj, Si, Sj, m):
        Si = jlie.sim3_mul(jlie.sim3_exp(di), Si)
        Sj = jlie.sim3_mul(jlie.sim3_exp(dj), Sj)
        return jlie.sim3_log(jlie.sim3_mul(jlie.sim3_inv(m),
                                           jlie.sim3_mul(jlie.sim3_inv(Si),
                                                         Sj)))
    z7 = jnp.zeros(7, jnp.float32)
    jJ = jax.jit(jax.vmap(jax.jacfwd(jres, argnums=(0, 1)),
                          in_axes=(None, None, 0, 0, 0)))(z7, z7, J(Si),
                                                          J(Sj), J(meas))
    tJ = tba._jacobians(tba._sim3_residual, 2, 7, T(Si), T(Sj), T(meas))
    for a, b in zip(tJ, jJ):
        assert np.isfinite(N(a)).all()
        np.testing.assert_allclose(N(a), np.asarray(b), atol=1e-4, rtol=1e-4)


def test_reprojection_jacobians_closed_form_match_jacfwd():
    rng = np.random.default_rng(14)
    n = 50
    Tw = _poses(rng, n, 0.2)
    X = np.array(hl.se3_apply(hl.se3_inv(J(Tw)), J(np.concatenate([
        rng.uniform(-1, 1, (n, 2)), rng.uniform(2, 6, (n, 1))], -1).astype(
            np.float32))))
    X[:4] = np.array(hl.se3_apply(hl.se3_inv(J(Tw[:4])), J(
        np.array([[0.1, 0.2, -1.0]] * 4, np.float32))))   # behind
    uv = rng.normal(0, 0.3, (n, 2)).astype(np.float32)
    z6, z3 = jnp.zeros(6, jnp.float32), jnp.zeros(3, jnp.float32)
    jc, jp = jax.jit(jba._reproj_jac)(z6, z3, J(Tw), J(X), J(uv))
    r, tc, tp = tba._reproj_terms(T(Tw), T(X), T(uv))
    np.testing.assert_allclose(N(r), np.asarray(jax.jit(jba._reproj_val)(
        z6, z3, J(Tw), J(X), J(uv))), atol=1e-5)
    np.testing.assert_allclose(N(tc), np.asarray(jc), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(N(tp), np.asarray(jp), atol=1e-4, rtol=1e-4)


# ---------------------------------------------------------------------------
# matching and remap
# ---------------------------------------------------------------------------

def _bits(rng, n):
    return (rng.random((n, 256)) < 0.5).astype(np.uint8)


@pytest.mark.parametrize("consecutive", [False, True])
def test_rotation_consistency_mask_exact(consecutive):
    rng = np.random.default_rng(15)
    n = 300
    idx = rng.integers(-1, 250, n).astype(np.int32)
    valid = (idx >= 0) & (rng.random(n) < 0.9)
    ang_b = rng.uniform(0, 2 * np.pi, 250).astype(np.float32)
    # three popular differences, two of them tied, one straddling 0
    d = rng.choice([0.01, 1.0, 2.5, -0.02], n) + rng.normal(0, 0.03, n)
    d[rng.random(n) < 0.3] = rng.uniform(0, 2 * np.pi, 1)[0]
    ang_a = (np.where(idx >= 0, ang_b[idx], 0.0) + d).astype(np.float32)
    for keep in (1, 2, 3):
        j = np.asarray(jmatch.rotation_consistency_mask(
            J(ang_a), J(ang_b), J(idx), J(valid), keep=keep,
            consecutive=consecutive))
        t = N(tmatch.rotation_consistency_mask(
            T(ang_a), T(ang_b), T(idx), T(valid), keep=keep,
            consecutive=consecutive))
        np.testing.assert_array_equal(t, j)
    # a histogram of equal counts: the lower bins win, as top_k orders them
    flat = (np.arange(60) % 30 * (2 * np.pi / 30) + 0.05).astype(np.float32)
    zeros = np.zeros(1, np.float32)
    idx0 = np.zeros(60, np.int32)
    ok = np.ones(60, bool)
    j = np.asarray(jmatch.rotation_consistency_mask(
        J(flat), J(zeros), J(idx0), J(ok), consecutive=consecutive))
    t = N(tmatch.rotation_consistency_mask(T(flat), T(zeros), T(idx0),
                                           T(ok), consecutive=consecutive))
    np.testing.assert_array_equal(t, j)
    assert t.sum() == 6


def test_match_descriptor_variants_exact():
    rng = np.random.default_rng(16)
    n, m, k = 120, 150, 3
    a = _bits(rng, n)
    perm = rng.permutation(m)[:n]
    b = _bits(rng, m)
    b[perm] = np.where(rng.random((n, 256)) < 0.08, 1 - a, a)
    va, vb = rng.random(n) < 0.9, rng.random(m) < 0.9
    xa = rng.uniform(0, 300, (n, 2)).astype(np.float32)
    xb = rng.uniform(0, 300, (m, 2)).astype(np.float32)
    xb[perm] = xa + rng.normal(0, 6, (n, 2)).astype(np.float32)
    radius = rng.uniform(5, 40, n).astype(np.float32)
    na = rng.integers(-1, 6, n).astype(np.int32)
    nb = rng.integers(0, 6, m).astype(np.int32)
    ka = np.stack([a, np.roll(a, 3, 0), _bits(rng, n)])
    kva = np.stack([va, va, rng.random(n) < 0.5])
    sift_a = rng.normal(size=(n, 128)).astype(np.float32)
    sift_a /= np.linalg.norm(sift_a, axis=-1, keepdims=True)
    sift_b = np.concatenate([sift_a + 0.004 * rng.normal(size=(n, 128)).astype(
        np.float32), rng.normal(size=(m - n, 128)).astype(np.float32)])
    sift_b /= np.linalg.norm(sift_b, axis=-1, keepdims=True)
    cases = [
        ("match_descriptors", (a, va, b, vb, "orb"), {}),
        ("match_descriptors", (a, va, b, vb, "orb"), dict(ratio=0.8)),
        ("match_descriptors", (sift_a, va, sift_b, vb, "sift"), {}),
        ("match_descriptors_windowed", (a, va, xa, b, vb, xb, 25.0, "orb"),
         {}),
        ("match_descriptors_windowed", (a, va, xa, b, vb, xb, radius, "orb"),
         dict(cross_check=False)),
        ("match_descriptors_bucketed", (a, va, na, b, vb, nb, "orb"), {}),
        ("match_descriptors_batch", (ka, kva, b, vb, "orb"), {}),
    ]
    for name, args, kw in cases:
        jargs = [J(x) if isinstance(x, np.ndarray) else x for x in args]
        targs = [T(x) if isinstance(x, np.ndarray) else x for x in args]
        ji, jo = getattr(jmatch, name)(*jargs, **kw)
        ti, to = getattr(tmatch, name)(*targs, **kw)
        assert np.asarray(jo).sum() > 10, name
        np.testing.assert_array_equal(N(to), np.asarray(jo), err_msg=name)
        np.testing.assert_array_equal(N(ti), np.asarray(ji), err_msg=name)
    jp, jv = jmatch.matches_to_pairs(ji[0], jo[0])
    tp, tv = tmatch.matches_to_pairs(ti[0], to[0])
    np.testing.assert_array_equal(N(tp), np.asarray(jp))
    np.testing.assert_array_equal(N(tv), np.asarray(jv))


@pytest.mark.parametrize("channels", [0, 3])
def test_remap_matches_reference(channels):
    rng = np.random.default_rng(17)
    shape = (40, 50) + ((channels,) if channels else ())
    img = rng.uniform(0, 255, shape).astype(np.float32)
    xy = np.stack([rng.uniform(-5, 55, (30, 35)),
                   rng.uniform(-5, 45, (30, 35))], -1).astype(np.float32)
    np.testing.assert_allclose(N(tim.remap(T(img), T(xy))),
                               np.asarray(jim.remap(J(img), J(xy))),
                               atol=2e-4, rtol=1e-6)


# ---------------------------------------------------------------------------
# RANSAC
# ---------------------------------------------------------------------------

def _h_data(rng, n=200):
    H = np.array([[1.1, 0.05, 10.0], [-0.03, 0.95, -5.0], [1e-4, -5e-5, 1.0]])
    pa = rng.uniform(0, 500, (n, 2))
    ph = np.concatenate([pa, np.ones((n, 1))], -1) @ H.T
    pb = ph[:, :2] / ph[:, 2:] + rng.normal(0, 0.5, (n, 2))
    out = rng.random(n) < 0.3
    pb[out] = rng.uniform(0, 500, (int(out.sum()), 2))
    return pa.astype(np.float32), pb.astype(np.float32)


def _f_data(rng, n=240):
    K = np.array([[400.0, 0, 320], [0, 400, 240], [0, 0, 1]])
    ang = 0.1
    R = np.array([[np.cos(ang), 0, np.sin(ang)], [0, 1, 0],
                  [-np.sin(ang), 0, np.cos(ang)]])
    X = rng.uniform(-3, 3, (n, 3))
    X[:, 2] = rng.uniform(4, 10, n)
    xa = X @ K.T
    xb = (X @ R.T + [1.0, 0.2, 0.1]) @ K.T
    xa = xa[:, :2] / xa[:, 2:] + rng.normal(0, 0.3, (n, 2))
    xb = xb[:, :2] / xb[:, 2:]
    out = rng.random(n) < 0.25
    xb[out] = rng.uniform(0, 640, (int(out.sum()), 2))
    return xa.astype(np.float32), xb.astype(np.float32)


def _pnp_data(rng, planar, n=150):
    if planar:
        X = rng.uniform(-20, 20, (n, 3))
        X[:, 2] = 0.0
        Tw = np.concatenate([[-5.0, 3.0, 25.0], [1.0, 0.0, 0.0, 0.0]])
    else:
        X = rng.uniform(-2, 2, (n, 3))
        Tw = np.concatenate([[0.2, -0.1, 5.0], _quats(rng, 1)[0] * 0.05
                             + [0, 0, 0, 1]])
        Tw[3:] /= np.linalg.norm(Tw[3:])
    pc = np.array(hl.se3_apply(J(Tw.astype(np.float32)),
                                   J(X.astype(np.float32))))
    p2n = pc[:, :2] / pc[:, 2:] + rng.normal(0, 0.001, (n, 2))
    out = rng.random(n) < 0.25
    p2n[out] += rng.uniform(0.05, 0.2, (int(out.sum()), 2))
    valid = rng.random(n) < 0.95
    return X.astype(np.float32), p2n.astype(np.float32), valid


def _ransac_inputs():
    rng = np.random.default_rng(21)
    pa, pb = _h_data(rng)
    fa, fb = _f_data(rng)
    pnp = {p: _pnp_data(rng, p) for p in (False, True)}
    pts = rng.uniform(-5, 5, (200, 3)).astype(np.float32)
    pts[:, 2] = 0.1 * pts[:, 0] - 0.05 * pts[:, 1] + rng.normal(0, 0.03, 200)
    pts[:40, 2] += rng.uniform(1, 3, 40)
    S = np.array([1, 2, 3, 0.1, 0.2, 0.3, 0.9, 1.7], np.float32)
    S[3:7] /= np.linalg.norm(S[3:7])
    sb = np.array(hl.sim3_apply(J(S), J(pts)))
    sb = sb + rng.normal(0, 0.01, sb.shape).astype(np.float32)
    sb[:50] += rng.uniform(-3, 3, (50, 3)).astype(np.float32)
    return dict(h=(pa, pb), f=(fa, fb), pnp=pnp, plane=pts, sim3=(pts, sb))


def _ransac_reference():
    d = _ransac_inputs()
    out = {}
    for kind, fn, k in (("h", jr.find_homography, 4),
                        ("f", jr.find_fundamental, 8)):
        pa, pb = d[kind]
        valid = np.ones(len(pa), bool)
        for lo in (1, 8):
            key = jax.random.PRNGKey(lo)
            res = fn(key, J(pa), J(pb), J(valid), threshold=3.0,
                     iters=ITERS, lo_topk=lo)
            out[kind, lo] = (_draw(key, len(pa), valid, ITERS, k),
                             [np.asarray(x) for x in res])
    for planar, (X, p2n, valid) in d["pnp"].items():
        key = jax.random.PRNGKey(5)
        k1, k2 = jax.random.split(key)
        res = jr.find_pnp(key, J(X), J(p2n), J(valid), threshold=0.01,
                          iters=ITERS)
        out["pnp", planar] = (
            (_draw(k1, len(X), valid, ITERS // 2, 6),
             _draw(k2, len(X), valid, ITERS - ITERS // 2, 4)),
            [np.asarray(x) for x in res])
    valid = np.ones(200, bool)
    key = jax.random.PRNGKey(6)
    out["plane"] = (_draw(key, 200, valid, ITERS, 3), [np.asarray(x) for x in
                    jr.find_plane(key, J(d["plane"]), J(valid), sigma=0.15,
                                  iters=ITERS)])
    out["sim3"] = (_draw(key, 200, valid, ITERS, 3), [np.asarray(x) for x in
                   jr.find_sim3(key, J(d["sim3"][0]), J(d["sim3"][1]),
                                J(valid), threshold=0.1, iters=ITERS)])
    return out


@pytest.fixture(scope="module")
def ransac_ref(tmp_path_factory, worker_id):
    return once_per_session("torch_solvers_ransac", _ransac_reference,
                            tmp_path_factory, worker_id)


def _assert_result(t, j, model_cmp):
    tm, ti, ts, tok = (N(x) for x in t)
    jm, ji, js, jok = j
    np.testing.assert_array_equal(ti, ji)
    assert float(ts) == float(js) and bool(tok) == bool(jok)
    model_cmp(tm, jm)


@pytest.mark.parametrize("kind, lo_topk", [("h", 1), ("h", 8), ("f", 1),
                                           ("f", 8)])
def test_two_view_ransac_exact_on_the_same_samples(ransac_ref, kind,
                                                   lo_topk):
    pa, pb = _ransac_inputs()[kind]
    idx, jres = ransac_ref[kind, lo_topk]
    fn = (tr._find_homography_from_samples if kind == "h"
          else tr._find_fundamental_from_samples)
    tres = fn(T(idx), T(pa), T(pb), torch.ones(len(pa), dtype=torch.bool),
              threshold=3.0, lo_topk=lo_topk)
    assert bool(jres[3])

    def cmp(tm, jm):
        if kind == "f":     # F is defined up to sign
            tm = tm * np.sign(np.sum(tm * jm))
            np.testing.assert_allclose(tm, jm, atol=1e-4)
        else:
            np.testing.assert_allclose(tm, jm, atol=1e-3 * np.abs(jm).max())
    _assert_result(tres, jres, cmp)


@pytest.mark.parametrize("planar", [False, True])
def test_pnp_ransac_exact_on_the_same_samples(ransac_ref, planar):
    X, p2n, valid = _ransac_inputs()["pnp"][planar]
    (i6, i4), jres = ransac_ref["pnp", planar]
    tres = tr._find_pnp_from_samples(T(i6), T(i4), T(X), T(p2n), T(valid),
                                     threshold=0.01)
    assert bool(jres[3])

    def cmp(tm, jm):
        np.testing.assert_allclose(tm, jm, atol=1e-4)
    _assert_result(tres, jres, cmp)


@pytest.mark.parametrize("seed", [0, 7, 2 ** 32 - 1])
def test_threefry_key_splits_and_draws_as_the_reference(seed):
    """threefry.Key against jax.random on three splits: the key words
    equal, the Gumbel noise within 2.5e-7 absolute and relative (XLA's log
    and torch's round apart; the uniforms under them are equal) and the
    Gumbel top-k samples equal."""
    jkey, tkey = jax.random.PRNGKey(seed), threefry.Key(seed)
    assert tkey.words == tuple(np.asarray(jkey).tolist())
    for _ in range(3):
        (jkey, jsub), (tkey, tsub) = jax.random.split(jkey), tkey.split()
        for j, t in ((jkey, tkey), (jsub, tsub)):
            assert t.words == tuple(np.asarray(j).tolist())
        g = np.asarray(jax.random.gumbel(jsub, (ITERS, 300)))
        t = tsub.gumbel((ITERS, 300)).numpy()
        np.testing.assert_allclose(t, g, rtol=2.5e-7, atol=2.5e-7)
        valid = np.arange(300) % 4 != 0
        np.testing.assert_array_equal(
            N(tr.sample_indices(tsub, 300, T(valid), ITERS, 6)),
            _draw(jsub, 300, valid, ITERS, 6))


def test_tracker_key_splits_and_draws_as_the_reference():
    """The tracker draws from the reference's key: `_next_key` splits as
    the JAX tracker's (tracker.py:76-78) from PRNGKey(SLAM.Seed);
    `split(num)` gives jax.random.split(key, num)'s keys; the two-view
    initializer and the multi-H matcher split a key as the reference's
    (init2view.py:136, multih.py:58, :123, :132)."""
    from pislamfusion_tpu_torch.core.svar import Svar
    from pislamfusion_tpu_torch.models.tracker import Tracker
    from pislamfusion_tpu_torch.models.worldmap import WorldMap
    cfg = Svar()
    cfg.set("SLAM.Seed", "3")
    trk = Tracker(WorldMap(), cfg, device="cpu")
    jkey = jax.random.PRNGKey(3)
    for _ in range(4):
        jkey, jsub = jax.random.split(jkey)
        assert trk._next_key().words == tuple(np.asarray(jsub).tolist())
    key = threefry.Key(11)
    for num in (2, 4, 5):
        assert [k.words for k in key.split(num)] == [
            tuple(r) for r in np.asarray(jax.random.split(
                jax.random.PRNGKey(11), num)).tolist()]
    valid = np.arange(120) % 5 != 0
    ka, kb = jax.random.split(jax.random.PRNGKey(11))
    g_h, g_f = key.split()
    np.testing.assert_array_equal(
        N(tr.sample_indices(g_h, 120, T(valid), ITERS, 4)),
        _draw(ka, 120, valid, ITERS, 4))
    np.testing.assert_array_equal(
        N(tr.sample_indices(g_f, 120, T(valid), ITERS, 8)),
        _draw(kb, 120, valid, ITERS, 8))
    noise = tmh._plane_noise(key, 4, ITERS, 120)
    for t, j in zip(noise, jax.random.split(jax.random.PRNGKey(11), 4)):
        np.testing.assert_allclose(
            N(t), np.asarray(jax.random.gumbel(j, (ITERS, 120))),
            rtol=2.5e-7, atol=2.5e-7)


@pytest.mark.parametrize("planar", [False, True])
def test_pnp_ransac_from_the_references_key(ransac_ref, planar):
    """find_pnp on threefry.Key(5) runs the samples that the JAX package's
    find_pnp draws from PRNGKey(5), to the same result (the loop closer's
    verification draws so)."""
    X, p2n, valid = _ransac_inputs()["pnp"][planar]
    _, jres = ransac_ref["pnp", planar]
    tres = tr.find_pnp(threefry.Key(5), T(X), T(p2n), T(valid),
                       threshold=0.01, iters=ITERS)

    def cmp(tm, jm):
        np.testing.assert_allclose(tm, jm, atol=1e-4)
    _assert_result(tres, jres, cmp)


def test_plane_and_sim3_ransac_exact_on_the_same_samples(ransac_ref):
    d = _ransac_inputs()
    valid = torch.ones(200, dtype=torch.bool)
    idx, jres = ransac_ref["plane"]
    tres = tr._find_plane_from_samples(T(idx), T(d["plane"]), valid, 0.15)
    _assert_result(tres, jres, lambda t, j: np.testing.assert_allclose(
        t, j, atol=1e-5))
    idx, jres = ransac_ref["sim3"]
    tres = tr._find_sim3_from_samples(T(idx), T(d["sim3"][0]),
                                      T(d["sim3"][1]), valid, 0.1)
    _assert_result(tres, jres, lambda t, j: np.testing.assert_allclose(
        t, j, atol=1e-4))


def test_sim3_horn_and_its_rank_guard():
    rng = np.random.default_rng(22)
    S = np.array([0.5, -1, 2, 0.1, -0.3, 0.2, 0.9, 0.7], np.float32)
    S[3:7] /= np.linalg.norm(S[3:7])
    cloud = rng.normal(size=(20, 3)).astype(np.float32)
    line = np.stack([np.linspace(0, 10, 20), np.zeros(20), np.zeros(20)],
                    -1).astype(np.float32)
    line += rng.normal(0, 1e-6, line.shape).astype(np.float32)
    point = np.zeros((20, 3), np.float32)
    w = rng.uniform(0, 1, 20).astype(np.float32)
    for src in (cloud, line, point):
        dst = np.array(hl.sim3_apply(J(S), J(src)))
        for ww in (None, w):
            j = np.asarray(jr.sim3_horn(J(src), J(dst),
                                        None if ww is None else J(ww)))
            t = N(tr.sim3_horn(T(src), T(dst), None if ww is None else T(ww)))
            np.testing.assert_allclose(t, j, atol=1e-4)
    # batched hypotheses equal one call each
    idx = rng.integers(0, 20, (5, 3))
    dst = np.array(hl.sim3_apply(J(S), J(cloud)))
    batch = N(tr.sim3_horn(T(cloud[idx]), T(dst[idx])))
    for i in range(5):
        np.testing.assert_allclose(batch[i], N(tr.sim3_horn(
            T(cloud[idx[i]]), T(dst[idx[i]]))), atol=1e-6)


def test_triangulate_and_parallax_match_reference():
    rng = np.random.default_rng(23)
    n = 120
    X = np.concatenate([rng.uniform(-3, 3, (n, 2)),
                        rng.uniform(4, 10, (n, 1))], -1).astype(np.float32)
    Ta = np.array([0, 0, 0, 0, 0, 0, 1], np.float32)
    Tb = np.array([1.0, 0.1, 0.0, 0.0, 0.04, 0.0, 1.0], np.float32)
    Tb[3:] /= np.linalg.norm(Tb[3:])

    def rays(Tc2w):
        pc = np.array(hl.se3_apply(hl.se3_inv(J(Tc2w)), J(X)))
        r = pc / pc[:, 2:]
        r[:, :2] += rng.normal(0, 1e-3, (n, 2))
        return r.astype(np.float32)
    ra, rb = rays(Ta), rays(Tb)
    jX, jd = jr.triangulate(J(Ta), J(Tb), J(ra), J(rb))
    tX, td = tr.triangulate(T(Ta), T(Tb), T(ra), T(rb))
    scale = np.linalg.norm(np.asarray(jX), axis=-1, keepdims=True)
    assert (np.abs(N(tX) - np.asarray(jX)) <= 1e-3 * scale).all()
    np.testing.assert_allclose(N(td), np.asarray(jd), rtol=1e-3)
    np.testing.assert_allclose(
        N(tr.parallax_cos(T(Ta), T(Tb), tX)),
        np.asarray(jr.parallax_cos(J(Ta), J(Tb), jX)), atol=1e-5)


# ---------------------------------------------------------------------------
# two-view initialization and the initializers
# ---------------------------------------------------------------------------

def _pair(rng, n=240, planar=False, baseline=(1.0, 0.0, 0.0),
          outlier_frac=0.1):
    """tests/test_init2view.py's make_pair."""
    X = rng.uniform(-3, 3, (n, 3))
    X[:, 2] = (6.0 + 0.2 * X[:, 0] - 0.1 * X[:, 1] if planar
               else rng.uniform(4, 10, n))
    ang = 0.08
    R = np.array([[np.cos(ang), 0, np.sin(ang)], [0, 1, 0],
                  [-np.sin(ang), 0, np.cos(ang)]])
    ra = X[:, :2] / X[:, 2:]
    Xb = X @ R.T + np.asarray(baseline)
    rb = Xb[:, :2] / Xb[:, 2:]
    ra = ra + rng.normal(0, 0.001, ra.shape)
    rb = rb + rng.normal(0, 0.001, rb.shape)
    out = rng.random(n) < outlier_frac
    rb[out] += rng.uniform(0.05, 0.2, (int(out.sum()), 2))
    return ra.astype(np.float32), rb.astype(np.float32)


SCENES = {"general": dict(), "planar": dict(planar=True, outlier_frac=0.05),
          "rotation": dict(baseline=(0.0, 0.0, 0.0), outlier_frac=0.0)}


def _init_inputs():
    rng = np.random.default_rng(31)
    return {name: _pair(rng, **kw) for name, kw in SCENES.items()}


def _init_reference():
    from pislamfusion_tpu.models.initializers import InitializerOpt
    out = {}
    for i, (name, (ra, rb)) in enumerate(_init_inputs().items()):
        valid = np.ones(len(ra), bool)
        valid[::17] = False
        for lo in (1, 8):
            key = jax.random.PRNGKey(i)
            ka, kb = jax.random.split(key)
            res = jinit.initialize_two_view(key, J(ra), J(rb), J(valid),
                                            iters=ITERS, lo_topk=lo)
            out[name, lo] = ((_draw(ka, len(ra), valid, ITERS, 4),
                              _draw(kb, len(ra), valid, ITERS, 8)),
                             {k: np.asarray(v) for k, v in
                              res._asdict().items()})
        res = InitializerOpt()(jax.random.PRNGKey(0), J(ra), J(rb), J(valid))
        out[name, "opt"] = {k: np.asarray(v) for k, v in
                            res._asdict().items()}
    return out


@pytest.fixture(scope="module")
def init_ref(tmp_path_factory, worker_id):
    return once_per_session("torch_solvers_init", _init_reference,
                            tmp_path_factory, worker_id)


def _assert_two_view(t, j, pose_tol=1e-4, point_tol=1e-3, mask_diff=0):
    """Decisions equal; masks equal (or differing on at most mask_diff of
    the matches); the pose (of an accepted pair: a refused one's is
    noise) within pose_tol; the points both keep within point_tol of
    their distance."""
    t = {k: N(v) for k, v in t._asdict().items()}
    assert bool(t["ok"]) == bool(j["ok"])
    assert bool(t["used_h"]) == bool(j["used_h"])
    assert (t["mask"] != j["mask"]).sum() <= mask_diff * len(j["mask"])
    if bool(j["ok"]):
        np.testing.assert_allclose(t["T_c2w"], j["T_c2w"], atol=pose_tol)
    m = j["mask"] & t["mask"]
    scale = np.linalg.norm(j["points"][m], axis=-1, keepdims=True)
    assert (np.abs(t["points"][m] - j["points"][m])
            <= point_tol * scale).all()


@pytest.mark.parametrize("scene", list(SCENES))
@pytest.mark.parametrize("lo_topk", [1, 8])
def test_initialize_two_view_exact_on_the_same_samples(init_ref, scene,
                                                       lo_topk):
    ra, rb = _init_inputs()[scene]
    valid = np.ones(len(ra), bool)
    valid[::17] = False
    (ih, i_f), jres = init_ref[scene, lo_topk]
    tres = tinit._initialize_two_view_from_samples(
        T(ih), T(i_f), T(ra), T(rb), T(valid), lo_topk=lo_topk)
    _assert_two_view(tres, jres)
    assert bool(jres["ok"]) == (scene != "rotation")
    assert bool(jres["used_h"]) == (scene != "general")


@pytest.mark.parametrize("scene", list(SCENES))
def test_initializer_opt_matches_reference(init_ref, scene):
    from pislamfusion_tpu_torch.models.initializers import InitializerOpt
    ra, rb = _init_inputs()[scene]
    valid = np.ones(len(ra), bool)
    valid[::17] = False
    tres = InitializerOpt()(threefry.Key(0), T(ra), T(rb), T(valid))
    # the joint pose + inverse-depth LM has a free scale (the monocular
    # gauge): its first steps agree to 1e-5, then rounding moves the two
    # along that direction apart (measured 1.3e-4 and 1.7e-3 in the pose,
    # 3 of 240 masks)
    _assert_two_view(tres, init_ref[scene, "opt"], pose_tol=5e-3,
                     point_tol=3e-2, mask_diff=0.02)


def test_initializer_registry_and_estimators():
    from pislamfusion_tpu_torch.core.registry import INITIALIZERS
    from pislamfusion_tpu_torch.core.svar import Svar
    from pislamfusion_tpu_torch.models.initializers import (
        InitializerOpt, InitializerSVD, create_initializer, estimator_lo_topk)
    cfg = Svar()
    for name, cls in (("svd", InitializerSVD), ("eigen", InitializerSVD),
                      ("svdzm", InitializerSVD), ("opt", InitializerOpt),
                      ("opt_svd", InitializerOpt), ("nosuch", InitializerSVD)):
        cfg.set("Initializer", name)
        assert isinstance(create_initializer(cfg), cls), name
    assert set(INITIALIZERS.names()) >= {"svd", "eigen", "svdzm", "opt",
                                         "opt_svd"}
    assert estimator_lo_topk(cfg) == 1
    cfg.set("Estimator", "LORANSAC")
    assert estimator_lo_topk(cfg) == 8
    cfg.set("Estimator.LOTopK", "4")
    cfg.set("Initializer", "svd")
    assert create_initializer(cfg).lo_topk == 4
    cfg.set("Estimator", "nosuch")
    assert estimator_lo_topk(cfg) == 1
    # the public entry draws on the key: the same seed, the same run
    ra, rb = _init_inputs()["general"]
    v = torch.ones(len(ra), dtype=torch.bool)
    runs = [create_initializer(cfg)(threefry.Key(3), T(ra), T(rb), v)
            for _ in range(2)]
    assert bool(runs[0].ok)
    for a, b in zip(*runs):
        np.testing.assert_array_equal(N(a), N(b))


# ---------------------------------------------------------------------------
# multi-homography matching
# ---------------------------------------------------------------------------

def _multih_inputs():
    """Two planes seen by both frames (two homographies a->b), descriptors
    that repeat in groups (the base matcher's ratio and cross-check drop
    those; the homography windows recover them), some clutter."""
    rng = np.random.default_rng(41)
    na, nb = 260, 280
    xa = rng.uniform(0, 400, (na, 2))
    Hs = [np.array([[1.0, 0.02, 12.0], [-0.02, 1.0, -7.0], [1e-5, 0, 1.0]]),
          np.array([[0.97, -0.05, 30.0], [0.05, 0.97, 4.0], [0, 2e-5, 1.0]])]
    plane = (xa[:, 0] > 200).astype(int)
    ph = np.einsum("nij,nj->ni", np.stack(Hs)[plane],
                   np.concatenate([xa, np.ones((na, 1))], -1))
    xb = np.concatenate([ph[:, :2] / ph[:, 2:] + rng.normal(0, 0.4, (na, 2)),
                         rng.uniform(0, 430, (nb - na, 2))])
    da = _bits(rng, na)
    motifs = _bits(rng, 6)
    rep = rng.random(na) < 0.35
    da[rep] = motifs[rng.integers(0, 6, int(rep.sum()))]
    db = np.concatenate([np.where(rng.random((na, 256)) < 0.05, 1 - da, da),
                         _bits(rng, nb - na)])
    ang_a = rng.uniform(0, 2 * np.pi, na).astype(np.float32)
    ang_b = np.concatenate([ang_a + 0.1 + rng.normal(0, 0.05, na),
                            rng.uniform(0, 2 * np.pi, nb - na)])
    va, vb = rng.random(na) < 0.95, np.ones(nb, bool)
    f32 = np.float32
    return (da, va, xa.astype(f32), ang_a, db, vb, xb.astype(f32),
            ang_b.astype(f32))


def _multih_reference():
    da, va, xa, ang_a, db, vb, xb, ang_b = _multih_inputs()
    key = jax.random.PRNGKey(7)
    keys = jax.random.split(key, 3)
    noise = np.stack([np.asarray(jax.random.gumbel(k, (ITERS, len(xa))))
                      for k in keys])
    res = jmh.match_multih(key, J(da), J(va), J(xa), J(db), J(vb), J(xb),
                           n_h=3, ransac_iters=ITERS)
    kf, kh = jax.random.split(key)
    noise_f = np.asarray(jax.random.gumbel(kf, (ITERS, len(xa))))
    noise_h = np.stack([np.asarray(jax.random.gumbel(k, (ITERS, len(xa))))
                        for k in jax.random.split(kh, 3)])
    bres = jmh.match_bf_multih(key, J(da), J(va), J(xa), J(ang_a), J(db),
                               J(vb), J(xb), J(ang_b), n_h=3,
                               ransac_iters=ITERS)
    base = jmatch.match_descriptors(J(da), J(va), J(db), J(vb), "orb",
                                    ratio=0.8)
    return (noise, [np.asarray(x) for x in res], noise_f, noise_h,
            [np.asarray(x) for x in bres], np.asarray(base[1]).sum())


@pytest.fixture(scope="module")
def multih_ref(tmp_path_factory, worker_id):
    return once_per_session("torch_solvers_multih", _multih_reference,
                            tmp_path_factory, worker_id)


def test_multih_exact_on_the_same_noise(multih_ref):
    da, va, xa, ang_a, db, vb, xb, ang_b = (T(x) for x in _multih_inputs())
    noise, jres, noise_f, noise_h, jbres, n_base = multih_ref
    tres = tmh._match_multih_from_noise(T(noise), da, va, xa, db, vb, xb)
    tb = tmh._match_bf_multih_from_noise(T(noise_f), T(noise_h), da, va, xa,
                                         ang_a, db, vb, xb, ang_b)
    for t, j in ((tres, jres), (tb, jbres)):
        np.testing.assert_array_equal(N(t[1]), j[1])
        np.testing.assert_array_equal(N(t[0])[j[1]], j[0][j[1]])
        assert int(t[2]) == int(j[2]) >= 1
    # the growth is real: more matches than the ratio-tested base
    assert jres[1].sum() > n_base + 20


def test_multih_public_entry_is_seeded():
    args = [T(x) for x in _multih_inputs()]
    da, va, xa, ang_a, db, vb, xb, ang_b = args
    runs = [tmh.match_multih(threefry.Key(1), da, va, xa, db, vb, xb,
                             n_h=2, ransac_iters=32) for _ in range(2)]
    for a, b in zip(*runs):
        np.testing.assert_array_equal(N(a), N(b))
    idx, ok, n = tmh.match_bf_multih(threefry.Key(1), da, va, xa, ang_a,
                                     db, vb, xb, ang_b, n_h=2,
                                     ransac_iters=32)
    assert int(ok.sum()) > 50 and int(n) >= 1


# ---------------------------------------------------------------------------
# bundle adjustment
# ---------------------------------------------------------------------------

def _ba_world(rng, n_frames=5, n_points=120, noise=5e-4):
    """tests/test_ba.py's make_world: cameras on an arc over a cloud."""
    c2w = []
    for i in range(n_frames):
        ang = 0.25 * i
        c = [4.0 * np.sin(ang), 0.5 * i, -6.0 + 0.3 * i]
        q = [0.0, np.sin(ang * 0.1), 0.0, np.cos(ang * 0.1)]
        c2w.append(np.concatenate([c, q]))
    c2w = np.asarray(c2w, np.float32)
    pts = rng.uniform(-3, 3, (n_points, 3)).astype(np.float32)
    pts[:, 2] *= 0.5
    w2c = np.array(hl.se3_inv(J(c2w)))
    of, op, uv = [], [], []
    for f in range(n_frames):
        pc = np.array(hl.se3_apply(J(w2c[f]), J(pts)))
        for p in np.nonzero(pc[:, 2] > 1.0)[0]:
            of.append(f)
            op.append(p)
            uv.append(pc[p, :2] / pc[p, 2])
    uv = (np.asarray(uv) + rng.normal(0, noise, (len(of), 2))).astype(
        np.float32)
    return w2c, pts, np.asarray(of, np.int32), np.asarray(op, np.int32), uv


def _ba_inputs():
    """A 5-frame, 120-point bundle from perturbed poses and points with two
    frames fixed, GPS priors on three frames, two relative edges, one
    zero-weight observation and one fixed point; and the graph, ICP and
    inverse-depth problems of tests/test_ba.py at small sizes."""
    rng = np.random.default_rng(51)
    w2c, pts, of, op, uv = _ba_world(rng)
    F = len(w2c)
    pert = np.array(hl.se3_exp(J(0.03 * rng.normal(size=(F, 6)).astype(
        np.float32))))
    T0 = np.array(hl.se3_mul(J(pert), J(w2c)))
    T0[:2] = w2c[:2]
    fixed = np.array([True, True, False, False, False])
    pts0 = pts + rng.normal(0, 0.05, pts.shape).astype(np.float32)
    pf = np.zeros(len(pts), bool)
    pf[3] = True
    ow = np.ones(len(of), np.float32)
    ow[5] = 0.0
    prior_frame = np.array([2, 3, 4], np.int32)
    prior_pose = np.array(hl.se3_mul(hl.se3_exp(J(0.01 * rng.normal(
        size=(3, 6)).astype(np.float32))), J(w2c[2:])))
    rel_i, rel_j = np.array([1, 2], np.int32), np.array([3, 4], np.int32)
    rel_meas = np.array(hl.se3_mul(J(w2c[rel_i]), hl.se3_inv(J(
        w2c[rel_j]))))
    bundle = dict(poses=T0, pose_fixed=fixed, points=pts0, point_fixed=pf,
                  obs_frame=of, obs_point=op, obs_uv=uv, obs_weight=ow,
                  rel_i=rel_i, rel_j=rel_j, rel_meas=rel_meas,
                  rel_weight=np.array([5.0, 5.0], np.float32),
                  prior_frame=prior_frame, prior_pose=prior_pose,
                  prior_info=np.full((3, 6), 20.0, np.float32))
    # pose graph: a noisy chain of 8 with a loop edge and 6 skip edges
    n = 8
    truth = _poses(rng, n, 2.0)
    gi = np.r_[np.arange(n - 1), 0, np.arange(n - 2)].astype(np.int32)
    gj = np.r_[np.arange(1, n), n - 1, np.arange(2, n)].astype(np.int32)
    e = len(gi)
    gm = np.array(hl.se3_mul(hl.se3_mul(J(truth[gi]), hl.se3_inv(
        J(truth[gj]))), hl.se3_exp(J(0.01 * rng.normal(size=(e, 6)).astype(
            np.float32)))))
    g0 = np.array(hl.se3_mul(hl.se3_exp(J(0.1 * rng.normal(
        size=(n, 6)).astype(np.float32))), J(truth)))
    gfixed = np.zeros(n, bool)
    gfixed[0] = True
    gw = np.ones(e, np.float32)
    gw[3] = 0.0
    graph = (g0, gfixed, gi, gj, gm, gw)
    sims = np.concatenate([g0, np.ones((n, 1), np.float32)], -1)
    sims[4:, 7] = 1.3
    smeas = np.concatenate([np.array(hl.se3_inv(J(gm))),
                            np.ones((e, 1), np.float32)], -1)
    sgraph = (sims, gfixed, gi, gj, smeas, gw)
    # ICP / fit_sim3: a similarity with outliers
    S = np.array([0.3, -0.2, 1.0, 0.05, 0.1, -0.05, 1.0, 1.4], np.float32)
    S[3:7] /= np.linalg.norm(S[3:7])
    icp_a = pts[:60]
    icp_b = np.array(hl.sim3_apply(J(S), J(icp_a))) + rng.normal(
        0, 0.01, (60, 3)).astype(np.float32)
    icp_b[:6] += 4.0
    icp_w = np.ones(60, np.float32)
    # inverse-depth pose: test_optimize_pose_invdepth's, 60 + 6 matches,
    # two at the 1e-6 depth floor
    X = rng.uniform(-2, 2, (66, 3)).astype(np.float32)
    X[:, 2] += 6.0
    Tref = np.array([0, 0, 0, 0, 0, 0, 1.0], np.float32)
    Tcur_c2w = np.concatenate([[0.8, -0.3, 0.1], np.array(
        [0.02, 0.03, -0.01, 1.0]) / np.linalg.norm([0.02, 0.03, -0.01, 1.0])
    ]).astype(np.float32)
    Tcur = np.array(hl.se3_inv(J(Tcur_c2w)))
    rr = X[:, :2] / X[:, 2:]
    pc = np.array(hl.se3_apply(J(Tcur), J(X)))
    rc = (pc[:, :2] / pc[:, 2:] + rng.normal(0, 1.25e-3, (66, 2))).astype(
        np.float32)
    w2d = np.r_[np.ones(60), np.zeros(6)].astype(np.float32)
    w3d = 1.0 - w2d
    q0 = np.full(66, 1.0 / np.median(X[:, 2]), np.float32)
    q0[:2] = 1e-6
    Tinit = np.array(hl.se3_inv(J(np.array([0.6, -0.1, 0, 0, 0, 0, 1.0],
                                               np.float32))))
    invdepth = (Tinit, Tref, rr.astype(np.float32), rc, w2d, q0, X, rc, w3d)
    return dict(bundle=bundle, graph=graph, sgraph=sgraph,
                icp=(icp_a, icp_b, icp_w), fit=(g0, truth), invdepth=invdepth)


def _ba_reference():
    d = _ba_inputs()
    prob = jba.make_problem(**{k: J(v) for k, v in d["bundle"].items()})
    out = {"optimize": [np.asarray(x) for x in jba.optimize(prob, iters=12)],
           "optimize_tol": [np.asarray(x) for x in
                            jba.optimize(prob, iters=30, tol=1e-4)]}
    g = [J(x) for x in d["graph"]]
    out["se3_graph"] = [np.asarray(x) for x in jba.optimize_se3_graph(
        *g, iters=10)]
    out["se3_graph_cg"] = [np.asarray(x) for x in jba.optimize_se3_graph_cg(
        *g, iters=6, cg_iters=20)]
    out["sim3_graph"] = [np.asarray(x) for x in jba.optimize_sim3_graph(
        *[J(x) for x in d["sgraph"]], iters=10)]
    out["icp"] = [np.asarray(x) for x in jba.optimize_icp(
        *[J(x) for x in d["icp"]], iters=5)]
    out["icp_fixed"] = [np.asarray(x) for x in jba.optimize_icp(
        *[J(x) for x in d["icp"]], iters=5, fix_scale=True)]
    out["fit"] = np.asarray(jba.fit_sim3(*[J(x) for x in d["fit"]]))
    out["invdepth"] = [np.asarray(x) for x in jba.optimize_pose_invdepth(
        *[J(x) for x in d["invdepth"]], iters=10)]
    return out


@pytest.fixture(scope="module")
def ba_ref(tmp_path_factory, worker_id):
    return once_per_session("torch_solvers_ba", _ba_reference,
                            tmp_path_factory, worker_id)


@pytest.mark.parametrize("tol", [0.0, 1e-4])
def test_bundle_adjustment_matches_reference(ba_ref, tol):
    d = _ba_inputs()["bundle"]
    prob = convert.ba_problem_from_numpy(d, device="cpu")
    stats = {}
    poses, points, cost = tba.optimize(prob, iters=30 if tol else 12,
                                       tol=tol, stats=stats)
    jp, jx, jc = ba_ref["optimize_tol" if tol else "optimize"]
    np.testing.assert_allclose(N(poses), jp, atol=1e-4)
    np.testing.assert_allclose(N(points), jx, atol=1e-3)
    np.testing.assert_allclose(float(cost), float(jc), rtol=1e-3)
    np.testing.assert_array_equal(N(poses)[:2], d["poses"][:2])
    assert N(points)[3].tolist() == d["points"][3].tolist()
    # tol > 0 reads one flag a step and stops early; tol == 0 reads none
    assert stats["host_syncs"] == (stats["steps"] if tol else 0)
    assert stats["steps"] == 12 or stats["steps"] < 30
    # the port's make_problem builds what the reference's does
    made = tba.make_problem(**d, device="cpu")
    for a, b in zip(made, prob):
        np.testing.assert_array_equal(N(a), N(b))


def test_graph_and_icp_solvers_match_reference(ba_ref):
    d = _ba_inputs()
    g = [T(x) for x in d["graph"]]
    for name, run in (
            ("se3_graph", lambda: tba.optimize_se3_graph(*g, iters=10)),
            ("se3_graph_cg", lambda: tba.optimize_se3_graph_cg(
                *g, iters=6, cg_iters=20)),
            ("sim3_graph", lambda: tba.optimize_sim3_graph(
                *[T(x) for x in d["sgraph"]], iters=10)),
            ("icp", lambda: tba.optimize_icp(*[T(x) for x in d["icp"]],
                                             iters=5)),
            ("icp_fixed", lambda: tba.optimize_icp(
                *[T(x) for x in d["icp"]], iters=5, fix_scale=True))):
        for t, j in zip(run(), ba_ref[name]):
            np.testing.assert_allclose(N(t), j, atol=1e-4, rtol=1e-4,
                                       err_msg=name)
    np.testing.assert_allclose(N(tba.fit_sim3(*[T(x) for x in d["fit"]])),
                               ba_ref["fit"], atol=1e-4)


def test_pose_invdepth_matches_reference(ba_ref):
    args = [T(x) for x in _ba_inputs()["invdepth"]]
    out = tba.optimize_pose_invdepth(*args, iters=10)
    for t, j in zip(out, ba_ref["invdepth"]):
        np.testing.assert_allclose(N(t), j, atol=1e-4, rtol=1e-3)


def test_ba_problem_and_camera_cross_packages():
    d = _ba_inputs()["bundle"]
    jprob = jba.make_problem(**{k: J(v) for k, v in d.items()})
    tprob = convert.ba_problem_from_numpy(
        [np.asarray(x) for x in jprob], device="cpu")
    assert tprob._fields == jprob._fields
    for a, b in zip(tprob, jprob):
        np.testing.assert_array_equal(N(a), np.asarray(b))
    assert tprob.obs_frame.dtype == torch.int64
    with pytest.raises(ValueError):
        convert.ba_problem_from_numpy({"poses": d["poses"]}, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            convert.ba_problem_from_numpy(d)
        with pytest.raises(RuntimeError, match="CUDA"):
            tba.make_problem(d["poses"], d["pose_fixed"])


# ---------------------------------------------------------------------------
# the reference's own g2o output (tests/test_golden_ba.py's bars)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def gold():
    sections, cur = {}, None
    with open(GOLDEN) as f:
        for line in f:
            parts = line.split()
            if not parts:
                continue
            if parts[0] == "##":
                cur = sections[parts[1]] = {"meta": parts[2:], "rows": []}
            else:
                cur["rows"].append(parts)
    return sections


def _rows(sec, tag):
    return [r[1:] for r in sec["rows"] if r[0] == tag]


def _se3(vals):
    return torch.tensor([float(v) for v in vals[:7]])


def _inv(Tm):
    return tlie.se3_inv(torch.as_tensor(Tm))


def _se3_diff(Ta, Tb):
    d = N(tlie.se3_mul(_inv(Ta), torch.as_tensor(Tb)))
    return (float(np.linalg.norm(d[:3])),
            2.0 * float(np.arcsin(min(1.0, np.linalg.norm(d[3:6])))))


def test_golden_pnp(gold):
    sec = gold["pnp"]
    ground, init, solved = (_se3(_rows(sec, t)[0])
                            for t in ("ground", "init", "solved"))
    m = torch.tensor([[float(v) for v in r] for r in _rows(sec, "m")])
    Tm, _, _ = tba.optimize_pose(init, m[:, :3], m[:, 3:5],
                                 torch.ones(len(m)), iters=30,
                                 huber_delta=float(np.sqrt(1e-5)))
    trans, rot = _se3_diff(Tm, solved)
    assert trans < 5e-3 and rot < 5e-3, (trans, rot)
    assert _se3_diff(Tm, ground)[0] <= _se3_diff(solved, ground)[0] * 1.5 \
        + 1e-3


def test_golden_bundle(gold):
    sec = gold["bundle"]
    kf0, kf1_init, kf1_ground, solved = (
        _se3(_rows(sec, t)[0])
        for t in ("kf0", "kf1_init", "kf1_ground", "solved_kf1"))
    pts = torch.tensor([[float(v) for v in r[:3]] for r in _rows(sec, "pt")])
    gpts = np.asarray([[float(v) for v in r[4:7]]
                       for r in _rows(sec, "pt")], np.float32)
    ob = [torch.tensor([[float(v) for v in r[:2]] for r in _rows(sec, t)])
          for t in ("ob0", "ob1")]
    P = len(pts)
    prob = tba.make_problem(
        poses=torch.stack([_inv(kf0), _inv(kf1_init)]),
        pose_fixed=[True, False], points=pts, point_fixed=np.zeros(P, bool),
        obs_frame=np.r_[np.zeros(P), np.ones(P)],
        obs_point=np.r_[np.arange(P), np.arange(P)],
        obs_uv=torch.cat(ob), obs_weight=np.ones(2 * P), device="cpu")
    poses, points, _ = tba.optimize(prob, iters=40,
                                    huber_delta=float(np.sqrt(1e-5)))
    kf1 = _inv(poses[1])
    trans, rot = _se3_diff(kf1, solved)
    assert trans < 1e-2 and rot < 1e-2, (trans, rot)
    assert _se3_diff(kf1, kf1_ground)[0] <= _se3_diff(
        solved, kf1_ground)[0] * 1.5 + 2e-3
    spts = np.asarray([[float(v) for v in r] for r in _rows(sec, "solved_pt")],
                      np.float32)
    pts_np = N(points)
    assert np.sqrt(np.mean(np.sum((pts_np - spts) ** 2, -1))) < 2e-2
    rms_ba = np.sqrt(np.mean(np.sum((pts_np - gpts) ** 2, -1)))
    rms_ref = np.sqrt(np.mean(np.sum((spts - gpts) ** 2, -1)))
    assert rms_ba <= rms_ref * 1.5 + 2e-3


def test_golden_bundle_gps(gold):
    sec = gold["bundle_gps"]
    kfg = [_se3(r) for r in _rows(sec, "kf_ground")]
    kfi = [_se3(r) for r in _rows(sec, "kf_init")]
    gps = [_se3(r) for r in _rows(sec, "gps")]
    info = [float(v) for v in _rows(sec, "gpsinfo")[0]]
    solved = [_se3(r) for r in _rows(sec, "solved_kf")]
    pts = np.asarray([[float(v) for v in r[:3]] for r in _rows(sec, "pt")],
                     np.float32)
    obs = [(int(r[0]), int(r[1]), float(r[2]), float(r[3]))
           for r in _rows(sec, "ob")]
    NK = len(kfi)
    prob = tba.make_problem(
        poses=torch.stack([_inv(t) for t in kfi]), pose_fixed=[False] * NK,
        points=pts, point_fixed=np.zeros(len(pts), bool),
        obs_frame=[o[1] for o in obs], obs_point=[o[0] for o in obs],
        obs_uv=[[o[2], o[3]] for o in obs], obs_weight=np.ones(len(obs)),
        prior_frame=np.arange(NK), prior_pose=torch.stack(
            [_inv(t) for t in gps]),
        prior_info=np.tile(np.asarray(info[3:6] + info[0:3]), (NK, 1)),
        device="cpu")
    poses, _, _ = tba.optimize(prob, iters=40,
                               huber_delta=float(np.sqrt(1e-5)))
    for k in range(NK):
        c2w = _inv(poses[k])
        trans, rot = _se3_diff(c2w, solved[k])
        assert trans < 3e-2 and rot < 3e-2, (k, trans, rot)
        assert _se3_diff(c2w, kfg[k])[0] <= _se3_diff(
            solved[k], kfg[k])[0] * 2.0 + 1e-2


def test_golden_se3_graph_noninferior(gold):
    sec = gold["se3_graph"]
    kfs = torch.stack([_se3(r) for r in _rows(sec, "kf")])
    solved = torch.stack([_se3(r) for r in _rows(sec, "solved")])
    edges = [(int(r[0]), int(r[1]), torch.tensor([float(v) for v in r[2:9]]))
             for r in _rows(sec, "edge")]
    fixed = torch.zeros(len(kfs), dtype=torch.bool)
    fixed[0] = True
    new, _ = tba.optimize_se3_graph(
        _inv(kfs), fixed, torch.tensor([e[0] for e in edges]),
        torch.tensor([e[1] for e in edges]), torch.stack([e[2] for e in
                                                          edges]),
        torch.ones(len(edges)), iters=40)

    def gen_cost(c2w):
        tot = 0.0
        for i, j, m in edges:
            pred = tlie.se3_mul(c2w[i], m)
            d = tlie.se3_log(tlie.se3_mul(tlie.se3_inv(pred), c2w[j]))
            tot += float(torch.sum(d * d))
        return tot
    c_ba = gen_cost(_inv(new))
    assert c_ba < gen_cost(kfs) * 0.5
    assert c_ba <= gen_cost(solved) + 1e-6


# ---------------------------------------------------------------------------
# the slice: the card phase's chain on the small strip
# ---------------------------------------------------------------------------

CHAIN = dict(n_features=200, n_levels=4, iters=ITERS, mh_iters=ITERS,
             ba_iters=8)


def _chain_reference():
    """The port's ORB features of the small strip's frames 0-2 (600x640,
    CPU), and the JAX package's chain on them with its own keys."""
    import chip_smoke
    from torch_port_reference import jax_solver_chain
    frames, poses = chip_smoke.render_strip(3, 600, 640, 600.0, 0.24, 1024,
                                            "cpu")
    feats = [{k: N(v) for k, v in f.items()} for f in _detect(frames)]
    jr_, draws = jax_solver_chain(feats, poses, 600.0, 640, 600,
                                  CHAIN["iters"], CHAIN["mh_iters"],
                                  CHAIN["ba_iters"], tol_run=False)
    return feats, poses, chip_smoke.chain_summary(jr_, poses), draws


def _detect(frames):
    from pislamfusion_tpu_torch.ops import image as im
    from pislamfusion_tpu_torch.ops.features import orb
    params = orb.OrbParams(n_features=CHAIN["n_features"],
                           n_levels=CHAIN["n_levels"])
    return [orb.orb_detect(im.rgb_to_gray(f.to(torch.float32)), params)
            for f in frames]


@pytest.fixture(scope="module")
def chain_ref(tmp_path_factory, worker_id):
    return once_per_session("torch_solvers_chain", _chain_reference,
                            tmp_path_factory, worker_id)


def test_solver_chain_matches_reference(chain_ref):
    """chip_smoke.solver_chain (phase 2c's steps) on the CPU against the
    JAX package's chain, on the same ORB features and the JAX package's
    draws: every decision and mask equal, the models within the module
    tolerances above."""
    import chip_smoke
    feats, poses, js, draws = chain_ref
    frames = torch.zeros((3, 600, 640, 3), dtype=torch.uint8)
    r = chip_smoke.solver_chain(
        frames, poses, 600.0, **CHAIN, feats=[
            {k: T(v) for k, v in f.items()} for f in feats],
        draws=chip_smoke.Draws(saved={k: T(v) for k, v in draws.items()}))
    ts = chip_smoke.chain_summary(r, poses)
    assert js["n_match"] > 100 and js["n_tri"] > 100
    np.testing.assert_array_equal(ts["ok"], js["ok"])
    np.testing.assert_array_equal(ts["tri"], js["tri"])
    scale = np.linalg.norm(js["X"], axis=-1, keepdims=True)
    assert (np.abs(ts["X"] - js["X"]) <= 1e-3 * scale + 1e-6).all()
    for name in ("svd", "opt"):
        t, j = ts[name], js[name]
        assert bool(t["ok"]) == bool(j["ok"]) and bool(t["used_h"]) == \
            bool(j["used_h"])
        tol = 1e-4 if name == "svd" else 5e-3
        assert (t["mask"] != j["mask"]).mean() <= (0 if name == "svd"
                                                   else 0.02)
        np.testing.assert_allclose(t["T_c2w"], j["T_c2w"], atol=tol)
    assert js["svd"]["ok"] and js["plane"]["ok"]
    np.testing.assert_array_equal(ts["plane"]["inliers"],
                                  js["plane"]["inliers"])
    np.testing.assert_allclose(ts["plane"]["model"], js["plane"]["model"],
                               rtol=2e-5, atol=1e-4)
    for t, j in zip(ts["pnp"], js["pnp"]):
        assert t["ok"] == j["ok"]
        np.testing.assert_array_equal(t["inliers"], j["inliers"])
        # the pose-only LM on points 120 m away fixes depth to ~5e-5
        # relative in f32 (measured 5.6 mm)
        np.testing.assert_allclose(t["T"], j["T"], rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(ts["ba_cost0"], js["ba_cost0"], rtol=1e-4)
    np.testing.assert_allclose(ts["ba"]["poses"], js["ba"]["poses"],
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(ts["ba"]["cost"], js["ba"]["cost"],
                               rtol=1e-3)
    # three near-collinear centres leave Horn's rotation about their line
    # free (the rank guard takes 1e-5 of the spread for a line, and BA
    # leaves centimetres), so the two eigen solvers may pick different
    # rotations about it; the scale and the aligned centres are defined
    assert ts["sim3"]["rank1"] == js["sim3"]["rank1"]
    np.testing.assert_allclose(ts["sim3"]["model"][7], js["sim3"]["model"][7],
                               rtol=1e-4)
    np.testing.assert_allclose(ts["sim3"]["err_m"], js["sim3"]["err_m"],
                               atol=1e-3)
    np.testing.assert_array_equal(ts["multih"]["ok"], js["multih"]["ok"])
    ok = js["multih"]["ok"]
    np.testing.assert_array_equal(ts["multih"]["idx"][ok],
                                  js["multih"]["idx"][ok])
    assert ts["multih"]["n_planes"] == js["multih"]["n_planes"]
    # the port's gates hold on it, and BA's tol > 0 run stops early
    assert ts["ba"]["cost"] < ts["ba_cost0"]
    assert ts["ba_tol_stats"]["host_syncs"] == ts["ba_tol_stats"]["steps"]
