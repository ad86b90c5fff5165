"""The port's scale-out (`pislamfusion_tpu_torch.parallel`) on an 8-shard
CPU mesh, against the JAX package's `parallel` on its 8 virtual CPU
devices (tests/test_parallel.py's cases, at their exact shapes).

Four JAX reference calls, each made once a session (`once_per_session`)
on inputs made from a seed with numpy, are held to the port on the same
inputs:

- `dist_ba.optimize_sharded` on test_parallel.py's `_make_problem`:
  poses within 1e-4 (and the reference's bars: cost under 1e-4, the
  truth within 5e-3, the single-device solver within 1e-4);
- `dist_mosaic.feed_frames` (mesh=None in JAX): the port's striped canvas
  gathered equals its own single-device canvas exactly and JAX's within
  the reference's atol 2e-4 / rtol 1e-5 (Laplacian) and 1e-5 (weights);
- `batch.batched_orb_detect` on the reference's TPU path
  (`forced_tpu_path`): each image's level-0 keypoints the same, >= 95 %
  of all its keypoints the same (xy, octave) and >= 99.9 % of their
  descriptor bits equal (see `_assert_image_features_match` for why not
  test_torch_fastvo.py's 98 %), and the batch equal to the port's own
  per-image `orb_detect`;
- `dist_vo.process_survey`, the 8 segments x 3 frames case, plain: n_match
  within 3 a frame, translation within 5e-3 m, quaternion within 1e-4
  (test_torch_fastvo.py's FastVO bars), and the reference's truth and
  PSNR bars.

The sharded RANSACs draw from torch generators, not JAX keys, so they,
the drift-corrected and coarse-anchored surveys and the segmenter are held
to the reference's own bars. `Act=Survey` with `Survey.Mesh=2` on the CPU
is held to tests/test_cli.py's bars.
"""
import ast
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import chip_smoke
from pislamfusion_tpu_torch import convert
from pislamfusion_tpu_torch.core.camera import Camera
from pislamfusion_tpu_torch.models.fastvo import FastVO
from pislamfusion_tpu_torch.ops import ba, ransac
from pislamfusion_tpu_torch.ops import mosaic as M
from pislamfusion_tpu_torch.ops.features import orb as torb
from pislamfusion_tpu_torch.parallel import (batch, dist_ba, dist_mosaic,
                                             dist_ransac, dist_vo, make_mesh)
from pislamfusion_tpu_torch.parallel import mesh as tmesh
from synth_survey import degrade_frame, make_ground, nadir_pose, render_view
from torch_port_reference import (forced_tpu_path,  # noqa: F401
                                  once_per_session, torch_one_thread)

CPU = torch.device("cpu")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _mesh():
    return make_mesh([CPU] * 8)


def _jax_mesh():
    from pislamfusion_tpu.parallel import make_mesh as jmake_mesh
    return jmake_mesh(jax.devices()[:8])


# ------------------------------------------------------------------ mesh
def test_mesh_shape_and_collectives():
    mesh = _mesh()
    assert mesh.devices.size == 8 and mesh.size == 8
    assert mesh.shape == {"dp": 2, "tp": 4}
    assert tmesh.default_mesh_shape(6) == (3, 2)
    assert tmesh.blocks(10, 4) == [(0, 3), (3, 6), (6, 9), (9, 10)]
    vals = [torch.full((2,), float(i)) for i in range(8)]
    for copy in tmesh.psum(vals):
        assert torch.equal(copy, torch.full((2,), 28.0))
    for g in tmesh.all_gather(vals):
        assert torch.equal(g[:, 0], torch.arange(8.0))
    copies = tmesh.replicate(mesh, (vals[3], vals[5]))
    assert len(copies) == 8 and all(torch.equal(c[1], vals[5])
                                    for c in copies)
    parts = tmesh.shard_batch(mesh, torch.arange(4), "dp")
    assert [p.tolist() for p in parts] == [[0, 1], [2, 3]]
    parts = tmesh.shard_batch(mesh, torch.arange(8), None)
    assert [p.tolist() for p in parts] == [[i] for i in range(8)]
    # a shard's work runs under its device: the CUDA device context on a
    # card (here only built, there is no card), nothing on the CPU
    ctx = tmesh.on(torch.device("cuda", 1))
    assert isinstance(ctx, torch.cuda.device) and ctx.idx == 1
    assert not isinstance(tmesh.on(CPU), torch.cuda.device)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            make_mesh()


_WRAPPERS = ("ops/features/flatpyr.py", "ops/features/packedpyr.py",
             "ops/features/fastselect.py", "ops/features/patchgather.py",
             "ops/shearwarp.py", "ops/stencil.py")


@pytest.mark.parametrize("rel", _WRAPPERS)
def test_kernel_launches_run_under_their_tensors_device(rel):
    """Every kernel launch (a ctypes call handed the current stream) sits
    inside `with torch.cuda.device(X.device)` on the same tensor whose
    `current_stream(X.device)` it takes, so a shard on cuda:1 launches on
    cuda:1 whichever device is current."""
    path = os.path.join(REPO, "pislamfusion_tpu_torch", rel)
    tree = ast.parse(open(path).read())
    parents = {}
    for node in ast.walk(tree):
        for child in ast.iter_child_nodes(node):
            parents[child] = node

    def guards(node):
        while node in parents:
            node = parents[node]
            if isinstance(node, ast.With):
                for item in node.items:
                    e = item.context_expr
                    if isinstance(e, ast.Call) and \
                            ast.unparse(e.func) == "torch.cuda.device":
                        yield ast.unparse(e.args[0])

    streams = [n for n in ast.walk(tree) if isinstance(n, ast.Attribute)
               and n.attr == "cuda_stream"]
    assert streams, rel
    for n in streams:
        call = n.value
        assert isinstance(call, ast.Call) and ast.unparse(call.func) == \
            "torch.cuda.current_stream", ast.unparse(n)
        dev = ast.unparse(call.args[0])
        assert dev.endswith(".device") and dev in set(guards(n)), \
            f"{rel}:{n.lineno}: current_stream({dev}) outside " \
            f"torch.cuda.device({dev})"
    # and every call handed that stream is inside the same guard
    for node in ast.walk(tree):
        if isinstance(node, ast.Call) and any(
                isinstance(a, ast.Name) and a.id == "stream"
                for a in node.args):
            assert any(g.endswith(".device") for g in guards(node)), \
                f"{rel}:{node.lineno}: a launch outside its device guard"


# -------------------------------------------------------------------- BA
def _jax_ba():
    from pislamfusion_tpu.ops import ba as jba
    from pislamfusion_tpu.parallel import dist_ba as jdist_ba
    from test_parallel import _make_problem
    prob, T_true, pts_true = _make_problem(np.random.default_rng(0))
    p8, x8, c8 = jdist_ba.optimize_sharded(prob, _jax_mesh(), iters=10)
    return {"problem": {k: np.asarray(v) for k, v in
                        zip(jba.BAProblem._fields, prob)},
            "T_true": T_true, "pts_true": pts_true,
            "poses": np.asarray(p8), "points": np.asarray(x8),
            "cost": float(c8)}


@pytest.fixture(scope="module")
def jax_ba(tmp_path_factory, worker_id):
    return once_per_session("jax_dist_ba", _jax_ba, tmp_path_factory,
                            worker_id)


def test_dist_ba_matches_jax_and_single_device(jax_ba):
    prob = convert.ba_problem_from_numpy(jax_ba["problem"], "cpu")
    p8, x8, c8 = dist_ba.optimize_sharded(prob, _mesh(), iters=10)
    p1, _, _ = ba.optimize(prob, iters=10)
    # both converge to ground truth (the reference's bars)
    assert float(c8) < 1e-4, float(c8)
    np.testing.assert_allclose(p8.numpy(), jax_ba["T_true"], atol=5e-3)
    np.testing.assert_allclose(x8.numpy(), jax_ba["pts_true"], atol=5e-3)
    # ... agree with the single-device solver and with JAX's sharded one
    np.testing.assert_allclose(p8.numpy(), p1.numpy(), atol=1e-4)
    np.testing.assert_allclose(p8.numpy(), jax_ba["poses"], atol=1e-4)
    np.testing.assert_allclose(x8.numpy(), jax_ba["points"], atol=1e-4)


# ------------------------------------------------------------ batch ORB
def _batch_images():
    rng = np.random.default_rng(0)
    B = 4                                  # mesh.shape["dp"] * 2
    imgs = np.zeros((B, 96, 128), np.float32)
    for b in range(B):
        for _ in range(20):
            y, x = rng.integers(10, 70), rng.integers(10, 100)
            imgs[b, y:y + 12, x:x + 16] = rng.uniform(100, 250)
    return imgs


def _jax_batch_orb():
    from pislamfusion_tpu.ops.features.orb import OrbParams
    from pislamfusion_tpu.parallel import batch as jbatch
    with pytest.MonkeyPatch.context() as mp, forced_tpu_path(mp):
        feats = jbatch.batched_orb_detect(
            jnp.asarray(_batch_images()),
            OrbParams(n_features=128, n_levels=3), _jax_mesh())
        return {k: np.asarray(v) for k, v in feats.items()}


@pytest.fixture(scope="module")
def jax_batch_orb(tmp_path_factory, worker_id):
    return once_per_session("jax_batched_orb", _jax_batch_orb,
                            tmp_path_factory, worker_id)


def _assert_image_features_match(ref, got, min_valid):
    """At 96x128 neither K1 nor K7 takes the pyramid: both packages run
    the resize chain, the port in the reference's TPU spelling (f32
    interpolation matrices, test_torch_image.py), JAX on the CPU through
    jax.image.resize, up to 1.3e-3 gray apart on these images. Level 0 is
    the image itself on both sides: its keypoints must be the same set.
    On the flat rectangles of this input that difference flips the rank
    of tied FAST scores on levels 1-2, so over all levels >= 95 % of JAX's
    keypoints (measured 96.6-100 %); >= 99.9 % of the bits of the common
    ones equal."""
    def keyed(d, level=None):
        return {(round(float(x), 3), round(float(y), 3), int(o)): i
                for i, ((x, y), o, v) in enumerate(
                    zip(d["xy"], d["octave"], d["valid"]))
                if v and (level is None or o == level)}
    kr, kg = keyed(ref), keyed(got)
    assert len(kr) > min_valid
    assert set(keyed(ref, 0)) == set(keyed(got, 0))
    common = set(kr) & set(kg)
    assert len(common) >= 0.95 * len(kr)
    ir = [kr[c] for c in common]
    ig = [kg[c] for c in common]
    assert np.mean(got["desc"][ig] == ref["desc"][ir]) >= 0.999


def test_batched_detect_sharded(jax_batch_orb):
    mesh = _mesh()
    imgs = torch.from_numpy(_batch_images())
    B = imgs.shape[0]
    params = torb.OrbParams(n_features=128, n_levels=3)
    feats = batch.batched_orb_detect(imgs, params, mesh)
    assert feats["desc"].shape == (B, 128, 256)
    assert int(feats["valid"].sum(1).min()) > 10
    for b in range(B):
        one = torb.orb_detect(imgs[b], params)
        for k in one:
            assert torch.equal(feats[k][b], one[k]), k
        _assert_image_features_match(
            {k: v[b] for k, v in jax_batch_orb.items()},
            {k: v[b].numpy() for k, v in feats.items()}, 10)
    idx, ok = batch.batched_consecutive_match(feats, "orb", mesh=mesh)
    assert idx.shape == (B, 128)
    i1, o1 = batch.batched_consecutive_match(feats, "orb", wrap=False)
    assert i1.shape == (B - 1, 128)
    assert torch.equal(idx[:B - 1], i1) and torch.equal(ok[:B - 1], o1)
    from pislamfusion_tpu_torch.ops import matching
    i3, o3 = matching.match_descriptors(
        feats["desc"][3], feats["valid"][3], feats["desc"][0],
        feats["valid"][0], "orb", max_dist=80.0)
    assert torch.equal(idx[3], i3) and torch.equal(ok[3], o3)


def test_batched_sift_detect_equals_per_image():
    from pislamfusion_tpu_torch.ops.features import sift as tsift
    imgs = torch.from_numpy(_batch_images()) * 0.8 + 20.0
    params = tsift.SiftParams(n_features=64)
    feats = batch.batched_sift_detect(imgs, params, _mesh())
    for b in range(imgs.shape[0]):
        one = tsift.sift_detect(imgs[b], params)
        for k in one:
            assert torch.equal(feats[k][b], one[k]), k
    assert int(feats["valid"].sum(1).min()) > 5


# ---------------------------------------------------------------- mosaic
BANDS, TILES, PATCH = 3, 8, (512, 512)


def _mosaic_inputs():
    rng = np.random.default_rng(0)
    K = 4
    imgs = rng.uniform(0, 255, (K, 240, 320, 3)).astype(np.float32)
    h_mats, origins = [], []
    for k in range(K):
        s = 0.45 + 0.1 * rng.uniform()
        h_mats.append(np.array([[s, 0.0, 5.0 + k], [0.0, s, 3.0 + k],
                                [1e-5 * k, 0.0, 1.0]], np.float32))
        origins.append([256 * (k % 3), 256 * ((k * 2) % 3)])
    return imgs, np.stack(h_mats), np.asarray(origins, np.int32)


def _jax_feed():
    from pislamfusion_tpu.ops import mosaic as JM
    from pislamfusion_tpu.parallel import dist_mosaic as jdm
    imgs, h_mats, origins = _mosaic_inputs()
    lap0, w0 = JM.alloc_canvas(TILES, TILES, BANDS)
    lap, w = jdm.feed_frames(lap0, w0, imgs, h_mats, origins, BANDS, PATCH,
                             mesh=None)
    return [np.asarray(a) for a in lap], [np.asarray(a) for a in w]


@pytest.fixture(scope="module")
def jax_feed(tmp_path_factory, worker_id):
    return once_per_session("jax_feed_frames", _jax_feed, tmp_path_factory,
                            worker_id)


def test_dist_mosaic_matches_single_device_and_jax(jax_feed):
    """The row-striped canvas over the 8-shard mesh equals the
    single-device canvas bit for bit and JAX's within the reference's
    bars."""
    imgs, h_mats, origins = _mosaic_inputs()
    lap0, w0 = M.alloc_canvas(TILES, TILES, BANDS, CPU)
    single_lap, single_w = dist_mosaic.feed_frames(
        lap0, w0, imgs, h_mats, origins, BANDS, PATCH, mesh=None)
    lap1, w1 = M.alloc_canvas(TILES, TILES, BANDS, CPU)
    shard_lap, shard_w = dist_mosaic.feed_frames(
        lap1, w1, imgs, h_mats, origins, BANDS, PATCH, mesh=_mesh())
    # the result stays distributed between frames: one stripe a shard
    assert all(len(b.parts) == 8 for b in shard_lap + shard_w)
    assert shard_lap[0].parts[1].shape[0] == 256
    lap, w = dist_mosaic.gather_canvas(shard_lap, shard_w)
    for a, b in zip(single_lap + single_w, lap + w):
        assert torch.equal(a, b)
    for a, b in zip(lap, jax_feed[0]):
        np.testing.assert_allclose(a.numpy(), b, atol=2e-4, rtol=1e-5)
    for a, b in zip(w, jax_feed[1]):
        np.testing.assert_allclose(a.numpy(), b, atol=1e-5)


# ---------------------------------------------------------------- RANSAC
def test_dist_ransac_pnp_over_the_mesh():
    """Sharded PnP RANSAC on the reference's 30 %-inlier problem
    (chip_smoke.pnp_problem, as phase 2g runs it), at its bars. At the
    reference's budget, 8 shards x 64 hypotheses, the JAX package finds
    the pose for 6 of 20 keys and the port for 8 of 20 seeds
    (scripts/torch_pnp_rate.py): a 6-point sample is all inliers with p ~
    6e-4, so the reference's PRNGKey(5) passes by its draw. The bars are
    held at 8 x 2048 (1024 DLT samples a shard: a miss ~0.7 %), and at
    8 x 64 the result is the best of the shards' own."""
    T_true, pts, p2n, out = chip_smoke.pnp_problem()
    N = pts.shape[0]
    args = (torch.from_numpy(pts), torch.from_numpy(p2n),
            torch.ones(N, dtype=torch.bool))
    mesh = _mesh()
    r = dist_ransac.find_pnp_sharded(
        torch.Generator().manual_seed(5), *args, mesh=mesh, threshold=0.01,
        iters_per_device=2048)
    assert bool(r.ok)
    inl = r.inliers.numpy()
    assert inl[~out].sum() > 0.8 * (~out).sum()
    assert inl[out].sum() < 0.1 * out.sum()
    err_t = np.linalg.norm(r.model.numpy()[:3] - T_true[:3])
    assert err_t < 0.05, err_t
    r64 = dist_ransac.find_pnp_sharded(
        torch.Generator().manual_seed(5), *args, mesh=mesh, threshold=0.01,
        iters_per_device=64)
    gens = dist_ransac._shard_generators(torch.Generator().manual_seed(5),
                                         mesh)
    own = [ransac.find_pnp(g, *args, threshold=0.01, iters=64)
           for g in gens]
    best = int(np.argmax([float(o.score) if bool(o.ok) else -1.0
                          for o in own]))
    assert float(r64.score) == float(own[best].score)
    assert torch.equal(r64.model, own[best].model)


def test_dist_ransac_homography_over_the_mesh():
    """Sharded homography RANSAC on 50 % outliers: the best of 8 x 32
    hypotheses maps a clean grid like the truth (test_opencv_oracle.py's
    median transfer bar of 1 px) and is no worse than any shard's."""
    rng = np.random.default_rng(4)
    Hgt = np.array([[1.1, 0.08, 12.0], [-0.05, 0.96, -7.0],
                    [1e-4, -8e-5, 1.0]])
    n = 200
    pa = rng.uniform(20, 400, (n, 2))
    q = np.c_[pa, np.ones(n)] @ Hgt.T
    pb = q[:, :2] / q[:, 2:3] + rng.normal(0, 0.5, (n, 2))
    bad = rng.choice(n, n // 2, replace=False)
    pb[bad] = rng.uniform(20, 400, (len(bad), 2))
    args = (torch.from_numpy(pa.astype(np.float32)),
            torch.from_numpy(pb.astype(np.float32)),
            torch.ones(n, dtype=torch.bool))
    mesh = _mesh()
    r = dist_ransac.find_homography_sharded(
        torch.Generator().manual_seed(3), *args, mesh=mesh,
        iters_per_device=32)
    assert bool(r.ok)
    g = np.stack(np.meshgrid(np.linspace(40, 380, 8),
                             np.linspace(40, 380, 8)), -1).reshape(-1, 2)
    gh = np.c_[g, np.ones(len(g))]

    def act(H):
        q = gh @ np.asarray(H, np.float64).T
        return q[:, :2] / q[:, 2:3]
    assert np.median(np.linalg.norm(act(r.model.numpy()) - act(Hgt),
                                    axis=1)) < 1.0
    gens = dist_ransac._shard_generators(torch.Generator().manual_seed(3),
                                         mesh)
    for gen in gens:
        one = ransac.find_homography(gen, *args, iters=32)
        assert float(r.score) >= float(one.score)


# ------------------------------------------------------------- survey VO
CAM = (320, 240, 260.0, 260.0, 160.0, 120.0)


def _geometry(poses):
    lp, _ = M.auto_resolution(Camera(*CAM), 25.0, 0.5)
    es = M.ELE_PIXELS * lp
    flat = np.asarray(poses).reshape(-1, 7)
    min_xy = flat[:, :2].min(0) - 3 * es
    span = flat[:, :2].max(0) - min_xy + 3 * es
    return lp, min_xy, int(np.ceil(span.max() / es)) + 2


def _psnr_vs_ground(img, covered, ground, min_xy, lp):
    ys, xs = np.nonzero(covered)
    gx = np.clip(((min_xy[0] + (xs + 0.5) * lp) / 0.1).astype(int), 0,
                 ground.shape[1] - 1)
    gy = np.clip(((min_xy[1] + (ys + 0.5) * lp) / 0.1).astype(int), 0,
                 ground.shape[0] - 1)
    d = img[ys, xs].astype(np.float64) - ground[gy, gx]
    return 10 * np.log10(255.0 ** 2 / max((d ** 2).mean(), 1e-12))


def _port_vo(poses, warp_mode=""):
    lp, min_xy, tiles = _geometry(poses)
    return FastVO(Camera(*CAM), min_xy, tiles, lp, bands=3, n_features=512,
                  n_levels=4, window_radius=40.0, fast_warp=False,
                  warp_mode=warp_mode, device="cpu")


@pytest.fixture(scope="module")
def survey8():
    """test_dist_vo_segments_match_sequential's scene: 8 segments x 3
    frames, one a shard."""
    from pislamfusion_tpu.core.camera import Camera as JCamera
    srng = np.random.default_rng(9)
    ground = make_ground(srng)
    cam = JCamera(*CAM)
    poses = np.asarray([[nadir_pose(30.0 + 1.5 * k, 36.0 + 2.0 * s, 25.0)
                         for k in range(3)] for s in range(8)])
    frames = np.stack([np.stack([render_view(ground, cam, p) for p in seg])
                       for seg in poses])
    return ground, poses, frames


def _jax_survey(poses, frames):
    """The JAX process_survey of the 8 x 3 case on the reference's TPU
    path (its ORB through K1 and K2 in interpret mode; the gather warp, as
    FastVO's warp_mode "" resolves on the CPU)."""
    from pislamfusion_tpu.core.camera import Camera as JCamera
    from pislamfusion_tpu.models.fastvo import FastVO as JFastVO
    from pislamfusion_tpu.parallel import dist_vo as jdist_vo
    lp, min_xy, tiles = _geometry(poses)
    vo = JFastVO(JCamera(*CAM), min_xy, tiles, lp, bands=3, n_features=512,
                 n_levels=4, window_radius=40.0, fast_warp=False,
                 warp_mode="gather")
    with pytest.MonkeyPatch.context() as mp, forced_tpu_path(mp):
        est, n_match = jdist_vo.process_survey(vo, frames, poses[:, 0],
                                               _jax_mesh())
    return {"poses": np.asarray(est), "n_match": np.asarray(n_match)}


@pytest.fixture(scope="module")
def jax_survey(survey8, tmp_path_factory, worker_id):
    _, poses, frames = survey8
    return once_per_session("jax_dist_vo_8x3",
                            lambda: _jax_survey(poses, frames),
                            tmp_path_factory, worker_id)


def test_dist_vo_segments_match_jax(survey8, jax_survey):
    ground, poses, frames = survey8
    vo = _port_vo(poses)
    est, n_match = dist_vo.process_survey(vo, frames, poses[:, 0], _mesh())
    assert est.shape == (8, 3, 7)
    # against JAX's run on the same frames
    assert np.abs(n_match - jax_survey["n_match"]).max() <= 3
    np.testing.assert_allclose(est[..., :3], jax_survey["poses"][..., :3],
                               atol=5e-3)
    q, qj = est[..., 3:], jax_survey["poses"][..., 3:]
    sign = np.sign(np.sum(q * qj, -1, keepdims=True))
    np.testing.assert_allclose(q * sign, qj, atol=1e-4)
    # the reference's bars against the truth
    assert (n_match[:, 1:] > 50).all(), n_match
    err = np.linalg.norm(est[..., :3] - poses[..., :3], axis=-1)
    assert err.max() < 0.5, err.max()
    img, covered = vo.blended()
    assert covered.sum() > 8000
    lp, min_xy, _ = _geometry(poses)
    psnr = _psnr_vs_ground(img, covered, ground, min_xy, lp)
    assert psnr > 24.0, f"merged mosaic PSNR {psnr:.1f} dB"


def test_dist_vo_drift_correction():
    """The reference's test_dist_vo_drift_correction at its bars: the
    bent boundary poses land on the next anchor, the trajectory gets no
    worse, the merged mosaic reconstructs the ground; 3 segments on 8
    shards (the last shards hold none)."""
    from pislamfusion_tpu.core.camera import Camera as JCamera
    srng = np.random.default_rng(11)
    ground = make_ground(srng)
    cam = JCamera(*CAM)
    N, seg_len, overlap = 10, 4, 1
    stride = seg_len - overlap
    truth = np.asarray([nadir_pose(30.0 + 1.4 * k, 38.0, 25.0)
                        for k in range(N)])
    frames = np.stack([
        degrade_frame(render_view(ground, cam, p), srng,
                      blur_px=1.2, noise=2.5) for p in truth])
    segs, firsts = dist_vo.segments_from_frames(frames, seg_len,
                                                overlap=overlap)
    anchors = truth[firsts]
    S = segs.shape[0]
    assert S == 3 and firsts[1] - firsts[0] == stride
    lp, min_xy, _ = _geometry(truth)
    mesh = _mesh()
    vo = _port_vo(truth)
    est_u, nm_u = dist_vo.process_survey(vo, segs, anchors, mesh)
    img_u, cov_u = vo.blended()
    est_c, nm_c = dist_vo.process_survey(vo, segs, anchors, mesh,
                                         correct_drift=True,
                                         anchor_stride=stride)
    img_c, cov_c = vo.blended()
    assert (nm_c[:, 1:] > 50).all(), nm_c
    assert np.array_equal(nm_u, nm_c)
    for s in range(S - 1):
        dp = np.linalg.norm(est_c[s, stride, :3] - anchors[s + 1, :3])
        dq = abs(float(np.dot(est_c[s, stride, 3:], anchors[s + 1, 3:])))
        assert dp < 1e-3, (s, dp)
        assert dq > 1.0 - 1e-5, (s, dq)
    drift_u = max(np.linalg.norm(est_u[s, stride, :3] - anchors[s + 1, :3])
                  for s in range(S - 1))
    assert drift_u > 1e-3, drift_u

    def ate(est):
        err = [np.linalg.norm(est[s, k, :3] - truth[firsts[s] + k, :3])
               for s in range(S) for k in range(seg_len)
               if firsts[s] + k < N]
        return np.mean(err), np.max(err)
    mean_u, max_u = ate(est_u)
    mean_c, max_c = ate(est_c)
    assert mean_c <= mean_u + 1e-4, (mean_c, mean_u)
    assert max_c <= max_u + 1e-4, (max_c, max_u)
    assert cov_c.sum() > 0.9 * cov_u.sum()
    psnr = _psnr_vs_ground(img_c, cov_c, ground, min_xy, lp)
    assert psnr > 22.0, f"corrected merged mosaic PSNR {psnr:.1f} dB"
    with pytest.raises(ValueError):
        dist_vo.process_survey(vo, segs, anchors, mesh, correct_drift=True)


def test_dist_vo_coarse_pass_anchors():
    """The reference's test_dist_vo_coarse_pass_anchors at its bars: a
    2x-pooled serial track-only pass gives the anchors, the full-res
    drift-corrected segments land on them."""
    from pislamfusion_tpu.core.camera import Camera as JCamera
    srng = np.random.default_rng(13)
    ground = make_ground(srng)
    cam = JCamera(*CAM)
    N, seg_len, overlap = 10, 4, 1
    stride = seg_len - overlap
    truth = np.asarray([nadir_pose(30.0 + 1.4 * k, 44.0, 25.0)
                        for k in range(N)])
    frames = np.stack([render_view(ground, cam, p) for p in truth])
    segs, firsts = dist_vo.segments_from_frames(frames, seg_len,
                                                overlap=overlap)
    lp, min_xy, _ = _geometry(truth)
    vo = _port_vo(truth)
    anchors, nm_coarse = dist_vo.anchors_from_coarse(
        vo, frames, firsts, truth[0], scale=2, n_features=384)
    assert anchors.shape == (segs.shape[0], 7)
    assert (nm_coarse[1:] > 40).all(), nm_coarse
    coarse_err = np.linalg.norm(anchors[:, :3] - truth[firsts, :3], axis=1)
    assert coarse_err.max() < 1.0, coarse_err
    est, nm = dist_vo.process_survey(vo, segs, anchors, _mesh(),
                                     correct_drift=True,
                                     anchor_stride=stride)
    assert (nm[:, 1:] > 50).all()
    S = segs.shape[0]
    for s in range(S - 1):
        dp = np.linalg.norm(est[s, stride, :3] - anchors[s + 1, :3])
        assert dp < 1e-3, (s, dp)
    err = [np.linalg.norm(est[s, k, :3] - truth[firsts[s] + k, :3])
           for s in range(S) for k in range(seg_len)
           if firsts[s] + k < N]
    assert max(err) < coarse_err.max() + 0.3, (max(err), coarse_err.max())
    img, covered = vo.blended()
    assert covered.sum() > 5000
    psnr = _psnr_vs_ground(img, covered, ground, min_xy, lp)
    assert psnr > 14.0, f"coarse-anchored mosaic PSNR {psnr:.1f} dB"


def test_anchors_from_gps_and_segmenter():
    from types import SimpleNamespace
    frames = np.arange(10 * 4 * 6).reshape(10, 4, 6).astype(np.float32)
    segs, firsts = dist_vo.segments_from_frames(frames, seg_len=4,
                                                overlap=1)
    assert segs.shape[1] == 4
    assert (segs[1][0] == frames[firsts[1]]).all()
    assert firsts[1] - firsts[0] == 3
    assert (segs[-1][-1] == frames[-1]).all() or \
        (segs[-1][-1] == segs[-1][-2]).all()
    metas = [SimpleNamespace(gps_enu=np.array([10.0 * s, 5.0, 30.0]),
                             pyr=None) for s in range(segs.shape[0])]
    anchors = dist_vo.anchors_from_gps(metas)
    assert anchors.shape == (segs.shape[0], 7)
    assert np.allclose(anchors[:, 3:], [1, 0, 0, 0])
    assert np.allclose(anchors[2, :3], [20.0, 5.0, 30.0])
    plane = np.array([1.0, 2.0, 0.0, 0, 0, 0, 1.0])
    a2 = dist_vo.anchors_from_gps(metas, plane)
    assert np.allclose(a2[0, :3], anchors[0, :3] - [1.0, 2.0, 0.0])


# ------------------------------------------------------------------- app
def test_survey_act_over_a_cpu_mesh(tmp_path, capsys):
    """`Act=Survey Survey.Mesh=2 Device=cpu`: test_cli.py's survey at its
    bars, through the segment-parallel engine (GPS anchors, drift
    corrected) on two shards of the CPU."""
    from pislamfusion_tpu_torch import app
    from pislamfusion_tpu_torch.core.svar import Svar
    from pislamfusion_tpu_torch.io.dataset import imread
    from test_cli import _write_dataset
    ds_file, poses, _ = _write_dataset(str(tmp_path / "ds"),
                                       np.random.default_rng(11))
    out = str(tmp_path / "out")
    rc = app.main(["Act=Survey", ds_file, f"Out.Dir={out}",
                   "Survey.Height=25", "Survey.NFeature=512",
                   f"GeoTiles.Dir={os.path.join(out, 'tiles')}",
                   "Survey.Mesh=2", "Device=cpu", "StackTrace=0"],
                  cfg=Svar())
    assert rc == 0
    said = capsys.readouterr().out
    assert "segments x 13 over 2 devices, drift-corrected" in said, said
    assert os.path.isfile(os.path.join(out, "result.png"))
    traj = np.loadtxt(os.path.join(out, "trajectory.txt"))
    assert traj.shape[0] == len(poses)
    assert [f for _, _, fs in os.walk(os.path.join(out, "tiles"))
            for f in fs if f.endswith(".png")], "geo tiles missing"
    err = traj[:, 1:3] - poses[:, :2]
    err = err - err.mean(0)
    ate = float(np.sqrt(np.mean(np.sum(err ** 2, -1))))
    assert ate < 2.0, f"survey ATE {ate:.2f} m"
    img = imread(os.path.join(out, "result.png"))
    assert (img != 255).any(-1).sum() > 3000
