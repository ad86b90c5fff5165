"""The external oracles, against the port: tests/test_golden_reference.py's
fixtures emitted by the reference system's own code and
tests/test_opencv_oracle.py's OpenCV cross-checks, with the same
parametrisations and bars, through the port's modules on the CPU.

- Golden (tests/data/golden): the MapHash checkpoint written by the
  reference's compiler (parsed, rewritten losslessly, loaded into the
  port's WorldMap), the two .gbow vocabularies trained and saved by the
  reference (word ids, TF-IDF BowVectors, FeatureVectors and descriptor
  distances of its LCG queries; re-saved and re-loaded), and its header
  math table (lie, host SE3, camera models, GPS).
- OpenCV (`cv2` through `pytest.importorskip`): the port's RANSACs
  (homography, fundamental, PnP; their draws from torch generators
  seeded as the reference's keys are) against cv2's estimators by
  action, the shear warp's plain version (K3) against
  cv2.warpPerspective, pyrDown/pyrUp, the Gaussian blur and the
  Laplacian pyramid against cv2's, and `orb_detect` against cv2.ORB.
"""
import os

import numpy as np
import pytest
import torch

from pislamfusion_tpu_torch.io import maphash
from pislamfusion_tpu_torch.ops import image as im
from pislamfusion_tpu_torch.ops import ransac as R
from pislamfusion_tpu_torch.ops.vocabulary import Vocabulary
from torch_port_reference import torch_one_thread  # noqa: F401

GOLDEN = os.path.join(os.path.dirname(__file__), "data", "golden")


def _lcg_stream(seed):
    """The golden writer's 31-bit LCG (native/golden_writer.cpp)."""
    s = [seed]

    def nxt():
        s[0] = (1103515245 * s[0] + 12345) & 0x7FFFFFFF
        return s[0]
    return nxt


def _orb_descs(nxt, n):
    return np.array([[(nxt() >> 16) & 0xFF for _ in range(32)]
                     for _ in range(n)], np.uint8)


def _sift_descs(nxt, n):
    return np.array([[(nxt() % 1000) / 250.0 for _ in range(128)]
                     for _ in range(n)], np.float32)


def _expect(stem):
    out = {}
    with open(os.path.join(GOLDEN, stem + "_expect.txt")) as fh:
        for line in fh:
            parts = line.split()
            out.setdefault(parts[0], []).append(parts[1:])
    return out


# ------------------------------------------------------------- golden map
def test_reference_maphash_parses():
    from pislamfusion_tpu_torch.ops import lie
    with open(os.path.join(GOLDEN, "ref_map.maphash"), "rb") as fh:
        data = maphash.loads(fh.read())
    assert len(data.points) == 3 and len(data.frames) == 2
    p7, p8, p9 = data.points
    assert (p7.id, p7.ref_frame) == (7, 4)
    np.testing.assert_allclose(p7.position, [1.5, -2.0, 30.0])
    np.testing.assert_array_equal(p8.color, [200, 100, 50])
    np.testing.assert_allclose(p9.normal, [0, 0.28, -0.96])
    f4, f5 = data.frames
    assert (f4.id, f4.timestamp, f4.image_channels) == (4, 123.25, 3)
    assert f4.image_path == "img/000004.jpg"
    assert f4.camera_params == [1920, 1080, 1200, 1200, 960, 540]
    assert f4.gps_data[:3] == [116.3, 39.9, 50.0]
    assert f4.pose_qtxyzw_t_s[7] == 1.25
    np.testing.assert_allclose(f4.pose_qtxyzw_t_s[4:7], [10, 20, 120])
    # the quaternion is the reference's SO3::exp([0.02,-0.01,0.3])
    q = lie.so3_exp(torch.tensor([0.02, -0.01, 0.3],
                                 dtype=torch.float64)).numpy()
    np.testing.assert_allclose(f4.pose_qtxyzw_t_s[:4], q, atol=1e-12)
    np.testing.assert_allclose(f4.keypoints["x"], [100, 300, 640.5])
    np.testing.assert_allclose(f4.keypoints["angle"], [90, -1, 12.5])
    np.testing.assert_array_equal(f4.keypoints["octave"], [0, 1, 2])
    np.testing.assert_array_equal(f4.colors, [[1, 2, 3], [4, 5, 6],
                                              [7, 8, 9]])
    assert f4.observations == [(7, 0), (8, 2)]
    assert f4.children == [(5, 42)] and f4.parents == []
    assert f5.image_channels == 1 and len(f5.gps_data) == 14
    assert f5.pose_qtxyzw_t_s[7] == 1.0
    assert f5.observations == [(9, 0)]
    assert f5.children == [] and f5.parents == [(4, 42)]


def test_reference_maphash_rewrite_roundtrip():
    with open(os.path.join(GOLDEN, "ref_map.maphash"), "rb") as fh:
        raw = fh.read()
    d1 = maphash.loads(raw)
    b1 = maphash.dumps(d1)
    assert len(b1) == len(raw)
    d2 = maphash.loads(b1)
    assert maphash.dumps(d2) == b1
    assert d2.frames[0].observations == d1.frames[0].observations
    np.testing.assert_allclose(d2.frames[0].pose_qtxyzw_t_s,
                               d1.frames[0].pose_qtxyzw_t_s)


def test_reference_maphash_loads_into_worldmap():
    from pislamfusion_tpu_torch.models.worldmap import WorldMap
    wm = WorldMap()
    assert wm.load(os.path.join(GOLDEN, "ref_map.maphash"))
    assert wm.frame_num() == 2 and wm.point_num() == 3
    f4 = wm.frame(4)
    assert f4 is not None and f4.timestamp == 123.25
    assert wm.point(8).observations.get(4) == 2
    assert f4.connections.get(5) == 42


# ----------------------------------------------------------- golden vocab
@pytest.mark.parametrize("stem,seed,gen", [
    ("ref_vocab_orb", 12345, _orb_descs),
    ("ref_vocab_sift", 999331, _sift_descs),
])
def test_reference_gbow_transform_parity(stem, seed, gen):
    voc = Vocabulary.load(os.path.join(GOLDEN, stem + ".gbow"))
    assert voc is not None
    exp = _expect(stem)
    assert voc.size() == int(exp["words"][0][0])
    nxt = _lcg_stream(seed)
    for _ in range(8):           # skip the training draws
        gen(nxt, 10)
    q1, q2 = gen(nxt, 8), gen(nxt, 8)
    wid, _, _ = voc.transform_arrays(q1)
    assert [int(x) for x in np.asarray(wid)] \
        == [int(r[1]) for r in exp["wid1"]]
    for q, key in ((q1, "bow1"), (q2, "bow2")):
        bow, _ = voc.transform(q, levelsup=1)
        ref = {int(r[0]): float(r[1]) for r in exp[key]}
        assert set(bow) == set(ref)
        for k in bow:
            # f32 node weights in the .gbow against the reference's
            # in-memory doubles: agree to f32 resolution
            assert bow[k] == pytest.approx(ref[k], rel=3e-7, abs=3e-7)
    _, fv = voc.transform(q1, levelsup=1)
    ref_fv = {int(r[0]): [int(x) for x in r[1:]] for r in exp["fv1"]}
    assert fv == ref_fv
    for r in exp["dist"]:
        i, dref = int(r[0]), float(r[1])
        assert float(Vocabulary.distance(q1[i], q2[i])) == \
            pytest.approx(dref, rel=1e-6)


def test_reference_gbow_resave_reloads(tmp_path):
    voc = Vocabulary.load(os.path.join(GOLDEN, "ref_vocab_orb.gbow"))
    p = str(tmp_path / "re.gbow")
    assert voc.save(p)
    v2 = Vocabulary.load(p)
    assert v2.size() == voc.size()
    np.testing.assert_array_equal(v2.node_desc, voc.node_desc)
    np.testing.assert_allclose(v2.node_weight, voc.node_weight)


def test_reference_math_table():
    """ref_math_expect.txt, computed by the reference's own header math:
    the port's lie (f64 tensors here), host SE3, camera models and GPS."""
    from pislamfusion_tpu_torch.core import gps as G
    from pislamfusion_tpu_torch.core.camera import Camera
    from pislamfusion_tpu_torch.ops import lie
    from pislamfusion_tpu_torch.utils import host_se3 as hse3
    exp = _expect("ref_math")

    def t64(v):
        return torch.tensor(v, dtype=torch.float64)
    ws = {0: [0.02, -0.01, 0.3], 1: [1.2, -0.7, 0.4],
          2: [0, 0, 0], 3: [-2.9, 0.1, 0.05]}
    for row in exp["so3exp"]:
        q = lie.so3_exp(t64(ws[int(row[0])])).numpy()
        np.testing.assert_allclose(q, [float(v) for v in row[1:]],
                                   atol=5e-7)
    for row in exp["so3ln"]:
        i = int(row[0])
        qref = [float(v) for v in exp["so3exp"][i][1:]]
        w = lie.so3_log(t64(qref)).numpy()
        np.testing.assert_allclose(w, [float(v) for v in row[1:]],
                                   atol=5e-6)

    def _quat_f64(w):
        w = np.asarray(w, np.float64)
        th = np.linalg.norm(w)
        ax = w / th
        return np.concatenate([ax * np.sin(th / 2), [np.cos(th / 2)]])
    A = np.concatenate([[1.0, -2.0, 3.0], _quat_f64([0.1, 0.2, -0.3])])
    B = np.concatenate([[0.5, 4.0, -1.5], _quat_f64([-0.5, 0.05, 0.6])])
    C = hse3.se3_mul(A, B)
    ref = [float(v) for v in exp["se3mul"][0]]
    np.testing.assert_allclose(C[:3], ref[:3], atol=1e-12)
    np.testing.assert_allclose(np.abs(C[3:]), np.abs(ref[3:]), atol=1e-12)
    Ai = hse3.se3_inv(A)
    ref = [float(v) for v in exp["se3inv"][0]]
    np.testing.assert_allclose(Ai[:3], ref[:3], atol=1e-12)
    pw = np.asarray([2.5, -1.25, 7.0])
    np.testing.assert_allclose(
        hse3.se3_apply(A, pw), [float(v) for v in exp["se3apply"][0]],
        atol=1e-12)
    S = np.concatenate([A, [1.75]])
    np.testing.assert_allclose(
        lie.sim3_apply(t64(S), t64(pw)).numpy().reshape(-1),
        [float(v) for v in exp["sim3apply"][0]], atol=1e-6)
    p3 = np.asarray([0.35, -0.2, 2.0])
    uv_probe = np.asarray([100.5, 700.25])
    for key, params in (
            ("pinhole", [1920, 1080, 1200, 1210, 955, 545]),
            ("atan", [1920, 1080, 1200, 1210, 955, 545, 0.85]),
            ("opencv", [1920, 1080, 1200, 1210, 955, 545,
                        0.1, -0.05, 0.001, -0.002, 0.02])):
        row = exp[key][0]
        cam = Camera.from_parameters(params)
        uv = np.asarray(cam.project(p3), np.float64).reshape(-1)
        np.testing.assert_allclose(uv, [float(v) for v in row[1:3]],
                                   rtol=1e-5, atol=1e-4)
        ray = np.asarray(cam.unproject(uv_probe), np.float64).reshape(-1)
        np.testing.assert_allclose(ray[:2], [float(v) for v in row[3:5]],
                                   rtol=1e-4, atol=1e-5)
    ecef = G.lla_to_ecef(116.30, 39.90, 50.0)
    np.testing.assert_allclose(np.asarray(ecef).reshape(-1),
                               [float(v) for v in exp["gps2xyz"][0]],
                               rtol=1e-12)
    lla = np.asarray(G.ecef_to_lla(np.asarray(ecef))).reshape(-1)
    ref = [float(v) for v in exp["xyz2gps"][0]]     # (lat, lon, alt)
    np.testing.assert_allclose([lla[1], lla[0]], ref[:2], atol=1e-9)
    assert abs(lla[2] - ref[2]) < 1e-4


# ----------------------------------------------------------------- OpenCV
def _cv2():
    return pytest.importorskip("cv2")


def _aerial(n=512, gray=False):
    from PIL import Image
    p = os.path.join(os.path.dirname(__file__), "data", "aerial_npu.png")
    a = np.asarray(Image.open(p).convert("RGB"), np.float32)
    a = np.concatenate([a, a[:, ::-1]], 1)
    a = np.concatenate([a, a[::-1]], 0)
    img = Image.fromarray(a.astype(np.uint8)).resize((n, n), Image.LANCZOS)
    a = np.asarray(img, np.float32)
    if gray:
        a = a @ np.array([0.299, 0.587, 0.114], np.float32)
    return a


def _psnr(a, b, peak=255.0):
    mse = float(np.mean((np.asarray(a, np.float64)
                         - np.asarray(b, np.float64)) ** 2))
    return 99.0 if mse == 0 else 10.0 * np.log10(peak * peak / mse)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _noisy_correspondences(rng, H, n=200, outlier_frac=0.3, span=400.0):
    pa = rng.uniform(20, span, (n, 2)).astype(np.float64)
    q = (np.c_[pa, np.ones(n)] @ H.T)
    pb = q[:, :2] / q[:, 2:3]
    pb += rng.normal(0, 0.5, pb.shape)
    n_out = int(outlier_frac * n)
    out_idx = rng.choice(n, n_out, replace=False)
    pb[out_idx] = rng.uniform(20, span, (n_out, 2))
    return pa.astype(np.float32), pb.astype(np.float32), out_idx


@pytest.mark.parametrize("seed,outlier_frac", [
    (0, 0.3), (1, 0.3), (2, 0.3), (3, 0.1), (4, 0.5), (5, 0.6),
])
def test_homography_vs_cv2(seed, outlier_frac):
    cv2 = _cv2()
    rng = np.random.default_rng(seed)
    Hgt = np.array([[1.1, 0.08, 12.0], [-0.05, 0.96, -7.0],
                    [1e-4, -8e-5, 1.0]])
    pa, pb, _ = _noisy_correspondences(rng, Hgt, outlier_frac=outlier_frac)
    ours = R.find_homography(torch.Generator().manual_seed(seed), _t(pa),
                             _t(pb), torch.ones(len(pa), dtype=torch.bool),
                             threshold=3.0, iters=256)
    Hcv, mask = cv2.findHomography(pa, pb, cv2.RANSAC, 3.0)
    assert bool(ours.ok) and Hcv is not None
    g = np.stack(np.meshgrid(np.linspace(40, 380, 8),
                             np.linspace(40, 380, 8)), -1).reshape(-1, 2)
    gh = np.c_[g, np.ones(len(g))]

    def act(H):
        q = gh @ np.asarray(H, np.float64).T
        return q[:, :2] / q[:, 2:3]
    ref = act(Hgt)
    err_ours = np.linalg.norm(act(ours.model.numpy()) - ref, axis=1)
    err_cv = np.linalg.norm(act(Hcv) - ref, axis=1)
    assert np.median(err_ours) < 1.0
    assert np.median(err_ours) < np.median(err_cv) + 1.0
    assert float(ours.score) >= 0.95 * float(mask.sum())


@pytest.mark.parametrize("seed", [3, 4])
def test_fundamental_vs_cv2(seed):
    cv2 = _cv2()
    rng = np.random.default_rng(seed)
    n = 250
    P = np.c_[rng.uniform(-2, 2, (n, 2)), rng.uniform(4, 10, n)]
    Rrot = cv2.Rodrigues(np.array([0.02, -0.25, 0.01]))[0]
    t = np.array([0.8, 0.05, 0.1])
    K = np.array([[400.0, 0, 256], [0, 400.0, 256], [0, 0, 1]])
    pa = (P / P[:, 2:3]) @ K.T
    Q = P @ Rrot.T + t
    pb = (Q / Q[:, 2:3]) @ K.T
    pa, pb = pa[:, :2], pb[:, :2]
    pb += rng.normal(0, 0.4, pb.shape)
    out_idx = rng.choice(n, n // 4, replace=False)
    pb[out_idx] = rng.uniform(0, 512, (len(out_idx), 2))
    pa32, pb32 = pa.astype(np.float32), pb.astype(np.float32)
    ours = R.find_fundamental(torch.Generator().manual_seed(seed),
                              _t(pa32), _t(pb32),
                              torch.ones(n, dtype=torch.bool),
                              threshold=2.0, iters=384)
    Fcv, mask = cv2.findFundamentalMat(pa32, pb32, cv2.FM_RANSAC, 2.0,
                                       0.999)
    assert bool(ours.ok) and Fcv is not None
    clean = np.ones(n, bool)
    clean[out_idx] = False

    def sampson(F):
        F = np.asarray(F, np.float64)
        x1 = np.c_[pa[clean], np.ones(clean.sum())]
        x2 = np.c_[pb[clean], np.ones(clean.sum())]
        Fx1 = x1 @ F.T
        Ftx2 = x2 @ F
        num = np.sum(x2 * (x1 @ F.T), 1) ** 2
        den = Fx1[:, 0] ** 2 + Fx1[:, 1] ** 2 \
            + Ftx2[:, 0] ** 2 + Ftx2[:, 1] ** 2
        return np.sqrt(num / den)
    assert np.median(sampson(ours.model.numpy())) < 1.0
    assert np.median(sampson(ours.model.numpy())) \
        < np.median(sampson(Fcv[:3])) + 1.0
    assert float(ours.score) >= 0.9 * float(mask.sum())


@pytest.mark.parametrize("seed", [5, 6])
def test_pnp_vs_cv2(seed):
    cv2 = _cv2()
    from pislamfusion_tpu_torch.utils import host_se3 as hse3
    rng = np.random.default_rng(seed)
    n = 160
    p3d = np.c_[rng.uniform(-3, 3, (n, 2)), rng.uniform(5, 12, n)]
    rvec_gt = np.array([0.05, -0.3, 0.08])
    tvec_gt = np.array([0.4, -0.2, 0.6])
    Rm = cv2.Rodrigues(rvec_gt)[0]
    Pc = p3d @ Rm.T + tvec_gt
    p2n = (Pc[:, :2] / Pc[:, 2:3])
    p2n += rng.normal(0, 0.0012, p2n.shape)
    out_idx = rng.choice(n, n // 5, replace=False)
    p2n[out_idx] += rng.uniform(0.05, 0.3, (len(out_idx), 2))
    ours = R.find_pnp(torch.Generator().manual_seed(seed),
                      _t(p3d.astype(np.float32)), _t(p2n.astype(np.float32)),
                      torch.ones(n, dtype=torch.bool), threshold=0.01,
                      iters=256)
    okcv, rvec, tvec, inl = cv2.solvePnPRansac(
        p3d.astype(np.float32), p2n.astype(np.float32), np.eye(3),
        None, reprojectionError=0.01 * 1.0, iterationsCount=200,
        flags=cv2.SOLVEPNP_ITERATIVE)
    assert bool(ours.ok) and okcv
    T = ours.model.numpy().astype(np.float64)
    R_ours = hse3.quat_to_matrix(T[3:7])
    ang_ours = np.degrees(np.arccos(np.clip(
        (np.trace(R_ours @ Rm.T) - 1) / 2, -1, 1)))
    ang_cv = np.degrees(np.arccos(np.clip(
        (np.trace(cv2.Rodrigues(rvec)[0] @ Rm.T) - 1) / 2, -1, 1)))
    assert ang_ours < 0.5 and np.linalg.norm(T[:3] - tvec_gt) < 0.05
    assert ang_ours < ang_cv + 0.5


@pytest.mark.parametrize("pers,tile,min_psnr", [
    (0.0, 256, 55.0),    # affine: the shear decomposition is exact
    (5e-5, 64, 45.0),    # projective: per-tile affine fit, 64-px tiles
])
def test_warp_perspective_vs_cv2(pers, tile, min_psnr):
    """The shear warp's plain version (K3's function) against
    cv2.warpPerspective(INTER_LINEAR) in the interior of the source."""
    cv2 = _cv2()
    from pislamfusion_tpu_torch.ops import shearwarp as SW
    img = _aerial(512)
    Hm = np.array([[0.9, 0.12, 30.0], [-0.08, 1.05, 10.0],
                   [pers, -0.8 * pers, 1.0]], np.float64)
    ph = pw = 256
    patch, live, fit_err = SW.warp_patch_plain(
        _t(img), _t(Hm.astype(np.float32)), (ph, pw), tile=tile)
    assert float(fit_err) <= 0.1 and bool(live.all())
    ref = cv2.warpPerspective(img, Hm, (pw, ph),
                              flags=cv2.INTER_LINEAR | cv2.WARP_INVERSE_MAP)
    got = patch.numpy()
    sl = (slice(8, -8), slice(8, -8))
    q = np.stack(np.meshgrid(np.arange(pw), np.arange(ph)), -1)
    qh = np.concatenate([q, np.ones((ph, pw, 1))], -1) @ Hm.T
    src = qh[..., :2] / qh[..., 2:3]
    inside = ((src[..., 0] > 2) & (src[..., 0] < 509)
              & (src[..., 1] > 2) & (src[..., 1] < 509))[sl]
    d = (got[sl] - ref[sl])[inside]
    p = _psnr(d, np.zeros_like(d))
    assert p > min_psnr, p


def test_pyr_down_up_vs_cv2():
    cv2 = _cv2()
    img = _aerial(512)
    ours_d = im.pyr_down(_t(img)).numpy()
    ref_d = cv2.pyrDown(img)
    assert ours_d.shape == ref_d.shape
    assert _psnr(ours_d[2:-2, 2:-2], ref_d[2:-2, 2:-2]) > 48.0
    ours_u = im.pyr_up(_t(ref_d)).numpy()
    ref_u = cv2.pyrUp(ref_d)
    assert ours_u.shape == ref_u.shape
    assert _psnr(ours_u[2:-2, 2:-2], ref_u[2:-2, 2:-2]) > 48.0


def test_gaussian_blur_vs_cv2():
    cv2 = _cv2()
    img = _aerial(512, gray=True)
    sigma = 2.0
    r = int(np.ceil(3 * sigma))
    ours = im.gaussian_blur(_t(img)[..., None], sigma)[..., 0].numpy()
    ref = cv2.GaussianBlur(img, (2 * r + 1, 2 * r + 1), sigma,
                           borderType=cv2.BORDER_REFLECT_101)
    assert _psnr(ours[r:-r, r:-r], ref[r:-r, r:-r]) > 50.0


def test_laplacian_pyramid_vs_cv2():
    cv2 = _cv2()
    img = _aerial(512)
    bands = 4
    lap_ours = im.build_laplacian_pyramid(_t(img), bands)
    g = [img]
    for _ in range(bands):
        g.append(cv2.pyrDown(g[-1]))
    lap_cv = [g[i] - cv2.pyrUp(g[i + 1],
                               dstsize=(g[i].shape[1], g[i].shape[0]))
              for i in range(bands)] + [g[bands]]
    for i, (a, b) in enumerate(zip(lap_ours, lap_cv)):
        a = a.numpy()
        assert a.shape == b.shape
        c = 2 + bands - i
        assert _psnr(a[c:-c, c:-c], b[c:-c, c:-c]) > 40.0, i
    rec = im.restore_from_laplacian([_t(x) for x in lap_cv]).numpy()
    assert _psnr(rec[4:-4, 4:-4], img[4:-4, 4:-4]) > 45.0


def test_orb_descriptors_vs_cv2():
    cv2 = _cv2()
    from pislamfusion_tpu_torch.ops.features import orb as O
    img = _aerial(768, gray=True)
    det = O.orb_detect(_t(img), O.OrbParams(n_features=800))
    ours_xy = det["xy"].numpy()
    ours_oct = det["octave"].numpy()
    ours_valid = det["valid"].numpy()
    ours_desc = O.pack_bits(det["desc"]).numpy()
    orb = cv2.ORB_create(nfeatures=800, scaleFactor=1.2, nlevels=8,
                         fastThreshold=20)
    kps, desc_cv = orb.detectAndCompute(img.astype(np.uint8), None)
    assert len(kps) > 100
    cv_xy = np.array([k.pt for k in kps], np.float32)
    cv_oct = np.array([k.octave for k in kps])
    sel_cv = cv_oct == 0
    sel_us = (ours_oct == 0) & ours_valid
    a = ours_xy[sel_us]
    b = cv_xy[sel_cv]
    d = np.linalg.norm(a[:, None] - b[None, :], axis=-1)
    i, j = np.nonzero(d <= 1.5)
    best = {}
    for ii, jj in zip(i, j):
        if ii not in best or d[ii, jj] < d[ii, best[ii]]:
            best[ii] = jj
    assert len(best) >= 50, f"only {len(best)} shared keypoints"
    da = ours_desc[sel_us][list(best.keys())]
    db = desc_cv[sel_cv][list(best.values())]
    ham = np.unpackbits(da ^ db, axis=1).sum(1)
    med = float(np.median(ham))
    assert med <= 48.0, med
    assert float(np.percentile(ham, 90)) <= 96.0
