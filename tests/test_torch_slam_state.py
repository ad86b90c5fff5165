"""SLAM state of the PyTorch port held to the JAX package on the CPU:
`models/frame.py`, `models/worldmap.py`, `io/maphash.py`,
`ops/vocabulary.py` (with the embedded ORB and SIFT vocabularies) and
`models/matchers.py`.

The maps come from ONE short run of the JAX package's SLAM over frames 0-3
of tests/test_slam.py's survey (`torch_port_reference.jax_slam_capture`,
once a session), read through `convert.worldmap_to_numpy`.

Tolerances:
- Frame packing, the world map's bookkeeping, checkpoints and exports:
  equal (the packed float32 buffer holds every feature value exactly).
- `.maphash`: the JAX package's file loads in the port with equal frames,
  poses, points and observations, and the port's save of the same map is
  byte-equal to the JAX package's.
- The vocabulary: equal words, weights and node ids, equal BoW vectors to
  1e-6 and equal scores to 1e-6 (float64 sums of float32 weights).
- The matchers: equal match masks and indices on frames 0 and 3 of the run;
  the ones that draw RANSAC samples are fed the JAX package's draws.
- The loop detectors (BoW and distance): equal candidates in equal order.
- SLAM's undistortion of the mosaic feed (an ATAN camera): within 2e-3
  gray.
"""
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pislamfusion_tpu.core.camera import Camera as JCamera
from pislamfusion_tpu.models import frame as jframe
from pislamfusion_tpu.models import worldmap as jworldmap
from pislamfusion_tpu_torch import convert
from pislamfusion_tpu_torch.core.camera import Camera
from pislamfusion_tpu_torch.models import frame as tframe
from pislamfusion_tpu_torch.models import worldmap as tworldmap
from torch_port_reference import (jax_slam_capture, once_per_session,
                                  torch_one_thread)  # noqa: F401


@pytest.fixture(scope="module")
def capture(tmp_path_factory, worker_id):
    return once_per_session("torch_slam_capture", jax_slam_capture,
                            tmp_path_factory, worker_id)


def _feats(rng, n, kind):
    desc = (rng.integers(0, 2, (n, 256)).astype(np.uint8) if kind == "orb"
            else rng.normal(0, 0.2, (n, 128)).astype(np.float32))
    return {"xy": rng.uniform(0, 64, (n, 2)).astype(np.float32),
            "desc": desc,
            "angle": rng.uniform(-np.pi, np.pi, n).astype(np.float32),
            "octave": rng.integers(0, 8, n).astype(np.int32),
            "response": rng.uniform(0, 1e3, n).astype(np.float32),
            "valid": rng.integers(0, 2, n).astype(bool)}


# ---------------------------------------------------------------------------
# Frame and WorldMap
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["orb", "sift"])
def test_frame_device_features_pack_exactly(kind):
    """tests/test_frame.py's case: the packed single copy reproduces every
    feature array exactly, in both packages, through set_features_device,
    dispatch_pack / install_packed and release_device_features."""
    feats = _feats(np.random.default_rng(2), 100, kind)
    cam = (64, 48, 50.0, 50.0, 32.0, 24.0)
    tf = tframe.Frame(id=0, timestamp=0.0, camera=Camera(*cam))
    jf = jframe.Frame(id=0, timestamp=0.0, camera=JCamera(*cam))
    tf.set_features_device({k: torch.from_numpy(v) for k, v in
                            feats.items()}, kind)
    jf.set_features_device({k: jnp.asarray(v) for k, v in feats.items()},
                           kind)
    assert tf.n_kp == jf.n_kp == 100 and tf._feats is None
    fd, buf = tf.dispatch_pack()
    assert buf.shape == (100, sum(v.reshape(100, -1).shape[1]
                                  for v in feats.values()))
    tf.install_packed(fd, buf.numpy())
    jf.ensure_host_features()
    for k, v in feats.items():
        assert tf._feats[k].dtype == v.dtype == jf._feats[k].dtype, k
        np.testing.assert_array_equal(tf._feats[k], v, err_msg=k)
        np.testing.assert_array_equal(jf._feats[k], v, err_msg=k)
    np.testing.assert_array_equal(tf.rays, jf.rays)
    # a keyframe keeps its host copy when its device tensors go
    kf = tframe.Frame(id=1, timestamp=0.0, camera=Camera(*cam),
                      is_keyframe=True)
    kf.set_features_device({k: torch.from_numpy(v) for k, v in
                            feats.items()}, kind)
    kf.release_device_features()
    assert kf.feats_dev is None
    np.testing.assert_array_equal(kf.desc, feats["desc"])


def _build_map(mod_frame, mod_map, cam_cls, rng):
    """The same small map in either package: 4 frames (2 keyframes), 30
    points with observations, then erasures."""
    m = mod_map.WorldMap()
    cam = cam_cls(64, 48, 50.0, 50.0, 32.0, 24.0)
    for i in range(4):
        f = mod_frame.Frame(id=m.get_fid(), timestamp=float(i), camera=cam)
        f.set_features(_feats(np.random.default_rng(10 + i), 40, "orb"),
                       "orb")
        f.pose_c2w = np.array([i, 0.5 * i, 10.0, 0, 0, 0, 1.0], np.float32)
        f.is_keyframe = i % 2 == 0
        f.gps_enu = np.array([i, 0, 10.0], np.float32) if i < 2 else None
        m.insert_frame(f)
    for j in range(30):
        p = mod_frame.MapPoint(id=m.get_pid(),
                               position=rng.normal(size=3).astype(
                                   np.float32),
                               descriptor=rng.integers(0, 2, 256).astype(
                                   np.uint8), ref_frame=j % 4)
        m.insert_point(p)
        for fid in range(4):
            if (j + fid) % 3:
                m.add_observation(p.id, fid, (j * 7 + fid) % 40)
    m.erase_observation(3, 1)
    m.erase_point(5)
    m.erase_frame(3)
    m.frame(0).connections = {2: 12}
    m.frame(2).connections = {0: 12}
    return m


def test_worldmap_bookkeeping_checkpoints_and_exports(tmp_path):
    rng = np.random.default_rng(0)
    jm = _build_map(jframe, jworldmap, JCamera, rng)
    tm = _build_map(tframe, tworldmap, Camera, np.random.default_rng(0))
    js, ts = convert.worldmap_to_numpy(jm), convert.worldmap_to_numpy(tm)
    _assert_states_equal(js, ts)
    for a, b in zip(jm.keyframe_center_arrays(), tm.keyframe_center_arrays()):
        np.testing.assert_array_equal(a, b)
    ja, ta = jm.point_arrays(), tm.point_arrays()
    assert ja[0] == ta[0]
    np.testing.assert_array_equal(ja[1], ta[1])
    np.testing.assert_array_equal(jm.point_position_sample(8),
                                  tm.point_position_sample(8))
    for name in ("map.npz", "map.maphash"):
        jp, tp = str(tmp_path / f"j_{name}"), str(tmp_path / f"t_{name}")
        assert jm.save(jp) and tm.save(tp)
        j2, t2 = jworldmap.WorldMap(), tworldmap.WorldMap()
        assert j2.load(tp) and t2.load(jp)     # each reads the other's
        _assert_states_equal(convert.worldmap_to_numpy(j2),
                             convert.worldmap_to_numpy(t2))
    jp, tp = str(tmp_path / "j.v1"), str(tmp_path / "t.v1")
    assert jm._save_v1(jp) and tm._save_v1(tp)
    t2 = tworldmap.WorldMap()
    assert t2.load(jp)
    _assert_states_equal(js, convert.worldmap_to_numpy(t2), features=False)
    for fn in ("export_ply", "export_trajectory"):
        assert getattr(jm, fn)(str(tmp_path / f"j_{fn}"))
        assert getattr(tm, fn)(str(tmp_path / f"t_{fn}"))
        with open(tmp_path / f"j_{fn}") as a, open(tmp_path / f"t_{fn}") as b:
            assert a.read() == b.read()


def _assert_states_equal(a, b, features=True):
    """Two worldmap_to_numpy states: the same frames (id, pose, keyframe
    flag, connections, kp2mp and, with `features`, the feature arrays),
    points (position, descriptor, observations) and id counters."""
    fa = {f["id"]: f for f in a["frames"]}
    fb = {f["id"]: f for f in b["frames"]}
    assert sorted(fa) == sorted(fb)
    keys = ["pose_c2w", "is_keyframe", "connections", "kp2mp"]
    if features:
        keys += ["xy", "desc", "angle", "octave", "response", "valid"]
    for i in fa:
        for k in keys:
            x, y = fa[i][k], fb[i][k]
            if isinstance(x, np.ndarray) or isinstance(y, np.ndarray):
                np.testing.assert_array_equal(x, y, err_msg=f"{i} {k}")
            else:
                assert x == y, (i, k)
    pa = {p["id"]: p for p in a["points"]}
    pb = {p["id"]: p for p in b["points"]}
    assert sorted(pa) == sorted(pb)
    for i in pa:
        np.testing.assert_array_equal(pa[i]["position"], pb[i]["position"])
        np.testing.assert_array_equal(pa[i]["descriptor"],
                                      pb[i]["descriptor"])
        assert pa[i]["observations"] == pb[i]["observations"]
    assert (a["next_fid"], a["next_pid"]) == (b["next_fid"], b["next_pid"])


def test_maphash_of_the_jax_run_loads_in_the_port(capture, tmp_path):
    path = str(tmp_path / "run.maphash")
    with open(path, "wb") as f:
        f.write(capture["maphash"])
    tm, jm = tworldmap.WorldMap(), jworldmap.WorldMap()
    assert tm.load(path) and jm.load(path)
    ts, js = convert.worldmap_to_numpy(tm), convert.worldmap_to_numpy(jm)
    _assert_states_equal(js, ts)
    # against the run's own map: the frames, poses, points and
    # observations the file carries
    after = capture["after"]
    assert sorted(f["id"] for f in ts["frames"]) == sorted(
        f["id"] for f in after["frames"])
    poses = {f["id"]: f["pose_c2w"] for f in after["frames"]}
    for f in ts["frames"]:
        np.testing.assert_array_equal(f["pose_c2w"], poses[f["id"]])
    obs = {p["id"]: p["observations"] for p in after["points"]
           if not p["bad"]}
    assert {p["id"]: p["observations"] for p in ts["points"]} == obs


def test_maphash_save_is_byte_equal(capture, tmp_path):
    tm = convert.worldmap_from_numpy(capture["after"], device="cpu")
    path = str(tmp_path / "port.maphash")
    assert tm.save(path)
    with open(path, "rb") as f:
        assert f.read() == capture["maphash"]


def test_worldmap_state_round_trip(capture):
    """worldmap_from_numpy(worldmap_to_numpy(...)) keeps the state, and
    installs device copies of every frame's features."""
    tm = convert.worldmap_from_numpy(capture["after"], device="cpu")
    _assert_states_equal(capture["after"], convert.worldmap_to_numpy(tm))
    for f in tm.frames():
        np.testing.assert_array_equal(f.feats_dev["desc"].numpy(), f.desc)
    assert tm.keyframes()[-1].id == 3


# ---------------------------------------------------------------------------
# vocabulary
# ---------------------------------------------------------------------------

def _sift_descriptors(capture):
    from pislamfusion_tpu_torch.ops.features import sift
    img = torch.from_numpy(capture["frames"][0]).to(torch.float32)
    gray = img @ torch.tensor([0.299, 0.587, 0.114])
    f = sift.sift_detect(gray, sift.SiftParams(n_features=300,
                                               contrast_threshold=0.005))
    return f["desc"].numpy(), f["valid"].numpy()


@pytest.mark.parametrize("kind", ["orb", "sift"])
def test_embedded_vocabulary_words_vectors_and_scores(capture, kind):
    from pislamfusion_tpu.models import slam as jslam
    from pislamfusion_tpu_torch.models import slam as tslam
    jv, tv = jslam._default_vocabulary(kind), tslam._default_vocabulary(kind)
    assert tv is not None and tv.size() == jv.size() > 100
    if kind == "orb":
        fr = {f["id"]: f for f in capture["after"]["frames"]}
        descs = [(fr[i]["desc"], fr[i]["valid"]) for i in (0, 3)]
    else:
        d, v = _sift_descriptors(capture)
        descs = [(d, v), (d[::-1].copy(), v[::-1].copy())]
    bows = []
    for desc, valid in descs:
        for lvl in (0, 2):
            jw = [np.asarray(x) for x in jv.transform_arrays(
                jnp.asarray(desc), jnp.asarray(valid), lvl)]
            tw = [x.numpy() for x in tv.transform_arrays(
                torch.from_numpy(desc), torch.from_numpy(valid), lvl)]
            for a, b in zip(jw, tw):
                np.testing.assert_array_equal(a, b)
        jb, jfv = jv.transform(jnp.asarray(desc), jnp.asarray(valid))
        tb, tfv = tv.transform(torch.from_numpy(desc),
                               torch.from_numpy(valid))
        assert sorted(jb) == sorted(tb) and jfv == tfv
        np.testing.assert_allclose([tb[k] for k in sorted(tb)],
                                   [jb[k] for k in sorted(jb)], atol=1e-6)
        bows.append((jb, tb))
    (ja, ta), (jb, tb) = bows
    assert abs(tv.score(ta, tb) - jv.score(ja, jb)) < 1e-6
    assert abs(tv.score(ta, ta) - 1.0) < 1e-6


def test_trained_vocabulary_and_gbow_file(tmp_path):
    """tests/test_vocabulary.py's trained trees: the same training gives the
    same tree and IDF weights in both packages, each reads the other's
    .gbow, and the batched descent equals the sequential walk."""
    from pislamfusion_tpu.ops import vocabulary as jvoc
    from pislamfusion_tpu_torch.ops import vocabulary as tvoc
    rng = np.random.default_rng(0)
    train = rng.integers(0, 256, (600, 32), dtype=np.uint8)
    jv = jvoc.Vocabulary.create(train, k=4, L=3)
    tv = tvoc.Vocabulary.create(train, k=4, L=3)
    for k in ("node_desc", "node_parent", "node_children", "node_word",
              "words"):
        np.testing.assert_array_equal(getattr(jv, k), getattr(tv, k))
    np.testing.assert_allclose(tv.node_weight, jv.node_weight, atol=1e-6)
    assert jv.save(str(tmp_path / "j.gbow"))
    t2 = tvoc.Vocabulary.load(str(tmp_path / "j.gbow"))
    q = np.random.default_rng(7).integers(0, 256, (64, 32), dtype=np.uint8)
    w = t2.transform_arrays(q)[0].numpy()
    for i in range(len(q)):
        cur = 0
        for _ in range(tv.L):
            ch = tv.node_children[cur]
            ch = ch[ch >= 0]
            if len(ch) == 0:
                break
            cur = int(ch[int(np.argmin([tvoc.Vocabulary.distance(
                q[i], tv.node_desc[c]) for c in ch]))])
        assert w[i] == tv.node_word[cur]
    np.testing.assert_array_equal(w, np.asarray(jv.transform_arrays(q)[0]))


# ---------------------------------------------------------------------------
# matchers
# ---------------------------------------------------------------------------

MATCHER_NAMES = ["BF", "BoW", "bow", "liu_bow", "hybird", "flann",
                 "flanntest", "SiftGPU", "liu_SiftGPU", "multiH", "flannH",
                 "flann_multiH", "bf_knn_multiH", "bowH", "bow_homography",
                 "BFMultiH", "bf_multiH", "zy_bfMultiH"]


def _match_frames(state, mod_frame, cam_cls):
    fr = {f["id"]: f for f in state["frames"]}
    out = []
    for i in (0, 3):
        d = fr[i]
        f = mod_frame.Frame(id=i, timestamp=float(i),
                            camera=cam_cls.from_parameters(d["camera"]))
        f.set_features({k: d[k] for k in ("xy", "desc", "angle", "octave",
                                           "response", "valid")}, "orb")
        out.append(f)
    return out


def _noise_of(cls_name, key, n):
    """The Gumbel noise the JAX matcher of class `cls_name` draws from
    `key`, one array a draw, in the order the port's multih draws it."""
    if cls_name in ("MatcherMultiH", "MatcherBoWH"):
        return [np.asarray(jax.random.gumbel(k, (192, n)))
                for k in jax.random.split(key, 4)]
    kf, kh = jax.random.split(key)
    return [np.asarray(jax.random.gumbel(kf, (192, n)))] + [
        np.asarray(jax.random.gumbel(k, (192, n)))
        for k in jax.random.split(kh, 5)]


def _jax_matches(capture):
    from pislamfusion_tpu.core.registry import MATCHERS
    from pislamfusion_tpu.core.svar import Svar
    from pislamfusion_tpu.models import matchers  # noqa: F401
    fa, fb = _match_frames(capture["after"], jframe, JCamera)
    key = jax.random.PRNGKey(3)
    out = {}
    for name in MATCHER_NAMES:
        m = MATCHERS.create(name, Svar())
        cls = type(m).__name__
        if cls not in out:
            idx, ok = m(key, fa, fb)
            noise = (_noise_of(cls, key, fa.n_kp) if cls in (
                "MatcherMultiH", "MatcherBoWH", "MatcherBFMultiH") else [])
            out[cls] = (np.asarray(idx), np.asarray(ok), noise)
        out[name] = cls
    return out


@pytest.fixture(scope="module")
def jax_matches(capture, tmp_path_factory, worker_id):
    return once_per_session("torch_slam_matchers",
                            lambda: _jax_matches(capture),
                            tmp_path_factory, worker_id)


@pytest.mark.parametrize("name", MATCHER_NAMES)
def test_matcher_gives_the_reference_matches(name, capture, jax_matches,
                                             monkeypatch):
    from pislamfusion_tpu_torch.core.registry import MATCHERS
    from pislamfusion_tpu_torch.core.svar import Svar
    from pislamfusion_tpu_torch.models import matchers  # noqa: F401
    from pislamfusion_tpu_torch.ops import threefry
    m = MATCHERS.create(name, Svar(), device="cpu")
    cls = type(m).__name__
    assert jax_matches[name] == cls
    j_idx, j_ok, noise = jax_matches[cls]
    draws = [torch.from_numpy(np.array(x)) for x in noise]
    key_gumbel = threefry.Key.gumbel

    def jax_draws(key, shape):
        # the port's key draws the JAX key's noise to float rounding; the
        # JAX draw itself is handed on, so that the matches are exact
        g = draws.pop(0)
        np.testing.assert_allclose(key_gumbel(key, shape).numpy(),
                                   g.numpy(), rtol=2.5e-7, atol=2.5e-7)
        return g
    monkeypatch.setattr(threefry.Key, "gumbel", jax_draws)
    fa, fb = _match_frames(capture["after"], tframe, Camera)
    idx, ok = m(threefry.Key(3), fa, fb)
    assert not draws
    np.testing.assert_array_equal(ok.numpy(), j_ok)
    np.testing.assert_array_equal(idx.numpy()[j_ok], j_idx[j_ok])
    assert j_ok.sum() > 100


def test_bow_matcher_buckets_by_vocabulary_node(capture):
    """MatcherBoW restricts candidates to a shared node (levelsup 4 below
    the leaves): never more matches than plain BF's cross-checked base."""
    from pislamfusion_tpu_torch.core.svar import Svar
    from pislamfusion_tpu_torch.models import matchers as tm
    fa, fb = _match_frames(capture["after"], tframe, Camera)
    from pislamfusion_tpu_torch.ops import threefry
    g = threefry.Key(0)
    _, ok_bow = tm.MatcherBoW(Svar(), device="cpu")(g, fa, fb)
    _, ok_bf = tm.MatcherBF(Svar(), device="cpu")(g, fa, fb)
    assert 0 < int(ok_bow.sum()) <= int(ok_bf.sum())


def test_matchers_default_to_cuda_and_raise_without_it():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is usable")
    from pislamfusion_tpu_torch.models import matchers as tm
    with pytest.raises(RuntimeError, match="CUDA"):
        tm.MatcherMultiH()
    assert os.path.basename(tm.__file__) == "matchers.py"


@pytest.mark.parametrize("kind", ["BoW", "distance"])
def test_loop_detector_candidates_match_reference(capture, kind):
    """LoopDetectorBoW (the embedded ORB vocabulary's words, an inverted
    file) and LoopDetectorDistance on the run's keyframes 0-2 queried with
    keyframe 3: the same candidates in the same order."""
    from pislamfusion_tpu.core.svar import Svar as JSvar
    from pislamfusion_tpu.models import loopclose as jl
    from pislamfusion_tpu.models import slam as jslam
    from pislamfusion_tpu_torch.core.svar import Svar
    from pislamfusion_tpu_torch.models import loopclose as tl
    from pislamfusion_tpu_torch.models import slam as tslam
    state = capture["after"]
    tm = convert.worldmap_from_numpy(state, device="cpu")
    jm = jworldmap.WorldMap()
    path = None
    out = []
    for mod, m, cfg, vocab in (
            (jl, jm, JSvar(), jslam._default_vocabulary("orb")),
            (tl, tm, Svar(), tslam._default_vocabulary("orb"))):
        cfg.set("SLAM.LoopMinFrameGap", "0")
        cfg.set("SLAM.LoopMinCommonWords", "2")
        if m is jm:
            import tempfile
            path = tempfile.mktemp(suffix=".npz")
            tm.save(path)
            assert jm.load(path)
            os.remove(path)
        kwargs = {} if mod is jl else {"device": "cpu"}
        det = (mod.LoopDetectorBoW(m, cfg, vocab, **kwargs) if kind == "BoW"
               else mod.LoopDetectorDistance(m, cfg, **kwargs))
        kfs = sorted(m.keyframes(), key=lambda f: f.id)
        for f in kfs[:-1]:
            det.insert(f)
        kfs[-1].connections = {}
        out.append(det.candidates(kfs[-1]))
    assert out[0] == out[1] and len(out[0]) >= 2


def test_slam_undistorts_the_mosaic_feed():
    """SLAM._undistort_for_mosaic for an ATAN camera: the port's
    undistort_map + remap equal the JAX package's within 2e-3 gray (the
    f32 rounding of the ATAN model's inverse, 8e-6 relative)."""
    from pislamfusion_tpu.core.camera import CameraATAN as JATAN
    from pislamfusion_tpu.models import slam as jslam
    from pislamfusion_tpu_torch.core.camera import CameraATAN
    from pislamfusion_tpu_torch.models import slam as tslam
    kw = dict(width=64, height=48, fx=50.0, fy=50.0, cx=32.0, cy=24.0,
              d=0.9)
    img = np.random.default_rng(4).uniform(0, 255, (48, 64, 3)).astype(
        np.float32)
    js = jslam.SLAM(None, JATAN(**kw))
    ts = tslam.SLAM(None, CameraATAN(**kw), device="cpu")
    np.testing.assert_allclose(ts._undistort_for_mosaic(img),
                               np.asarray(js._undistort_for_mosaic(img)),
                               atol=2e-3)
