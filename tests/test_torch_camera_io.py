"""The port's camera models, host copies and dataset IO against the JAX
package's, on the CPU.

- Camera models (PinHole, Ideal, ATAN, OpenCV, OCAM): a numpy input gives
  numpy output equal to the reference's numpy path (the same numpy
  code); a tensor input gives a tensor on its device within 1e-5 of the
  reference's jax.numpy output (f32, other operation orders); OCAM's
  polynomials 1e-4 relative. Factories, parameter vectors, scaling and
  `in_view` exactly. `undistort_map` within 2e-4 px (OCAM's, through
  its degree-8 inverse polynomial in f32, 2e-2 px) and `ops.image.remap`
  within 2e-3 gray.
- Host copies (utils/padding, utils/host_se3, core/glog, core/messenger,
  core/resource, core/gps, io/native_io, io/dataset, and with the fused
  system io/tiles, viz and core/memory_metric): each copy's syntax
  tree, without imports and docstrings, equals its original's, except the
  definitions listed (and why) in HOST_COPY_CHANGES; each module's cases
  of tests/test_camera_gps.py, tests/test_datasets.py and
  tests/test_native_io.py give equal results in both packages.
- `dataset.imread`: equal to the reference's PIL read for PNG (also with
  PIL hidden) and for JPEG through the native decoder; a file nothing can
  decode raises.
"""
import ast
import dataclasses
import os
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pislamfusion_tpu.core import camera as jcam
from pislamfusion_tpu.core import gps as jgps
from pislamfusion_tpu.ops import image as jim
from pislamfusion_tpu_torch import convert
from pislamfusion_tpu_torch.core import camera as tcam
from pislamfusion_tpu_torch.core import gps as tgps
from pislamfusion_tpu_torch.ops import image as tim
from torch_port_reference import torch_one_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _ocam_params():
    """tests/test_ocam.py's synthetic Scaramuzza camera."""
    pol = (-250.0, 0.0, 8.0e-4)
    r = np.linspace(0.0, 380.0, 500)
    theta = np.arctan2(pol[0] + pol[2] * r * r, r)
    inv = tuple(float(v) for v in np.polyfit(theta, r, 8)[::-1])
    return dict(width=800, height=600, cx=405.0, cy=302.0, pol=pol,
                invpol=inv, c=1.001, d=-0.002, e=0.0015)


CAMERAS = {
    "ideal": ("Camera", dict(width=640, height=480)),
    "pinhole": ("Camera", dict(width=640, height=480, fx=500.0, fy=498.0,
                               cx=321.0, cy=239.0)),
    "atan": ("CameraATAN", dict(width=640, height=480, fx=500.0, fy=500.0,
                                cx=320.0, cy=240.0, d=0.9)),
    "atan0": ("CameraATAN", dict(width=640, height=480, fx=500.0, fy=500.0,
                                 cx=320.0, cy=240.0, d=0.0)),
    "opencv": ("CameraOpenCV", dict(width=640, height=480, fx=500.0,
                                    fy=500.0, cx=320.0, cy=240.0, k1=0.1,
                                    k2=-0.05, p1=0.001, p2=-0.001, k3=0.01)),
    "ocam": ("CameraOCAM", _ocam_params()),
}


def _both(name):
    cls, kw = CAMERAS[name]
    return getattr(jcam, cls)(**kw), getattr(tcam, cls)(**kw)


def _pixels_and_points(name, rng):
    if name == "ocam":
        ang = rng.uniform(0, 2 * np.pi, 64)
        rad = rng.uniform(5.0, 340.0, 64)
        px = np.stack([405.0 + rad * np.cos(ang), 302.0 + rad * np.sin(ang)],
                      -1)
        p3d = rng.normal(size=(64, 3))
    else:
        px = rng.uniform(0, 640, (64, 2))
        p3d = np.concatenate([rng.uniform(-0.4, 0.4, (64, 2)),
                              rng.uniform(1, 3, (64, 1))], -1)
    return px.astype(np.float32), p3d.astype(np.float32)


@pytest.mark.parametrize("name", list(CAMERAS))
def test_camera_models_match_reference(name):
    jc, tc = _both(name)
    assert dataclasses.astuple(tc) == dataclasses.astuple(jc)
    assert tc.name == jc.name and tc.is_valid() == jc.is_valid()
    assert tc.parameters() == jc.parameters()
    px, p3d = _pixels_and_points(name, np.random.default_rng(1))
    tol = dict(rtol=1e-4, atol=1e-3) if name == "ocam" else dict(
        rtol=1e-5, atol=1e-5)
    for fn, x in (("project", p3d), ("unproject", px)):
        # numpy in, numpy out: the reference's own numpy path
        got = getattr(tc, fn)(x)
        assert isinstance(got, np.ndarray)
        np.testing.assert_array_equal(got, getattr(jc, fn)(x))
        # a tensor in, a tensor out on its device
        got = getattr(tc, fn)(torch.from_numpy(x))
        assert isinstance(got, torch.Tensor) and got.device.type == "cpu"
        np.testing.assert_allclose(got.numpy(), np.asarray(
            getattr(jc, fn)(jnp.asarray(x))), **tol)
    np.testing.assert_array_equal(tc.in_view(torch.from_numpy(px), 4.0),
                                  np.asarray(jc.in_view(jnp.asarray(px),
                                                        4.0)))
    np.testing.assert_array_equal(tc.in_view(px), jc.in_view(px))
    for s in (2, 3):
        small_t, small_j = tc.downsampled(s), jc.downsampled(s)
        assert type(small_t).__name__ == type(small_j).__name__
        assert dataclasses.astuple(small_t) == dataclasses.astuple(small_j)
    if name != "ocam":
        assert dataclasses.astuple(tc.scaled(0.5)) == dataclasses.astuple(
            jc.scaled(0.5))


def test_camera_factory_and_parameter_vectors():
    for name in CAMERAS:
        jc, tc = _both(name)
        p = convert.camera_to_parameters(jc)
        got = convert.camera_from_parameters(p)
        assert type(got).__name__ == type(jc).__name__
        assert dataclasses.astuple(got) == dataclasses.astuple(tc)
        assert convert.camera_to_parameters(got) == p
    for p in ([640, 480], [640, 480, 500, 500, 320, 240],
              [640, 480, 500, 500, 320, 240, 0.9],
              [640, 480, 500, 500, 320, 240, 0.1, -0.05, 0.001, 0.001, 0.0]):
        assert tcam.Camera.from_parameters(p).name == \
            jcam.Camera.from_parameters(p).name
    for bad in ([1, 2, 3], [1.0] * 12):
        with pytest.raises(ValueError):
            tcam.Camera.from_parameters(bad)


def test_ocam_from_file_and_degenerate_projection(tmp_path):
    kw = _ocam_params()
    cam = tcam.CameraOCAM(**kw)
    lines = [" ".join([str(len(kw["pol"]))] + [f"{v:.17g}" for v in
                                               kw["pol"]]),
             " ".join([str(len(kw["invpol"]))] + [f"{v:.17g}" for v in
                                                  kw["invpol"]]),
             f"{kw['cy']} {kw['cx']}", f"{kw['c']} {kw['d']} {kw['e']}",
             f"{kw['height']} {kw['width']}"]
    p = tmp_path / "calib_results.txt"
    p.write_text("# pol\n" + "\n# x\n".join(lines) + "\n")
    got = tcam.CameraOCAM.from_file(str(p))
    assert got == cam and got.name == "OCAM" and got.is_valid()
    assert dataclasses.astuple(got) == dataclasses.astuple(
        jcam.CameraOCAM.from_file(str(p)))
    for x in (np.array([0.0, 0.0, 1.0], np.float32),
              torch.tensor([0.0, 0.0, 1.0])):
        np.testing.assert_allclose(np.asarray(cam.project(x)),
                                   [kw["cx"], kw["cy"]])


@pytest.mark.parametrize("name", ["opencv", "atan", "ocam"])
def test_undistort_map_and_remap_match_reference(name):
    jc, tc = _both(name)
    target = jcam.Camera(160, 120, 130.0, 130.0, 80.0, 60.0) \
        if name == "ocam" else None
    ttarget = None if target is None else tcam.Camera(
        *dataclasses.astuple(target))
    jm = np.asarray(jcam.undistort_map(jc, target))
    tm = tcam.undistort_map(tc, ttarget, device="cpu")
    assert tm.dtype == torch.float32 and tm.device.type == "cpu"
    np.testing.assert_allclose(tm.numpy(), jm, atol=2e-4 if name != "ocam"
                               else 2e-2, rtol=1e-5)
    img = np.random.default_rng(2).uniform(0, 255, (jc.height, jc.width,
                                                    3)).astype(np.float32)
    np.testing.assert_allclose(
        tim.remap(torch.from_numpy(img), torch.from_numpy(jm)).numpy(),
        np.asarray(jim.remap(jnp.asarray(img), jnp.asarray(jm))), atol=2e-3)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            tcam.undistort_map(tc)


# ---------------------------------------------------------------------------
# host copies
# ---------------------------------------------------------------------------

# definitions of a copy that differ from its original, and why
HOST_COPY_CHANGES = {
    # the generated module imports the port's resource registry
    "core/resource.py": {"generate_module"},
    # the port's own copy of imageio.cpp, built into _build/ under a
    # per-process name renamed into place
    "io/native_io.py": {"_PKG_DIR", "_NATIVE_DIR", "_SRC", "_SO", "_build"},
    # each topic's publishes are counted: SLAM stamps the frames it queues
    # for the mosaic with the map epoch (models/fusion.py); a queue counts
    # the items it drops
    "core/messenger.py": {"Messenger.__init__", "Messenger._dispatch",
                          "Messenger.published", "DataTrans.__init__",
                          "DataTrans.product"},
    # device memory from the CUDA caching allocator's counters
    "core/memory_metric.py": {"device_usage"},
    # the card's machine has no PIL: PNGs through read_png, others through
    # the native decoder, then PIL
    "io/dataset.py": {"imread"},
    # the device feature dict holds torch tensors: the packing is one
    # torch.cat (no jit, so no cached jitted packer), the host copy is
    # `.cpu().numpy()`, and the descriptor dtype test reads a torch dtype
    "models/frame.py": {"_pack_feats", "_pack_feats_jit", "Frame._materialize",
                        "Frame.dispatch_pack", "Frame.install_packed"},
}
HOST_COPIES = ["utils/padding.py", "utils/host_se3.py", "core/glog.py",
               "core/messenger.py", "core/resource.py", "core/gps.py",
               "io/native_io.py", "io/dataset.py", "io/maphash.py",
               "models/worldmap.py", "models/frame.py",
               "resources/__init__.py", "resources/orb_vocab.py",
               "resources/sift_vocab.py", "io/tiles.py", "viz.py",
               "core/memory_metric.py"]


def _definitions(pkg, rel):
    """{name: ast dump} of a module's top-level statements, imports and
    docstrings removed; a class's members also as "Class.member"."""
    with open(os.path.join(REPO, pkg, rel)) as f:
        tree = ast.parse(f.read())

    class Strip(ast.NodeTransformer):
        def generic_visit(self, node):
            node = super().generic_visit(node)
            body = getattr(node, "body", None)
            if isinstance(body, list):
                body = [s for s in body if not isinstance(
                    s, (ast.Import, ast.ImportFrom)) and not (
                    isinstance(s, ast.Expr) and isinstance(
                        s.value, ast.Constant) and isinstance(
                        s.value.value, str))]
                node.body = body or [ast.Pass()]
            return node
    tree = Strip().visit(tree)
    out = {}
    for i, s in enumerate(tree.body):
        if isinstance(s, (ast.FunctionDef, ast.ClassDef)):
            name = s.name
        elif isinstance(s, ast.Assign) and isinstance(s.targets[0],
                                                      ast.Name):
            name = s.targets[0].id
        else:
            name = f"#{i}"
        out[name] = ast.dump(s)
        if isinstance(s, ast.ClassDef):
            for j, m in enumerate(s.body):
                target = getattr(m, "target", None) or (
                    m.targets[0] if isinstance(m, ast.Assign) else None)
                member = getattr(m, "name", None) or getattr(
                    target, "id", None) or f"#{j}"
                out[f"{name}.{member}"] = ast.dump(m)
    return out


@pytest.mark.parametrize("rel", HOST_COPIES)
def test_host_copy_equals_its_original(rel):
    ref = _definitions("pislamfusion_tpu", rel)
    port = _definitions("pislamfusion_tpu_torch", rel)
    changed = HOST_COPY_CHANGES.get(rel, set())
    # a class with a changed member differs as a whole; its other members
    # are compared one by one
    skip = changed | {n.split(".")[0] for n in changed if "." in n}
    assert set(port) - skip == set(ref) - skip
    for name in set(ref) - skip:
        assert port[name] == ref[name], f"{rel}: {name} differs"
    assert changed <= set(port) | set(ref)


def test_gps_and_host_se3_give_the_reference_results():
    from pislamfusion_tpu.utils import host_se3 as jh
    from pislamfusion_tpu_torch.utils import host_se3 as th
    from pislamfusion_tpu.utils import padding as jp
    from pislamfusion_tpu_torch.utils import padding as tp
    lla = (108.9, 34.2, 400.0)
    xyz = tgps.lla_to_ecef(*lla)
    np.testing.assert_array_equal(xyz, jgps.lla_to_ecef(*lla))
    np.testing.assert_allclose(tgps.ecef_to_lla(xyz), lla, atol=1e-6)
    f_t, f_j = tgps.LocalFrame(*lla), jgps.LocalFrame(*lla)
    np.testing.assert_array_equal(f_t.to_local(108.9, 34.21, 410.0),
                                  f_j.to_local(108.9, 34.21, 410.0))
    np.testing.assert_array_equal(f_t.local_to_lla(np.array([50., -20, 5])),
                                  f_j.local_to_lla(np.array([50., -20, 5])))
    assert tgps.lnglat_from_distance(108.9, 34.2, 120.0, -45.0) == \
        jgps.lnglat_from_distance(108.9, 34.2, 120.0, -45.0)
    a_t, a_j = tgps.GPSArray(), jgps.GPSArray()
    for a in (a_t, a_j):
        a.add(0.0, 108.0, 34.0, 100.0)
        a.add(10.0, 108.001, 34.001, 200.0)
    np.testing.assert_array_equal(a_t.at(5.0), a_j.at(5.0))
    assert a_t.at(100.0) is None
    for pyr in ((-90.0, 0.0, 0.0), (-90.0, 0.0, 175.0), (-80, 30, 5)):
        np.testing.assert_array_equal(tgps.pyr_to_rotation(*pyr),
                                      jgps.pyr_to_rotation(*pyr))
    for fn in ("wgs84_to_gcj02", "gcj02_to_wgs84", "wgs84_to_bd09",
               "bd09_to_wgs84"):
        assert getattr(tgps, fn)(39.9042, 116.4074) == \
            getattr(jgps, fn)(39.9042, 116.4074)
    assert tgps.datum_shift(39.9, 116.4, "gcj02") == jgps.datum_shift(
        39.9, 116.4, "gcj02")
    rng = np.random.default_rng(3)
    A = rng.normal(size=(6, 7))
    A[:, 3:] /= np.linalg.norm(A[:, 3:], axis=-1, keepdims=True)
    B = A.copy()
    B[:, :3] = 2.0 * A[:, :3] + 1.0
    np.testing.assert_array_equal(th.sim3_fit_pose_gauge(A, B),
                                  jh.sim3_fit_pose_gauge(A, B))
    np.testing.assert_array_equal(th.se3_mul(A[0], A[1]),
                                  jh.se3_mul(A[0], A[1]))
    for a, b in zip(tp.pad_rows(9, A, A[:, 0]), jp.pad_rows(9, A, A[:, 0])):
        np.testing.assert_array_equal(a, b)
    assert tp.round_capacity(700) == jp.round_capacity(700)


def test_glog_messenger_resource(tmp_path):
    from pislamfusion_tpu_torch.core import glog, messenger, resource
    got = []
    m = messenger.Messenger()
    pub = m.advertise("topic") if hasattr(m, "advertise") else None
    if pub is not None:
        m.subscribe("topic", got.append)
        pub.publish(3)
        assert got == [3]
    resource.register("a/b", b"xyz")
    assert resource.get("a/b") == b"xyz"
    out = tmp_path / "x.bin"
    assert resource.export("a/b", str(out)) and out.read_bytes() == b"xyz"
    src = tmp_path / "src.bin"
    src.write_bytes(b"\x00\x01hello")
    mod = tmp_path / "port_embedded_res.py"
    assert resource.generate_module(str(src), "emb/x", str(mod))
    # loaded from its file under a name of its own: the reference's test
    # imports a module of its own named embedded_res in the same process
    import importlib.util
    spec = importlib.util.spec_from_file_location("port_embedded_res",
                                                  str(mod))
    spec.loader.exec_module(importlib.util.module_from_spec(spec))
    assert resource.get("emb/x") == b"\x00\x01hello"
    assert "pislamfusion_tpu_torch.core" in mod.read_text()
    glog.logger.info("port glog")
    with pytest.raises(SystemExit):
        glog.check(False, "x")


# ---------------------------------------------------------------------------
# native image IO and the datasets
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def images(tmp_path_factory):
    from PIL import Image
    rng = np.random.default_rng(0)
    d = tmp_path_factory.mktemp("imgs")
    img = rng.integers(0, 255, (48, 64, 3)).astype(np.uint8)
    Image.fromarray(img).save(str(d / "t.png"))
    Image.fromarray(img).save(str(d / "t.jpg"), quality=95)
    Image.fromarray(img[..., 0]).save(str(d / "g.png"))
    (d / "bad.jpg").write_bytes(b"not an image")
    return d, img


def test_native_io_decodes_and_writes(images, tmp_path):
    from pislamfusion_tpu_torch.io import native_io
    if not native_io.available():
        pytest.skip("g++, libjpeg or libpng is absent: native imageio "
                    "degrades to PIL")
    assert native_io._SO.startswith(os.path.join(
        REPO, "pislamfusion_tpu_torch", "_build"))
    d, img = images
    np.testing.assert_array_equal(native_io.imread_f32(str(d / "t.png")),
                                  img.astype(np.float32))
    from PIL import Image
    pil = np.asarray(Image.open(str(d / "t.jpg")).convert("RGB"))
    assert np.abs(native_io.imread_f32(str(d / "t.jpg")) - pil).max() <= 2
    assert native_io.imread_f32(str(d / "bad.jpg")) is None
    pf = native_io.Prefetcher(threads=2)
    tickets = [pf.submit(str(d / n)) for n in ("t.png", "g.png")]
    np.testing.assert_array_equal(pf.wait(tickets[0]), img)
    np.testing.assert_array_equal(pf.wait(tickets[1]), img[..., :1].repeat(
        3, -1))
    pf.close()
    out = str(tmp_path / "w.png")
    assert native_io.save_png(out, img)
    assert native_io.flush_writes() == 0
    np.testing.assert_array_equal(np.asarray(Image.open(out)), img)


def test_dataset_imread(images, monkeypatch):
    from pislamfusion_tpu.io import dataset as jds
    from pislamfusion_tpu_torch.io import dataset as tds
    from pislamfusion_tpu_torch.io import native_io
    d, img = images
    for name in ("t.png", "g.png", "t.jpg"):
        ref = jds.imread(str(d / name))
        got = tds.imread(str(d / name))
        assert got.dtype == np.uint8 and got.shape == ref.shape
        if name.endswith(".png") or native_io.available():
            assert np.abs(got.astype(int) - ref).max() <= (
                0 if name.endswith(".png") else 2)
    with pytest.raises(Exception):
        tds.imread(str(d / "bad.jpg"))
    # with PIL hidden: PNGs through the package's decoder; a file nothing
    # decodes raises with the reason
    monkeypatch.setitem(sys.modules, "PIL", None)
    np.testing.assert_array_equal(tds.imread(str(d / "t.png")), img)
    monkeypatch.setattr(native_io, "imread_f32", lambda *a, **k: None)
    with pytest.raises(RuntimeError, match="PIL is not installed"):
        tds.imread(str(d / "t.jpg"))


def _dataset_cases(tmp_path):
    """tests/test_datasets.py's three layouts."""
    xml = """<?xml version="1.0"?>
<doc>
 <project>
  <ProjectType value="rtmapper"/>
  <Dataset><Camera value="cam0"/></Dataset>
  <cam0><Paraments value="320 240 260 260 160 120"/></cam0>
 </project>
 <images>
  <frame timestamp="1.5" image="img/a.jpg">
   <gps longtitude="116.1" latitude="40.2" altitude="95.0"/>
   <gpsSigma longtitude="2.0" latitude="2.0" altitude="5.0"/>
   <height value="70.0" sigma="3.0"/>
   <attitude pitch="1.0" yaw="2.0" roll="3.0"/>
   <attitudeSigma pitch="0.1" yaw="0.2" roll="0.3"/>
  </frame>
  <frame timestamp="2.5" image="/abs/b.jpg">
   <gps longtitude="116.2" latitude="40.3" altitude="96.0"/>
   <gpsSigma longtitude="2.0" latitude="2.0" altitude="5.0"/>
  </frame>
 </images>
</doc>"""
    (tmp_path / "project.rtm").write_text(xml)
    root = tmp_path / "rgbd"
    os.makedirs(root)
    (root / "assoc.txt").write_text(
        "1.0 0 0 0 0 0 0 1 1.0 depth/1.png 1.0 rgb/1.png\n"
        "2.0 1 0 0 0 0 0 1 2.0 depth/2.png 2.0 rgb/2.png\n")
    (root / "ds.npurgbd").write_text(
        "Camera=kinect\nkinect.Paraments=640 480 525 525 320 240\n"
        "VideoFile=assoc.txt\n")
    cfg = tmp_path / "cfgds"
    os.makedirs(cfg)
    (cfg / "video.txt").write_text("1.0 rgb/a.jpg\n2.0 rgb/b.jpg\n")
    (cfg / "gps.txt").write_text("0.9 116.0 40.0 95.0 5.0\n"
                                 "1.9 116.001 40.0 95.0 5.0\n")
    (cfg / "play.cfg").write_text(
        "Video.Type=GSLAM\nVideo.File=video.txt\n"
        "Video.CameraInName=cam\ncam.Paraments=320 240 260 260 160 120\n")
    return [str(tmp_path / "project.rtm"), str(root / "ds.npurgbd"),
            str(cfg / "play.cfg")]


def _frame_record(fr):
    out = {}
    for f in dataclasses.fields(fr):
        v = getattr(fr, f.name)
        if f.name == "camera":
            v = None if v is None else dataclasses.astuple(v)
        elif isinstance(v, np.ndarray):
            v = v.tolist()
        out[f.name] = v
    return out


def test_datasets_read_what_the_reference_reads(tmp_path):
    from pislamfusion_tpu.io.dataset import open_dataset as jopen
    from pislamfusion_tpu_torch.core.registry import DATASETS
    from pislamfusion_tpu_torch.io.dataset import _parse_gpshpyr
    from pislamfusion_tpu_torch.io.dataset import open_dataset as topen
    for ext in ("npudronemap", "rtm", "cfg", "npurgbd", "kitti", "tummono",
                "tum", "tumrgbd", "euroc", "cvmono"):
        assert ext in DATASETS, ext
    for path in _dataset_cases(tmp_path):
        jd, td = jopen(path), topen(path)
        assert td is not None and td.is_opened() and len(td) == len(jd)
        assert dataclasses.astuple(td.camera) == dataclasses.astuple(
            jd.camera)
        assert [_frame_record(f) for f in td._frames] == \
            [_frame_record(f) for f in jd._frames]
    v14 = list(range(14))
    from pislamfusion_tpu.io.dataset import _parse_gpshpyr as jparse
    for a, b in zip(_parse_gpshpyr(v14), jparse(v14)):
        np.testing.assert_array_equal(np.asarray(a, float),
                                      np.asarray(b, float))
