"""The port's Map2D engines against the JAX package's, on the CPU.

The world is tests/test_mosaic.py's: a 160x120 nadir camera (fx 100) at
20 m over a smooth 512^2 ground texture (0.1 m a texel), Map2D.Scale 0.5
(0.4 m a canvas pixel, a patch of 2 tiles), 3 bands, five frames with
some yaw; Type 4 renders them 3 at a time, so its last batch has a
zero-weight padding slot. The inputs are made from a numpy seed. Each engine type runs
once in the JAX package on its TPU path (`forced_tpu_path`, K3 through the
Pallas interpreter; Types 3 and 4 with Map2D.WarpMode=shear) and once in
the port on the CPU, on the same frames:

- canvas weights (every band) within 1e-5 (f32, other operation orders);
- blended mosaic >= 60 dB PSNR against the JAX one over the pixels
  either covers (the two differ by f32 summation order only);
- coverage masks equal; frames_rendered and frames_skipped equal.

With Map2DRender.EnableSeam the seam pass gives each canvas pixel to the
frame whose (smoothed) weight is largest, and along the ridge where two
frames' analytic weights are equal the two packages' weights differ by
1-4 f32 ulps (other operation orders), so ownership of a ridge pixel can
go either way: band 0's weights still agree within 1e-5 everywhere, and
in each coarser band (the pyrDown of the masked weights) at most 1 % of
the pixels may differ by more (measured: 0.04, 0.2 and 0.6 % in bands
1-3; the blended mosaics agree to 97 dB).

The same bounds hold after `refresh` on a drifted pose set, after canvas
growth, and for a port engine that takes over a JAX engine's state after
four frames (`convert.py`; a RenderMap2D's with one frame pending) and
is fed the fifth, which is also held to a port engine fed all five; a
state loads only into an engine of its own Map2D.Type, bands and
weight_type, with a canvas that fits its tiles. `grow_canvas` is exact,
and so are the PNG round trip and the copies of the host-only modules.

`read_png` is held to the reference's (PIL's `convert("RGB")`) exactly,
with PIL and with PIL hidden (the package's own decoder), on PNGs of
every colour type: palette (with tRNS), 16-bit gray, RGB, gray+alpha and
RGBA, 1/2/4-bit gray and palette, Adam7-interlaced, each row under a
filter drawn from a seed (all five, or only None, Sub and Up, the
decoder's row-wise path).
"""
import os
import struct
import sys
import zlib

import numpy as np
import pytest
import torch

import jax

from pislamfusion_tpu.core.camera import Camera as JCamera
from pislamfusion_tpu.core.svar import Svar as JSvar
from pislamfusion_tpu.models import map2d as jmap
from pislamfusion_tpu.ops import mosaic as jm
from pislamfusion_tpu_torch import convert
from pislamfusion_tpu_torch.core.camera import Camera
from pislamfusion_tpu_torch.core.svar import Svar
from pislamfusion_tpu_torch.models import map2d as tmap
from pislamfusion_tpu_torch.ops import mosaic as tm
from torch_port_reference import (forced_tpu_path,  # noqa: F401
                                  once_per_session, torch_one_thread)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CAM = (160, 120, 100.0, 100.0, 80.0, 60.0)
PLANE = np.array([0, 0, 0, 0, 0, 0, 1.0])
GROUND_SCALE = 0.1
K_CARRY = 4                     # frames fed before the state is carried
W_TOL, PSNR_MIN = 1e-5, 60.0
SEAM_RIDGE = 0.01
# engine cases: (Map2D.Type, extra config)
CASES = {
    "multiband": (3, {"Map2D.WarpMode": "shear"}),
    "render": (4, {"Map2D.WarpMode": "shear", "Map2D.RenderBatch": 3}),
    "render_seam": (4, {"Map2D.WarpMode": "shear", "Map2D.RenderBatch": 3,
                        "Map2DRender.EnableSeam": 1}),
    "weighted": (1, {}),
    "gpu": (2, {}),
}


def _pose(x, y, yaw_deg, z=20.0):
    """Nadir camera (180 deg about x) at (x, y, z), turned by yaw."""
    th = np.deg2rad(yaw_deg) / 2.0
    return np.array([x, y, z, np.cos(th), np.sin(th), 0.0, 0.0])


POSES = [_pose(14, 14, 0), _pose(19, 14, 8), _pose(24, 15, -6),
         _pose(29, 18, 15), _pose(25, 22, -10)]


def _blur_np(g, sigma):
    r = int(np.ceil(3 * sigma))
    x = np.arange(-r, r + 1, dtype=np.float64)
    k = np.exp(-x * x / (2 * sigma * sigma))
    k /= k.sum()
    for ax in (0, 1):
        pad = [(0, 0)] * g.ndim
        pad[ax] = (r, r)
        p = np.pad(g, pad, mode="reflect")
        g = sum(w * np.take(p, np.arange(i, i + g.shape[ax]), axis=ax)
                for i, w in enumerate(k))
    return g


def _render(ground, pose):
    """The ground seen by the camera: bilinear, edge-clamped (numpy)."""
    cam = Camera(*CAM)
    h = jm.homography_canvas_to_image_np(pose, cam, (0.0, 0.0), GROUND_SCALE)
    hinv = np.linalg.inv(h)
    v, u = np.mgrid[0:cam.height, 0:cam.width].astype(np.float64)
    q = hinv @ np.stack([u.ravel(), v.ravel(), np.ones(u.size)])
    gx = np.clip(q[0] / q[2], 0, ground.shape[1] - 1.001)
    gy = np.clip(q[1] / q[2], 0, ground.shape[0] - 1.001)
    x0, y0 = np.floor(gx).astype(int), np.floor(gy).astype(int)
    fx, fy = (gx - x0)[:, None], (gy - y0)[:, None]
    out = (ground[y0, x0] * (1 - fx) * (1 - fy)
           + ground[y0, x0 + 1] * fx * (1 - fy)
           + ground[y0 + 1, x0] * (1 - fx) * fy
           + ground[y0 + 1, x0 + 1] * fx * fy)
    return out.reshape(cam.height, cam.width, 3).astype(np.float32)


@pytest.fixture(scope="module")
def world():
    rng = np.random.default_rng(1)
    g = _blur_np(rng.uniform(0, 255, (512, 512, 3)), 10.0)
    ground = np.clip(96 + (g - g.mean()) * 12.0, 16, 240).astype(np.float32)
    frames = [_render(ground, p) for p in POSES]
    # VO drift from frame 3 on: a random walk, 1.5 m a frame
    steps = np.random.default_rng(2).normal(0, 1.5, (len(POSES), 2))
    steps[:3] = 0.0
    drift = np.cumsum(steps, 0)
    drifted = [p.copy() for p in POSES]
    for p, d in zip(drifted, drift):
        p[:2] += d
    return frames, drifted


def _cfg(svar_cls, extra):
    s = svar_cls()
    s.set("Map2D.Scale", "0.5")
    s.set("Map2D.BandNumber", "3")
    for k, v in extra.items():
        s.set(k, str(v))
    return s


def _host(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _weights(engine):
    if hasattr(engine, "canvas_w"):
        return [_host(a) for a in engine.canvas_w]
    return [_host(engine.wsum)]


def _summary(engine):
    img, cov = engine.blended()
    return {"img": np.asarray(img), "cov": np.asarray(cov),
            "w": _weights(engine), "rendered": engine.frames_rendered,
            "skipped": engine.frames_skipped,
            "tiles": (engine.h_tiles, engine.w_tiles)}


def _jax_case(case, frames, drifted):
    """The JAX engine on its TPU path: every frame (with its state after
    K_CARRY frames), and, for the multiband and weighted cases, a drifted
    run refreshed to the true poses."""
    typ, extra = CASES[case]
    out = {}
    with pytest.MonkeyPatch.context() as mp, forced_tpu_path(mp):
        m = jmap.create_map2d(typ, _cfg(JSvar, extra))
        assert m.prepare(PLANE, JCamera(*CAM), [(None, p) for p in POSES])
        for i, (f, p) in enumerate(zip(frames, POSES)):
            if i == K_CARRY:
                out["state"] = convert.map2d_state_to_numpy(m)
            m.feed(f, p)
        out["all"] = _summary(m)
        if case in ("multiband", "weighted", "gpu"):
            m = jmap.create_map2d(typ, _cfg(JSvar, extra))
            assert m.prepare(PLANE, JCamera(*CAM),
                             [(None, p) for p in POSES])
            for f, p in zip(frames, drifted):
                m.feed(f, p)
            out["refed"] = m.refresh(list(zip(frames, drifted, POSES)))
            out["refresh"] = _summary(m)
    return out


class _Runs(dict):
    """The JAX runs of this module (of the test session), each computed
    when a test first asks for it."""

    def __init__(self, world, tmp_path_factory, worker_id):
        super().__init__()
        self.args = world, tmp_path_factory, worker_id

    def __missing__(self, case):
        (frames, drifted), tmp_path_factory, worker_id = self.args
        self[case] = once_per_session(
            f"jax_map2d_{case}", lambda: _jax_case(case, frames, drifted),
            tmp_path_factory, worker_id)
        return self[case]


@pytest.fixture(scope="module")
def jax_runs(world, tmp_path_factory, worker_id):
    return _Runs(world, tmp_path_factory, worker_id)


def _port(case, device="cpu"):
    typ, extra = CASES[case]
    return tmap.create_map2d(typ, _cfg(Svar, extra), device=device)


def _psnr(a, b, mask):
    d = (a.astype(np.float64) - b.astype(np.float64))[mask] ** 2
    return 10 * np.log10(255.0 ** 2 / max(d.mean(), 1e-20))


def _assert_same(t, j, ridge=0.0):
    """`ridge`: the share of a band's pixels (bands 1 and up) whose weight
    may differ by more than W_TOL."""
    assert t["tiles"] == j["tiles"]
    assert t["rendered"] == j["rendered"] and t["skipped"] == j["skipped"]
    np.testing.assert_array_equal(t["cov"], j["cov"])
    assert j["cov"].sum() > 4000      # more than one footprint (80x60 px)
    assert len(t["w"]) == len(j["w"])
    np.testing.assert_allclose(t["w"][0], j["w"][0], rtol=0, atol=W_TOL)
    for a, b in zip(t["w"][1:], j["w"][1:]):
        assert (np.abs(a - b) > W_TOL).mean() <= ridge
    assert _psnr(t["img"], j["img"], t["cov"] | j["cov"]) >= PSNR_MIN


@pytest.mark.parametrize("case", sorted(CASES))
def test_engine_matches_reference(case, world, jax_runs):
    frames, _ = world
    m = _port(case)
    assert m.prepare(PLANE, Camera(*CAM), [(None, p) for p in POSES])
    for f, p in zip(frames, POSES):
        assert m.feed(f, p)
    _assert_same(_summary(m), jax_runs[case]["all"],
                 SEAM_RIDGE if case == "render_seam" else 0.0)


@pytest.mark.parametrize("case", ["multiband", "weighted", "gpu"])
def test_refresh_matches_reference(case, world, jax_runs):
    """As tests/test_refresh.py: frames fed at drifted poses, then
    refreshed to the true ones."""
    frames, drifted = world
    m = _port(case)
    assert m.prepare(PLANE, Camera(*CAM), [(None, p) for p in POSES])
    for f, p in zip(frames, drifted):
        m.feed(f, p)
    refed = m.refresh(list(zip(frames, drifted, POSES)))
    assert refed == jax_runs[case]["refed"] > 0
    _assert_same(_summary(m), jax_runs[case]["refresh"])
    assert m.refresh([(f, p, p) for f, p in zip(frames, POSES)]) == 0


@pytest.mark.parametrize("case", ["multiband", "render", "weighted", "gpu"])
def test_convert_carries_a_reference_engine(case, world, jax_runs):
    """A JAX engine's state after K_CARRY frames (a RenderMap2D's with one
    frame pending), carried into a port engine that is fed the rest,
    matches the JAX engine fed every frame and a port engine fed every
    frame."""
    frames, _ = world
    state = convert.map2d_state_from_numpy(jax_runs[case]["state"], "cpu")
    if case == "render":
        assert len(state["pending"]) == 1
    m = convert.load_map2d_state(_port(case), state)
    for f, p in zip(frames[K_CARRY:], POSES[K_CARRY:]):
        m.feed(f, p)
    carried = _summary(m)
    _assert_same(carried, jax_runs[case]["all"])
    fresh = _port(case)
    assert fresh.prepare(PLANE, Camera(*CAM), [(None, p) for p in POSES])
    for f, p in zip(frames, POSES):
        fresh.feed(f, p)
    _assert_same(carried, _summary(fresh))


def test_convert_checks_dtypes(world, jax_runs):
    st = dict(jax_runs["multiband"]["state"])
    st["canvas_w"] = [a.astype(np.float64) for a in st["canvas_w"]]
    with pytest.raises(ValueError, match="float32"):
        convert.map2d_state_from_numpy(st, "cpu")
    state = convert.map2d_state_from_numpy(jax_runs["weighted"]["state"],
                                           "cpu")
    with pytest.raises(ValueError, match="canvas_lap"):
        convert.load_map2d_state(_port("multiband"), state)


@pytest.mark.parametrize("state_case, engine_case", [
    ("gpu", "weighted"), ("weighted", "gpu"), ("render", "multiband")])
def test_convert_refuses_another_engine_kind(state_case, engine_case, world,
                                            jax_runs):
    """Types 1 and 2 share the names acc/wsum but not their meaning (Type
    1's acc is the sum of weight times colour, Type 2's the blended
    colour), so a state loads only into an engine of its own Map2D.Type,
    bands and weight_type."""
    state = convert.map2d_state_from_numpy(jax_runs[state_case]["state"],
                                           "cpu")
    assert state["map2d_type"] == CASES[state_case][0]
    with pytest.raises(ValueError, match="does not take"):
        convert.load_map2d_state(_port(engine_case), state)


@pytest.mark.parametrize("case", ["weighted", "multiband"])
def test_convert_checks_the_canvas_against_the_tiles(case, world, jax_runs):
    state = convert.map2d_state_from_numpy(jax_runs[case]["state"], "cpu")
    state["w_tiles"] += 1
    with pytest.raises(ValueError, match="tiles"):
        convert.load_map2d_state(_port(case), state)


def test_canvas_growth_matches_reference(world):
    """A canvas prepared on the first frame only grows to take the rest
    (spreadMap): the Type 1 engine's geometry and result, the reference's
    on its own path."""
    frames, _ = world
    extra = CASES["weighted"][1]
    j = jmap.create_map2d(1, _cfg(JSvar, extra))
    t = _port("weighted")
    assert j.prepare(PLANE, JCamera(*CAM), [(None, POSES[0])])
    assert t.prepare(PLANE, Camera(*CAM), [(None, POSES[0])])
    tiles0 = (j.h_tiles, j.w_tiles)
    assert (t.h_tiles, t.w_tiles) == tiles0
    far = _pose(260.0, 240.0, 0.0)
    for f, p in zip(frames[:3], POSES[:2] + [far]):
        assert j.feed(f, p) and t.feed(f, p)
    assert j.h_tiles > tiles0[0] and j.w_tiles > tiles0[1]
    np.testing.assert_allclose(t.min_xy, j.min_xy, rtol=0, atol=1e-9)
    _assert_same(_summary(t), _summary(j))


def test_grow_canvas_exact():
    rng = np.random.default_rng(3)
    lap = [rng.normal(0, 9, (512 >> i, 256 >> i, 3)).astype(np.float32)
           for i in range(4)]
    w = [rng.uniform(0, 1, (512 >> i, 256 >> i, 1)).astype(np.float32)
         for i in range(4)]
    grow = jax.jit(jm.grow_canvas, static_argnums=(2, 3, 4))
    jl, jw = grow(lap, w, 3, 4, (1, 2))
    tl, tw = tm.grow_canvas([torch.from_numpy(a) for a in lap],
                            [torch.from_numpy(a) for a in w], 3, 4, (1, 2))
    for a, b in zip(tl + tw, list(jl) + list(jw)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_save_and_read_png_round_trip(world, tmp_path, monkeypatch):
    frames, _ = world
    m = _port("weighted")
    assert m.prepare(PLANE, Camera(*CAM), [(None, p) for p in POSES])
    for f, p in zip(frames[:3], POSES[:3]):
        m.feed(f, p)
    path = str(tmp_path / "result.png")
    assert m.save(path)
    img, cov = m.blended()
    back = tmap.read_png(path)
    ys, xs = np.nonzero(cov)
    y0, x0 = ys.min() // 256 * 256, xs.min() // 256 * 256
    crop = img[y0:ys.max() // 256 * 256 + 256,
               x0:xs.max() // 256 * 256 + 256].astype(np.uint8)
    np.testing.assert_array_equal(back, crop)
    np.testing.assert_array_equal(back, jmap.read_png(path))
    # a PNG from another encoder (PIL picks a filter for each row: Sub,
    # Up, Average, Paeth), read as the reference reads it
    from PIL import Image
    noisy = np.random.default_rng(4).integers(0, 256, (40, 50, 3),
                                              dtype=np.uint8)
    other = str(tmp_path / "other.png")
    Image.fromarray(np.cumsum(noisy, 1).astype(np.uint8)).save(
        other, optimize=True)
    ref = jmap.read_png(other)
    np.testing.assert_array_equal(tmap.read_png(other), ref)
    # and both again through the package's own decoder
    monkeypatch.setitem(sys.modules, "PIL", None)
    np.testing.assert_array_equal(tmap.read_png(path), crop)
    np.testing.assert_array_equal(tmap.read_png(other), ref)


_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
          (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))
_CHANS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


def _png_rows(a, depth):
    """Scanline bytes of samples a [h, w, c] at `depth` bits."""
    if depth >= 8:
        return [a[y].astype(">u2" if depth == 16 else np.uint8).tobytes()
                for y in range(a.shape[0])]
    per = 8 // depth
    shifts = np.array([8 - depth * (k + 1) for k in range(per)], np.uint8)
    rows = []
    for y in range(a.shape[0]):
        v = a[y].reshape(-1).astype(np.uint8)
        v = np.concatenate([v, np.zeros(-len(v) % per, np.uint8)])
        rows.append((v.reshape(-1, per) << shifts).sum(1).astype(
            np.uint8).tobytes())
    return rows


def _png_filter(rows, bpp, rng, filters):
    """Each scanline under a filter type drawn from rng among the first
    `filters` (PNG spec 9: None, Sub, Up, Average, Paeth)."""
    out, prev = [], bytes(len(rows[0]))
    for r in rows:
        t = int(rng.integers(0, filters))
        cur = np.frombuffer(r, np.uint8).astype(np.int32)
        up = np.frombuffer(prev, np.uint8).astype(np.int32)
        a = np.concatenate([np.zeros(bpp, np.int32), cur])[:len(cur)]
        c = np.concatenate([np.zeros(bpp, np.int32), up])[:len(cur)]
        p = a + up - c
        pa, pb, pc = abs(p - a), abs(p - up), abs(p - c)
        pred = [0, a, up, (a + up) // 2,
                np.where((pa <= pb) & (pa <= pc), a,
                         np.where(pb <= pc, up, c))][t]
        out.append(bytes([t]) + ((cur - pred) & 255).astype(
            np.uint8).tobytes())
        prev = r
    return out


def _write_test_png(path, a, depth, ctype, interlace, palette, seed,
                    filters):
    """A PNG of samples a [h, w, c], written by this test's own encoder."""
    rng = np.random.default_rng(seed)
    h, w = a.shape[:2]
    bpp = max(1, depth * _CHANS[ctype] // 8)
    raw = b""
    for x0, y0, dx, dy in (_ADAM7 if interlace else ((0, 0, 1, 1),)):
        sub = a[y0::dy, x0::dx]
        if sub.size:
            raw += b"".join(_png_filter(_png_rows(sub, depth), bpp, rng,
                                        filters))

    def chunk(tag, data):
        c = struct.pack(">I", len(data)) + tag + data
        return c + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF)

    png = b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(
        ">IIBBBBB", w, h, depth, ctype, 0, 0, interlace))
    if palette is not None:
        png += chunk(b"PLTE", palette.astype(np.uint8).tobytes())
        png += chunk(b"tRNS", bytes([0, 128]))
    png += chunk(b"IDAT", zlib.compress(raw)) + chunk(b"IEND", b"")
    with open(path, "wb") as f:
        f.write(png)


@pytest.mark.parametrize("pil", ["pil", "own_decoder"])
@pytest.mark.parametrize("depth, ctype, interlace, filters", [
    (8, 3, 0, 5), (4, 3, 1, 5), (2, 3, 0, 5), (1, 3, 0, 5),  # palette, tRNS
    (16, 2, 0, 5), (16, 0, 0, 5), (16, 6, 1, 5),             # 16-bit
    (8, 4, 0, 5), (16, 4, 0, 5),                             # gray + alpha
    (8, 2, 1, 5), (8, 6, 1, 5), (8, 0, 1, 5),                # Adam7
    (1, 0, 0, 5), (2, 0, 1, 5), (4, 0, 0, 5),                # low-bit gray
    (8, 2, 0, 3), (16, 6, 1, 3), (2, 3, 0, 3),   # None, Sub and Up rows only
], ids=lambda v: str(v))
def test_read_png_reads_what_the_reference_reads(depth, ctype, interlace,
                                                 filters, pil, tmp_path,
                                                 monkeypatch):
    rng = np.random.default_rng(depth * 10 + ctype)
    top = (1 << depth) - 1
    a = rng.integers(0, top + 1, (21, 19, _CHANS[ctype]))
    if depth == 16:     # 16-bit gray is clipped at 255 on the way to RGB
        a[0, :6, 0] = [0, 1, 100, 255, 256, 300]
    palette = (rng.integers(0, 256, (top + 1, 3)) if ctype == 3 else None)
    path = str(tmp_path / "t.png")
    _write_test_png(path, a, depth, ctype, interlace, palette, seed=depth,
                    filters=filters)
    ref = jmap.read_png(path)
    if pil == "own_decoder":
        monkeypatch.setitem(sys.modules, "PIL", None)
    got = tmap.read_png(path)
    assert got.dtype == np.uint8 and got.shape == (21, 19, 3)
    np.testing.assert_array_equal(got, ref)


def test_factory_and_defaults():
    for name, cls in (("3", tmap.MultiBandMap2D), ("4", tmap.RenderMap2D),
                      ("1", tmap.WeightedMap2D),
                      ("2", tmap.WeightedGPUMap2D),
                      ("multiband", tmap.MultiBandMap2D),
                      ("render", tmap.RenderMap2D)):
        m = tmap.create_map2d(name, _cfg(Svar, {}), device="cpu")
        assert type(m) is cls
    assert tmap.create_map2d(3, Svar(), device="cpu").warp_mode == "gather"
    assert tm.default_warp_mode("cuda") == "shear"


def test_create_map2d_defaults_to_cuda_and_raises_without_it():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is usable")
    with pytest.raises(RuntimeError, match="CUDA"):
        tmap.create_map2d(3, _cfg(Svar, {}))
    with pytest.raises(RuntimeError, match="CUDA"):
        tmap.create_map2d(1, _cfg(Svar, {}), device="cuda")


@pytest.mark.parametrize("name", ["svar", "registry"])
def test_host_copies_equal_their_originals(name):
    """core/svar.py and core/registry.py are copies of the reference's
    host-only modules: equal apart from import lines."""
    def body(pkg):
        with open(os.path.join(REPO, pkg, "core", f"{name}.py")) as f:
            return [ln for ln in f.read().splitlines()
                    if not ln.startswith(("import ", "from "))]
    assert body("pislamfusion_tpu_torch") == body("pislamfusion_tpu")
