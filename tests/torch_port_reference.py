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
import threading

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


class StartedOncePerSession:
    """A result computed once per test session, started now and read
    later: `start()` starts the work (a subprocess, say) and `read(handle)`
    waits for it and returns its result. Under pytest-xdist the first
    worker to set up takes the session's lock and starts the work; `get()`
    then reads it, pickles the result (or its error) into the session's
    shared temporary directory and frees the lock. Another worker's
    `get()` waits on the lock and loads the pickle (a module-scoped
    fixture alone is computed again by every worker that runs a test of
    the module). So a subprocess runs beside the caller's own work in
    between. `close()` (at the fixture's teardown) collects a result no
    test read."""

    def __init__(self, name, start, read, tmp_path_factory, worker_id):
        self._read, self._proc, self._lock = read, None, None
        self._value = self._path = None
        self._started = False       # this object started the work
        if worker_id == "master":
            self._proc, self._started = start(), True
            return
        from filelock import FileLock, Timeout
        self._path = tmp_path_factory.getbasetemp().parent / f"{name}.pkl"
        lock = FileLock(f"{self._path}.lock")
        try:
            lock.acquire(timeout=0)
        except Timeout:
            return                      # another worker runs it
        if self._path.is_file():
            lock.release()
            return
        try:
            self._proc, self._started = start(), True
        except BaseException:
            lock.release()
            raise
        self._lock = lock

    def get(self):
        if self._value is None and self._started:
            try:
                self._value = ("ok", self._read(self._proc))
            except Exception as e:      # every waiting worker fails alike
                self._value = ("error", repr(e))
            self._proc, self._started = None, False
            if self._lock is not None:
                with open(self._path, "wb") as f:
                    pickle.dump(self._value, f)
                self._lock.release()
                self._lock = None
        if self._value is None:
            from filelock import FileLock
            with FileLock(f"{self._path}.lock"):
                with open(self._path, "rb") as f:
                    self._value = pickle.load(f)
        kind, value = self._value
        if kind != "ok":
            raise AssertionError(f"the reference's run failed: {value}")
        return value

    def close(self):
        if self._started:
            try:
                self.get()
            except AssertionError:
                pass


def once_per_session(name, make, tmp_path_factory, worker_id):
    """make(), computed once per test session (StartedOncePerSession with a
    start that computes at once)."""
    return StartedOncePerSession(name, make, lambda value: value,
                                 tmp_path_factory, worker_id).get()


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


def jax_solver_chain(feats, poses, fx, W, H, iters=256, mh_iters=192,
                     ba_iters=10, seed=0, key=0, tol_run=True):
    """The JAX package's counterpart of `chip_smoke.solver_chain`, on the
    port's ORB features (`feats`: one dict of numpy arrays a frame, the
    port's `orb_detect` outputs), with the JAX package's own keys.

    Returns (results, draws): results in `solver_chain`'s layout (numpy
    and the JAX package's named tuples; `chip_smoke.chain_summary` reads
    them), and the sample indices and Gumbel noise each of its RANSACs
    drew, by `chip_smoke.Draws` name, so that the port's chain can be
    handed the same samples. tol_run=False skips BA's tol > 0 run (its
    results are then the tol = 0 run's)."""
    import jax
    import jax.numpy as jnp

    import chip_smoke
    from pislamfusion_tpu.core.camera import Camera
    from pislamfusion_tpu.core.svar import Svar
    from pislamfusion_tpu.models.initializers import create_initializer
    from pislamfusion_tpu.ops import ba, lie, matching, multih, ransac

    J = jnp.asarray
    K = len(feats)
    cam = Camera(W, H, fx, fx, W / 2.0, H / 2.0)
    sigma = 1.0 / fx
    fa, fb = feats[0], feats[-1]
    n = fa["xy"].shape[0]
    keys = jax.random.split(jax.random.PRNGKey(key), 5)
    draws, r = {}, {}

    def draw(name, k, valid, it, m):
        draws[name] = np.asarray(ransac._sample_indices(k, n, valid, it, m))

    idx, ok = matching.match_descriptors(J(fa["desc"]), J(fa["valid"]),
                                         J(fb["desc"]), J(fb["valid"]), "orb")
    ok = matching.rotation_consistency_mask(J(fa["angle"]), J(fb["angle"]),
                                            idx, ok)
    r["idx"], r["ok"] = idx, ok
    ra = cam.unproject(J(fa["xy"]))
    rb = cam.unproject(J(fb["xy"])[jnp.where(ok, idx, 0)])
    cfg = Svar()
    cfg.set("Initializer", "svd")
    cfg.set("Initializer.RansacIters", str(iters))
    ka, kb = jax.random.split(keys[0])
    draw("init_h", ka, ok, iters, 4)
    draw("init_f", kb, ok, iters, 8)
    r["svd"] = create_initializer(cfg)(keys[0], ra[:, :2], rb[:, :2], ok,
                                       sigma)
    cfg.set("Initializer", "opt")
    r["opt"] = create_initializer(cfg)(keys[1], ra[:, :2], rb[:, :2], ok,
                                       sigma)
    P = J(np.asarray(poses, np.float32))
    X, depth = ransac.triangulate(P[0], P[-1], ra, rb)
    cosp = ransac.parallax_cos(P[0], P[-1], X)
    tri = (ok & (depth > 0) & jnp.all(jnp.isfinite(X), -1) & (cosp > 0)
           & (cosp < 0.99998))
    X = jnp.where(tri[:, None], X, 0.0)
    r["X"], r["tri"] = X, tri
    draw("plane", keys[2], tri, iters, 3)
    r["plane"] = ransac.find_plane(keys[2], X, tri, 1.0, iters)
    r["pnp"], obs_uv, obs_w = [], [ra[:, :2]], [tri]
    for i in range(1, K - 1):
        fi = feats[i]
        idx_i, ok_i = matching.match_descriptors(
            J(fa["desc"]), J(fa["valid"]) & tri, J(fi["desc"]),
            J(fi["valid"]), "orb")
        p2n = cam.unproject(J(fi["xy"])[jnp.where(ok_i, idx_i, 0)])[:, :2]
        k = jax.random.fold_in(keys[3], i)
        k1, k2 = jax.random.split(k)
        draw(f"pnp{i}_6", k1, ok_i, iters // 2, 6)
        draw(f"pnp{i}_4", k2, ok_i, iters - iters // 2, 4)
        r["pnp"].append(ransac.find_pnp(k, X, p2n, ok_i, iters=iters))
        obs_uv.append(p2n)
        obs_w.append(ok_i)
    obs_uv.append(rb[:, :2])
    obs_w.append(tri)
    dpose, dX = chip_smoke.ba_start(np.random.default_rng(seed), K, n)
    T0 = lie.se3_mul(lie.se3_exp(J(dpose)), lie.se3_inv(P))
    prob = ba.make_problem(
        T0, np.arange(K) == 0, X + J(dX) * tri[:, None], ~tri,
        np.repeat(np.arange(K), n), np.tile(np.arange(n), K),
        jnp.concatenate(obs_uv), jnp.concatenate(obs_w).astype(jnp.float32))
    hd = float(np.sqrt(5.991) / fx)
    r["ba_cost0"] = jax.jit(ba._total_cost, static_argnums=1)(prob, hd)
    r["ba"] = ba.optimize(prob, iters=ba_iters, huber_delta=hd)
    r["ba_tol"] = ba.optimize(prob, iters=3 * ba_iters, huber_delta=hd,
                              tol=1e-4) if tol_run else r["ba"]
    r["sim3"] = ba.fit_sim3(lie.se3_inv(r["ba"][0]), P)
    draws["multih"] = np.stack([
        np.asarray(jax.random.gumbel(k, (mh_iters, n)))
        for k in jax.random.split(keys[4], 4)])
    r["multih"] = multih.match_multih(
        keys[4], J(fa["desc"]), J(fa["valid"]), J(fa["xy"]), J(fb["desc"]),
        J(fb["valid"]), J(fb["xy"]), n_h=4, ransac_iters=mh_iters)
    return r, draws


SLAM_CAM = (320, 240, 260.0, 260.0, 160.0, 120.0)
SLAM_STAGE_FRAME = 3     # the second keyframe after the two-view set-up


def slam_survey_frames(n=None):
    """tests/test_slam.py's survey (seed 11, 320x240, 36 nadir frames),
    rendered by the port's warp on the CPU (equal to the JAX package's
    render_view): (frames [K, 240, 320, 3] float32, true poses [K, 7])."""
    import chip_smoke
    from pislamfusion_tpu_torch.core.camera import Camera
    ground = torch.from_numpy(chip_smoke.survey_ground(
        np.random.default_rng(11)))
    cam = Camera(*SLAM_CAM)
    poses = chip_smoke.survey_poses()[:n]
    frames = np.stack([chip_smoke.survey_view(ground, cam, p).numpy()
                       for p in poses])
    return frames, poses


def _survey_view_at(pose):
    """The survey's view [240, 320, 3] float32 (numpy) from `pose`."""
    import chip_smoke
    from pislamfusion_tpu_torch.core.camera import Camera
    ground = torch.from_numpy(chip_smoke.survey_ground(
        np.random.default_rng(11)))
    return chip_smoke.survey_view(ground, Camera(*SLAM_CAM), pose).numpy()


def _jax_cfg():
    from pislamfusion_tpu.core.svar import Svar
    import chip_smoke
    cfg = Svar()
    for k, v in chip_smoke.slam_survey_cfg()._data.items():
        cfg.set(k, v)
    return cfg


def jax_slam_capture():
    """ONE short run of the JAX package's SLAM on the CPU over frames 0-3
    of the survey (tests/test_slam.py's config; frame 3 is the second
    keyframe after the two-view set-up), with what the port's stage tests
    start from and compare with, all numpy:

    - "frames", "poses": the frames and true poses;
    - "before": `convert.worldmap_to_numpy` of the SLAM before frame 3;
    - "track": frame 3's fused tracking step, its inputs (the frame's
      features, the last frame's descriptors, aux, the staged local map)
      and the JAX outputs of `fused_track_packed_feats` and
      `fused_localmap_step` (from the first LM's bindings);
    - "new_points": the map before frame 3's triangulation sweep, the
      mapper's keyframe count and the points it created (kp -> position);
    - "windows": every local BA window solved (arguments and results);
    - "after": the SLAM after frame 3, its map saved as .maphash bytes;
    - "close": `LoopCloserSE3Graph._close` on the after-map (frame 3 onto
      keyframe 0 with a given correction): poses and points after;
    - "gps": `Mapper.fit_gps_all` on the after-map with each keyframe's
      true centre as its ENU fix: poses after, and the fit's rms;
    - "ransac_pnp": `TrackerRansacPnP._track_last_frame`, before frame 3,
      of the features of a view 1 m on from the tracker's last frame: the
      features, its result, pose, bindings and inliers (its pose LM on the
      PnP inliers, as the port's), and the sample indices its PnP RANSAC
      drew (6- and 4-point hypotheses)."""
    import tempfile

    import jax.numpy as jnp
    from pislamfusion_tpu.core.camera import Camera
    from pislamfusion_tpu.models import mapper as jm
    from pislamfusion_tpu.models import pipeline as jp
    from pislamfusion_tpu.models.loopclose import LoopCloserSE3Graph
    from pislamfusion_tpu.models.slam import create_slam
    from pislamfusion_tpu.models.worldmap import WorldMap
    from pislamfusion_tpu.utils import host_se3 as hse3
    from pislamfusion_tpu_torch import convert

    frames, poses = slam_survey_frames(SLAM_STAGE_FRAME + 1)
    cfg = _jax_cfg()
    slam = create_slam(cfg, Camera(*SLAM_CAM))
    out = {"frames": frames, "poses": poses, "windows": []}
    solve = jm.Mapper.solve_local_window

    def record_window(*a, **k):
        res = solve(*a, **k)
        kw = {n: k[n] for n in ("iters", "huber_delta", "tol", "prior_kw")
              if n in k}
        out["windows"].append((a[:7], kw, res))
        return res

    jm.Mapper.solve_local_window = staticmethod(record_window)
    try:
        for i in range(SLAM_STAGE_FRAME):
            slam.track(frames[i], float(i))
        out["before"] = convert.worldmap_to_numpy(slam)
        tr, mapper = slam.tracker, slam.mapper
        # frame 3's fused step, from the tracker's own inputs
        last = tr.last_frame
        if tr._local_stage is None:
            tr._stage_local_map()
        lpos, ldesc, lvalid, ids_p = tr._local_stage
        pos, has = tr._gather_frame_points(last)
        T_pred = hse3.se3_inv(hse3.se3_mul(last.pose_c2w, tr.motion))
        aux = np.concatenate([pos.reshape(-1), has.astype(np.float32),
                              np.asarray(T_pred, np.float32)]).astype(
                                  np.float32)
        feats = jp.fused_extract(jnp.asarray(frames[SLAM_STAGE_FRAME]),
                                 tr.detector.params)
        cam = last.camera
        geo = dict(fx=cam.fx, fy=cam.fy, cx=cam.cx, cy=cam.cy,
                   width=cam.width, height=cam.height)
        packed = jp.fused_track_packed_feats(
            feats, jnp.asarray(last.desc), jnp.asarray(last.valid),
            jnp.asarray(aux), lpos, ldesc, lvalid, radius=20.0,
            radius_local=8.0, chi2_th=5.991, **geo)
        # the first LM's bindings, read from the packed row (layout:
        # pipeline.fused_track_packed_feats)
        n = last.n_kp
        pk = np.asarray(packed)
        a = pk[16:16 + 6 * n].reshape(6, n)
        idx, ok = a[0].astype(np.int64), a[1] > 0.5
        p3d_cur = np.zeros((n, 3), np.float32)
        p3d_cur[idx[ok]] = pos[ok]
        w_cur = a[3] * (a[2] < 5.991 / cam.fx ** 2)
        lm = jp.fused_localmap_step(
            feats["desc"], feats["valid"], feats["xy"], jnp.asarray(pk[:7]),
            jnp.asarray(p3d_cur), jnp.asarray(w_cur, jnp.float32), lpos,
            ldesc, lvalid, radius=8.0, chi2_th=5.991, **geo)
        # a view 1 m on from the last frame (frame 3 is 3 m on: outside
        # ransacPnP's window of 0.05 of the width around the last pixels)
        near = _survey_view_at(poses[SLAM_STAGE_FRAME - 1]
                               + np.array([1.0, 0, 0, 0, 0, 0, 0]))
        near_feats = jp.fused_extract(jnp.asarray(near), tr.detector.params)
        out["ransac_pnp"] = _jax_ransac_pnp_step(
            slam, cfg, {k: np.asarray(v) for k, v in near_feats.items()},
            SLAM_STAGE_FRAME)
        out["track"] = {
            "feats": {k: np.asarray(v) for k, v in feats.items()},
            "last_desc": np.asarray(last.desc),
            "last_valid": np.asarray(last.valid), "aux": aux,
            "lpos": np.asarray(lpos), "ldesc": np.asarray(ldesc),
            "lvalid": np.asarray(lvalid), "geo": geo,
            "packed": pk,
            "p3d_cur": p3d_cur, "w_cur": w_cur.astype(np.float32),
            "lm": [np.asarray(x) for x in lm]}
        # frame 3's triangulation sweep: the map it starts from, and what
        # it creates
        dispatch, commit = mapper._new_points_dispatch, \
            mapper._new_points_commit

        def spy_dispatch(frame, fd=None):
            out["new_points"] = {
                "map": convert.worldmap_to_numpy(mapper.map),
                "frame": frame.id, "kf_count": mapper._kf_count}
            return dispatch(frame, fd)

        def spy_commit(frame, neighbors, fetched):
            before = frame.kp2mp.copy()
            created = commit(frame, neighbors, fetched)
            kp = np.nonzero((before < 0) & (frame.kp2mp >= 0))[0]
            out["new_points"]["created"] = created
            out["new_points"]["kp"] = {
                int(k): np.array(mapper.map.point(int(
                    frame.kp2mp[k])).position) for k in kp}
            return created

        mapper._new_points_dispatch = spy_dispatch
        mapper._new_points_commit = spy_commit
        slam.track(frames[SLAM_STAGE_FRAME], float(SLAM_STAGE_FRAME))
    finally:
        jm.Mapper.solve_local_window = staticmethod(solve)
    out["after"] = convert.worldmap_to_numpy(slam)
    with tempfile.TemporaryDirectory() as d:
        slam.map.save(f"{d}/map.maphash")
        with open(f"{d}/map.maphash", "rb") as f:
            out["maphash"] = f.read()
        slam.map.save(f"{d}/map.npz")

        def clone():
            m = WorldMap()
            assert m.load(f"{d}/map.npz")
            return m
        m = clone()
        kfs = m.keyframes()
        T_corr = np.array(kfs[-1].pose_c2w, np.float32)
        T_corr[:3] += np.array([0.05, -0.03, 0.02], np.float32)
        close_cfg = _jax_cfg()
        close_cfg.set("SLAM.LoopGraphDenseMax", "0")   # the CG solver
        LoopCloserSE3Graph(m, close_cfg)._close(kfs[-1], kfs[0].id, T_corr)
        out["close"] = {"T_corr": T_corr, "poses": {
            f.id: np.array(f.pose_c2w) for f in m.keyframes()},
            "points": {p.id: np.array(p.position) for p in m.points()}}
        m = clone()
        for f in m.keyframes():
            f.gps_enu = poses[f.id][:3].astype(np.float32)
        mp = jm.Mapper(m, cfg)
        ok = mp.fit_gps_all(min_frames=3)
        out["gps"] = {"ok": ok, "rms": mp.last_gps_fit_rms, "poses": {
            f.id: np.array(f.pose_c2w) for f in m.keyframes()}}
    return out


def _jax_ransac_pnp_step(slam, cfg, feats, fid):
    """The JAX package's `TrackerRansacPnP._track_last_frame` of a frame
    with the host features `feats` against `slam`'s last frame, on its map
    (read only), recording the indices its PnP RANSAC draws. Its pose LM
    fits the PnP inliers, as the port's does (the JAX package fits every
    match: ROADMAP queue 3)."""
    from pislamfusion_tpu.models import tracker as jt
    from pislamfusion_tpu.models.frame import Frame
    from pislamfusion_tpu.ops import ransac as jr
    import jax
    last = slam.tracker.last_frame
    tr = jt.TrackerRansacPnP(slam.map, cfg)
    tr.last_frame = last
    frame = Frame(id=fid, timestamp=float(fid), camera=last.camera)
    frame.set_features(feats, last.desc_kind)
    draws = []
    find_pnp = jr.find_pnp

    def spy(key, p3d, p2n, valid, **kw):
        k1, k2 = jax.random.split(key)
        n, iters = p3d.shape[0], kw.get("iters", 256)
        draws.append((np.asarray(jr._sample_indices(k1, n, valid,
                                                     iters // 2, 6)),
                      np.asarray(jr._sample_indices(k2, n, valid,
                                                     iters - iters // 2, 4))))
        res = find_pnp(key, p3d, p2n, valid, **kw)
        inliers.append(np.asarray(res.inliers))
        return res

    inliers = []
    solve_pose = tr._solve_pose

    def on_the_inliers(frame, T_init_c2w, pos, has, idxn, okn, src_frame):
        okn = okn & inliers[-1][np.where(okn, idxn, 0)]
        return solve_pose(frame, T_init_c2w, pos, has, idxn, okn, src_frame)

    tr._solve_pose = on_the_inliers
    jr.find_pnp = spy
    try:
        ok = tr._track_last_frame(frame)
    finally:
        jr.find_pnp = find_pnp
    return {"feats": feats, "ok": ok, "pose": np.array(frame.pose_c2w),
            "kp2mp": np.array(frame.kp2mp), "draws": draws,
            "n_inliers": getattr(tr, "_n_inliers", 0)}


def chain_scene():
    """tests/test_track_chain.py's synthetic scene (rng 0: 64 points, five
    frames strafing in x, 64 slots a frame) as numpy: (the K=4 chain's
    inputs, the fused_track_chain keywords)."""
    import test_track_chain as ttc
    rng = np.random.default_rng(0)
    n, P, K = 64, 96, 4
    pts, desc, poses = ttc._make_scene(rng)
    feats = []
    for pose in poses:
        f, _ = ttc._frame_feats(rng, pts, desc, pose, n)
        feats.append({k: np.asarray(v) for k, v in f.items()})
    lpos = np.zeros((P, 3), np.float32)
    lpos[:len(pts)] = pts
    ldesc = np.zeros((P, 32), np.uint8)
    ldesc[:len(pts)] = desc
    lvalid = np.zeros(P, bool)
    lvalid[:len(pts)] = True
    f0, slot_of = ttc._frame_feats(rng, pts, desc, poses[0], n)
    prev_p3d = np.zeros((n, 3), np.float32)
    prev_has = np.zeros(n, bool)
    for i, s in enumerate(slot_of):
        if s >= 0:
            prev_p3d[s] = pts[i]
            prev_has[s] = True
    aux = np.concatenate([prev_p3d.reshape(-1), prev_has.astype(np.float32),
                          poses[0], np.array([0, 0, 0, 0, 0, 0, 1.0])]
                         ).astype(np.float32)
    inputs = {"desc_k": np.stack([feats[k]["desc"] for k in range(1, K + 1)]),
              "valid_k": np.stack([feats[k]["valid"]
                                   for k in range(1, K + 1)]),
              "xy_k": np.stack([feats[k]["xy"] for k in range(1, K + 1)]),
              "prev_desc": np.asarray(f0["desc"]),
              "prev_valid": np.asarray(f0["valid"]), "aux": aux,
              "local_pos": lpos, "local_desc": ldesc, "local_valid": lvalid}
    kw = dict(fx=ttc.FX, fy=ttc.FY, cx=ttc.CX, cy=ttc.CY, width=ttc.W,
              height=ttc.H, radius=ttc.RADIUS, radius_local=ttc.R_LOCAL,
              chi2_th=ttc.CHI2)
    return inputs, kw, np.stack(poses)


def jax_chain_capture():
    """The JAX package's `fused_track_chain` (jitted, on this thread) on
    `chain_scene`'s inputs: (inputs, keywords, poses, rows [K, ...])."""
    import jax.numpy as jnp
    from pislamfusion_tpu.models import pipeline as jp
    inputs, kw, poses = chain_scene()
    rows = jp.fused_track_chain(
        *[jnp.asarray(inputs[k]) for k in (
            "desc_k", "valid_k", "xy_k", "prev_desc", "prev_valid", "aux",
            "local_pos", "local_desc", "local_valid")], **kw)
    return inputs, kw, poses, np.asarray(rows)


class LaggedPool:
    """The mapper's one-worker pool (`core.messenger.ThreadPool`) replaced
    by a fixed schedule: a keyframe's job runs on the tracking thread just
    before the frame `lag` frames after it is tracked, so the tracker runs
    `lag` frames ahead of its mapper and a keyframe skips its local BA (the
    reference's _abordBundle) exactly when a newer keyframe came within
    those frames. `pending()` (read only by `Mapper.finish`, after the
    tracking thread ended) runs what is left. A job that raises is counted
    in `errors`, as the pool's future would hold it."""

    def __init__(self, lag):
        self.lag, self.jobs, self.errors = lag, [], 0
        self.tracked = threading.Semaphore(0)

    def add(self, fn, frame, *args):
        self.jobs.append((frame.id, fn, (frame, *args)))

    def run_due(self, fid):
        while self.jobs and self.jobs[0][0] + self.lag <= fid:
            self._run(self.jobs.pop(0))

    def _run(self, job):
        try:
            job[1](*job[2])
        except Exception:                                  # noqa: BLE001
            self.errors += 1

    def pending(self):
        while self.jobs:
            self._run(self.jobs.pop(0))
        return 0


@contextlib.contextmanager
def lagged_mapper(messenger_module, slam_class, lag, pool_class=LaggedPool):
    """Online SLAM (either package: its `core.messenger` module and `SLAM`
    class) with a `pool_class` (a `LaggedPool`) as the mapper's pool.
    `SLAM._track_one` runs the jobs due before each frame and releases the
    pool's `tracked` semaphore after it, so that a feeder can wait for each
    frame."""
    thread_pool, track_one = messenger_module.ThreadPool, slam_class._track_one

    def tracked_one(self, frame):
        pool = self.mapper._pool
        pool.run_due(frame.id)
        try:
            return track_one(self, frame)
        finally:
            pool.tracked.release()

    messenger_module.ThreadPool = lambda workers=1: pool_class(lag)
    slam_class._track_one = tracked_one
    try:
        yield
    finally:
        messenger_module.ThreadPool = thread_pool
        slam_class._track_one = track_one


@contextlib.contextmanager
def reference_pose_fit(tracker_class):
    """The port's tracker (`tracker_class`) with the JAX package's
    relocalization pose fit: `_solve_pose` fits every match, not only the
    PnP-RANSAC inliers `_track_ref_kf` hands it (ROADMAP queue 3), so that a
    run that relocalizes can be held to the JAX package's."""
    solve_pose = tracker_class._solve_pose

    def fit_every_match(self, frame, T_init_c2w, pos, has, idxn, okn,
                        src_frame, inliers=None):
        return solve_pose(self, frame, T_init_c2w, pos, has, idxn, okn,
                          src_frame)

    tracker_class._solve_pose = fit_every_match
    try:
        yield
    finally:
        tracker_class._solve_pose = solve_pose


# tests/test_soak.py:91-121's online liveness run (40 frames 1.8 m apart,
# loop closing, noisy GPS)
STARVED_CFG = (("FeatureDetector", "ORB"), ("SLAM.nFeature", "500"),
               ("SLAM.MaxOverlap", "0.9"), ("SLAM.LoopClose", "1"),
               ("SLAM.isOnline", "1"), ("SLAM.BAFrameCap", "8"),
               ("SLAM.BAPointCap", "1024"), ("SLAM.BAObsCap", "4096"),
               ("SLAM.LocalBAIters", "6"), ("GPS.MinFrames2Fit", "5"))
STARVED_ORIGIN = (116.0, 40.0, 0.0)


def starved_scene():
    """tests/test_soak.py:91-121's scene, rendered by the port's warp on
    the CPU: (frames, true poses, GPS fixes (lon, lat, alt)) from rng 5."""
    import chip_smoke
    from pislamfusion_tpu_torch.core.camera import Camera
    from pislamfusion_tpu_torch.core.gps import LocalFrame
    rng = np.random.default_rng(5)
    ground = torch.from_numpy(chip_smoke.survey_ground(rng))
    cam = Camera(*SLAM_CAM)
    poses = np.stack([np.array([26.0 + 1.8 * i, 36.0, 25.0, 1.0, 0, 0, 0])
                      for i in range(40)])
    frames = [chip_smoke.survey_view(ground, cam, p).numpy() for p in poses]
    local = LocalFrame(*STARVED_ORIGIN)
    fixes = [local.local_to_lla(p[:3] + rng.normal(0, 0.4, 3))
             for p in poses]
    return frames, poses, fixes


def starved_run(slam, scene, local_frame, finish, join_s=60.0):
    """Feed the scene to an online `slam` made under `lagged_mapper`, one
    frame at a time (each tracked before the next is fed), then `finish()`
    (whether the SLAM's threads ended).
    Returns what the test compares: frames tracked and counted, the
    keyframe ids, and the keyframes' geo ATE (their centres against the
    truth in the SLAM's ENU frame, tests/test_soak.py:70-77's measure),
    GPS fitted, loops closed, points, errors."""
    frames, poses, fixes = scene
    for i, img in enumerate(frames):
        slam.track(img, float(i), gps_lla=fixes[i], gps_acc=0.5)
        if not slam.mapper._pool.tracked.acquire(timeout=join_s):
            raise AssertionError(f"frame {i} not tracked within {join_s} s")
    done = finish()
    kfs = slam.map.keyframes()
    est = np.stack([f.pose_c2w[:3] for f in kfs])
    gt = np.stack([slam._local_frame.to_local(
        *local_frame.local_to_lla(poses[f.id][:3])) for f in kfs])
    return {"tracked": int(slam.frames_tracked),
            "total": int(slam.frames_total),
            "keyframes": [int(f.id) for f in kfs],
            "geo_ate": float(np.sqrt(np.mean(np.sum((est - gt) ** 2, -1)))),
            "gps_fitted": bool(slam.mapper.gps_fitted),
            "closed": int(slam.loop_closer.closed_loops),
            "points": int(slam.map.point_num()),
            "errors": int(slam.track_errors + slam.mapper._pool.errors),
            "finished": done}


def jax_starved_runs(lags):
    """The JAX package's online SLAM on `starved_scene` under
    `lagged_mapper` at each lag: {lag: starved_run's dict}."""
    import importlib
    from pislamfusion_tpu.core.camera import Camera
    from pislamfusion_tpu.core.gps import LocalFrame
    from pislamfusion_tpu.core.svar import Svar
    from pislamfusion_tpu.models import slam as js
    messenger = importlib.import_module("pislamfusion_tpu.core.messenger")
    scene = starved_scene()
    out = {}
    for lag in lags:
        cfg = Svar()
        for k, v in STARVED_CFG:
            cfg.set(k, v)
        with lagged_mapper(messenger, js.SLAM, lag):
            slam = js.create_slam(cfg, Camera(*SLAM_CAM))
            out[lag] = starved_run(
                slam, scene, LocalFrame(*STARVED_ORIGIN),
                lambda: slam.finish() or not slam._worker.is_alive())
    return out


def _main(argv):
    """PYTHONPATH=. python tests/torch_port_reference.py solver-chain
    FILE.npz (from the repository root): the JAX package's solver chain,
    on the CPU, on the features and poses that
    scripts/torch_solver_chain.py saved, with its errors against the true
    poses (the port's runs on the same features are in that script's
    output).

    PYTHONPATH=. python tests/torch_port_reference.py slam-survey: the JAX
    package's SLAM over tests/test_slam.py's survey (the frames of
    `slam_survey_frames`), its frames tracked, keyframes and ATE against
    the truth (the port's, on the CPU at several thread counts:
    scripts/torch_slam_spread.py).

    PYTHONPATH=.:tests python tests/torch_port_reference.py online-starved
    LAG [LAG ...]: `jax_starved_runs` at each lag, one JSON line."""
    import jax
    jax.config.update("jax_platforms", "cpu")
    import chip_smoke
    if argv == ["slam-survey"]:
        return _jax_slam_survey()
    if argv[:1] == ["online-starved"]:
        import json
        from pislamfusion_tpu.core.jaxcache import enable_persistent_cache
        enable_persistent_cache()
        print(json.dumps(jax_starved_runs([int(a) for a in argv[1:]])))
        return None
    if len(argv) != 2 or argv[0] != "solver-chain":
        raise SystemExit(_main.__doc__)
    z = np.load(argv[1])
    K = int(z["K"])
    feats = [{k: z[f"{k}{i}"] for k in ("xy", "angle", "desc", "valid")}
             for i in range(K)]
    poses = z["poses"]
    r, _ = jax_solver_chain(feats, poses, float(z["fx"]), int(z["W"]),
                            int(z["H"]), int(z["iters"]), int(z["mh_iters"]),
                            int(z["ba_iters"]))
    s = chip_smoke.chain_summary(r, poses)
    print("JAX package's chain (CPU) on the port's features: "
          + chip_smoke.chain_line(s))


def _jax_slam_survey():
    import chip_smoke
    from pislamfusion_tpu.core.camera import Camera
    from pislamfusion_tpu.models.slam import create_slam
    frames, gt = slam_survey_frames()
    slam = create_slam(_jax_cfg(), Camera(*SLAM_CAM))
    for i, img in enumerate(frames):
        slam.track(img, float(i))
    ate, span, _ = chip_smoke.slam_ate(slam, gt)
    print(f"JAX package's SLAM (CPU) over the survey: tracked "
          f"{slam.frames_tracked}/{slam.frames_total}, keyframes "
          f"{len(slam.map.keyframes())}, ATE {ate / span * 100:.3f} % of "
          f"the span")


if __name__ == "__main__":
    import sys
    _main(sys.argv[1:])
