"""Runs behind ROADMAP.md queue 3's faults of both packages, for either
package on the CPU, each printing one JSON line a run (from the repository
root; both packages on the same frames, rendered by the port's warp):

    PYTHONPATH=.:tests:scripts python tests/torch_e2e_faults.py CMD ...

- `starved {port|jax} [--no-skip] LAG ...`: tests/test_soak.py:91-121's
  online run with the mapper `lag` frames behind the tracker
  (`torch_port_reference.lagged_mapper`); `--no-skip` runs every
  keyframe's local BA (the _abordBundle skip off).
- `soak {port|jax} SEED ...`: tests/test_soak.py:27's SLAM (offline,
  everything on; its FusionSystem consumer reads the SLAM's queue and
  writes nothing back, so it is left out) with the loop closer's RANSAC
  seeded SEED (the JAX package's key, the port's threefry.Key of it; 7 is
  each package's own): tracked, the frames lost, the keyframe geo ATE
  against its 2 m bar, and every closure's frame, keyframe and corrected
  position's distance from the truth.
- `pnp-rates N`: the port's soak (seed 7) up to frame 28, where its loop
  closer verifies a wrong closure; each PnP of that verification run
  again on the same inputs under N seeds in both packages: the share that
  passes the closer's bar (ok and 25 inliers or more).
- `sequence {port|jax} SEED ...`: tests/test_real_sequence.py:82 with the
  loop closer seeded SEED: each of its bars' values.
- `continue N`: the JAX package's soak made to take the wrong frame-28
  closure (the first key whose PnP passes on kf 0), then continued from
  its state after frame 28 by itself and by the port under N seeds
  (`convert.load_worldmap_state`): tracked frames 29-79, keyframe geo
  ATE, closures taken after frame 28.
- `summary FILE ...`: the `soak` lines of FILEs by package: runs, geo-bar
  misses, first closures wrong (over 10 m from the truth), and Fisher's
  exact test and the Mann-Whitney test on the geo ATEs between packages.
"""
import contextlib
import importlib
import json
import os
import sys
import tempfile

import numpy as np
import torch

import torch_e2e_scenes as E
from pislamfusion_tpu_torch.ops import threefry
from torch_port_reference import (SLAM_CAM, STARVED_CFG, STARVED_ORIGIN,
                                  LaggedPool, lagged_mapper, starved_run,
                                  starved_scene)

SOAK_CFG = (("FeatureDetector", "ORB"), ("SLAM.nFeature", "500"),
            ("SLAM.MaxOverlap", "0.9"), ("SLAM.LoopClose", "1"),
            ("SLAM.isOnline", "0"), ("SLAM.BAFrameCap", "8"),
            ("SLAM.BAPointCap", "1024"), ("SLAM.BAObsCap", "4096"),
            ("SLAM.LocalBAIters", "6"), ("Plane.MinPoints", "400"),
            ("GPS.MinFrames2Fit", "5"))
LOOP_MIN_INLIERS = 25.0     # LoopCloser.MinInliers' default


def _pkg(name):
    """(package module name, create_slam(cfg, cam))."""
    root = "pislamfusion_tpu_torch" if name == "port" else "pislamfusion_tpu"
    slam = importlib.import_module(f"{root}.models.slam")
    if name == "port":
        return root, lambda cfg, cam: slam.create_slam(cfg, cam,
                                                       device="cpu")
    return root, slam.create_slam


def _mod(root, name):
    return importlib.import_module(f"{root}.{name}")


def _cfg(root, items):
    cfg = _mod(root, "core.svar").Svar()
    for k, v in items:
        cfg.set(k, v)
    return cfg


@contextlib.contextmanager
def seeded_closer(root, seed, closes):
    """The loop closer's RANSAC seeded `seed`; each closure appended to
    `closes` as (frame, keyframe id, corrected c2w pose)."""
    lc = _mod(root, "models.loopclose").LoopCloserSE3Graph
    init, close = lc.__init__, lc._close

    def seeded(self, *a, **k):
        init(self, *a, **k)
        if root == "pislamfusion_tpu":
            import jax
            self._key = jax.random.PRNGKey(seed)
        else:
            self._key = threefry.Key(seed)

    def recorded(self, frame, kf_id, T):
        closes.append((frame, int(kf_id), np.array(T, np.float64)))
        return close(self, frame, kf_id, T)

    lc.__init__, lc._close = seeded, recorded
    try:
        yield
    finally:
        lc.__init__, lc._close = init, close


class _NoSkipPool(LaggedPool):
    def _run(self, job):
        frame, _ = job[2]
        super()._run((job[0], job[1], (frame, 0)))


def starved(name, lags, no_skip):
    root, create = _pkg(name)
    messenger = _mod(root, "core.messenger")
    slam_cls = _mod(root, "models.slam").SLAM
    Camera, LocalFrame = (_mod(root, "core.camera").Camera,
                          _mod(root, "core.gps").LocalFrame)
    scene = starved_scene()
    for lag in lags:
        with lagged_mapper(messenger, slam_cls, lag,
                           _NoSkipPool if no_skip else LaggedPool):
            slam = create(_cfg(root, STARVED_CFG), Camera(*SLAM_CAM))
            r = starved_run(slam, scene, LocalFrame(*STARVED_ORIGIN),
                            lambda: slam.finish() is not False)
        print(json.dumps({"package": name, "lag": lag, "no_skip": no_skip,
                          **r}), flush=True)


def _soak_scene():
    """tests/test_soak.py:27's frames (the port's warp) and GPS fixes."""
    from pislamfusion_tpu_torch.core.gps import LocalFrame
    rng = np.random.default_rng(21)
    ground = torch.from_numpy(E.survey_ground(rng))
    cam = E._camera()
    poses = E.soak_poses()
    local = LocalFrame(116.0, 40.0, 0.0)
    frames, fixes = [], []
    for p in poses:
        frames.append(E.render_view(ground, cam, p))
        fixes.append(local.local_to_lla(p[:3] + rng.normal(0, 0.4, 3)))
    return frames, poses, fixes, local


def _soak_run(name, seed, scene, upto=None):
    root, create = _pkg(name)
    frames, poses, fixes, local = scene
    closes, lost = [], []
    with seeded_closer(root, seed, closes):
        slam = create(_cfg(root, SOAK_CFG), _mod(root, "core.camera").Camera(
            *SLAM_CAM))
        for i, img in enumerate(frames[:upto]):
            fr = slam.track(img, float(i), gps_lla=fixes[i], gps_acc=0.5)
            if fr is None or fr.n_tracked() == 0:
                lost.append(i)
    return slam, closes, poses, local, lost


def soak(name, seeds):
    scene = _soak_scene()
    for seed in seeds:
        slam, closes, poses, local, lost = _soak_run(name, seed, scene)
        slam.finish()

        def truth(i):
            return slam._local_frame.to_local(
                *local.local_to_lla(poses[i][:3]))
        kfs = slam.map.keyframes()
        err = [np.linalg.norm(f.pose_c2w[:3] - truth(f.id)) for f in kfs]
        geo = float(np.sqrt(np.mean(np.square(err))))
        print(json.dumps({
            "package": name, "seed": seed, "tracked": slam.frames_tracked,
            "total": slam.frames_total, "geo_ate": geo,
            "geo_bar_met": geo < 2.0, "keyframes": len(kfs),
            "lost_frames": lost,
            "closures": [(fr.id, kf, round(float(np.linalg.norm(
                T[:3] - truth(fr.id))), 2)) for fr, kf, T in closes]}),
            flush=True)


def pnp_rates(n):
    """The PnPs of the port's frame-28 verification (seed 7), under n
    seeds in each package."""
    import jax
    import jax.numpy as jnp
    from pislamfusion_tpu.ops import ransac as jr
    from pislamfusion_tpu_torch.models import loopclose as lc
    from pislamfusion_tpu_torch.ops import ransac as tr
    calls, find, verify = [], tr.find_pnp, lc.LoopCloserSE3Graph._verify

    def spy(gen, p3d, p2n, w, **kw):
        if spy.on:
            calls.append((p3d.numpy().copy(), p2n.numpy().copy(),
                          w.numpy().copy(), kw["threshold"]))
        return find(gen, p3d, p2n, w, **kw)

    def verified(self, frame, cands):
        spy.on = frame.id == 28
        try:
            return verify(self, frame, cands)
        finally:
            spy.on = False

    spy.on = False
    tr.find_pnp, lc.LoopCloserSE3Graph._verify = spy, verified
    try:
        _soak_run("port", 7, _soak_scene(), upto=29)
    finally:
        tr.find_pnp, lc.LoopCloserSE3Graph._verify = find, verify
    for j, (p3d, p2n, w, thr) in enumerate(calls):
        acc = {"jax": 0, "port": 0}
        for s in range(n):
            r = jr.find_pnp(jax.random.PRNGKey(1000 + s), jnp.asarray(p3d),
                            jnp.asarray(p2n), jnp.asarray(w), threshold=thr)
            acc["jax"] += bool(r.ok) and float(r.score) >= LOOP_MIN_INLIERS
            r = find(torch.Generator().manual_seed(1000 + s),
                     torch.from_numpy(p3d), torch.from_numpy(p2n),
                     torch.from_numpy(w), threshold=thr)
            acc["port"] += bool(r.ok) and float(r.score) >= LOOP_MIN_INLIERS
        print(json.dumps({"frame": 28, "pnp": j, "matches": int(w.sum()),
                          "seeds": n, "accepted_jax": acc["jax"] / n,
                          "accepted_port": acc["port"] / n}), flush=True)


def _jax_sequence(out_dir):
    """tests/test_real_sequence.py:82's run on the JAX package, its bars'
    values (the test's own scene, renderer and steps)."""
    import jax.numpy as jnp
    import synth_survey as S
    import test_real_sequence as trs
    from pislamfusion_tpu.core.camera import Camera
    from pislamfusion_tpu.core.gps import LocalFrame
    from pislamfusion_tpu.core.messenger import DataTrans
    from pislamfusion_tpu.models.fusion import FusionSystem
    from pislamfusion_tpu.models.slam import create_slam
    from pislamfusion_tpu.ops import lie, ransac
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "examples"))
    from pipeline_demo import mosaic_psnr_vs_truth
    ground = trs._ground()
    cam = Camera(*SLAM_CAM)
    poses, strips = trs._trajectory()
    cfg = _cfg("pislamfusion_tpu", [
        ("FeatureDetector", "ORB"), ("SLAM.nFeature", "600"),
        ("SLAM.MaxOverlap", "0.95"), ("SLAM.LoopClose", "1"),
        ("SLAM.BAFrameCap", "8"), ("SLAM.BAPointCap", "1024"),
        ("SLAM.BAObsCap", "4096"), ("SLAM.LocalBAIters", "8"),
        ("Plane.MinPoints", "400"), ("PrepareFrameNum", "8"),
        ("Map2D.BandNumber", "4")])
    trans_q, plane_q = DataTrans(30), DataTrans(30)
    slam = create_slam(cfg, cam)
    slam.trans_queue, slam.plane_queue = trans_q, plane_q
    fusion = FusionSystem(cfg, cam, trans_q=trans_q, plane_q=plane_q).start()
    local = LocalFrame(108.9, 34.0, 0.0)
    rng = np.random.default_rng(21)
    for i, p in enumerate(poses):
        g, b = trs._exposure(i, int(strips[i]))
        img = np.clip(S.render_view(ground, cam, p) * g + b, 0,
                      255).astype(np.float32)
        slam.track(img, float(i), gps_lla=local.local_to_lla(
            p[:3] + rng.normal(0, 0.5, 3)), gps_acc=0.5)
    slam.finish()
    slam.mapper.force_plane()
    ended = fusion.finish()
    frames = [f for f in slam.map.frames()
              if f.n_tracked() > 0 or f.is_keyframe]
    est = np.stack([f.pose_c2w[:3] for f in frames])
    gt = poses[np.asarray([f.id for f in frames])][:, :3]
    J = jnp.asarray
    Sfit = ransac.sim3_horn(J(est, jnp.float32), J(gt, jnp.float32))
    al = np.asarray(lie.sim3_apply(Sfit, J(est, jnp.float32)))
    psnr, cov = mosaic_psnr_vs_truth(fusion.map2d, ground, np.asarray(
        ransac.sim3_horn(J(gt, jnp.float32), J(est, jnp.float32))))
    fusion.save(os.path.join(out_dir, "result.png"))
    return {"consumer ended": bool(ended),
            "tracked share": slam.frames_tracked / slam.frames_total,
            "gps_fitted": bool(slam.mapper.gps_fitted),
            "ATE m": float(np.sqrt(np.mean(np.sum((al - gt) ** 2, -1)))),
            "frames fed": fusion.frames_fed,
            "frames refreshed": fusion.frames_refreshed,
            "coverage": float(cov), "PSNR dB": float(psnr),
            "closed_loops": slam.loop_closer.closed_loops}


def sequence(name, seeds):
    for seed in seeds:
        root, _ = _pkg(name)
        with tempfile.TemporaryDirectory() as out, \
                seeded_closer(root, seed, []):
            if name == "port":
                c = E.real_sequence("cpu")
                r = {b[0]: b[1] for b in c.bars}
                r["closed_loops"] = c.stats["closed_loops"]
            else:
                r = _jax_sequence(out)
        print(json.dumps({"package": name, "seed": seed,
                          **{k: (bool(v) if isinstance(v, np.bool_) else v)
                             for k, v in r.items()}}), flush=True)


def continued(n):
    """`continue N` (see the module's docstring)."""
    import jax
    from pislamfusion_tpu.models import loopclose as jlc
    from pislamfusion_tpu_torch import convert
    from pislamfusion_tpu_torch.core.gps import LocalFrame
    frames, poses, fixes, local = scene = _soak_scene()
    find = jlc.ransac.find_pnp

    def forced(key, p3d, p2n, w, **kw):
        if forced.frame == 28 and int(np.asarray(w).sum()) == 43:
            for k in range(40):
                r = find(jax.random.PRNGKey(k), p3d, p2n, w, **kw)
                if bool(r.ok) and float(r.score) >= LOOP_MIN_INLIERS:
                    return r
        return find(key, p3d, p2n, w, **kw)

    root, create = _pkg("jax")
    slam = create(_cfg(root, SOAK_CFG), _mod(root, "core.camera").Camera(
        *SLAM_CAM))
    jlc.ransac.find_pnp = forced
    try:
        for i in range(29):
            forced.frame = i
            slam.track(frames[i], float(i), gps_lla=fixes[i], gps_acc=0.5)
    finally:
        jlc.ransac.find_pnp = find
    state = convert.worldmap_to_numpy(slam)
    before = slam.loop_closer.closed_loops

    def run_on(s, name, seed):
        tracked = 0
        for i in range(29, len(frames)):
            fr = s.track(frames[i], float(i), gps_lla=fixes[i], gps_acc=0.5)
            tracked += int(fr is not None and fr.n_tracked() > 0)
        s.finish()
        err = [np.linalg.norm(f.pose_c2w[:3] - s._local_frame.to_local(
            *local.local_to_lla(poses[f.id][:3]))) for f in s.map.keyframes()]
        print(json.dumps({"package": name, "seed": seed, "tracked_29_79":
                          tracked, "geo_ate": float(np.sqrt(np.mean(
                              np.square(err)))), "closures_after_28":
                          s.loop_closer.closed_loops - (
                              before if name == "jax" else 0)}), flush=True)

    run_on(slam, "jax", 7)
    proot, pcreate = _pkg("port")
    for seed in range(n):
        ps = pcreate(_cfg(proot, list(SOAK_CFG) + [("SLAM.Seed", str(seed)),
                                                   ("GPS.Fitted", "1")]),
                     _mod(proot, "core.camera").Camera(*SLAM_CAM))
        convert.load_worldmap_state(ps, state)
        ps._local_frame = LocalFrame(*fixes[0])
        ps.cfg.set("GPS.Origin", " ".join(str(v) for v in fixes[0]))
        ps.loop_closer._last_close_id = 28
        ps.loop_closer._key = threefry.Key(seed + 100)
        run_on(ps, "port", seed)


def summary(paths):
    from scipy.stats import fisher_exact, mannwhitneyu
    runs = {}
    for path in paths:
        with open(path) as f:
            for ln in f:
                if ln.startswith("{") and '"geo_bar_met"' in ln:
                    d = json.loads(ln)
                    runs.setdefault(d["package"], {})[d["seed"]] = d
    counts = {}
    for name, rs in sorted(runs.items()):
        rs = list(rs.values())
        miss = sum(not r["geo_bar_met"] for r in rs)
        wrong = sum(bool(r["closures"]) and r["closures"][0][2] > 10
                    for r in rs)
        counts[name] = (len(rs), miss, wrong)
        print(json.dumps({"package": name, "runs": len(rs),
                          "geo_bar_missed": miss,
                          "first_closure_wrong": wrong,
                          "median_geo_ate": float(np.median(
                              [r["geo_ate"] for r in rs]))}))
    (nj, mj, wj), (npt, mp, wp) = counts["jax"], counts["port"]
    print(json.dumps({
        "fisher_p_geo_bar_missed": fisher_exact(
            [[mj, nj - mj], [mp, npt - mp]]).pvalue,
        "fisher_p_first_closure_wrong": fisher_exact(
            [[wj, nj - wj], [wp, npt - wp]]).pvalue,
        "mannwhitney_p_geo_ate": mannwhitneyu(
            [r["geo_ate"] for r in runs["jax"].values()],
            [r["geo_ate"] for r in runs["port"].values()]).pvalue}))


def main(argv):
    if argv[1:2] == ["jax"] or argv[:1] in (["pnp-rates"], ["continue"]):
        import jax
        jax.config.update("jax_platforms", "cpu")
        from pislamfusion_tpu.core.jaxcache import enable_persistent_cache
        enable_persistent_cache()
    torch.set_num_threads(1)
    cmd, rest = argv[0], argv[1:]
    if cmd == "pnp-rates":
        return pnp_rates(int(rest[0]))
    if cmd == "continue":
        return continued(int(rest[0]))
    if cmd == "summary":
        return summary(rest)
    name, rest = rest[0], rest[1:]
    if cmd == "starved":
        no_skip = "--no-skip" in rest
        return starved(name, [int(a) for a in rest if a != "--no-skip"],
                       no_skip)
    return {"soak": soak, "sequence": sequence}[cmd](
        name, [int(a) for a in rest])


if __name__ == "__main__":
    main(sys.argv[1:])
