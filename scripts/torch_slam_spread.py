"""How far the port's SLAM moves under float noise, on the CPU.

Run from the repository root (no GPU needed):

    python3 scripts/torch_slam_spread.py

On tests/test_slam.py's survey (320x240, 36 frames, its config), through
`chip_smoke.slam_survey_run`:

1. the whole run with 1, 2, 4 and 8 intra-op threads: each run's
   keyframes and ATE (Sim3-aligned to the truth) as a share of the span,
   the widest gap between the runs' keyframe counts, and the 1-thread
   run's camera centres Sim3-aligned to the 8-thread run's (RMS and
   largest, over the first row and the survey);
2. one step (tracking, then mapping) from the 8-thread run's state at
   chip_smoke.SLAM_STEP_FRAMES, on 1 and on 8 threads: the largest
   difference of the frame's and the keyframes' centres, as a share of
   the map's span;
3. every 6th local BA window of the 8-thread run solved again with its
   points moved by 1e-6 relative noise: the largest pose and point
   differences and the relative difference of the robust cost;
4. `pipeline.fused_track_chain` over chip_smoke.SLAM_CHAIN_K frames from
   the 8-thread run's state at each of chip_smoke.SLAM_CHAIN_FRAMES,
   again with its aux (the last frame's map points, its pose and the
   motion model) moved by 1e-7 relative noise, three draws: the largest
   pose difference of each row as a share of the translation scale.

These are the spreads that chip_smoke.py's phase 3 gates are set
against (the card's floats differ from the CPU's as much as two thread
counts' do); the keyframe gap is its SLAM_CARD_KF, section 4 sets its
SLAM_CHAIN_POSE.
"""
from __future__ import annotations

import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke as cs  # noqa: E402
from pislamfusion_tpu_torch import convert  # noqa: E402
from pislamfusion_tpu_torch.core.camera import Camera  # noqa: E402
from pislamfusion_tpu_torch.models import mapper as tm  # noqa: E402
from pislamfusion_tpu_torch.models import pipeline  # noqa: E402
from pislamfusion_tpu_torch.models.slam import create_slam  # noqa: E402
from pislamfusion_tpu_torch.ops import ba  # noqa: E402

CAM = (320, 240, 260.0, 260.0, 160.0, 120.0)


def step(state, frame, i, threads):
    """One `track` of frame i from `state` on `threads` threads: (the
    frame's centre, {keyframe id: centre})."""
    torch.set_num_threads(threads)
    s = create_slam(cs.slam_survey_cfg(), Camera(*CAM), device="cpu")
    convert.load_worldmap_state(s, state)
    s.tracker._key = state["generators"][0]
    s.mapper.generator.set_state(state["generators"][1])
    if state["plane_tries"] is not None:
        s.mapper._plane_tries = state["plane_tries"]
    fr = s.track(frame, float(i))
    return fr.pose_c2w[:3].copy(), {f.id: f.pose_c2w[:3].copy()
                                    for f in s.map.keyframes()}


def window_cost(args, kw, poses, pts):
    """The robust reprojection cost of a window's solution."""
    poses_w, fixed, _, of, op, ouv, _ = args
    prob = ba.make_problem(poses=poses, pose_fixed=fixed, points=pts,
                           obs_frame=of, obs_point=op, obs_uv=ouv,
                           obs_weight=np.ones(len(of), np.float32),
                           device="cpu")
    return float(ba._reproj_cost(prob, kw["huber_delta"]))


def main() -> int:
    runs = {}
    for threads in (8, 1, 2, 4):
        torch.set_num_threads(threads)
        states, windows = {}, []

        def snapshot(slam, i):
            if threads == 8 and i in cs.SLAM_STEP_FRAMES:
                st = convert.worldmap_to_numpy(slam)
                st["generators"] = (slam.tracker._key,
                                    slam.mapper.generator.get_state())
                st["plane_tries"] = getattr(slam.mapper, "_plane_tries",
                                            None)
                states[i] = st
        solve = tm.Mapper.solve_local_window

        def record(*a, **k):
            windows.append((a[:7], {n: k[n] for n in (
                "iters", "huber_delta", "tol", "prior_kw") if n in k}))
            return solve(*a, **k)
        tm.Mapper.solve_local_window = staticmethod(record)
        try:
            slam, poses, gt, frames = cs.slam_survey_run(
                "cpu", on_frame=snapshot)
        finally:
            tm.Mapper.solve_local_window = staticmethod(solve)
        ate, span, _ = cs.slam_ate(slam, gt)
        runs[threads] = (poses, states, windows, frames,
                         len(slam.map.keyframes()))
        print(f"{threads} threads: tracked {slam.frames_tracked}/36, "
              f"keyframes {len(slam.map.keyframes())}, ATE "
              f"{ate / span * 100:.3f} % of the span", flush=True)
    kfs = [r[4] for r in runs.values()]
    print(f"keyframes over 1, 2, 4 and 8 threads: "
          f"{[runs[t][4] for t in (1, 2, 4, 8)]}, widest gap "
          f"{max(kfs) - min(kfs)}")
    p8, states, windows, frames, _ = runs[8]
    p1 = runs[1][0]
    common = sorted(set(p1) & set(p8))
    row = cs.traj_share(p1, p8, [i for i in common if i < 12])
    whole = cs.traj_share(p1, p8, common)
    print(f"1 vs 8 threads, whole runs, Sim3-aligned centres, RMS "
          f"(largest) as a share of the span: first row {row[0] * 100:.4f} "
          f"% ({row[1] * 100:.4f} %), survey {whole[0] * 100:.4f} % "
          f"({whole[1] * 100:.4f} %)")
    for i, st in sorted(states.items()):
        (c1, k1), (c8, k8) = (step(st, frames[i], i, t) for t in (1, 8))
        c = np.stack(list(k8.values()))
        span = float(np.linalg.norm(c.max(0) - c.min(0)))
        d = max([np.abs(c1 - c8).max()] + [np.abs(k1[k] - k8[k]).max()
                                           for k in k8 if k in k1])
        print(f"one step from frame {i}'s state, 1 vs 8 threads: largest "
              f"centre difference {d / span * 100:.5f} % of the map's span")
    torch.set_num_threads(8)
    rng = np.random.default_rng(0)
    for j in range(0, len(windows), 6):
        args, kw = windows[j]
        p0, x0 = solve(*args, **kw, device="cpu")
        moved = list(args)
        moved[2] = (np.asarray(args[2]) * (1.0 + 1e-6 * rng.standard_normal(
            np.shape(args[2])))).astype(np.float32)
        q0, y0 = solve(*moved, **kw, device="cpu")
        c0 = window_cost(args, kw, p0, x0)
        c1 = window_cost(args, kw, q0, y0)
        print(f"local BA window {j} ({len(args[2])} points): with 1e-6 "
              f"noise, poses within {np.abs(p0 - q0).max():.3e}, points "
              f"within {np.abs(x0 - y0).max():.3e}, cost "
              f"{abs(c0 - c1) / c0:.3e} relative")
    worst = 0.0
    for i in cs.SLAM_CHAIN_FRAMES:
        s = create_slam(cs.slam_survey_cfg(), Camera(*CAM), device="cpu")
        convert.load_worldmap_state(s, states[i])
        ins, kw = cs.slam_chain_inputs(s)
        imgs = torch.from_numpy(cs.bench_gray(frames[i:i + cs.SLAM_CHAIN_K]))
        feats = [pipeline.fused_extract(im, s.detector.params) for im in imgs]
        stacked = [torch.stack([f[k] for f in feats])
                   for k in ("desc", "valid", "xy")]
        rows = pipeline.fused_track_chain(*stacked, *ins, **kw).numpy()
        n = ins[0].shape[0]
        for _ in range(3):
            aux = ins[2] * (1.0 + 1e-7 * torch.from_numpy(
                rng.standard_normal(ins[2].shape).astype(np.float32)))
            moved = pipeline.fused_track_chain(*stacked, *ins[:2], aux,
                                               *ins[3:], **kw).numpy()
            d = [cs.rows_apart(moved[k], rows[k], n)[0]
                 for k in range(len(rows))]
            worst = max(worst, max(d))
            print(f"chain of {len(rows)} from frame {i}'s state, aux with "
                  f"1e-7 noise: rows' poses within " + ", ".join(
                      f"{v:.2e}" for v in d) + " of the translation scale")
    print(f"chains under 1e-7 noise: largest row pose difference "
          f"{worst:.3e} of the translation scale")
    return 0


if __name__ == "__main__":
    sys.exit(main())
