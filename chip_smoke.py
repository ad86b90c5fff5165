"""Smoke run of the PyTorch + CUDA port (`pislamfusion_tpu_torch`) on one GPU.

Run from the repository root, with no arguments, on a machine with one
NVIDIA H100 and the CUDA toolkit:

    python3 chip_smoke.py

It builds the port's CUDA kernels from `pislamfusion_tpu_torch/csrc/`
(one `nvcc` per source, all started together), then:

1. holds each kernel (K1 flat pyramid, K2 patch gather, K3 shear warp, K4
   fused FAST+NMS+select, K5 banded stack, K6 bilinear grid, K7 packed
   pyramid, K8 banded sandwich) against its plain PyTorch version on the
   card at the shapes of the main paths (K4 on K1's and K7's 8-level
   1080p pyramids, K7's 4-level pyramid of the small strip and K1's
   pyramid of a sigma-40 noise frame, each with the share of pixels that
   pass its pretest, its bound counted for what the strip's pyramid needs
   at the f32 min/max and add rates measured on the card, and the card's
   clocks sampled before and after; K3 at FastVO's half resolution and at
   the Map2D engine's full resolution, each also transposed (the map
   turned 100 degrees), all four timed beside their bounds; K7 in one
   launch a call, also on the small strip's 600x640 pyramid and from a
   CUDA graph of two calls replayed twice, with its plan line; K2 also
   on centres at the buffer's corners and edges;
   K6 on SIFT's orientation and descriptor grids; K8 at the Map2D
   patch's pyrDown and pyrUp, its weight chain, the canvas pyrUp of
   `blended()`, FastVO's half-res pyramid, its 1080p source pyrDown and
   its band-0 weight pyrUp, each with its launch plan and resident blocks
   an SM; K1 and K5 at every octave also print theirs), and times the
   kernel, its plain version and one library call that computes the same
   function where there is one (each the device time of a call, from 20
   calls captured in one CUDA graph), beside its bound (K5 at each of its
   three octaves, beside the multiply-adds its plan does); K1, K2, K5's
   octave 0, K7, K8's 1536^2x3 pyrDown and 1080p source pyrDown and K6's
   orientation grid also with a cold L2 (a 128 MB write before each call,
   its own time subtracted);
2. drives the FastVO paths through `FastVO.process` at 1920x1080 over 24
   frames of bench.py's synthetic survey strip (window radius 60, 5
   bands): ORB-1000 with 8 levels (the flat pyramid K1 and K4), the same
   with pyramid="packed" (K7 and K4), then SIFT-1000 (4 octaves, 3 scales
   an octave); then the Map2D engines through `create_map2d` / `prepare` /
   `feed` / `blended` on the same 24 frames (Map2D.Scale 0.5, 5 bands,
   the shear warp): Type 3 (MultiBand) and Type 4 (Render, EnableSeam,
   RenderBatch 8). For each path, every kernel's launch count is set to 0
   just before the timed run and read just after; the run is timed with
   CUDA events after a warm-up pass; one more pass is broken down by stage
   and 8 frames run under torch.profiler for the device's busy share,
   device time by kernel and host time by operator. FastVO's tracking is
   checked as bench.py does; the Map2D mosaics must cover the union of
   the frames' footprints;
2c. drives SLAM's geometric base at full width (`solver_chain`, frames
   0-6 of the same strip): `orb_detect` (K1, K4, K2) on every frame,
   Hamming matching of frames 0 and 6 with the rotation filter,
   unprojection through `Camera`, the `svd` and `opt` initializers
   (`create_initializer`), triangulation with the true poses, the plane
   RANSAC, PnP of frames 1-5, BA over frames 0-6 from a perturbed start
   (tol 0 and tol 1e-4), `fit_sim3` of BA's camera centres to the truth
   and multi-homography matching; it prints each step's result, errors
   against the true poses, device ms (CUDA events) and launches
   (torch.profiler), and gates on the PnP and BA poses, BA's cost, the
   plane's normal and K1, K4 and K2 having launched;
2d. drives SLAM at full width through `create_slam` and `SLAM.track`,
   offline (`SLAM.isOnline` 0, SLAM.nFeature 1000, the default BA caps,
   the tracker, mapper and loop closer): ORB over 36 frames of the
   strip, then SIFT over 18, each with every launch count set to 0 just
   before and read just after; it prints ms a frame (host clock, and by
   the port's timer scopes: extract, track, keyframe/mapper, local BA,
   loop close), frames tracked, keyframes, local BAs, map points, the
   plane, ATE after Sim3 alignment to the true poses and the launches of
   K1, K4 and K2 (ORB) and K5 and K6 (SIFT); it gates on 85 % of frames
   tracked, ATE under 2 % of the span, 6 keyframes (ORB), a local BA and
   those launches;
2f. drives SLAM online (`SLAM.isOnline` 1: the tracking thread and the
   mapper's worker), bench.py's SLAM pass cut to frames 0-11 of the strip
   out and back (23 frames, uint8 gray from the host; bench.py takes
   frames 0-23, 47 frames: a depth cut that makes room for phase 2i),
   ORB-1000, no loop closing, in the four (SLAM.TrackChain,
   SLAM.TrackScale) configurations (1, 1), (8, 1), (1, 2), (8, 2), one
   round (bench.py runs two; one keeps the script near half its time
   limit), then
   SIFT-1000 chained over frames
   0-17, the synchronising calls of one chain of 8 frames
   (`torch.cuda.set_sync_debug_mode`), and, after phase 2e, one online
   `app.main(["Act=SLAM", ...])` with TrackChain 8 over phase 2e's
   dataset; each call with every launch count set to 0 just before and
   read just after; it prints ms a frame (host clock), tracked,
   keyframes, ATE, the chains dispatched and their mean length, the
   launches and peak device memory, and gates on every call's tracking
   thread and mapper ending within a bounded wait, frames_total equal to
   the frames fed, no track error, a chain of 2 or more in each chained
   configuration, the path's kernels launched, 50 % tracked and ATE under
   2 % of the span (ORB), and phase 2e's liveness gates (the app call);
2g. drives the scale-out modules (`pislamfusion_tpu_torch/parallel/`)
   over a mesh of 4 shards on the one card (`make_mesh([cuda:0] * 4)`,
   each shard's work in turn on the default stream):
   `dist_vo.process_survey` over frames 0-24 of the strip as 4 segments
   of 7 overlapping by 1, anchored by the true poses of their first
   frames, plain and drift-corrected (ORB-1000, 8 levels, 5 bands, window
   60), each timed with CUDA events after a warm-up beside a serial
   `FastVO.process` of the same frames, with its peak device memory, its
   synchronising calls (`torch.cuda.set_sync_debug_mode`) and its
   launches (counts set to 0 just before, read just after); it gates on
   `n_match[:, 1:] > 50`, the position error within the serial run's
   (+0.1 m), the merged canvas covering the footprints' union (within 3 %),
   K1, K4, K2, K3 and K8 launched and, corrected, the boundary frames on
   the next anchor. Then `dist_ba.optimize_sharded` on phase 2c's BA
   problem against `ba.optimize` (quaternions within 1e-4, translations
   within 1e-4 scaled by the problem's size) and twice, bit-equal;
   `dist_mosaic.feed_frames` striped against mesh=None on 8 frames at
   FastVO's patch (the reference's bar, atol 2e-4 / rtol 1e-5);
   `dist_ransac.find_pnp_sharded` on tests/test_parallel.py's 30 %-inlier
   PnP (4 x 4096 hypotheses; its inlier and translation bars);
   `batch.batched_orb_detect` on 8 frames and `batched_sift_detect` on 4
   over a (4, 1) mesh, each equal to its per-frame detector;
2e. drives the fused system (`python -m pislamfusion_tpu_torch`) through
   `app.main` on a two-row 1080p lawnmower survey written as a
   `.npudronemap` dataset (fx 1200, 120 m up, 4 m a frame, rows 40 m
   apart, a GPS fix a frame with 0.4 m of noise): `Act=SLAM` once (SLAM
   in the caller's thread with GPS fitting and loop closing, the
   FusionSystem consumer in its own thread into Map2D Type 3 with K3 and
   K8, and the exporters), with every launch count set to 0 just
   before and read just after, `Act=TestMap2D` over its exported
   Map2DFusion folder, then `Act=Survey` (FastVO); it prints ms a
   frame, the timer scopes, peak device memory, the queue's drops and the
   launches, and gates on tests/test_cli.py's bars (tracked, GPS fit, geo
   ATE, frames fed and refreshed, mosaic PSNR against the texture, every
   artifact, the consumer ended without error) and on K1, K4, K2, K3 and
   K8 having launched;
3. checks the card's runs against the port's plain CPU runs on a small
   strip (600x640): FastVO ORB (both pyramids) and SIFT (3 frames, 256
   features, 3 bands), Map2D Types 1-4, Type 4 with and without
   seams (6 frames, 3 bands), and the solver chain on frames 0-2 (the
   card's features and one set of samples for both), then SLAM on
   tests/test_slam.py's 320x240 survey (36 frames, its config; the same
   RANSAC draws from CPU generators; the card run twice, bit-equal; the
   whole runs at tests/test_slam.py's bars and within SLAM_CARD_KF
   keyframes of each other; from the card run's state at six frames, one
   step on each device, and at three, both chain functions over 4 frames
   on each device), then the
   FusionSystem on tests/test_refresh.py's three cases and the geo tiles
   of its rebased canvas; `orb_detect` with the continuous-angle BRIEF
   (OrbParams(angle_bins=0)) and `dist_vo.process_survey` over 4 shards
   (3 segments of the small strip) card against CPU;
2h. then drives the JAX package's end-to-end SLAM suites on the port
   (`scripts/torch_e2e_scenes.py`, E2E_CASES), each at its reference
   test's scene, frames, configuration and bars through `create_slam(cfg,
   cam, device="cuda")`: tests/test_soak.py:27 (80 frames, everything on,
   with the FusionSystem feed) and tests/test_parallax.py:132 and :219
   (the parallax scene; blur and noise); each with every launch count set
   to 0 before it and read after it; it prints each case's ms a frame,
   tracked, ATE, loops closed, geo ATE, points and keyframes, every bar
   beside its value and the card, and gates on every bar, K2 launched
   over the phase (at these frame sizes ORB takes neither K1 nor K4, as
   in the JAX package) and K3 and K8 on the soak's feed. Loop closing,
   GPS fusion, the real-texture circuit, the race hunt and the real
   sequence run in `scripts/torch_e2e_phase.py` alone, by their time;
2i. then runs both vocabulary trainers on the card
   (scripts/torch_train_default_vocab.py, scripts/torch_train_sift_vocab.py)
   at TRAINER_VIEWS views of 480x640 each (a depth cut of their 24 and 16),
   each with every launch count set to 0 before it and read after it, and
   gates on the words and nodes, the .gbow's save -> load round trip and
   its embedded module, and K2 (ORB), K5 and K6 (SIFT) launched, reporting
   K1's and K4's launches; then one combination of doc/ABLATION.md's v3
   grid (`fixture=real gps=0.5 refresh=1 seed=0`, the pipeline demo's 52
   frames) through scripts/torch_batch_evaluate.py in a subprocess,
   printing its ms a frame, tracked share, ATE and PSNR beside the JAX
   package's, and gates on a tracked share over 0.85, a mosaic that is
   not blank (PSNR over 0 dB), no fusion error and K2, K3 and K8
   launched;
and prints the kernel table (each kernel's launches on its path and over
phases 2g, 2h and 2i) and the result line.

Every failure raises and ends the script with a nonzero exit code. With no
CUDA device it exits nonzero before printing any result.
"""
from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

import numpy as np

# published peaks of one H100 SXM (NVIDIA data sheet): HBM3 bytes/s and
# dense bf16 / fp32 (non-tensor) operations per second; the fp32 peak
# counts a fused multiply-add as two operations. K4's minima, maxima and
# subtractions are timed against rates this script measures
# (scripts/torch_k4_k3_sweep.py f32_rates)
HBM_BYTES_PER_S = 3.35e12
BF16_OPS_PER_S = 989e12
FP32_OPS_PER_S = 67e12

ALT = 120.0          # bench.py: flying height (m)
STEP_M = 4.0         # bench.py: straight strip, 4 m per frame


# ---------------------------------------------------------------------------
# bench.py's synthetic survey, rendered with numpy tables and torch products
# ---------------------------------------------------------------------------

def strip_texture(ts: int, seed: int = 0):
    """bench.py's random texture (bench.py:89-176): blotchy rectangles over
    noise, [ts, ts, 3] uint8 (numpy)."""
    rng = np.random.default_rng(seed)
    tex = np.full((ts, ts, 3), 128.0, np.float32)
    tex += rng.normal(0, 12, tex.shape).astype(np.float32)
    for _ in range(3000 * (ts * ts // (2048 * 2048) + 1)):
        y, x = rng.integers(10, ts - 48, 2)
        h, w = rng.integers(4, 24, 2)
        tex[y:y + h, x:x + w] = rng.uniform(10, 245, 3)
    return np.clip(tex, 0, 255).astype(np.uint8)


def render_strip(K: int, H: int, W: int, fx: float, gs: float, ts: int,
                 device, seed: int = 0):
    """K uint8 RGB frames [K, H, W, 3] (a tensor on `device`) of a nadir
    camera flying a straight strip over bench.py's random texture
    (bench.py:89-176: blotchy rectangles over noise, `ts` texels square,
    `gs` metres per texel), and the true poses [K, 7] (numpy, c2w in plane
    coordinates). Each frame is bench.py's separable bilinear resampling of
    the texture, computed here per frame."""
    import torch
    tex = strip_texture(ts, seed)
    offx, offy = 50.0, 30.0
    cx, cy = W / 2.0, H / 2.0
    a = ALT / (fx * gs)                       # texels per image pixel
    winc = int(np.ceil(W * a)) + 2
    winr = int(np.ceil(H * a)) + 2

    def samp(n, slope, b, win):
        s = slope * np.arange(n, dtype=np.float64) + b
        start = int(np.floor(s.min()))
        rel = s - start
        m = np.zeros((n, win), np.float32)
        i0 = np.floor(rel).astype(np.int64)
        f = rel - i0
        m[np.arange(n), i0] += 1.0 - f
        m[np.arange(n), i0 + 1] += f
        return torch.from_numpy(m).to(device), start

    texd = torch.from_numpy(tex).to(device).to(torch.float32)
    rmat, r0 = samp(H, -a, (120.0 + offy) / gs + a * cy, winr)
    frames, poses = [], []
    for i in range(K):
        x = 90.0 + STEP_M * i
        cmat, c0 = samp(W, a, (x + offx) / gs - a * cx, winc)
        win = texd[r0:r0 + winr, c0:c0 + winc]
        rows = torch.einsum("ok,khc->ohc", rmat, win)
        out = torch.einsum("pl,hlc->hpc", cmat, rows)
        frames.append(out.round().clamp(0, 255).to(torch.uint8))
        poses.append([x, 120.0, ALT, 1.0, 0.0, 0.0, 0.0])
    return torch.stack(frames), np.asarray(poses, np.float32)


# the SLAM survey of tests/test_slam.py: a textured ground (0.1 m a texel,
# tests/synth_survey.py make_ground) seen straight down from 25 m along a
# serpentine of 3 rows of 12 frames, 3 m apart, the rows 8 m apart
SURVEY_GS = 0.1


def survey_ground(rng, n=1024, rects=700):
    """tests/synth_survey.py's make_ground: corner-rich, aperiodic texture
    [n, n, 3] float32 (numpy, from `rng`)."""
    g = np.full((n, n, 3), 120.0, np.float32)
    g += rng.normal(0, 8, (n, n, 3)).astype(np.float32)
    ramp = np.linspace(-14.0, 14.0, 64, dtype=np.float32)
    for _ in range(rects):
        y, x = rng.integers(10, n - 40, 2)
        h, w = rng.integers(6, 36, 2)
        base = rng.uniform(20, 235, 3).astype(np.float32)
        patch = base[None, None, :] + ramp[:h, None, None] \
            * rng.uniform(-1, 1) + ramp[:w][None, :, None] \
            * rng.uniform(-1, 1)
        patch = patch + rng.normal(0, 6, (h, w, 3))
        g[y:y + h, x:x + w] = patch
    return np.clip(g, 0, 255)


def survey_poses(alt=25.0, y0=30.0, y1=54.0, dy=8.0, x0=25.0, x1=61.0,
                 dx=3.0):
    """tests/synth_survey.py's lawnmower: nadir poses [K, 7] (c2w, the
    camera looking down)."""
    poses = []
    for iy, y in enumerate(np.arange(y0, y1, dy)):
        xs = np.arange(x0, x1, dx)
        for x in (xs if iy % 2 == 0 else xs[::-1]):
            poses.append(np.array([x, y, alt, 1.0, 0.0, 0.0, 0.0]))
    return np.stack(poses)


def survey_view(ground, cam, pose, gs: float = SURVEY_GS):
    """The view [H, W, 3] float32 of the ground tensor [n, n, 3] (on any
    device) from pose: tests/synth_survey.py's render_view through the
    port's warp. Returns a tensor on the ground's device."""
    import torch
    from pislamfusion_tpu_torch.ops import image as im
    from pislamfusion_tpu_torch.ops import mosaic as M
    H = M.homography_canvas_to_image_np(pose, cam, (0.0, 0.0), gs)
    h = torch.from_numpy(np.linalg.inv(H).astype(np.float32)).to(
        ground.device)
    return im.warp_perspective(ground, h, (cam.height, cam.width),
                               border="replicate")[0]


def slam_survey_cfg(**extra):
    """tests/test_slam.py's fixture config (ORB-600, small BA caps, plane
    at 300 points, no loop closing), with `extra` keys set after."""
    from pislamfusion_tpu_torch.core.svar import Svar
    cfg = Svar()
    for k, v in (("FeatureDetector", "ORB"), ("SLAM.nFeature", "600"),
                 ("SLAM.MaxOverlap", "0.95"), ("SLAM.LoopClose", "0"),
                 ("SLAM.BAFrameCap", "8"), ("SLAM.BAPointCap", "1024"),
                 ("SLAM.BAObsCap", "4096"), ("SLAM.LocalBAIters", "8"),
                 ("Plane.MinPoints", "300")):
        cfg.set(k, v)
    for k, v in extra.items():
        cfg.set(k, str(v))
    return cfg


def slam_ate(slam, gt):
    """(ATE [m], span [m], aligned estimate) of a SLAM's frames in its map
    against the true poses gt [K, 7], after the Sim3 (Horn) alignment of
    the estimate to the truth, as tests/test_slam.py:55-68 measures it."""
    import torch
    from pislamfusion_tpu_torch.ops import lie, ransac
    frames = [f for f in slam.map.frames() if f.n_tracked() > 0
              or f.is_keyframe]
    est = np.stack([f.pose_c2w[:3] for f in frames]).astype(np.float32)
    gt_pos = gt[np.asarray([f.id for f in frames])][:, :3].astype(
        np.float32)
    S = ransac.sim3_horn(torch.from_numpy(est), torch.from_numpy(gt_pos))
    al = lie.sim3_apply(S, torch.from_numpy(est)).numpy()
    ate = float(np.sqrt(np.mean(np.sum((al - gt_pos) ** 2, -1))))
    span = float(np.linalg.norm(gt_pos.max(0) - gt_pos.min(0)))
    return ate, span, al


def strip_geometry(H: int, W: int, fx: float, poses):
    """bench.py:181-191: canvas ground resolution, patch and canvas tiles
    and the canvas origin for a strip flown at ALT."""
    ele = 256
    lp = (2 * (0.5 * ALT * np.hypot(W / fx, H / fx)) / np.hypot(W, H)) / 0.5
    footprint_px = int(np.hypot(W, H) * 0.5 / 1.0)
    patch_tiles = int(np.ceil(footprint_px / ele)) + 1
    span_m = max(poses[:, 0].max() - poses[:, 0].min(),
                 poses[:, 1].max() - poses[:, 1].min())
    canvas_tiles = patch_tiles + int(np.ceil(span_m / (ele * lp))) + 2
    patch_px = patch_tiles * ele
    min_xy = np.array([90.0 - 0.5 * patch_px * lp,
                       120.0 - 0.5 * patch_px * lp])
    return lp, patch_tiles, canvas_tiles, min_xy


def make_fastvo(H, W, fx, poses, n_features, n_levels, bands, device,
                detector="orb", **kw):
    """A port FastVO with bench.py's camera and canvas geometry; `kw` are
    further FastVO arguments (pyramid, fast_warp, warp_mode, ...)."""
    from pislamfusion_tpu_torch import Camera, FastVO
    lp, patch_tiles, canvas_tiles, min_xy = strip_geometry(H, W, fx, poses)
    cam = Camera(W, H, fx, fx, W / 2.0, H / 2.0)
    return FastVO(cam, min_xy, canvas_tiles, lp, bands=bands,
                  n_features=n_features, n_levels=n_levels,
                  window_radius=60.0, patch_tiles=patch_tiles,
                  detector=detector, device=device, **kw)


# ---------------------------------------------------------------------------
# timing and bounds
# ---------------------------------------------------------------------------

def graph_ms(fn, reps: int = 20) -> float:
    """Mean device time of fn() from `reps` calls captured in one CUDA
    graph and replayed once (CUDA events around the replay): the kernels'
    own time, without the host's time to issue them. fn must launch on
    the current stream and not synchronise."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    graph.replay()
    t1.record()
    t1.synchronize()
    return t0.elapsed_time(t1) / reps


FLUSH_BYTES = 128 << 20     # more than the H100's 50 MB L2


def graph_ms_cold(fn, flush, reps: int = 20) -> float:
    """graph_ms of fn() with a write of `flush` (FLUSH_BYTES) before each
    call, less graph_ms of the write alone: fn's device time with its
    inputs out of L2 (and L2 full of the write's dirty lines)."""
    both = graph_ms(lambda: (flush.fill_(1.0), fn()), reps)
    return both - graph_ms(lambda: flush.fill_(1.0), reps)


def timed(label: str, kernel, plain, library=None, reps: int = 20):
    """graph_ms of the kernel's wrapper, its plain version and the library
    yardstick (None where there is none), printed. Returns the three."""
    ms = [None if fn is None else graph_ms(fn, reps)
          for fn in (kernel, plain, library)]
    lib = "none" if ms[2] is None else f"{ms[2]:.4f} ms"
    print(f"  {label}: kernel {ms[0]:.4f} ms, plain {ms[1]:.4f} ms, library "
          f"{lib} (device time a call, {reps} calls in one CUDA graph)")
    return ms


def bound_ms(nbytes: float, ops: float, ops_per_s: float):
    """(least time in ms, "bytes" or "operations") for moving `nbytes`
    through HBM and doing `ops` at `ops_per_s`."""
    tb = nbytes / HBM_BYTES_PER_S * 1e3
    to = ops / ops_per_s * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def _row(name, source, replaces, err, ms, plain, bound, library):
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": None, "max_abs_err": err,
            "ms": ms, "plain_ms": plain, "bound_ms": bound[0],
            "bound_by": bound[1], "library_ms": library}


# ---------------------------------------------------------------------------
# phase 1: each kernel against its plain version at the main path's shapes
# ---------------------------------------------------------------------------

def check_flatpyr(gray, params, flush):
    import torch
    from pislamfusion_tpu_torch.ops.features import flatpyr
    H, W = gray.shape
    L, sf, cell = params.n_levels, params.scale_factor, params.cell
    if not flatpyr.flat_pyramid_available(H, W, L, sf, cell):
        raise AssertionError(f"K1 does not take {H}x{W} / {L} levels")
    ker = flatpyr.build_flat_pyramid(gray, L, sf, cell)
    kp = flatpyr.kernel_plan(H, W, L, sf, cell)
    occ = flatpyr.occupancy(kp, gray.device)
    print(f"K1 plan: tiles by level {kp.tiles}, tap bounds {kp.taps}, "
          f"{kp.items.shape[0]} items, {kp.smem} bytes of shared memory a "
          f"block, {occ} resident blocks an SM "
          "(cudaOccupancyMaxActiveBlocksPerMultiprocessor)")
    pln = flatpyr.build_flat_pyramid_plain(gray, L, sf, cell)
    torch.cuda.synchronize()
    d = (ker - pln).abs()
    frac = float((d <= 1e-3).to(torch.float64).mean())
    err = float(d.max())
    print(f"K1 flatpyr   {H}x{W} L={L}: packed {tuple(ker.shape)}, "
          f"max |kernel - plain| {err:.3e}, within 1e-3: {frac:.6%} "
          "(bound: >= 99.99% within 1e-3, max <= 1.0: a different f32 "
          "summation order can flip t1's bf16 rounding by one ulp)")
    if not (frac >= 0.9999 and err <= 1.0):
        raise AssertionError("K1 disagrees with its plain version")
    # library yardstick: the same function as dense bf16 cuBLAS products,
    # two torch.matmul calls per level
    t = flatpyr.flat_tables(H, W, L, sf, cell)
    mats = [(torch.from_numpy(mr).to(gray.device, torch.bfloat16),
             torch.from_numpy(mc).to(gray.device, torch.bfloat16).T)
            for mr, mc in t.mats16]
    g16 = gray.to(torch.bfloat16)
    kernel = lambda: flatpyr.build_flat_pyramid(gray, L, sf, cell)  # noqa
    ms, plain, library = timed(
        "K1", kernel,
        lambda: flatpyr.build_flat_pyramid_plain(gray, L, sf, cell),
        lambda: [torch.matmul(torch.matmul(mr, g16), mcT)
                 for mr, mcT in mats])
    print(f"  K1 cold L2: kernel {graph_ms_cold(kernel, flush):.4f} ms (a "
          f"{FLUSH_BYTES >> 20} MB write before each call, its own time "
          "subtracted)")
    plan = t.plan
    nbytes = (H * W * 4 + plan.total_rows * plan.wp * 4
              + t.row_w.nbytes + t.row_start.nbytes * 3 + t.col_w.nbytes
              + t.col_start.nbytes * 2)
    ops = 2.0 * (float(t.row_len.sum()) * W + sum(
        float(t.col_len[lv].sum()) * br
        for lv, br in enumerate(plan.block_rows[1:])))
    return ker, _row("flatpyr", "pislamfusion_tpu_torch/csrc/flatpyr.cu",
                     "pislamfusion_tpu/ops/features/flatpyr_pallas.py:227",
                     err, ms, plain, bound_ms(nbytes, ops, BF16_OPS_PER_S),
                     library)


def smi_sample() -> str:
    """The card's SM clock, power draw and limit and temperature now
    (`nvidia-smi`), for reading a kernel's time beside its clock."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw,power.limit,"
         "temperature.gpu", "--format=csv,noheader"], capture_output=True,
        text=True, timeout=60).stdout.strip()


def noise_gray(H: int, W: int, device, seed: int = 40):
    """A [H, W] frame of i.i.d. Gaussian noise, sigma 40 around 128,
    clipped to 0..255 (seeded): K4's worst case, where most pixels pass
    its pretest."""
    import torch
    rng = np.random.default_rng(seed)
    return torch.from_numpy(np.clip(rng.normal(128.0, 40.0, (H, W)), 0,
                                    255).astype(np.float32)).to(device)


def k4_cases(frame, params, device):
    """K4's four cases, (label, packed, offs, shapes): the K1 (flat) and K7
    (packed) pyramids of `frame` (bench.py's 1080p strip), K7's pyramid
    of the small strip's frame 0 (600x640, 4 levels), and the K1 pyramid
    of `noise_gray` at the frame's size."""
    import torch
    from pislamfusion_tpu_torch.ops import image as im
    from pislamfusion_tpu_torch.ops.features import flatpyr, orb, packedpyr
    H, W = frame.shape[:2]
    L, sf, cell = params.n_levels, params.scale_factor, params.cell
    r = orb._GATHER_R
    gray = im.rgb_to_gray(frame.to(torch.float32))
    plan = orb._flat_plan(H, W, L, sf, cell)
    offs = [(plan.pad_left, b + cell) for b in plan.bases]
    plan7 = packedpyr.pyramid_plan(H, W, L, sf, r)
    fr_s, _ = render_strip(1, 600, 640, 600.0, 0.24, 1024, device)
    p_s = orb.OrbParams(n_features=256, n_levels=4)
    plan_s = packedpyr.pyramid_plan(600, 640, 4, p_s.scale_factor, r)
    return [
        (f"{H}p K1 pyramid", flatpyr.build_flat_pyramid(gray, L, sf, cell),
         offs, plan.shapes),
        (f"{H}p K7 pyramid", packedpyr.build_packed_pyramid(gray, L, sf, r),
         [(r, b + r) for b in plan7.bases], plan7.shapes),
        ("600x640 K7 pyramid", packedpyr.build_packed_pyramid(
            im.rgb_to_gray(fr_s[0].to(torch.float32)), 4, p_s.scale_factor,
            r), [(r, b + r) for b in plan_s.bases], plan_s.shapes),
        (f"{H}p noise (sigma 40) K1 pyramid", flatpyr.build_flat_pyramid(
            noise_gray(H, W, device), L, sf, cell), offs, plan.shapes)]


# K4's operations a pixel (csrc/fastselect.cu): the pretest (8 minima and
# maxima a polarity less the shared ones: 14; 2 subtractions, 2
# comparisons), the full score (16 subtractions, 64 3-tap minima and
# maxima, 96 for the arcs, 1 to finish; 1 comparison with the threshold),
# NMS (8 maxima, 1 comparison) and the cell reduction (2 comparisons)
K4_PRETEST = {"alu": 16, "fma": 2}
K4_SCORE = {"alu": 162, "fma": 16}
K4_NMS = {"alu": 9, "fma": 0}
K4_CELL = {"alu": 2, "fma": 0}


def k4_work(packed, offs, shapes, params):
    """What K4's function needs on these inputs, counted with the plain
    version's pieces: per level the pixels scored (inside the border), the
    candidates (pixels that pass the pretest), the pixels whose score is
    above the threshold and the NMS survivors. Returns the counts and the
    ALU (minima, maxima, comparisons) and FMA-pipe (subtractions)
    operations: the pretest for every scored pixel, the full score for
    each candidate, NMS for each pixel above the threshold, the cell
    reduction for each survivor; and the dense count (the full score for
    every scored pixel, NMS and the reduction for every pixel)."""
    from pislamfusion_tpu_torch.ops.features import fastselect as fs
    from pislamfusion_tpu_torch.ops.features import orb
    thr, border = params.min_threshold, orb.EDGE_THRESHOLD
    n = dict(px=0, scored=0, cand=0, above=0, survivors=0)
    for (lh, lw), (ox, oy) in zip(shapes, offs):
        v = packed[oy:oy + lh, ox:ox + lw]
        s = fs.fast_score_map(v)
        n["px"] += lh * lw
        n["scored"] += max(lh - 2 * border, 0) * max(lw - 2 * border, 0)
        n["cand"] += int(fs.fast_pretest(v, thr, border).sum())
        n["above"] += int((s[border:lh - border, border:lw - border]
                           > thr).sum())
        n["survivors"] += int((fs.suppress(s, thr, border) > 0).sum())
    ops = {k: n["scored"] * K4_PRETEST[k] + n["cand"] * K4_SCORE[k]
           + n["above"] * K4_NMS[k] + n["survivors"] * K4_CELL[k]
           for k in ("alu", "fma")}
    dense = n["scored"] * sum(K4_SCORE.values()) + n["px"] * (
        sum(K4_NMS.values()) + sum(K4_CELL.values()))
    return n, ops, dense


def check_fastselect(cases, params, flush, rates):
    """K4 on each (label, packed, offs, shapes) of `cases`: kernel vs plain
    (equal: 0 differing cells in cv2d and ci2d), its candidate share, and
    its time (the first also with a cold L2 and beside its plain version)
    beside the card's clocks. The bound of the first case counts what its
    inputs need (`k4_work`) at the measured f32 rates `rates`
    ({"minmax", "add"} operations a second)."""
    import torch
    from pislamfusion_tpu_torch.ops.features import fastselect as fs
    from pislamfusion_tpu_torch.ops.features import orb
    cell, thr, border = params.cell, params.min_threshold, orb.EDGE_THRESHOLD
    errs, row = [], None

    def views(packed, offs, shapes):
        return [packed[oy:oy + lh, ox:ox + lw]
                for (lh, lw), (ox, oy) in zip(shapes, offs)]
    print(f"K4 clocks before: {smi_sample()} (clocks.sm, power.draw, "
          "power.limit, temperature.gpu)")
    for label, packed, offs, shapes in cases:
        ker = fs.fast_cell_winners(packed, offs, shapes, cell, thr, border)
        pln = fs.fast_cell_winners_plain(views(packed, offs, shapes), cell,
                                         thr, border)
        torch.cuda.synchronize()
        n_cells = sum(v.numel() for v, _ in pln)
        bad = sum(int((kv != pv).sum()) + int((ki != pi).sum())
                  for (kv, ki), (pv, pi) in zip(ker, pln))
        err = max(float((kv - pv).abs().max()) for (kv, _), (pv, _) in
                  zip(ker, pln))
        errs.append(err)
        n, ops, dense = k4_work(packed, offs, shapes, params)
        print(f"K4 fastselect {label}: {len(shapes)} levels, "
              f"{sum(h * w for h, w in shapes) / 1e6:.2f} Mpx, {n_cells} "
              f"cells of {cell} px, {sum(int((v > 0).sum()) for v, _ in pln)}"
              f" with a corner: {bad} differing cv2d/ci2d entries, max "
              f"|kernel - plain| {err:.3e} (bound: equal)")
        print(f"  K4 {label} candidates: {n['cand']} of {n['scored']} "
              f"scored pixels ({n['cand'] / n['scored']:.2%}) pass the "
              f"pretest, {n['above']} ({n['above'] / n['scored']:.2%}) "
              f"score above {thr}, {n['survivors']} survive NMS")
        if bad:
            raise AssertionError(f"K4 {label} disagrees with its plain "
                                 "version")
        kernel = lambda: fs.fast_cell_winners(  # noqa: E731
            packed, offs, shapes, cell, thr, border)
        if row is None:
            vs = views(packed, offs, shapes)
            ms, plain, _ = timed(
                f"K4 {label}", kernel,
                lambda: fs.fast_cell_winners_plain(vs, cell, thr, border))
            cold = graph_ms_cold(kernel, flush)
            print(f"  K4 {label} cold L2: kernel {cold:.4f} ms")
            plan = fs.winner_plan(tuple(shapes), tuple(offs), cell)
            nbytes = n["px"] * 4 + plan.n_cells * 8 + plan.levels.nbytes \
                + plan.blocks.nbytes
            t_alu = ops["alu"] / rates["minmax"] * 1e3
            t_fma = ops["fma"] / rates["add"] * 1e3
            tb = nbytes / HBM_BYTES_PER_S * 1e3
            bound = max((tb, "bytes"), (max(t_alu, t_fma), "operations"))
            print(f"  K4 work: {nbytes / 1e6:.2f} MB, {ops['alu'] / 1e9:.3f}"
                  f" G minima, maxima and comparisons at the measured "
                  f"{rates['minmax'] / 1e12:.2f}e12/s and "
                  f"{ops['fma'] / 1e9:.3f} G subtractions at "
                  f"{rates['add'] / 1e12:.2f}e12/s for what these inputs "
                  f"need ({sum(ops.values()) / 1e9:.3f} G; a dense score "
                  f"would be {dense / 1e9:.3f} G); bound {bound[0]:.5f} ms "
                  f"({bound[1]}), kernel {ms / bound[0]:.2f}x; plan "
                  f"{plan.run} cells a block, {plan.blocks.shape[0]} "
                  f"blocks, {plan.smem} bytes of shared memory, "
                  f"{fs.occupancy(plan, cell, packed.device)} resident "
                  "blocks an SM")
            row = _row("fastselect",
                       "pislamfusion_tpu_torch/csrc/fastselect.cu",
                       "pislamfusion_tpu/ops/features/fastselect.py:191",
                       None, ms, plain, bound, None)
        else:
            print(f"  K4 {label}: kernel {graph_ms(kernel):.4f} ms")
    print(f"K4 clocks after: {smi_sample()}")
    row["max_abs_err"] = max(errs)
    return row


def k7_agrees(ker, img, L, sf, r):
    """(K7's buffer equals the plain version's, zeros outside the blocks;
    max |kernel - plain| per level block; the plain buffer)."""
    import torch
    from pislamfusion_tpu_torch.ops.features import packedpyr as pp
    pln = pp.build_packed_pyramid_plain(img, L, sf, r)
    torch.cuda.synchronize()
    plan = pp.pyramid_plan(img.shape[0], img.shape[1], L, sf, r)
    errs = []
    live = torch.zeros(ker.shape, dtype=torch.bool, device=ker.device)
    for lvl, (lh, lw) in enumerate(plan.shapes):
        b = plan.bases[lvl]
        live[b:b + lh + 2 * r, :lw + 2 * r] = True
        errs.append(float((ker[b:b + lh + 2 * r, :lw + 2 * r]
                           - pln[b:b + lh + 2 * r, :lw + 2 * r])
                          .abs().max()))
    return (bool(torch.equal(ker, pln)) and not bool(ker[~live].any()),
            errs, pln)


def check_packedpyr(gray, params, r, flush):
    """K7 at the main path's shape: one launch a call; kernel vs plain on
    the whole buffer, every level's (lh + 2r, lw + 2r) block and the zeros
    around them (equal: both sum each pixel's taps as one chain of fused
    multiply-adds), also from a CUDA graph of two calls replayed twice
    (the kernel's counters must be back at 0 after each call); timed
    warm and cold with its bound."""
    import torch
    from pislamfusion_tpu_torch.ops import image as im
    from pislamfusion_tpu_torch.ops.features import packedpyr as pp
    H, W = gray.shape
    L, sf = params.n_levels, params.scale_factor
    if not pp.pyramid_available(H, W, L, sf, r):
        raise AssertionError(f"K7 does not take {H}x{W} / {L} levels")
    n0 = pp.build_packed_pyramid.launches
    ker = pp.build_packed_pyramid(gray, L, sf, r)
    n1 = pp.build_packed_pyramid.launches
    kp = pp.kernel_plan(H, W, L, sf, r)
    d = pp._device_plan(H, W, L, sf, r, str(gray.device))
    kinds = np.bincount(kp.records[:, 0], minlength=3)
    deep = min(pp.K7_FUSE_FROM, L)
    print(f"K7 plan: {kp.tile[0]}x{kp.tile[1]} tiles of depth 1 (levels "
          f"1-{deep - 1}), {kp.fused[0]}x{kp.fused[1]} of depth 2 (levels "
          f"{deep}-{L - 1}), {kinds[2]} tiles, {kinds[1]} pad and "
          f"{kinds[0]} zero items, {kp.n_counters} counters, {kp.smem} "
          f"bytes of shared memory a block, "
          f"{pp.occupancy(kp, gray.device)} resident blocks an SM "
          f"(cudaOccupancyMaxActiveBlocksPerMultiprocessor), grid "
          f"{d['grid']}; launches a call {n1 - n0}")
    if n1 - n0 != 1:
        raise AssertionError(f"K7 launched {n1 - n0} times in one call")
    t = pp.packed_tables(H, W, L, sf, r)
    plan = t.plan
    ok, errs, pln = k7_agrees(ker, gray, L, sf, r)
    err = max(errs)
    print(f"K7 packedpyr {H}x{W} L={L} r={r}: packed {tuple(ker.shape)}, "
          f"max |kernel - plain| per level block "
          f"{', '.join(f'{e:.3e}' for e in errs)}; whole buffer equal, "
          f"zeros outside the blocks: {ok} (bound: equal)")
    # the small strip's frame 0 (600x640, 4 levels; phase 3's input)
    fr_s, _ = render_strip(1, 600, 640, 600.0, 0.24, 1024, gray.device)
    g_s = im.rgb_to_gray(fr_s[0].to(torch.float32))
    ok_s, errs_s, _ = k7_agrees(pp.build_packed_pyramid(g_s, 4, sf, r), g_s,
                                4, sf, r)
    print(f"K7 packedpyr 600x640 L=4 r={r}: max |kernel - plain| per level "
          f"block {', '.join(f'{e:.3e}' for e in errs_s)}; whole buffer "
          f"equal, zeros outside the blocks: {ok_s}")
    if not (ok and ok_s):
        raise AssertionError("K7 disagrees with its plain version")
    # two calls captured in one graph, replayed twice, the outputs filled
    # with NaN between the replays: each replay must compute them again
    graph = torch.cuda.CUDAGraph()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        pp.build_packed_pyramid(gray, L, sf, r)
    torch.cuda.current_stream().wait_stream(side)
    with torch.cuda.graph(graph):
        outs = [pp.build_packed_pyramid(gray, L, sf, r) for _ in range(2)]
    replays = []
    for _ in range(2):
        for o in outs:
            o.fill_(float("nan"))
        graph.replay()
        torch.cuda.synchronize()
        replays.append(all(bool(torch.equal(o, pln)) for o in outs))
    zeroed = not bool(d["counters"].any())
    print(f"K7 graph of 2 calls, replayed twice: equal {replays}, "
          f"counters back at 0 {zeroed}")
    if not (all(replays) and zeroed):
        raise AssertionError("K7 from a replayed graph disagrees with its "
                             "plain version")
    del graph, outs
    kernel = lambda: pp.build_packed_pyramid(gray, L, sf, r)  # noqa: E731
    ms, plain, _ = timed(
        "K7", kernel, lambda: pp.build_packed_pyramid_plain(gray, L, sf, r))
    print(f"  K7 cold L2: kernel {graph_ms_cold(kernel, flush):.4f} ms (a "
          f"{FLUSH_BYTES >> 20} MB write before each call, its own time "
          "subtracted)")
    tabs = sum(a.nbytes for f in ("row_start", "row_len", "row_w",
                                  "col_start", "col_len", "col_w")
               for a in getattr(t, f))
    nbytes = H * W * 4 + plan.total_rows * plan.wpl * 4 + tabs
    ops = 2.0 * sum(float(cl.sum()) * float((rl + 1).sum())
                    for rl, cl in zip(t.row_len, t.col_len))
    bound = bound_ms(nbytes, ops, FP32_OPS_PER_S)
    print(f"  K7 work: {nbytes / 1e6:.2f} MB, {ops / 1e9:.4f} GFLOP; bound "
          f"{bound[0]:.5f} ms ({bound[1]}); 1 launch a call")
    return ker, _row("packedpyr", "pislamfusion_tpu_torch/csrc/packedpyr.cu",
                     "pislamfusion_tpu/ops/features/pyramid_pallas.py:279",
                     err, ms, plain, bound, None)


def edge_centers(H: int, W: int, device):
    """Centres on the four corners and the four edge midpoints of an
    [H, W] image: every patch around them is clamped."""
    import torch
    return torch.tensor([[0, 0], [W - 1, 0], [0, H - 1], [W - 1, H - 1],
                         [W // 2, 0], [W // 2, H - 1], [0, H // 2],
                         [W - 1, H // 2]], dtype=torch.int32, device=device)


def check_patchgather(packed, pxy, radius, flush):
    """K2 on the path's centres and on centres at the buffer's corners and
    edges, bit-exact; timed warm and cold beside one `aten::index` call
    on the two clamped index vectors (built outside the timed calls)."""
    import torch
    from pislamfusion_tpu_torch.ops.features import patchgather as pg
    ker = pg.gather_patches(packed, pxy, radius)
    pln = pg.gather_patches_plain(packed, pxy, radius)
    edge = edge_centers(packed.shape[0], packed.shape[1], packed.device)
    ker_e = pg.gather_patches(packed, edge, radius)
    pln_e = pg.gather_patches_plain(packed, edge, radius)
    torch.cuda.synchronize()
    exact = bool(torch.equal(ker, pln))
    exact_e = bool(torch.equal(ker_e, pln_e))
    err = float((ker - pln).abs().max())
    print(f"K2 patchgather {pxy.shape[0]} centers r={radius} from "
          f"{tuple(packed.shape)}: bit-exact {exact}, max diff {err:.3e}; "
          f"{edge.shape[0]} centres on the corners and edges (clamped): "
          f"bit-exact {exact_e} (bound: exact)")
    if not (exact and exact_e):
        raise AssertionError("K2 disagrees with its plain version")
    G = 2 * radius + 1
    ar = torch.arange(G, device=packed.device)
    xy = pxy.to(torch.int64)
    iy = (xy[:, 1:2] - radius + ar).clamp(0, packed.shape[0] - 1)
    ix = (xy[:, 0:1] - radius + ar).clamp(0, packed.shape[1] - 1)
    kernel = lambda: pg.gather_patches(packed, pxy, radius)  # noqa: E731
    ms, plain, library = timed(
        "K2", kernel, lambda: pg.gather_patches_plain(packed, pxy, radius),
        lambda: packed[iy[:, :, None], ix[:, None, :]])
    print(f"  K2 cold L2: kernel {graph_ms_cold(kernel, flush):.4f} ms (a "
          f"{FLUSH_BYTES >> 20} MB write before each call, its own time "
          "subtracted)")
    # bytes: the distinct source pixels the patches cover, the centers,
    # and the patches
    touched = torch.zeros(packed.shape, dtype=torch.bool,
                          device=packed.device)
    touched[iy[:, :, None], ix[:, None, :]] = True
    nbytes = (int(touched.sum()) * 4 + pxy.numel() * 4
              + ker.numel() * 4)
    return _row("patchgather", "pislamfusion_tpu_torch/csrc/patchgather.cu",
                "pislamfusion_tpu/ops/features/patchgather.py:148", err, ms,
                plain, bound_ms(nbytes, 0.0, FP32_OPS_PER_S), library)


def k3_cases(frames, poses, fx, device):
    """K3's four cases, (label, src, h, patch_hw): FastVO's half resolution
    (frame 0's pyrDown into the half-res patch of bench.py's geometry) and
    the Map2D engine's full resolution (frame 0 into its 1536^2 patch),
    each for the survey map and the map turned 100 degrees (the
    transposed path)."""
    import torch
    from pislamfusion_tpu_torch.models import fastvo as fv
    from pislamfusion_tpu_torch.ops import image as im
    from pislamfusion_tpu_torch.ops import shearwarp as sw
    H, W = frames.shape[1:3]
    vo = make_fastvo(H, W, fx, poses, 1000, 8, 5, device)
    pose0 = torch.as_tensor(poses[0]).to(device)
    _, Hc2i = vo._patch_homography(pose0)
    half = (vo.patch_tiles * fv.ELE // 2,) * 2
    s_half = torch.diag(torch.tensor([0.5, 0.5, 1.0], device=device))
    s_two = torch.diag(torch.tensor([2.0, 2.0, 1.0], device=device))
    h_hs = s_half @ Hc2i @ s_two
    m2d = make_map2d(3, H, W, fx, poses, device)
    _, h_np = m2d._frame_geometry(poses[0].astype(np.float64))
    full = (m2d.patch_tiles * fv.ELE,) * 2
    h_full = torch.from_numpy(h_np.astype(np.float32)).to(device)
    src = im.pyr_down(frames[0].to(torch.float32))
    rgb0 = frames[0].to(torch.float32)
    cases = [("survey", src, h_hs, half),
             ("rotated 100 deg", src, rotate_about_center(h_hs, 100.0,
                                                          half), half),
             ("full-res survey", rgb0, h_full, full),
             ("full-res rotated 100 deg", rgb0,
              rotate_about_center(h_full, 100.0, full), full)]
    for label, _, h, _ in cases:
        if bool(sw._choose_transpose(h)) != ("rotated" in label):
            raise AssertionError(f"K3 case {label}: expected the "
                                 f"{'transposed' if 'rotated' in label else 'plain'}"
                                 " path")
    return cases


def check_shearwarp(cases):
    """K3 on each (label, src, h, patch_hw) of `cases`: kernel vs plain,
    each timed beside its bound; the first of each resolution beside
    grid_sample. Returns the first case's row."""
    import torch
    import torch.nn.functional as F
    from pislamfusion_tpu_torch.ops import image as im
    from pislamfusion_tpu_torch.ops import shearwarp as sw
    errs, times, seen = [], [], set()
    for label, src, h, patch_hw in cases:
        out, live, fit = sw.warp_patch(src, h, patch_hw)
        ref, live_p, _ = sw.warp_patch_plain(src, h, patch_hw)
        torch.cuda.synchronize()
        tr = bool(sw._choose_transpose(h))
        if not torch.equal(live, live_p):
            raise AssertionError(f"K3 {label}: live tiles differ")
        err = float((out - ref).abs().max())
        dead = ~torch.repeat_interleave(torch.repeat_interleave(
            live, sw.TILE, 0), sw.TILE, 1)
        dead_max = float(out[dead].abs().max()) if bool(dead.any()) else 0.0
        print(f"K3 shearwarp {label}: {tuple(src.shape)} -> "
              f"{patch_hw + (src.shape[2],)}, transposed {tr}, live "
              f"{int(live.sum())}/{live.numel()}, fit err {float(fit):.3f}"
              f" px, max |kernel - plain| {err:.3e} (bound 1e-3), dead "
              f"tiles max {dead_max}, bit-equal {bool(torch.equal(out, ref))}")
        if err > 1e-3 or dead_max != 0.0:
            raise AssertionError(f"K3 {label} disagrees with its plain "
                                 "version")
        errs.append(err)
        tr_t, prm, win = sw._params(src, h, patch_hw, sw.TILE, 2.2)
        library = None
        if patch_hw not in seen:
            # library yardstick: torch's bilinear grid_sample of the same
            # source at the same output size (a different function:
            # projective bilinear sampling, not the two-pass resample)
            seen.add(patch_hw)
            grid = im.homography_grid(h, patch_hw)
            Hs, Ws = src.shape[0], src.shape[1]
            gn = torch.stack([grid[..., 0] * 2 / (Ws - 1) - 1,
                              grid[..., 1] * 2 / (Hs - 1) - 1], -1)[None]
            src_nchw = src.permute(2, 0, 1)[None].contiguous()
            library = lambda: F.grid_sample(  # noqa: E731
                src_nchw, gn, mode="bilinear", align_corners=True)
        ms = timed(f"K3 {label}", lambda: sw.launch_kernel(
            src, tr_t, prm, patch_hw, sw.TILE, win),
            lambda: sw.warp_patch_plain(src, h, patch_hw), library)
        ph, pw = patch_hw
        C = src.shape[2]
        nbytes = src.numel() * 4 + 9 * 4 + ph * pw * C * 4
        ops = ph * pw * (C * 24.0 + 40.0)
        bound = bound_ms(nbytes, ops, FP32_OPS_PER_S)
        print(f"  K3 {label}: bound {bound[0]:.5f} ms ({bound[1]}), kernel "
              f"{ms[0] / bound[0]:.2f}x; {sw.occupancy(C, win, src.device)}"
              f" resident blocks an SM at {sw.smem_bytes(win, C)} bytes of "
              "shared memory")
        times.append((ms, bound))
    (ms, plain, library), bound = times[0]
    return _row("shearwarp", "pislamfusion_tpu_torch/csrc/shearwarp.cu",
                "pislamfusion_tpu/ops/shearwarp.py:505", max(errs),
                ms, plain, bound, library)


def check_bandedstack(xs, params, flush):
    """K5 on each octave input x [h, w] (0..1) of `xs`: kernel vs plain,
    its launch plan and resident blocks an SM; each octave timed (warm
    L2) beside its bound, the first also with a cold L2 and beside its
    plain version and library yardstick."""
    import torch
    from pislamfusion_tpu_torch.ops import stencil
    from pislamfusion_tpu_torch.ops.features import sift
    errs, row = [], None
    for x in xs:
        h, w = x.shape
        tabs = sift._stack_tables(h, w, params)
        if tabs is None:
            raise AssertionError(f"K5 does not take {h}x{w}")
        ker = stencil.banded_stack(x, tabs)
        pln = stencil.banded_stack_plain(x, tabs)
        torch.cuda.synchronize()
        errs.append(float((ker - pln).abs().max()))
        print(f"K5 bandedstack {h}x{w}, {tabs.scales} scales, half-widths "
              f"{[int(r) for r in tabs.radius]}: max |kernel - plain| "
              f"{errs[-1]:.3e} (bound 1e-5 on the 0..1 scale; f32 sums in "
              "another order)")
        if not errs[-1] <= 1e-5:
            raise AssertionError(f"K5 {h}x{w} disagrees with its plain "
                                 "version")
        plan, _, occ, sms = stencil._stack_on(tabs, x.device)
        print(f"  K5 {h}x{w} plan: {plan.th}-row tiles, widths {plan.tw} "
              f"(t1 columns {plan.cw}), {plan.n_items} items, "
              f"{plan.nslot} column block slots, {plan.smem} bytes of "
              f"shared memory a block, {occ} resident blocks an SM "
              f"(cudaOccupancyMaxActiveBlocksPerMultiprocessor), grid "
              f"{min(plan.n_items, occ * sms)}")
        nbytes = (1 + tabs.scales) * h * w * 4 + sum(
            a.nbytes for a in (tabs.row_start, tabs.row_len, tabs.row_w,
                               tabs.col_start, tabs.col_len, tabs.col_w))
        ops = 2.0 * (float(tabs.row_len.sum()) * w
                     + float(tabs.col_len.sum()) * h)
        bound = bound_ms(nbytes, ops, FP32_OPS_PER_S)
        # the multiply-adds the plan does: each item's row pass over cw
        # t1 columns, its column pass over its outputs
        done = sum(2.0 * (2 * r + 1) * min(plan.th, h - ty * plan.th)
                   * (plan.cw[s] + min(plan.tw[s], w - tx * plan.tw[s]))
                   for s, r in enumerate(plan.rh)
                   for ty in range(plan.nty) for tx in range(plan.ntx[s]))
        kernel = lambda: stencil.banded_stack(x, tabs)  # noqa: E731
        if row is None:
            # library yardstick: two dense f32 torch.matmul a scale (TF32
            # off)
            mhs, mws = stencil._dense_on(tabs, x.device)
            ms, plain, library = timed(
                f"K5 {h}x{w}", kernel,
                lambda: stencil.banded_stack_plain(x, tabs),
                lambda: [torch.matmul(torch.matmul(mhs[p], x), mws[p].T)
                         for p in range(tabs.scales)])
            cold = graph_ms_cold(kernel, flush)
            row = (ms, plain, library, bound, nbytes, ops)
        else:
            ms, cold = graph_ms(kernel), None
        print(f"  K5 {h}x{w}: kernel {ms:.4f} ms"
              + ("" if cold is None else f", cold L2 {cold:.4f} ms")
              + f", bound {bound[0]:.5f} ms ({bound[1]}), "
              f"{ms / bound[0]:.2f}x; {ops / 1e9:.3f} GFLOP counted, "
              f"{done / 1e9:.3f} done by the plan ({done / ops:.2f}x), "
              f"{nbytes / 1e6:.1f} MB")
    ms, plain, library, bound, _, _ = row
    return _row("bandedstack", "pislamfusion_tpu_torch/csrc/bandedstack.cu",
                "pislamfusion_tpu/ops/stencil_pallas.py:338", max(errs), ms,
                plain, bound, library)


def check_bilineargrid(grad, grids, flush):
    """K6 on the packed gradient image grad [Hp, W, 2] at each (label,
    centers, rel) of `grids`: kernel vs plain, each grid timed beside
    grid_sample (the library yardstick), the first also with a cold L2.
    Returns the row of the first grid."""
    import torch
    import torch.nn.functional as F
    from pislamfusion_tpu_torch.ops.features import patchgather as pg
    from pislamfusion_tpu_torch.ops.features import sift
    R = sift.GRID_RADIUS
    Hp, W, C = grad.shape
    errs, figs = [], []
    for label, centers, rel in grids:
        if not float(rel.abs().max()) < R:
            raise AssertionError(f"K6 {label}: an offset reaches the radius")
        ker = pg.bilinear_grid(grad, centers, rel, R)
        pln = pg.bilinear_grid_plain(grad, centers, rel, R)
        torch.cuda.synchronize()
        errs.append(float((ker - pln).abs().max()))
        print(f"K6 bilineargrid {label}: {tuple(grad.shape)}, "
              f"{centers.shape[0]} keypoints x {rel.shape[2]} samples: max "
              f"|kernel - plain| {errs[-1]:.3e}, bit-equal "
              f"{bool(torch.equal(ker, pln))} (bound 1e-4)")
        if not errs[-1] <= 1e-4:
            raise AssertionError(f"K6 {label} disagrees with its plain "
                                 "version")
        # library yardstick: grid_sample's zero-padded bilinear at the same
        # points (align_corners: pixel centres at -1 and 1)
        px = centers[:, 0:1].to(torch.float32) + rel[:, 0]
        py = centers[:, 1:2].to(torch.float32) + rel[:, 1]
        gn = torch.stack([px * (2.0 / (W - 1)) - 1.0,
                          py * (2.0 / (Hp - 1)) - 1.0], -1)[None]
        src = grad.permute(2, 0, 1)[None].contiguous()
        kernel = lambda: pg.bilinear_grid(grad, centers, rel, R)  # noqa
        ms, plain, library = timed(
            f"K6 {label}", kernel,
            lambda: pg.bilinear_grid_plain(grad, centers, rel, R),
            lambda: F.grid_sample(src, gn, mode="bilinear",
                                  padding_mode="zeros", align_corners=True))
        if not figs:
            print(f"  K6 {label} cold L2: kernel "
                  f"{graph_ms_cold(kernel, flush):.4f} ms (a "
                  f"{FLUSH_BYTES >> 20} MB write before each call, its own "
                  "time subtracted)")
        figs.append((label, centers, rel, ms, plain, library))
    _, centers, rel, ms, plain, library = figs[0]
    # bytes: the in-image pixels the taps cover, the offsets, the centres
    # and the samples
    WH, _, WWpx, ya, xa, dy0, dx0 = pg._grid_geometry(centers, C, R)
    iy = ya[:, None] + torch.floor(rel[:, 1] + dy0[:, None].to(
        torch.float32)).clamp(0, WH - 2).to(torch.int64) - (R + 2)
    ix = xa[:, None] + torch.floor(rel[:, 0] + dx0[:, None].to(
        torch.float32)).clamp(0, WWpx - 2).to(torch.int64) - (R + 2)
    touched = torch.zeros((Hp + 2, W + 2), dtype=torch.bool,
                          device=grad.device)
    for dy in (0, 1):
        for dx in (0, 1):
            touched[(iy + dy).clamp(-1, Hp) + 1,
                    (ix + dx).clamp(-1, W) + 1] = True
    n_px = int(touched[1:-1, 1:-1].sum())
    K, _, M = rel.shape
    nbytes = n_px * C * 4 + (rel.numel() + centers.numel() + K * M * C) * 4
    ops = K * M * (8.0 + 9.0 * C)
    return _row("bilineargrid", "pislamfusion_tpu_torch/csrc/bilineargrid.cu",
                "pislamfusion_tpu/ops/features/patchgather.py:282",
                max(errs), ms, plain, bound_ms(nbytes, ops, FP32_OPS_PER_S),
                library)


def check_bandedsandwich(cases, flush):
    """K8 on each (label, x, tables, cold) of `cases`: kernel vs plain
    (torch.equal: the same f32 products and sums in the same order), each
    timed with its plain version and the library yardstick (two dense f32
    torch.matmul, TF32 off) beside its bound, and with a cold L2 where
    `cold`. Prints each case's launch plan and the kernel's resident
    blocks an SM. Returns the row of the first case and the per-case
    figures."""
    import torch
    from pislamfusion_tpu_torch.ops import stencil
    errs, figs = [], []
    for label, x, tabs, cold in cases:
        ker = stencil.banded_sandwich(x, tabs)
        pln = stencil.banded_sandwich_plain(x, tabs)
        torch.cuda.synchronize()
        err = float((ker - pln).abs().max())
        exact = bool(torch.equal(ker, pln))
        errs.append(err)
        H, W, C = x.shape
        Ho, Wo = tabs.out_shape
        plan, _, occ, sms = stencil._plan_on(tabs, C, x.device)
        ntr, ntc = plan.tiles
        print(f"K8 bandedsandwich {label}: {H}x{W}x{C} -> {Ho}x{Wo}x{C}, "
              f"max |kernel - plain| {err:.3e}, bit-equal {exact} (the gate: "
              "equal)")
        print(f"  K8 {label} plan: {plan.tr}x{plan.tc} output tiles "
              f"({ntr}x{ntc}), tap bound {plan.K}, {plan.smem} bytes of "
              f"shared memory a block, {occ} resident blocks an SM "
              f"(cudaOccupancyMaxActiveBlocksPerMultiprocessor), grid "
              f"{min(ntr * ntc, occ * sms)}")
        if not exact:
            raise AssertionError(f"K8 {label} disagrees with its plain "
                                 "version")
        mh = _dense_rows(tabs.row_start, tabs.row_len, tabs.row_w, H,
                         x.device)
        mw = _dense_rows(tabs.col_start, tabs.col_len, tabs.col_w, W,
                         x.device)
        x2 = x.reshape(H, W * C)
        kernel = lambda: stencil.banded_sandwich(x, tabs)  # noqa: E731
        ms, plain, library = timed(
            f"K8 {label}", kernel,
            lambda: stencil.banded_sandwich_plain(x, tabs),
            lambda: torch.matmul(mw, torch.matmul(mh, x2).view(Ho, W, C)))
        del mh, mw
        nbytes = (x.numel() + Ho * Wo * C) * 4 + sum(
            a.nbytes for a in (tabs.row_start, tabs.row_len, tabs.row_w,
                               tabs.col_start, tabs.col_len, tabs.col_w))
        ops = 2.0 * C * (float(tabs.row_len.sum()) * W
                         + float(tabs.col_len.sum()) * Ho)
        bound = bound_ms(nbytes, ops, FP32_OPS_PER_S)
        ms_cold = graph_ms_cold(kernel, flush) if cold else None
        print(f"  K8 {label} work: {nbytes / 1e6:.2f} MB, {ops / 1e9:.4f} "
              f"GFLOP; bound {bound[0]:.5f} ms ({bound[1]}); kernel "
              f"{ms / bound[0]:.2f}x the bound"
              + ("" if ms_cold is None else
                 f"; cold L2 {ms_cold:.4f} ms ({ms_cold / bound[0]:.2f}x)"))
        figs.append((label, err, ms, plain, library, bound, ms_cold))
    _, err, ms, plain, library, bound, _ = figs[0]
    return _row("bandedsandwich",
                "pislamfusion_tpu_torch/csrc/bandedsandwich.cu",
                "pislamfusion_tpu/ops/stencil_pallas.py:178", max(errs), ms,
                plain, bound, library), figs


def _dense_rows(start, length, w, n_in, device):
    """The dense [n_out, n_in] float32 matrix of a set of row spans (for
    the library yardstick only)."""
    import torch
    m = np.zeros((start.shape[0], n_in), np.float32)
    for r in range(start.shape[0]):
        m[r, start[r]:start[r] + length[r]] = w[r, :length[r]]
    return torch.from_numpy(m).to(device)


def rotate_about_center(h, theta_deg, hw):
    """h composed with a rotation of the patch by theta about its center."""
    import torch
    th = math.radians(theta_deg)
    cy, cx = hw[0] / 2.0, hw[1] / 2.0
    c, s = math.cos(th), math.sin(th)
    R = torch.tensor([[c, -s, cx - c * cx + s * cy],
                      [s, c, cy - s * cx - c * cy],
                      [0.0, 0.0, 1.0]], dtype=h.dtype, device=h.device)
    return h @ R


# ---------------------------------------------------------------------------
# phase 2: the main path at full width, timed and broken down by stage
# ---------------------------------------------------------------------------

def stage_breakdown(vo, frames, pose0):
    """Mean device ms per frame of each stage of FastVO's step (ORB:
    pyramid, FAST+NMS+select, descriptor tail; SIFT: octave stacks,
    extrema+select, orientation+descriptor; then match+LM and feed), from
    the CUDA events
    that one more pass of `process_tensor` records as each stage is
    enqueued."""
    import torch
    carry = vo.initial_carry(frames[0], pose0)
    evs = []

    def mark(stage):
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        evs.append((stage, e))

    mark("start")
    vo.process_tensor(frames, pose0, carry, mark)
    torch.cuda.synchronize()
    ms = {}
    for (_, e0), (stage, e1) in zip(evs, evs[1:]):
        ms[stage] = ms.get(stage, 0.0) + e0.elapsed_time(e1)
    return {k: v / frames.shape[0] for k, v in ms.items()}


def profile_frames(run, k: int):
    """run() (k frames) once more under torch.profiler: the device's busy
    share over the pass (the union of its kernels' intervals over the span
    from the first kernel's start to the last one's end), device time by
    kernel name and host time by operator."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    dev, host = {}, {}
    spans = []
    for e in prof.events():
        us = e.time_range.end - e.time_range.start
        if e.device_type.name == "CUDA":
            if getattr(e, "is_user_annotation", False):
                continue    # a record_function range, not device work
            dev[e.name] = dev.get(e.name, 0.0) + us
            spans.append((e.time_range.start, e.time_range.end))
        else:
            host[e.name] = host.get(e.name, 0.0) + e.self_cpu_time_total
    spans.sort()
    busy, end = 0.0, -math.inf
    for s, t in spans:
        if t > end:
            busy += t - max(s, end)
            end = t
    window = spans[-1][1] - spans[0][0]
    print(f"profile of {k} frames: device busy {busy / 1e3:.3f} ms of a "
          f"{window / 1e3:.3f} ms window ({busy / window:.1%}), "
          f"{len(spans)} device activities ({len(spans) / k:.0f} a frame)")
    for title, d in (("device ms/frame by kernel", dev),
                     ("host self ms/frame by op", host)):
        print(title + ":")
        for name, us in sorted(d.items(), key=lambda kv: -kv[1])[:15]:
            print(f"  {us / 1e3 / k:9.3f}  {name[:100]}")
    # the port's kernels, every instantiation of each `<name>_kernel`
    # summed
    from pislamfusion_tpu_torch import _build
    ours = {n: sum(us for name, us in dev.items()
                   if f"{n}_kernel" in name)
            for n in _build.KERNELS}
    print("port kernels, device ms/frame: " + ", ".join(
        f"{n} {us / 1e3 / k:.4f}" for n, us in ours.items() if us))


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "runs the port on a CUDA GPU only", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from pislamfusion_tpu_torch import _build
    from pislamfusion_tpu_torch.models import fastvo as fv
    from pislamfusion_tpu_torch.ops import image as im
    from pislamfusion_tpu_torch.ops import shearwarp as sw
    from pislamfusion_tpu_torch.ops import stencil
    from pislamfusion_tpu_torch.ops.features import (fastselect, flatpyr,
                                                     orb, packedpyr, sift)
    from pislamfusion_tpu_torch.ops.features import patchgather as pg

    # fp32 products in full fp32 (the reference's HIGHEST): TF32 off for
    # matmuls and convolutions
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("torch.backends.cuda.matmul.allow_tf32 = False, "
          "torch.backends.cudnn.allow_tf32 = False")
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)} "
          f"x{torch.cuda.device_count()}")

    t_run = time.perf_counter()

    def lap(phases):
        print(f"chip_smoke: {phases} done {time.perf_counter() - t_run:.1f}"
              " s into the run", flush=True)

    t0 = time.perf_counter()
    logs = _build.build_all()
    print(f"built {', '.join(_build.KERNELS)} in "
          f"{time.perf_counter() - t0:.1f} s (parallel nvcc, sm_90a)")
    for name, log in logs.items():
        for ln in log.splitlines():
            if "registers" in ln or "spill" in ln:
                print(f"  {name}: {ln.strip()}")

    # ---- the main paths' inputs: bench.py's 1080p strip
    H, W, fx, K = 1080, 1920, 1200.0, 24
    t0 = time.perf_counter()
    frames, poses = render_strip(K, H, W, fx, 0.12, 6144, dev)
    torch.cuda.synchronize()
    print(f"rendered {K} frames {W}x{H} in {time.perf_counter() - t0:.1f} s")
    vo = make_fastvo(H, W, fx, poses, 1000, 8, 5, dev)
    params = vo.params
    pose0 = torch.as_tensor(poses[0]).to(dev)

    # ---- phase 1: kernels against their plain versions
    gray = im.rgb_to_gray(frames[0].to(torch.float32))
    flush = torch.empty(FLUSH_BYTES // 4, dtype=torch.float32, device=dev)
    packed, k1 = check_flatpyr(gray, params, flush)
    plan = orb._flat_plan(H, W, params.n_levels, params.scale_factor,
                          params.cell)
    views = [packed[b + plan.cell:b + plan.cell + lh,
                    plan.pad_left:plan.pad_left + lw]
             for b, (lh, lw) in zip(plan.bases, plan.shapes)]
    offs = [(plan.pad_left, b + plan.cell) for b in plan.bases]
    picks = orb.select_levels(packed, views, offs, params)
    pxy = torch.cat([xy + torch.tensor(
        [[plan.pad_left, b + plan.cell]], dtype=torch.int32, device=dev)
        for (xy, _, _), b in zip(picks, plan.bases)])
    k2 = check_patchgather(packed, pxy, orb._GATHER_R, flush)
    # K7 at 1080p; K4 on K1's and K7's 1080p pyramids (the same level
    # shapes at other pitches and offsets), on K7's pyramid of the small
    # strip's frame 0 (600x640, 4 levels) and on the noise frame's K1
    # pyramid, its bound at the f32 rates measured here
    r = orb._GATHER_R
    packed7, k7 = check_packedpyr(gray, params, r, flush)
    del packed7
    sys.path.insert(0, os.path.join(os.path.dirname(
        os.path.abspath(__file__)), "scripts"))
    from torch_k4_k3_sweep import f32_rates
    rates = f32_rates(dev)
    print(f"f32 rates on this card: min/max {rates['minmax']:.4e}/s, add "
          f"{rates['add']:.4e}/s (scripts/torch_k4_k3_sweep.py f32_rates)")
    k4 = check_fastselect(k4_cases(frames[0], params, dev), params, flush,
                          rates)
    # K3 at FastVO's half resolution and at the Map2D engine's full
    # resolution, each also for a map 100 degrees away (transposed)
    cases3 = k3_cases(frames, poses, fx, dev)
    k3 = check_shearwarp(cases3)
    src, h_hs, half = cases3[0][1:]
    rgb0, h_full, full = cases3[2][1:]
    _, Hc2i = vo._patch_homography(pose0)
    s_two = torch.diag(torch.tensor([2.0, 2.0, 1.0], device=dev))
    m2d = make_map2d(3, H, W, fx, poses, dev)
    # K5 and K6 on frame 0's SIFT detection: octave 0's input, and the
    # packed gradient image with the orientation and descriptor grids
    sp = sift.SiftParams(n_features=1000)
    stacks = sift.build_stacks(gray, sp)
    # every octave input that takes K5 (at 1080p octaves 0-2)
    k5 = check_bandedstack([s[0] for s in stacks if min(s.shape[1:]) >= 256
                            and sift._stack_tables(*s.shape[1:], sp)
                            is not None], sp, flush)
    grad, (cx, cy, sig, bounds), _ = sift.pack_gradients(
        stacks, sift.select_octaves(stacks, sp), (H, W), sp)
    angle = sift._orientations(grad, cx, cy, sig, sp, bounds)
    grids = [(label, *sift._grid_points(cx, cy, a, sig, 16, r, bounds)[:2])
             for label, a, r in (
                 ("orientation grid", torch.zeros_like(cx), 4.5),
                 ("descriptor grid", angle, 1.5 * sp.desc_grid / 2.0))]
    k6 = check_bilineargrid(grad, grids, flush)
    # K8 at the shapes of the Map2D path (Type 3: the full-res patch's
    # Laplacian pyrDown and pyrUp, the weight chain, blended()'s pyrUp of
    # the canvas bands) and of FastVO's feed (the 1080p source's pyrDown,
    # the half-res patch's pyramid, band 0's weight pyrUp); the two
    # largest reads also with a cold L2
    from pislamfusion_tpu_torch.ops import mosaic as M
    patch = sw.warp_patch(rgb0, h_full, full)[0]
    w0 = M.analytic_weight_pyramid(h_full, (H, W), full, 0)[0]
    ch, cw = m2d.h_tiles * fv.ELE, m2d.w_tiles * fv.ELE
    lap1 = torch.from_numpy(np.random.default_rng(8).normal(
        0, 8, (ch // 2, cw // 2, 3)).astype(np.float32)).to(dev)
    fv_patch = sw.warp_patch(src, h_hs, half)[0]
    w_half = M.analytic_weight_pyramid(Hc2i @ s_two, (H, W), half, 0)[0]
    p0, p1 = full[0], full[0] // 2
    k8, k8_figs = check_bandedsandwich([
        (f"Map2D pyrDown {p0}^2x3", patch, im.pyr_tables(
            "down", p0, p0, p1, p1), True),
        (f"Map2D pyrUp {p1}^2x3", im.pyr_down(patch), im.pyr_tables(
            "up", p1, p1, p0, p0), False),
        (f"Map2D weight pyrDown {p0}^2x1", w0, im.pyr_tables(
            "down", p0, p0, p1, p1), False),
        (f"Map2D blended() canvas pyrUp {cw // 2}x{ch // 2}x3", lap1,
         im.pyr_tables("up", ch // 2, cw // 2, ch, cw), False),
        (f"FastVO pyrDown {half[0]}^2x3", fv_patch, im.pyr_tables(
            "down", half[0], half[1], half[0] // 2, half[1] // 2), False),
        (f"FastVO source pyrDown {H}x{W}x3", rgb0, im.pyr_tables(
            "down", H, W, (H + 1) // 2, (W + 1) // 2), True),
        (f"FastVO weight pyrUp {half[0]}^2x1", w_half, im.pyr_tables(
            "up", half[0], half[1], 2 * half[0], 2 * half[1]), False),
    ], flush)
    del m2d, patch, w0, lap1, fv_patch, w_half, flush
    rows = [k1, k2, k3, k4, k5, k6, k7, k8]
    wrappers = _build.kernel_wrappers()

    # ---- phase 2: the main paths, through FastVO.process
    orb_launches = run_main_path(
        "ORB", lambda: make_fastvo(H, W, fx, poses, 1000, 8, 5, dev),
        frames, poses, wrappers, ("flatpyr", "fastselect", "patchgather",
                                  "shearwarp", "bandedsandwich"))
    packed_launches = run_main_path(
        "ORB", lambda: make_fastvo(H, W, fx, poses, 1000, 8, 5, dev,
                                   pyramid="packed"),
        frames, poses, wrappers, ("packedpyr", "fastselect", "patchgather",
                                  "shearwarp", "bandedsandwich"),
        variant=" (pyramid=packed)")
    sift_launches = run_main_path(
        "SIFT", lambda: make_fastvo(H, W, fx, poses, 1000, 8, 5, dev,
                                    "sift"),
        frames, poses, wrappers, ("shearwarp", "bandedstack",
                                  "bilineargrid", "bandedsandwich"))
    # ---- phase 2b: the Map2D engines through create_map2d / prepare /
    # feed / blended: Type 3 (the default) and Type 4 with seams
    map2d_launches = run_map2d(
        "Map2D Type 3 (MultiBand)",
        lambda: make_map2d(3, H, W, fx, poses, dev), frames, poses,
        wrappers, ("shearwarp", "bandedsandwich"))
    run_map2d(
        "Map2D Type 4 (Render, EnableSeam, RenderBatch 8)",
        lambda: make_map2d(4, H, W, fx, poses, dev, {
            "Map2DRender.EnableSeam": 1, "Map2D.RenderBatch": 8}),
        frames, poses, wrappers, ("shearwarp", "bandedsandwich"))
    # ---- phase 2c: SLAM's solvers at full width, from orb_detect (K1, K4,
    # K2) through the initializers, PnP, BA and multih
    chain = run_solver_phase(frames, poses, fx, wrappers)[3]
    lap("phases 1, 2, 2b and 2c")
    del frames
    frames_s, poses_s = render_strip(36, H, W, fx, 0.12, 6144, dev)
    # ---- phase 2g: scale-out over 4 shards of the card: process_survey
    # (plain and drift-corrected) over frames 0-24, dist_ba on phase 2c's
    # BA problem, dist_mosaic, dist_ransac and the batched detectors
    scaleout_launches = run_scaleout_phase(
        frames_s, poses_s, fx, dev, wrappers, card,
        (chain["ba_problem"], chain["ba"]))
    del chain
    # ---- phase 2d: SLAM at full width through create_slam / track,
    # offline: ORB-1000 on 36 frames of the strip, SIFT-1000 on 18
    run_slam_phase("ORB", frames_s, poses_s, fx, dev, wrappers,
                   ("flatpyr", "fastselect", "patchgather"),
                   SLAM_MIN_KEYFRAMES)
    run_slam_phase("Sift", frames_s[:18], poses_s[:18], fx, dev, wrappers,
                   ("bandedstack", "bilineargrid"))
    # ---- phase 2f: online SLAM (bench.py's SLAM pass, cut): ORB-1000 over
    # 19 frames out and back in the four (TrackChain, TrackScale)
    # configurations, once each, then SIFT-1000 chained
    run_online_phase(frames_s, poses_s, fx, dev, wrappers, card)
    del frames_s
    lap("phases 2g, 2d and 2f")
    # ---- phase 2e: the fused system through app.main: Act=SLAM (SLAM with
    # the fusion consumer thread and the exporters), then Act=Survey, on a
    # two-row 1080p survey with GPS; then phase 2f's online Act=SLAM call
    # over the same dataset
    run_fused_phase(dev, wrappers, card, then=lambda ds, p, root:
                    run_online_app(ds, p, root, wrappers, card))
    lap("phase 2e and phase 2f's Act=SLAM")
    # ---- phase 3: the card against the port's CPU runs
    run_phase3(dev)
    lap("phase 3")
    # ---- phase 2h: the JAX package's end-to-end SLAM suites (the soak,
    # parallax, blur and noise) at their own scenes and bars
    e2e_launches = run_e2e_phase(dev, wrappers, card)
    lap("phase 2h")
    # ---- phase 2i: the vocabulary trainers on the card, and one
    # combination of the ablation grid through the harness
    ablation_launches = run_ablation_phase(dev, wrappers, card)
    lap("phase 2i")
    for row in rows:
        # each kernel's count from the path it was ported for
        path = (orb_launches if row["name"] in (
            "flatpyr", "patchgather", "shearwarp", "fastselect")
            else packed_launches if row["name"] == "packedpyr"
            else map2d_launches if row["name"] == "bandedsandwich"
            else sift_launches)
        row["launches"] = path[row["name"]]
        # and over phase 2g (the mesh of 4 shards: surveys, mosaic, BA,
        # PnP and the batched detectors)
        row["launches_2g"] = scaleout_launches[row["name"]]
        # and over phase 2h (the end-to-end SLAM cases)
        row["launches_2h"] = e2e_launches[row["name"]]
        # and over phase 2i (the trainers and the harness's combination)
        row["launches_2i"] = ablation_launches[row["name"]]

    print(card)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def run_phase3(dev):
    """Phase 3: the card against the port's CPU runs."""
    card_vs_cpu("orb", dev)
    card_vs_cpu("orb", dev, pyramid="packed")
    card_vs_cpu("sift", dev)
    brief_card_vs_cpu(dev)
    survey_card_vs_cpu(dev)
    map2d_card_vs_cpu(dev)
    solver_card_vs_cpu(dev)
    slam_card_vs_cpu(dev)
    fusion_card_vs_cpu(dev)


def run_main_path(label, make, frames, poses, wrappers, path_kernels,
                  variant=""):
    """A warm-up pass, then a fresh FastVO timed over the frames with every
    launch count of `wrappers` ({kernel: wrapper}) set to 0 just before
    and read just after; tracking gates, a per-stage pass and a profiled
    pass. `label` is the detector ("ORB" or "SIFT"), `variant` what the
    lines add to it. Returns {kernel: launches}."""
    import torch
    vo = make()
    vo.process(frames, poses[0])                 # warm-up pass
    vo = make()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for fn in wrappers.values():
        fn.launches = 0
    ev0 = torch.cuda.Event(enable_timing=True)
    ev1 = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    ev0.record()
    est, n_match = vo.process(frames, poses[0])
    ev1.record()
    ev1.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in wrappers.items()}
    dev_ms = ev0.elapsed_time(ev1)
    peak = torch.cuda.max_memory_allocated()
    K, H, W = frames.shape[:3]
    p = vo.params
    what = (f"ORB-{p.n_features}, {p.n_levels} levels" if label == "ORB"
            else f"SIFT-{p.n_features}, {p.n_octaves} octaves, "
            f"{p.scales_per_octave} scales")
    print(f"{label} FastVO.process{variant} {K} frames {W}x{H} ({what}, "
          f"{vo.bands} bands, canvas {vo.canvas_tiles} tiles, patch "
          f"{vo.patch_tiles} "
          f"tiles): {K / (dev_ms / 1e3):.2f} frames/s, {dev_ms / K:.3f} "
          f"ms/frame (CUDA events; host clock {wall * 1e3 / K:.3f} "
          "ms/frame)")
    label += variant
    print(f"{label} peak device memory {peak / 2**20:.1f} MiB")
    print(f"{label} n_match {n_match.tolist()}")
    drift = float(np.linalg.norm(est[-1, :3] - poses[-1, :3]))
    print(f"{label} VO drift over {K} frames: {drift:.3f} m")
    print(f"{label} launches in that run: " + ", ".join(
        f"{k} {n}" for k, n in launches.items()))
    if not (n_match[1:] > 50).all():
        raise AssertionError(f"{label}: VO lost track: {n_match}")
    if not np.isfinite(est).all():
        raise AssertionError(f"{label}: non-finite poses")
    if min(launches[k] for k in path_kernels) <= 0:
        raise AssertionError(f"{label}: a kernel of the path was not "
                             f"launched: {launches}")
    img, covered = vo.blended()
    if not (np.isfinite(img).all() and covered.mean() > 0.05):
        raise AssertionError(f"{label}: blended mosaic is not finite or is "
                             "empty")
    print(f"{label} mosaic {img.shape}, covered {covered.mean():.3f}")
    pose0 = torch.as_tensor(poses[0]).to(frames.device)
    stages = stage_breakdown(vo, frames, pose0)
    print(f"{label} per-stage ms/frame: " + ", ".join(
        f"{k} {v:.3f}" for k, v in stages.items()))
    profile_frames(lambda: vo.process(frames[:8], poses[0]), 8)
    return launches


def make_map2d(map2d_type, H, W, fx, poses, device, extra=None):
    """A prepared port Map2D engine for bench.py's camera and strip, with
    mosaic_demo.py's Map2D.Scale 0.5 and the engine's other defaults
    (5 bands, WeightType 0, FastWarp 0, WarpMode as resolved on the
    device) unless `extra` ({key: value}) sets a key."""
    from pislamfusion_tpu_torch import Camera
    from pislamfusion_tpu_torch.core.svar import Svar
    from pislamfusion_tpu_torch.models.map2d import create_map2d
    cfg = Svar()
    cfg.set("Map2D.Scale", "0.5")
    for k, v in (extra or {}).items():
        cfg.set(k, str(v))
    m = create_map2d(map2d_type, cfg, device=device)
    if not m.prepare(np.array([0, 0, 0, 0, 0, 0, 1.0]),
                     Camera(W, H, fx, fx, W / 2.0, H / 2.0),
                     [(None, p) for p in poses]):
        raise AssertionError("Map2D.prepare refused the strip")
    return m


def _feed_all(m, frames, poses):
    for k in range(frames.shape[0]):
        if not m.feed(frames[k], poses[k]):
            raise AssertionError(f"Map2D skipped frame {k}")


def run_map2d(label, make, frames, poses, wrappers, path_kernels):
    """The Map2D engine's main path at full width: a warm-up pass, then a
    fresh engine fed every frame and blended, with every launch count of
    `wrappers` set to 0 just before and read just after; ms/frame of
    `feed` from CUDA events, `blended()` apart; a per-stage pass (the
    engine's `mark` hook) and a profiled pass of 8 frames' feeds. Returns
    {kernel: launches}."""
    import torch
    m = make()
    _feed_all(m, frames, poses)                 # warm-up pass
    m.blended()
    del m
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    m = make()
    for fn in wrappers.values():
        fn.launches = 0
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    t0 = time.perf_counter()
    ev[0].record()
    _feed_all(m, frames, poses)
    ev[1].record()
    img, covered = m.blended()
    ev[2].record()
    ev[2].synchronize()
    wall = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in wrappers.items()}
    K, H, W = frames.shape[:3]
    feed_ms = ev[0].elapsed_time(ev[1])
    peak = torch.cuda.max_memory_allocated()
    canvas_px = (m.h_tiles * 256, m.w_tiles * 256)
    canvas_mb = sum(t.numel() * 4 for t in m.canvas_lap + m.canvas_w) / 1e6
    print(f"{label} {K} frames {W}x{H}: {m.length_pixel:.4f} m/px, patch "
          f"{m.patch_tiles} tiles ({m.patch_tiles * 256} px), canvas "
          f"{m.w_tiles}x{m.h_tiles} tiles ({canvas_px[1]}x{canvas_px[0]} px "
          f"at band 0, {m.bands} bands, {canvas_mb:.1f} MB), warp "
          f"{m.warp_mode}")
    print(f"{label} feed {feed_ms / K:.3f} ms/frame ({K / (feed_ms / 1e3):.2f}"
          f" frames/s, CUDA events), blended() {ev[1].elapsed_time(ev[2]):.3f}"
          f" ms, host clock {wall * 1e3 / K:.3f} ms/frame with blended")
    print(f"{label} peak device memory {peak / 2**20:.1f} MiB, "
          f"{(peak - base) / 2**20:.1f} MiB above the "
          f"{base / 2**20:.1f} MiB held before the engine was made")
    print(f"{label} launches in that run: " + ", ".join(
        f"{k} {n}" for k, n in launches.items()))
    if min(launches[k] for k in path_kernels) <= 0:
        raise AssertionError(f"{label}: a kernel of the path was not "
                             f"launched: {launches}")
    if m.frames_rendered != K or m.frames_skipped:
        raise AssertionError(f"{label}: rendered {m.frames_rendered}, "
                             f"skipped {m.frames_skipped} of {K}")
    # the covered canvas is the union of the nadir footprints: for a
    # straight strip, a rectangle of the footprint plus the track
    fw, fh = W * ALT / m.camera.fx, H * ALT / m.camera.fy
    span = poses[:, :2].max(0) - poses[:, :2].min(0)
    union = (fw + span[0]) * (fh + span[1]) / m.length_pixel ** 2
    share = covered.sum() / union
    print(f"{label} mosaic {img.shape}, covered {int(covered.sum())} px, "
          f"{share:.4f} of the footprints' union ({union:.0f} px)")
    if not (np.isfinite(img).all() and abs(share - 1.0) < 0.02):
        raise AssertionError(f"{label}: blended mosaic is not finite or "
                             "does not cover the footprints")
    evs = []

    def mark(stage):
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        evs.append((stage, e))

    m = make()
    m.mark = mark
    mark("start")
    _feed_all(m, frames, poses)
    m.blended()
    mark("blended")
    torch.cuda.synchronize()
    st = {}
    for (_, e0), (stage, e1) in zip(evs, evs[1:]):
        st[stage] = st.get(stage, 0.0) + e0.elapsed_time(e1)
    print(f"{label} per-stage ms/frame: " + ", ".join(
        f"{k} {v / K:.3f}" for k, v in st.items() if k != "blended")
        + f"; blended {st['blended']:.3f} ms once")
    m = make()
    profile_frames(lambda: _feed_all(m, frames[:8], poses[:8]), 8)
    return launches


# ---------------------------------------------------------------------------
# phase 2c: SLAM's solvers at full width
# ---------------------------------------------------------------------------

class Draws:
    """The chain's RANSAC samples by step name: drawn from one CPU
    generator the first time a name is asked for and kept, so that a second
    run (the CPU after the card, or the port after the JAX package, whose
    draws `saved` may hold) takes the same samples."""

    def __init__(self, seed: int = 0, saved=None):
        import torch
        self.gen = torch.Generator().manual_seed(seed)
        self.saved = dict(saved or {})

    def indices(self, name, valid, iters: int, k: int):
        import torch
        from pislamfusion_tpu_torch.ops import ransac
        if name not in self.saved:
            self.saved[name] = ransac.sample_indices(
                self.gen, valid.shape[0], valid.cpu(), iters, k)
        return torch.as_tensor(self.saved[name]).to(valid.device)

    def noise(self, name, shape, device):
        import torch
        from pislamfusion_tpu_torch.ops import ransac
        if name not in self.saved:
            self.saved[name] = ransac.gumbel(self.gen, shape)
        return torch.as_tensor(self.saved[name]).to(device)


# the chain's perturbation of BA's start (seeded numpy): camera positions
# and map points by PERTURB_M metres a component, rotations by
# PERTURB_RAD radians
PERTURB_M, PERTURB_RAD = 0.5, 0.005


def ba_start(rng, n_frames: int, n_points: int):
    """(pose twists [F, 6], point offsets [P, 3]) of BA's perturbed start,
    frame 0 unperturbed; the same numbers for both packages and devices."""
    dpose = np.concatenate([rng.normal(0, PERTURB_M, (n_frames, 3)),
                            rng.normal(0, PERTURB_RAD, (n_frames, 3))], -1)
    dpose[0] = 0.0
    return (dpose.astype(np.float32),
            rng.normal(0, PERTURB_M, (n_points, 3)).astype(np.float32))


def pose_errors(T_w2c, poses_c2w):
    """(camera-centre error m, rotation error deg) [K] of world->camera
    poses against the true camera->world poses (numpy)."""
    from pislamfusion_tpu_torch.ops import lie
    import torch
    est = lie.se3_inv(torch.as_tensor(np.asarray(T_w2c, np.float32)))
    truth = torch.as_tensor(np.asarray(poses_c2w, np.float32))
    d = lie.se3_mul(lie.se3_inv(truth), est).numpy()
    dc = np.linalg.norm(est.numpy()[..., :3] - truth.numpy()[..., :3],
                        axis=-1)
    rot = 2.0 * np.degrees(np.arcsin(np.clip(np.linalg.norm(
        d[..., 3:6], axis=-1), 0.0, 1.0)))
    return dc, rot


def solver_chain(frames, poses, fx, n_features=1000, n_levels=8,
                 iters=256, mh_iters=192, ba_iters=10, draws=None,
                 feats=None, step=None, seed=0):
    """SLAM's solvers through the port's entry points, on the device of
    `frames` ([K, H, W, 3] uint8, a straight strip; `poses` [K, 7] numpy,
    the true camera->world poses):

    1. `orb_detect` on every frame (or `feats`, a list of its outputs, if
       given), then `match_descriptors` (Hamming, cross-check) of frames 0
       and K-1 and `rotation_consistency_mask`;
    2. unprojection through `Camera`;
    3. `create_initializer` with Initializer=svd, then =opt (sigma 1 px);
    4. `triangulate` of the matches with the true poses (kept where in
       front, finite and with parallax cos in (0, 0.99998));
    5. `find_plane` on those points (sigma 1 m);
    6. `find_pnp` of frames 1..K-2 against them (each frame's ORB matched
       to frame 0's triangulated features);
    7. `ba.optimize` over all frames from `ba_start`'s perturbation, frame
       0 fixed, Huber at sqrt(5.991) px: `ba_iters` steps with tol=0, then
       up to 3 x ba_iters with tol=1e-4;
    8. `fit_sim3` of the tol=0 BA's camera centres to the true ones;
    9. `match_multih` of frames 0 and K-1 (4 planes, `mh_iters`).

    draws: None runs each RANSAC through its public entry point with the
    reference's key (`threefry.Key`) seeded by the step; a `Draws` hands
    every RANSAC its samples through the `_from_samples` variants.
    step(name), when given, returns the context each step runs in (timing,
    profiling). Returns a dict of the steps' results as tensors on the
    device."""
    import contextlib

    import torch
    from pislamfusion_tpu_torch import Camera
    from pislamfusion_tpu_torch.core.svar import Svar
    from pislamfusion_tpu_torch.models.initializers import create_initializer
    from pislamfusion_tpu_torch.ops import (ba, lie, matching, multih,
                                            ransac, threefry)
    from pislamfusion_tpu_torch.ops import image as im
    from pislamfusion_tpu_torch.ops.features import orb

    step = step or (lambda name: contextlib.nullcontext())
    K, H, W = frames.shape[:3]
    dev = frames.device
    cam = Camera(W, H, fx, fx, W / 2.0, H / 2.0)
    sigma = 1.0 / fx
    r = {}

    def gen(i):
        return threefry.Key(1000 * seed + i)

    with step("detect"):
        if feats is None:
            params = orb.OrbParams(n_features=n_features, n_levels=n_levels)
            feats = [orb.orb_detect(im.rgb_to_gray(f.to(torch.float32)),
                                    params) for f in frames]
        feats = [{k: v.to(dev) for k, v in f.items()} for f in feats]
        r["feats"] = feats
    fa, fb = feats[0], feats[-1]
    with step("match"):
        idx, ok = matching.match_descriptors(fa["desc"], fa["valid"],
                                             fb["desc"], fb["valid"], "orb")
        ok = matching.rotation_consistency_mask(fa["angle"], fb["angle"],
                                                idx, ok)
        r["idx"], r["ok"] = idx, ok
    with step("unproject"):
        ra = cam.unproject(fa["xy"])
        rb = cam.unproject(fb["xy"][torch.where(ok, idx, 0).long()])
    cfg = Svar()
    cfg.set("Initializer", "svd")
    cfg.set("Initializer.RansacIters", str(iters))
    with step("init svd"):
        init = create_initializer(cfg)
        if draws is None:
            r["svd"] = init(gen(1), ra[:, :2], rb[:, :2], ok, sigma)
        else:
            r["svd"] = init.from_samples(
                draws.indices("init_h", ok, iters, 4),
                draws.indices("init_f", ok, iters, 8), ra[:, :2], rb[:, :2],
                ok, sigma)
    with step("init opt"):
        cfg.set("Initializer", "opt")
        r["opt"] = create_initializer(cfg)(gen(2), ra[:, :2], rb[:, :2], ok,
                                           sigma)
    P = torch.as_tensor(np.asarray(poses, np.float32), device=dev)
    with step("triangulate"):
        X, depth = ransac.triangulate(P[0], P[-1], ra, rb)
        cosp = ransac.parallax_cos(P[0], P[-1], X)
        tri = (ok & (depth > 0) & torch.isfinite(X).all(-1) & (cosp > 0)
               & (cosp < 0.99998))
        X = torch.where(tri[:, None], X, 0.0)
        r["X"], r["tri"] = X, tri
    with step("plane"):
        if draws is None:
            r["plane"] = ransac.find_plane(gen(3), X, tri, 1.0, iters)
        else:
            r["plane"] = ransac._find_plane_from_samples(
                draws.indices("plane", tri, iters, 3), X, tri, 1.0)
    r["pnp"], obs_uv, obs_w = [], [ra[:, :2]], [tri]
    with step("pnp"):
        for i in range(1, K - 1):
            fi = feats[i]
            idx_i, ok_i = matching.match_descriptors(
                fa["desc"], fa["valid"] & tri, fi["desc"], fi["valid"],
                "orb")
            p2n = cam.unproject(fi["xy"][torch.where(
                ok_i, idx_i, 0).long()])[:, :2]
            if draws is None:
                res = ransac.find_pnp(gen(10 + i), X, p2n, ok_i, iters=iters)
            else:
                res = ransac._find_pnp_from_samples(
                    draws.indices(f"pnp{i}_6", ok_i, iters // 2, 6),
                    draws.indices(f"pnp{i}_4", ok_i, iters - iters // 2, 4),
                    X, p2n, ok_i)
            r["pnp"].append(res)
            obs_uv.append(p2n)
            obs_w.append(ok_i)
    obs_uv.append(rb[:, :2])
    obs_w.append(tri)
    with step("ba"):
        n = X.shape[0]
        dpose, dX = ba_start(np.random.default_rng(seed), K, n)
        T0 = lie.se3_mul(lie.se3_exp(torch.as_tensor(dpose, device=dev)),
                         lie.se3_inv(P))
        fixed = torch.zeros(K, dtype=torch.bool, device=dev)
        fixed[0] = True
        prob = ba.make_problem(
            T0, fixed, X + torch.as_tensor(dX, device=dev) * tri[:, None],
            ~tri, torch.arange(K, device=dev).repeat_interleave(n),
            torch.arange(n, device=dev).repeat(K), torch.cat(obs_uv),
            torch.cat(obs_w).to(torch.float32), device=dev)
        hd = math.sqrt(5.991) / fx
        r["ba_problem"] = (prob, hd)
        r["ba_cost0"] = ba._total_cost(prob, hd)
        r["ba"] = ba.optimize(prob, iters=ba_iters, huber_delta=hd)
        r["ba_tol_stats"] = {}
        r["ba_tol"] = ba.optimize(prob, iters=3 * ba_iters, huber_delta=hd,
                                  tol=1e-4, stats=r["ba_tol_stats"])
    with step("fit_sim3"):
        r["sim3"] = ba.fit_sim3(lie.se3_inv(r["ba"][0]), P)
    with step("multih"):
        args = (fa["desc"], fa["valid"], fa["xy"], fb["desc"], fb["valid"],
                fb["xy"])
        if draws is None:
            r["multih"] = multih.match_multih(gen(4), *args, n_h=4,
                                              ransac_iters=mh_iters)
        else:
            r["multih"] = multih._match_multih_from_noise(
                draws.noise("multih", (4, mh_iters, fa["xy"].shape[0]), dev),
                *args)
    return r


def chain_summary(r, poses):
    """The chain's results (`solver_chain`'s dict; its tensors, or the
    same results as numpy) as numpy, with their errors against the true
    poses."""
    import torch
    from pislamfusion_tpu_torch.ops import lie

    def n(x):
        if isinstance(x, torch.Tensor):
            return x.detach().cpu().numpy()
        return np.asarray(x)

    def t(x):
        return torch.as_tensor(np.array(n(x), np.float32))
    s = {"n_match": int(n(r["ok"]).sum()), "ok": n(r["ok"]),
         "n_tri": int(n(r["tri"]).sum()), "X": n(r["X"]),
         "tri": n(r["tri"])}
    # the second camera's centre in the first camera's frame: the
    # direction the initializers' unit translation should take
    c = lie.se3_apply(lie.se3_inv(t(poses[0])), t(poses[-1, :3])).numpy()
    for name in ("svd", "opt"):
        d = {k: n(v) for k, v in r[name]._asdict().items()}
        est = d["T_c2w"][:3]
        d["dir_cos"] = float(np.dot(est, c) / max(
            np.linalg.norm(est) * np.linalg.norm(c), 1e-12))
        s[name] = d
    model, inl, _, ok = (n(x) for x in r["plane"])
    normal = lie.quat_to_matrix(t(model[3:7])).numpy()[:, 2]
    s["plane"] = {"model": model, "inliers": inl, "ok": bool(ok),
                  "tilt_deg": float(np.degrees(np.arccos(min(1.0, abs(
                      float(normal[2]))))))}
    s["pnp"] = []
    for i, res in enumerate(r["pnp"], 1):
        T, inl, _, ok = (n(x) for x in res)
        dc, rot = pose_errors(T, poses[i])
        s["pnp"].append({"T": T, "inliers": inl, "ok": bool(ok),
                         "err_m": float(dc), "err_deg": float(rot)})
    for name in ("ba", "ba_tol"):
        Tw, pts, cost = (n(x) for x in r[name])
        dc, rot = pose_errors(Tw, poses)
        s[name] = {"poses": Tw, "points": pts, "cost": float(cost),
                   "err_m": dc, "err_deg": rot}
    s["ba_cost0"] = float(n(r["ba_cost0"]))
    s["ba_tol_stats"] = dict(r.get("ba_tol_stats", {}))
    S = n(r["sim3"])
    c_ba = lie.se3_inv(t(s["ba"]["poses"])).numpy()[:, :3]
    A = c_ba - c_ba.mean(0)
    ev = np.linalg.eigvalsh(A.T.astype(np.float64) @ A)
    aligned = lie.sim3_apply(t(S), t(c_ba)).numpy()
    s["sim3"] = {"model": S, "rank1": bool(ev[1] <= 1e-5 * max(ev[2],
                                                                 1e-12)),
                 "err_m": np.linalg.norm(aligned - poses[:, :3], axis=-1)}
    idx, ok, planes = (n(x) for x in r["multih"])
    s["multih"] = {"idx": idx, "ok": ok, "n_planes": int(planes)}
    return s


def chain_line(s):
    """The chain summary's results and errors on one line."""
    pnp = s["pnp"]
    parts = [
        f"matches {s['n_match']}, triangulated {s['n_tri']}",
        *(f"init {k}: ok {bool(s[k]['ok'])}, used_h {bool(s[k]['used_h'])}"
          f", inliers {int(s[k]['mask'].sum())}, translation direction "
          f"cos {s[k]['dir_cos']:.5f}" for k in ("svd", "opt")),
        f"plane: ok {s['plane']['ok']}, inliers "
        f"{int(s['plane']['inliers'].sum())}, normal "
        f"{s['plane']['tilt_deg']:.4f} deg from vertical",
        "pnp: " + "; ".join(
            f"frame {i}: ok {q['ok']}, inliers {int(q['inliers'].sum())}, "
            f"{q['err_m']:.4f} m, {q['err_deg']:.4f} deg"
            for i, q in enumerate(pnp, 1)),
        f"ba tol=0: cost {s['ba_cost0']:.6g} -> {s['ba']['cost']:.6g}, "
        f"centres max {s['ba']['err_m'].max():.4f} m, rotations max "
        f"{s['ba']['err_deg'].max():.4f} deg",
        f"ba tol>0: cost -> {s['ba_tol']['cost']:.6g}"
        + "".join(f", {k} {v}" for k, v in s["ba_tol_stats"].items())
        + f", centres max {s['ba_tol']['err_m'].max():.4f} m",
        f"fit_sim3: scale {float(s['sim3']['model'][7]):.5f}, rank guard "
        f"{'on' if s['sim3']['rank1'] else 'off'}, aligned centres max "
        f"{s['sim3']['err_m'].max():.4f} m",
        f"multih: matches {int(s['multih']['ok'].sum())}, planes "
        f"{s['multih']['n_planes']}",
    ]
    return "; ".join(parts)


# phase 2c's gates against the true poses, set from the port's CPU run and
# the JAX package's CPU run of the chain on the same 1080p pair (PERF.md
# section 7); the plane's from the issue's bound
PNP_TOL_M, PNP_TOL_DEG = 0.6, 0.27
BA_TOL_M, BA_TOL_DEG = 0.5, 0.07
PLANE_TOL_DEG = 1.0
SOLVER_STEPS = ("match", "init svd", "init opt", "triangulate", "plane",
                "pnp", "ba", "fit_sim3", "multih")


def check_chain(s, label):
    """Phase 2c's gates on a chain summary; raises on a failure."""
    bad = []
    if not s["plane"]["tilt_deg"] < PLANE_TOL_DEG:
        bad.append("plane normal")
    for i, q in enumerate(s["pnp"], 1):
        if not (q["ok"] and q["err_m"] < PNP_TOL_M
                and q["err_deg"] < PNP_TOL_DEG):
            bad.append(f"pnp frame {i}")
    for name in ("ba", "ba_tol"):
        b = s[name]
        if not (b["cost"] < s["ba_cost0"] and b["err_m"].max() < BA_TOL_M
                and b["err_deg"].max() < BA_TOL_DEG):
            bad.append(name)
    if bad:
        raise AssertionError(f"{label}: {', '.join(bad)} outside the gates "
                             f"(pnp {PNP_TOL_M} m / {PNP_TOL_DEG} deg, ba "
                             f"{BA_TOL_M} m / {BA_TOL_DEG} deg, plane "
                             f"{PLANE_TOL_DEG} deg)")


def run_solver_phase(frames, poses, fx, wrappers):
    """Phase 2c: `solver_chain` on frames 0-6 of the 1080p strip (ORB-1000,
    8 levels): a warm-up pass; a timed pass with every launch count of
    `wrappers` set to 0 just before and read just after, each step's
    device time from CUDA events; a pass with each solver step under
    torch.profiler for its kernel launches. Gates: `check_chain`, and
    K1, K4 and K2 launched. Returns {kernel: launches}."""
    import contextlib

    import torch
    from torch.profiler import ProfilerActivity, profile
    K = 7
    fr, ps = frames[:K], poses[:K]
    H, W = fr.shape[1:3]
    solver_chain(fr, ps, fx)                              # warm-up
    torch.cuda.synchronize()
    evs = {}

    @contextlib.contextmanager
    def timed_step(name):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        yield
        e1.record()
        evs[name] = (e0, e1)

    for fn in wrappers.values():
        fn.launches = 0
    t0 = time.perf_counter()
    r = solver_chain(fr, ps, fx, step=timed_step)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in wrappers.items()}
    ms = {k: e0.elapsed_time(e1) for k, (e0, e1) in evs.items()}
    counts = {}

    @contextlib.contextmanager
    def profiled_step(name):
        if name not in SOLVER_STEPS:
            yield
            return
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            yield
            torch.cuda.synchronize()
        ev = [e for e in prof.events() if e.device_type.name == "CUDA"
              and not getattr(e, "is_user_annotation", False)]
        counts[name] = (sum(1 for e in ev if not e.name.startswith(
            ("Memcpy", "Memset"))), len(ev))

    solver_chain(fr, ps, fx, step=profiled_step)
    s = chain_summary(r, ps)
    print(f"SLAM solvers (phase 2c) {W}x{H}, frames 0-{K - 1}, ORB-1000, 8 "
          f"levels, RANSAC 256 hypotheses, multih 4 planes x 192: "
          f"{chain_line(s)}")
    print("SLAM solvers device ms by step (CUDA events): " + ", ".join(
        f"{k} {v:.3f}" for k, v in ms.items())
        + f"; host clock {wall * 1e3:.1f} ms for the chain")
    print("SLAM solvers launches by step (torch.profiler; kernels, and all "
          "device activities): " + ", ".join(
              f"{k} {c[0]}/{c[1]}" for k, c in counts.items()))
    print("SLAM solvers launches of the port's kernels in the timed pass: "
          + ", ".join(f"{k} {n}" for k, n in launches.items()))
    check_chain(s, "phase 2c")
    if min(launches[k] for k in ("flatpyr", "fastselect", "patchgather")) < 1:
        raise AssertionError(f"phase 2c: K1, K4 or K2 was not launched: "
                             f"{launches}")
    return launches, ms, counts, r


# phase 2d's gates (tests/test_slam.py:48-68's bars): the share of frames
# tracked, ATE after Sim3 alignment to the true poses as a share of the
# span, and the keyframes the ORB run must make
SLAM_MIN_TRACKED, SLAM_MAX_ATE_SHARE, SLAM_MIN_KEYFRAMES = 0.85, 0.02, 6


def slam_full_cfg(detector: str):
    """Phase 2d's config: `FeatureDetector` ORB or Sift, SLAM.nFeature
    1000, offline, the default BA caps, tracker, mapper and loop closer."""
    from pislamfusion_tpu_torch.core.svar import Svar
    cfg = Svar()
    cfg.set("FeatureDetector", detector)
    cfg.set("SLAM.nFeature", "1000")
    cfg.set("SLAM.isOnline", "0")
    return cfg


def slam_stage_ms(stats, n: int):
    """Host ms a frame by stage from the port's timer scopes: extract (the
    extraction's enqueue), track (the rest of Tracker::track outside the
    mapper; it includes the wait for the frame's packed result), keyframe/
    mapper (Mapper::insertKeyFrame without local BA), local BA, loop
    close."""
    def tot(k):
        return stats.get(k, {}).get("total", 0.0) * 1e3
    extract = tot("Tracker::predispatch") + tot("Tracker::extract")
    mapper = tot("Mapper::insertKeyFrame")
    ba = tot("Mapper::localOptimization")
    return {"extract": extract / n,
            "track": (tot("Tracker::track") - mapper - extract) / n,
            "keyframe/mapper": (mapper - ba) / n, "local BA": ba / n,
            "loop close": tot("SLAM::loopClose") / n}


def run_slam_phase(label, frames, poses, fx, dev, wrappers, path_kernels,
                   min_keyframes=0):
    """Phase 2d: `create_slam` (offline) on the frames (a tensor on the
    card, copied to the host first, as a camera delivers them) through
    `SLAM.track`, with every launch count of `wrappers` set to 0 just
    before and read just after. Prints ms a frame (wall clock and by stage),
    tracking, the map, ATE and the launches of `path_kernels`; gates on
    SLAM_MIN_TRACKED, SLAM_MAX_ATE_SHARE, `min_keyframes`, a local BA and
    each path kernel launched. Returns {kernel: launches}."""
    import torch
    from pislamfusion_tpu_torch.core.camera import Camera
    from pislamfusion_tpu_torch.core.timer import timer
    from pislamfusion_tpu_torch.models.slam import create_slam
    K, H, W = frames.shape[:3]
    host = frames.cpu().numpy()
    slam = create_slam(slam_full_cfg(label),
                       Camera(W, H, fx, fx, W / 2.0, H / 2.0), device=dev)
    timer.reset()
    torch.cuda.synchronize()
    for fn in wrappers.values():
        fn.launches = 0
    t0 = time.perf_counter()
    for i in range(K):
        slam.track(host[i], float(i))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in wrappers.items()}
    stats = timer.stats()
    ms = slam_stage_ms(stats, K)
    ate, span, _ = slam_ate(slam, poses)
    n_kf = len(slam.map.keyframes())
    n_ba = stats.get("Mapper::localOptimization", {}).get("count", 0)
    tracked = slam.frames_tracked / slam.frames_total
    print(f"SLAM (phase 2d) {label}-1000 {W}x{H}, {K} frames of the strip, "
          f"offline: {wall * 1e3 / K:.1f} ms a frame (host clock), by "
          "stage: " + ", ".join(f"{k} {v:.1f}" for k, v in ms.items()))
    print(f"SLAM (phase 2d) {label}: tracked {slam.frames_tracked}/"
          f"{slam.frames_total}, keyframes {n_kf}, local BAs {n_ba}, map "
          f"points {slam.map.point_num()}, plane "
          f"{'published' if slam.plane is not None else 'not published'}"
          f"; ATE {ate:.4f} m over a {span:.1f} m span "
          f"({ate / span * 100:.4f} %), Sim3-aligned to the true poses")
    print(f"SLAM (phase 2d) {label} launches of the port's kernels: "
          + ", ".join(f"{k} {launches[k]} ({launches[k] / K:.2f} a frame)"
                      for k in path_kernels))
    if not (tracked >= SLAM_MIN_TRACKED and ate <= SLAM_MAX_ATE_SHARE * span
            and n_kf >= min_keyframes and n_ba >= 1
            and min(launches[k] for k in path_kernels) >= 1):
        raise AssertionError(f"phase 2d {label}: gates failed (tracked "
                             f"{tracked:.3f}, ATE share {ate / span:.4f}, "
                             f"keyframes {n_kf}, local BAs {n_ba}, "
                             f"launches {launches})")
    return launches


# ---------------------------------------------------------------------------
# phase 2e: the fused system (`python -m pislamfusion_tpu_torch`) at full
# width, through app.main
# ---------------------------------------------------------------------------

FUSED_ORIGIN = (116.35, 39.96, 40.0)   # tests/test_cli.py's GPS origin
FUSED_ROW, FUSED_TURN = 20, 3          # frames a row, frames of the turn
FUSED_ROW_GAP = 40.0                   # m between the rows: 63 % side overlap
FUSED_GS, FUSED_TEX = 0.12, 3072       # m a texel, texels square
FUSED_GPS_SIGMA = 0.4                  # m, one fix a frame
# the mapper publishes its plane once it holds this many live points:
# with ORB-1000 at 1080p the third or fourth keyframe (phase 2d never
# reached the default 2000)
FUSED_PLANE_MIN_POINTS = 500
# tests/test_cli.py's bars
FUSED_MIN_TRACKED, FUSED_MAX_ATE, FUSED_MIN_FED = 0.85, 2.0, 0.8
FUSED_MIN_PSNR, FUSED_MIN_COVER = 12.0, 0.15


def fused_poses():
    """Two lawnmower rows at ALT (4 m a frame, FUSED_ROW_GAP apart), the
    second flown back, joined by FUSED_TURN frames of the turn: nadir c2w
    poses [K, 7] in ground coordinates."""
    xs = 100.0 + STEP_M * np.arange(FUSED_ROW)
    y0, y1 = 100.0, 100.0 + FUSED_ROW_GAP
    turn = np.linspace(y0, y1, FUSED_TURN + 2)[1:-1]
    pts = ([(x, y0) for x in xs] + [(xs[-1], y) for y in turn]
           + [(x, y1) for x in xs[::-1]])
    return np.array([[x, y, ALT, 1.0, 0.0, 0.0, 0.0] for x, y in pts])


def write_fused_dataset(root, device, seed=5):
    """tests/test_cli.py's unified .npudronemap layout at 1080p: config.cfg
    (the camera), frames.txt, gps.txt (a fix a frame, FUSED_GPS_SIGMA of
    noise, just before its frame) and images/*.png (the port's encoders:
    the native libpng writer, else the zlib one), rendered on `device`
    from bench.py's texture. Returns (dataset file, true poses, texture
    [n, n, 3] uint8)."""
    import torch
    from pislamfusion_tpu_torch.core.camera import Camera
    from pislamfusion_tpu_torch.core.gps import LocalFrame
    from pislamfusion_tpu_torch.io import native_io
    from pislamfusion_tpu_torch.models.map2d import _write_png
    os.makedirs(os.path.join(root, "images"), exist_ok=True)
    H, W, fx = 1080, 1920, 1200.0
    tex = strip_texture(FUSED_TEX, seed)
    ground = torch.from_numpy(tex).to(device).to(torch.float32)
    cam = Camera(W, H, fx, fx, W / 2.0, H / 2.0)
    poses = fused_poses()
    rng = np.random.default_rng(seed)
    local = LocalFrame(*FUSED_ORIGIN)
    with open(os.path.join(root, "config.cfg"), "w") as f:
        f.write(f"Camera.Paraments={W} {H} {fx:g} {fx:g} {W / 2.0:g} "
                f"{H / 2.0:g}\n")
    with open(os.path.join(root, "frames.txt"), "w") as ff, \
            open(os.path.join(root, "gps.txt"), "w") as gf:
        for i, p in enumerate(poses):
            img = survey_view(ground, cam, p, FUSED_GS).round().clamp(
                0, 255).to(torch.uint8).cpu().numpy()
            name = f"images/{i:04d}.png"
            if not native_io.save_png(os.path.join(root, name), img,
                                      wait=False):
                _write_png(os.path.join(root, name), img)
            ff.write(f"{float(i):.6f} {name}\n")
            lla = local.local_to_lla(p[:3] + rng.normal(
                0, FUSED_GPS_SIGMA, 3))
            gf.write(f"{float(i) - 0.01:.6f} "
                     + " ".join(f"{v:.9f}" for v in lla) + "\n")
    if native_io.flush_writes():
        raise RuntimeError("phase 2e: the native PNG writer failed")
    ds_file = os.path.join(root, "survey.npudronemap")
    open(ds_file, "w").close()
    return ds_file, poses, tex


def geo_ate(est, gt):
    """RMS of est - gt after removing the common offset (the GPS anchor),
    as tests/test_cli.py measures geo-registration."""
    err = est - gt
    err = err - err.mean(0)
    return float(np.sqrt(np.mean(np.sum(err ** 2, -1))))


FUSED_SCOPES = ("App::track", "App::prefetchWait", "Fusion::feed",
                "Fusion::refresh", "Fusion::rebase_feed")
FUSED_KERNELS = ("flatpyr", "fastselect", "patchgather", "shearwarp",
                 "bandedsandwich")


def run_fused_slam(ds, out, wrappers, extra=(), label="phase 2e"):
    """One `app.main(["Act=SLAM", ...])` call on the card with every launch
    count of `wrappers` set to 0 just before and read just after, the
    run's SLAM and FusionSystem caught from `app.run_slam`. Returns (slam,
    fusion, wall s, launches, timer stats, {device: (peak bytes the run
    allocated above what was allocated before it, bytes allocated
    before)} from `memory_metric.device_usage`). `extra`: more key=value
    arguments for app.main."""
    import torch
    from pislamfusion_tpu_torch import app
    from pislamfusion_tpu_torch.core import memory_metric
    from pislamfusion_tpu_torch.core.svar import Svar
    from pislamfusion_tpu_torch.core.timer import timer
    caught = []
    run_slam = app.run_slam

    def spy(*a, **k):
        caught.append(run_slam(*a, **k))
        return caught[-1]
    argv = ["Act=SLAM", ds, f"Out.Dir={out}", "Device=cuda",
            "FeatureDetector=ORB", "SLAM.nFeature=1000", "SLAM.LoopClose=1",
            f"Plane.MinPoints={FUSED_PLANE_MIN_POINTS}", "Map2D.Type=3",
            "Map2D.Scale=0.5", "Map2D.BandNumber=5", "Map2D.WarpMode=shear",
            f"Map2DFusionFolder={out}/m2df", f"MapFusionFile={out}/map.mf",
            f"GeoTiles.Dir={out}/tiles", "Timer.Report=0", "StackTrace=0",
            *extra]
    timer.reset()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = memory_metric.device_usage()
    for fn in wrappers.values():
        fn.launches = 0
    app.run_slam = spy
    t0 = time.perf_counter()
    try:
        rc = app.main(argv, cfg=Svar())
    finally:
        app.run_slam = run_slam
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in wrappers.items()}
    if rc != 0 or len(caught) != 1:
        raise AssertionError(f"{label}: Act=SLAM returned {rc}")
    after = memory_metric.device_usage()
    peak = {d: (v["max_allocated"] - before[d]["allocated"],
                before[d]["allocated"]) for d, v in after.items()}
    return (*caught[0], wall, launches, timer.stats(), peak)


def fused_playback(out):
    """`Act=TestMap2D` on the card over the Map2DFusion folder an Act=SLAM
    run exported to `out`/m2df: its keyframes' JPEGs at their poses. The
    JPEGs decode only through the native decoder on a machine without
    PIL, so without it the playback is skipped, and the line says so."""
    from pislamfusion_tpu_torch import app
    from pislamfusion_tpu_torch.core.svar import Svar
    from pislamfusion_tpu_torch.io import native_io
    try:
        import PIL  # noqa: F401
        pil = True
    except ImportError:
        pil = False
    if not (native_io.available() or pil):
        print("fused (phase 2e) Act=TestMap2D: not run (no JPEG decoder: "
              "neither the native one nor PIL)")
        return
    t0 = time.perf_counter()
    rc = app.main(["Act=TestMap2D", f"Map2D.DataPath={out}/m2df",
                   f"Map.File2Save={out}/playback.png", "Device=cuda",
                   "Map2D.Scale=0.5", "StackTrace=0"], cfg=Svar())
    n = sum(1 for _ in open(os.path.join(out, "m2df", "trajectory.txt")))
    print(f"fused (phase 2e) Act=TestMap2D over the exported Map2DFusion "
          f"folder ({n} keyframes, JPEG through "
          f"{'the native decoder' if native_io.available() else 'PIL'}): "
          f"rc {rc}, {time.perf_counter() - t0:.2f} s")
    if rc != 0 or not os.path.isfile(os.path.join(out, "playback.png")):
        raise AssertionError("phase 2e Act=TestMap2D failed")


def run_fused_phase(dev, wrappers, card, then=None):
    """Phase 2e: the fused system on the two-row 1080p dataset, through
    `app.main(["Act=SLAM", ...])` once (SLAM on the caller's thread, the
    FusionSystem consumer in its own, Map2D Type 3 with K3 and K8),
    then `Act=Survey` (FastVO). Prints ms a frame, the timer scopes, peak
    device memory, the queue's drops and the launches; gates on
    tests/test_cli.py's bars. Then `then(dataset path, true poses, work
    directory)`, when given, before the dataset is removed."""
    import shutil
    import tempfile
    import torch
    sys.path.insert(0, os.path.join(os.path.dirname(
        os.path.abspath(__file__)), "examples"))
    from torch_pipeline_demo import mosaic_psnr_vs_truth
    from pislamfusion_tpu_torch import app
    from pislamfusion_tpu_torch.core.svar import Svar
    from pislamfusion_tpu_torch.io import native_io
    from pislamfusion_tpu_torch.ops import ransac
    root = tempfile.mkdtemp(prefix="psf_fused_")
    try:
        t0 = time.perf_counter()
        ds, poses, tex = write_fused_dataset(os.path.join(root, "ds"), dev)
        K = len(poses)
        print(f"fused (phase 2e) dataset: {K} frames 1920x1080 (two rows "
              f"of {FUSED_ROW} at {STEP_M:g} m a frame, {FUSED_ROW_GAP:g} m "
              f"apart, {FUSED_TURN} frames of turn, {ALT:g} m up, "
              f"{FUSED_GS} m a texel), a GPS fix a frame with "
              f"{FUSED_GPS_SIGMA} m of noise, written in "
              f"{time.perf_counter() - t0:.1f} s; native image IO "
              f"{native_io.available()}; Plane.MinPoints "
              f"{FUSED_PLANE_MIN_POINTS}")
        out = os.path.join(root, "slam")
        slam, fusion, wall, launches, stats, mem = run_fused_slam(
            ds, out, wrappers)
        tracked = slam.frames_tracked / max(slam.frames_total, 1)
        frames = [f for f in slam.map.frames()
                  if f.n_tracked() > 0 or f.is_keyframe]
        est = np.stack([f.pose_c2w[:3] for f in frames])
        ids = np.asarray([int(round(f.timestamp)) for f in frames])
        ate = geo_ate(est, poses[ids][:, :3])
        S = ransac.sim3_horn(
            torch.from_numpy(poses[ids][:, :3].astype(np.float32)),
            torch.from_numpy(est.astype(np.float32)))
        psnr, cover = mosaic_psnr_vs_truth(
            fusion.map2d, tex.astype(np.float32), S.numpy(),
            ground_scale=FUSED_GS) if fusion.map2d is not None \
            else (0.0, 0.0)
        dropped = fusion.dropped_before_prepare
        total_drop = slam.trans_queue.dropped
        tiles = [f for _, _, fs in os.walk(os.path.join(out, "tiles"))
                 for f in fs if f.endswith(".png")]
        missing = [f for f in ("result.png", "trajectory.txt",
                               "map.ply", "m2df/config.cfg", "map.mf")
                   if not os.path.isfile(os.path.join(out, f))]
        peak, held = mem.get("cuda:0", (0, 0))
        print(f"fused (phase 2e) Act=SLAM: "
              f"{wall * 1e3 / K:.1f} ms a frame (host clock, the whole "
              f"Act); tracked {slam.frames_tracked}/{slam.frames_total}"
              f", keyframes {len(slam.map.keyframes())}, map points "
              f"{slam.map.point_num()}, GPS fitted "
              f"{slam.mapper.gps_fitted}, geo ATE {ate:.3f} m; mosaic "
              f"fed {fusion.frames_fed}, refreshed "
              f"{fusion.frames_refreshed}, queue dropped {dropped} "
              f"before the plane ({total_drop} in all), PSNR "
              f"{psnr:.2f} dB over {cover:.3f} of the ground, "
              f"{len(tiles)} tiles; consumer alive {fusion.alive()}, "
              f"error {fusion.error is not None}; peak device memory "
              f"{peak / 2 ** 20:.1f} MiB above the {held / 2 ** 20:.1f} "
              f"MiB held before the call ({card})")
        print("fused (phase 2e) Act=SLAM timer scopes, total ms "
              "(calls): " + ", ".join(
                  f"{k} {stats.get(k, {}).get('total', 0.0) * 1e3:.1f} "
                  f"({stats.get(k, {}).get('count', 0)})"
                  for k in FUSED_SCOPES))
        print("fused (phase 2e) Act=SLAM launches: " + ", ".join(
            f"{k} {launches[k]}" for k in FUSED_KERNELS))
        fed_min = FUSED_MIN_FED * slam.frames_tracked - dropped
        if not (tracked >= FUSED_MIN_TRACKED and slam.mapper.gps_fitted
                and ate < FUSED_MAX_ATE and fusion.error is None
                and not fusion.alive()
                and fusion.frames_fed >= fed_min
                and fusion.frames_refreshed > 0
                and psnr >= FUSED_MIN_PSNR and cover > FUSED_MIN_COVER
                and not missing and tiles
                and min(launches[k] for k in FUSED_KERNELS) >= 1):
            raise AssertionError(
                f"phase 2e Act=SLAM: gates failed (tracked {tracked:.3f}"
                f", GPS fitted {slam.mapper.gps_fitted}, ATE {ate:.3f}, "
                f"fed {fusion.frames_fed} < {fed_min:.1f}?, refreshed "
                f"{fusion.frames_refreshed}, PSNR {psnr:.2f} over "
                f"{cover:.3f}, missing {missing}, tiles {len(tiles)}, "
                f"alive {fusion.alive()}, launches {launches}, error "
                f"{fusion.error})")
        fused_playback(out)
        # FastVO's batch survey on the same dataset, one card
        out = os.path.join(root, "survey")
        for fn in wrappers.values():
            fn.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rc = app.main(["Act=Survey", ds, f"Out.Dir={out}", "Device=cuda",
                       f"Survey.Height={ALT:g}", "Survey.NFeature=1000",
                       f"GeoTiles.Dir={out}/tiles", "Survey.Mesh=1",
                       "StackTrace=0"], cfg=Svar())
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {k: fn.launches for k, fn in wrappers.items()}
        traj = np.loadtxt(os.path.join(out, "trajectory.txt"))
        ate = geo_ate(traj[:, 1:3], poses[:, :2])
        tiles = [f for _, _, fs in os.walk(os.path.join(out, "tiles"))
                 for f in fs if f.endswith(".png")]
        print(f"fused (phase 2e) Act=Survey: {wall * 1e3 / K:.1f} ms a frame"
              f" (host clock, the whole Act, images read included), rc {rc},"
              f" {traj.shape[0]} trajectory rows, ATE {ate:.3f} m, "
              f"{len(tiles)} tiles; launches " + ", ".join(
                  f"{k} {launches[k]}" for k in FUSED_KERNELS))
        if not (rc == 0 and traj.shape[0] == K and ate < FUSED_MAX_ATE
                and tiles and os.path.isfile(os.path.join(out,
                                                          "result.png"))):
            raise AssertionError("phase 2e Act=Survey: gates failed")
        if then is not None:
            then(ds, poses, root)
    finally:
        shutil.rmtree(root, ignore_errors=True)


# ---------------------------------------------------------------------------
# phase 2f: online SLAM at full width (bench.py's SLAM pass on the port)
# ---------------------------------------------------------------------------

# bench.py:306's (SLAM.TrackChain, SLAM.TrackScale) configurations
ONLINE_CONFIGS = ((1, 1), (8, 1), (1, 2), (8, 2))
# phase 2f's gates for each ORB call: the share of the frames fed that
# tracked, ATE after Sim3 alignment as a share of the span. The share is
# below phase 2d's offline 35/36 on purpose: online, the tracker runs
# ahead of the mapper's worker (the JAX package's own online tests hold
# 0.35 on a busy host)
ONLINE_MIN_TRACKED, ONLINE_MAX_ATE_SHARE = 0.5, 0.02
ONLINE_JOIN_S = 120.0    # SLAM.finish's bound on the thread and the mapper
# frames of the strip out and back: bench.py takes 24 (47 frames); 12 (23
# frames) is a depth cut that keeps the script within its time with
# phase 2i (with 16, 31 frames, the whole script took 720 s on an H100,
# the four ORB configurations 2.2 s a frame together). 12 is the least
# `chain_syncs` can take: its chain of 8 starts at frame 4 of the pass
# and must not meet the turn (at 10 it consumed 6 of 8 frames)
ONLINE_FRAMES = 12
ORB_KERNELS = ("flatpyr", "fastselect", "patchgather")
# at TrackScale 2 (960x540) ORB-1000's 8 levels do not all keep one
# keypoint a cell, so the per-level chain selects instead of K4
ORB_HALF_KERNELS = ("flatpyr", "patchgather")
SIFT_KERNELS = ("bandedstack", "bilineargrid")


def online_order(k: int):
    """bench.py:276-277's out-and-back order over k frames: 0..k-1 then
    k-2..0."""
    return list(range(k)) + list(range(k - 2, -1, -1))


def bench_gray(rgb):
    """bench.py:272-274's host gray frames: RGB [..., H, W, 3] (numpy,
    uint8 or float) -> float BT.601 luma, clipped, truncated to uint8."""
    return np.clip(rgb.astype(np.float32) @ np.asarray(
        [0.299, 0.587, 0.114], np.float32), 0, 255).astype(np.uint8)


def online_cfg(detector: str, chain: int, scale: int):
    """bench.py:279-291's config on the port: `detector`-1000, no loop
    closing, SLAM.isOnline 1, SLAM.TrackChain and SLAM.TrackScale."""
    cfg = slam_full_cfg(detector)
    cfg.set("SLAM.LoopClose", "0")
    cfg.set("SLAM.isOnline", "1")
    cfg.set("SLAM.TrackChain", str(chain))
    cfg.set("SLAM.TrackScale", str(scale))
    return cfg


def run_online_slam(gray, gt, fx, dev, wrappers, chain, scale,
                    detector="ORB"):
    """One online SLAM call: `create_slam` (SLAM.isOnline 1) fed the
    frames `gray` [K, H, W] uint8 (numpy) from this thread through
    `SLAM.track`, then `finish` within ONLINE_JOIN_S, with every launch
    count of `wrappers` set to 0 just before and read just after; `gt`
    [K, 7] the true pose of each frame fed. Returns a dict: ms a frame
    (host clock, feed to finish), tracked, keyframes, ATE share, chains,
    launches, peak device memory above what the call found, and the
    liveness flags."""
    import torch
    from pislamfusion_tpu_torch.core.camera import Camera
    from pislamfusion_tpu_torch.core.messenger import DataTrans
    from pislamfusion_tpu_torch.models.slam import create_slam
    K, H, W = gray.shape
    slam = create_slam(online_cfg(detector, chain, scale),
                       Camera(W, H, fx, fx, W / 2.0, H / 2.0), device=dev)
    slam.trans_queue = DataTrans(30)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    for fn in wrappers.values():
        fn.launches = 0
    t0 = time.perf_counter()
    for j in range(K):
        slam.track(gray[j], float(j))
    ended = slam.finish(timeout=ONLINE_JOIN_S)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in wrappers.items()}
    ate, span, _ = slam_ate(slam, gt)
    lengths = slam.tracker.chain_lengths
    return {"ms": wall * 1e3 / K, "fed": K, "total": slam.frames_total,
            "tracked": slam.frames_tracked,
            "keyframes": len(slam.map.keyframes()), "ate": ate / span,
            "chains": len(lengths), "longest": max(lengths, default=0),
            "mean_chain": float(np.mean(lengths)) if lengths else 0.0,
            "launches": launches, "ended": ended,
            "alive": slam._worker.is_alive(),
            "pending": slam.mapper._pool.pending(),
            "errors": slam.track_errors + slam.mapper.worker_errors,
            "peak": torch.cuda.max_memory_allocated() - held}


def online_line(label, r, kernels, card):
    return (f"online (phase 2f) {label}: {r['ms']:.1f} ms a frame (host "
            f"clock, feed to finish); tracked {r['tracked']}/{r['total']} "
            f"of {r['fed']} fed, keyframes {r['keyframes']}, ATE "
            f"{r['ate'] * 100:.4f} % of the span (Sim3-aligned); chains "
            f"{r['chains']}, mean length {r['mean_chain']:.2f}, longest "
            f"{r['longest']}; track errors {r['errors']}, thread ended "
            f"{not r['alive']}, mapper pending {r['pending']}; launches "
            + ", ".join(f"{k} {r['launches'][k]}" for k in kernels)
            + f"; peak device memory {r['peak'] / 2 ** 20:.1f} MiB above "
            f"what the call found ({card})")


def online_gates(label, r, kernels, chain, orb=True):
    """Phase 2f's gates on one call (see ONLINE_MIN_TRACKED)."""
    ok = (r["ended"] and not r["alive"] and r["pending"] == 0
          and r["total"] == r["fed"] and r["errors"] == 0
          and min(r["launches"][k] for k in kernels) >= 1
          and (chain == 1 or r["longest"] >= 2)
          and (not orb or (r["tracked"] >= ONLINE_MIN_TRACKED * r["fed"]
                           and r["ate"] < ONLINE_MAX_ATE_SHARE)))
    if not ok:
        raise AssertionError(f"phase 2f {label}: gates failed ({r})")


def count_syncs(fn):
    """fn() under torch.cuda.set_sync_debug_mode("warn") on this thread:
    (its result, the synchronising calls it made, by their warnings). The
    mode's one notice a process ("Synchronization debug mode is a
    prototype feature ...") is not a call and is not counted."""
    import warnings
    import torch
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return out, sum("called a synchronizing CUDA operation" in str(w.message)
                    for w in caught)


def chain_syncs(gray, fx, dev, k=8):
    """The synchronising calls of one chain of `k` frames: an offline ORB
    SLAM tracks frames 0-3 of `gray`, then (1)
    `pipeline.fused_track_chain_images` on the next k frames with its one
    copy back, and (2) the whole `Tracker.track_chain` of them (staging,
    upload, the chain, the copy and the host bookkeeping, keyframes and
    the mapper's work for them inline). Returns (1, 2)."""
    import torch
    from pislamfusion_tpu_torch.core.camera import Camera
    from pislamfusion_tpu_torch.models import pipeline
    from pislamfusion_tpu_torch.models.frame import Frame
    from pislamfusion_tpu_torch.models.slam import create_slam
    K, H, W = gray.shape
    cam = Camera(W, H, fx, fx, W / 2.0, H / 2.0)
    cfg = slam_full_cfg("ORB")
    cfg.set("SLAM.LoopClose", "0")
    slam = create_slam(cfg, cam, device=dev)
    for j in range(4):
        slam.track(gray[j], float(j))
    ins, kw = slam_chain_inputs(slam)
    imgs = torch.from_numpy(gray[4:4 + k]).to(dev)
    torch.cuda.synchronize()
    _, n_fn = count_syncs(lambda: pipeline.fused_track_chain_images(
        imgs, *ins, params=slam.detector.params, **kw)[0].cpu())
    frames = [Frame(id=slam.map.get_fid(), timestamp=float(j), camera=cam,
                    image=gray[j]) for j in range(4, 4 + k)]
    torch.cuda.synchronize()
    n, n_all = count_syncs(lambda: slam.tracker.track_chain(frames))
    if n != k:
        raise AssertionError(f"phase 2f: the measured chain consumed {n} "
                             f"of {k} frames")
    return n_fn, n_all


def run_online_phase(frames, poses, fx, dev, wrappers, card):
    """Phase 2f: bench.py's SLAM pass on the port. The first ONLINE_FRAMES
    frames of the strip in bench.py's out-and-back order, uint8 gray
    from the host, ORB-1000, no loop closing, SLAM.isOnline 1: the four
    (TrackChain, TrackScale) configurations once each (bench.py:306-316
    runs them in two interleaved rounds); then
    SIFT-1000 with TrackChain 8 over frames 0-17; and the synchronising
    calls of one chain. Gates in `online_gates`."""
    k = min(len(poses), ONLINE_FRAMES)
    order = online_order(k)
    gray = bench_gray(frames[:k].cpu().numpy())[order]
    gt = poses[:k][order]
    K, H, W = gray.shape
    print(f"online (phase 2f) inputs: frames 0-{k - 1} of the strip "
          f"{W}x{H}, out and back ({K} frames), uint8 gray from the host; "
          f"ORB-1000, SLAM.LoopClose 0, SLAM.isOnline 1; the gates: "
          f"tracked >= {ONLINE_MIN_TRACKED:g} of the frames fed and ATE < "
          f"{ONLINE_MAX_ATE_SHARE * 100:g} % of the span (ORB), frames_total"
          f" = fed, no track error, the thread and the mapper ended within "
          f"{ONLINE_JOIN_S:g} s, a chain of 2 or more, the path's kernels "
          f"launched")
    # one round: bench.py's second, interleaved round (its per-config
    # minimum) is the benchmark's; the smoke keeps to half its time limit
    runs = {}
    for chain, scale in ONLINE_CONFIGS:
        label = f"ORB TrackChain {chain} TrackScale {scale}"
        r = run_online_slam(gray, gt, fx, dev, wrappers, chain, scale)
        print(online_line(label, r, ORB_KERNELS, card))
        online_gates(label, r, ORB_KERNELS if scale == 1
                     else ORB_HALF_KERNELS, chain)
        runs[(chain, scale)] = (r["ms"], r["tracked"])
    print("online (phase 2f) ORB, one round, ms a frame (frames/s, tracked "
          f"of {K}): " + "; ".join(
              f"TrackChain {c} TrackScale {s} {ms:.1f} ({1e3 / ms:.2f}, "
              f"{t})" for (c, s), (ms, t) in runs.items()))
    sg = bench_gray(frames[:18].cpu().numpy())
    r = run_online_slam(sg, poses[:18], fx, dev, wrappers, 8, 1, "Sift")
    print(online_line("SIFT TrackChain 8, frames 0-17", r, SIFT_KERNELS,
                      card))
    online_gates("SIFT", r, SIFT_KERNELS, 8, orb=False)
    n_fn, n_all = chain_syncs(gray, fx, dev)
    print(f"online (phase 2f) synchronising calls of one chain of 8 "
          f"frames (torch.cuda.set_sync_debug_mode): "
          f"fused_track_chain_images and its copy back {n_fn}; the whole "
          f"Tracker.track_chain (staging, upload, chain, copy, bookkeeping,"
          f" keyframes and their mapping inline) {n_all}")


# ---------------------------------------------------------------------------
# phase 2h: the JAX package's end-to-end SLAM suites on the port
# ---------------------------------------------------------------------------

# the cases run here (scripts/torch_e2e_scenes.py CARD_CASES), by their
# measured time: loop closing (88 frames, 61 s on the card), GPS fusion (72
# frames, 50 s), the real-texture circuit (208 frames, 117 s), the race hunt
# and the real sequence run in scripts/torch_e2e_phase.py: with them the
# script would pass its 680 s
E2E_CASES = ("soak", "parallax", "blur")
# the kernels the cases' ORB path launches at their frame sizes (320x240,
# 256x192): K2. K1 and K4 are not on it, as in the JAX package: the flat
# pyramid needs a level-0 block of 640 rows (flatpyr.flat_pyramid_available,
# flatpyr_pallas._tables), and K4 a keypoint a cell on every level
# (orb.fused_select_ok); these shapes take the resize chain and the
# per-level selection. The feed's kernels, on the soak's FusionSystem
E2E_PATH = ("patchgather",)
E2E_FEED = ("shearwarp", "bandedsandwich")


def run_e2e_phase(dev, wrappers, card):
    """Phase 2h: `torch_e2e_scenes.run_cases` over E2E_CASES, each case
    through `create_slam(cfg, cam, device="cuda")` (and `FusionSystem` in
    the soak) at its reference test's scene, frames, configuration and
    bars, with every launch count set to 0 before it and read after it.
    Prints each case's ms a frame, tracked, ATE, loops closed, geo ATE,
    points, keyframes, every bar beside its value, the card and its
    launches; gates on every bar, E2E_PATH's kernels launched over the
    phase and E2E_FEED's in the soak. Returns {kernel: launches over the
    phase}."""
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(
        __file__)), "scripts"))
    import torch_e2e_scenes as e2e
    t0 = time.perf_counter()
    cases, total = e2e.run_cases(E2E_CASES, dev, wrappers, card)
    print("e2e (phase 2h) launches over the phase: " + ", ".join(
        f"{k} {v}" for k, v in total.items())
        + f"; {time.perf_counter() - t0:.1f} s")
    missed = [c.name for c in cases if not c.ok]
    soak = next(c for c in cases if c.name == "soak")
    if missed or min(total[k] for k in E2E_PATH) < 1 \
            or min(soak.launches[k] for k in E2E_FEED) < 1:
        raise AssertionError(f"phase 2h: bars missed in {missed or 'none'}"
                             ", or a kernel not launched")
    return total


# ---------------------------------------------------------------------------
# phase 2i: the vocabulary trainers and the ablation harness
# ---------------------------------------------------------------------------

# training views a trainer: a depth cut (the trainers' defaults are 24 ORB
# and 16 SIFT views)
TRAINER_VIEWS = 4
# at 4 views a k=10, L=3 tree leaves some of its 1000 leaves unsplit (the
# port on the CPU: 957 ORB words, 874 SIFT); the gate asks for more than 800
TRAINER_MIN_WORDS = 800
TRAINER_KERNELS = {"orb": ("patchgather",),
                   "sift": ("bandedstack", "bilineargrid")}
# one combination of doc/ABLATION.md's v3 grid, at its full depth (the
# pipeline demo's 52-frame 320x240 survey), and its bars
ABLATION_COMBO = ("fixture=real", "gps=0.5", "refresh=1", "seed=0")
ABLATION_MIN_TRACKED = 0.85
ABLATION_KERNELS = ("patchgather", "shearwarp", "bandedsandwich")


def vocabulary_equal(a, b):
    """Two vocabularies hold the same tree, weights and words."""
    return ((a.k, a.L, a.weighting, a.scoring)
            == (b.k, b.L, b.weighting, b.scoring)
            and all(np.array_equal(getattr(a, f), getattr(b, f))
                    for f in ("node_desc", "node_parent", "node_weight",
                              "node_children", "node_word", "words")))


def run_trainer(name, trainer, root, dev, wrappers):
    """One vocabulary trainer over TRAINER_VIEWS views on the card, its
    .gbow saved, loaded back and embedded as a module. Returns (its line,
    its launches, whether its gates held)."""
    import importlib.util

    import torch
    from pislamfusion_tpu_torch.core import resource
    from pislamfusion_tpu_torch.ops.vocabulary import Vocabulary
    for w in wrappers.values():
        w.launches = 0
    torch_sync(dev)
    t0 = time.perf_counter()
    voc, D = trainer.train(TRAINER_VIEWS, dev, log=lambda _: None)
    torch_sync(dev)
    secs = time.perf_counter() - t0
    launches = {k: w.launches for k, w in wrappers.items()}
    gbow = os.path.join(root, f"{name}.gbow")
    module = os.path.join(root, f"{name}_vocab.py")
    import torch_train_default_vocab
    torch_train_default_vocab.save(voc, gbow, module,
                                   f"{name}_phase2i.gbow")
    back = Vocabulary.load(gbow)
    spec = importlib.util.spec_from_file_location(f"{name}_phase2i", module)
    spec.loader.exec_module(importlib.util.module_from_spec(spec))
    with open(gbow, "rb") as f:
        embedded = resource.get(f"{name}_phase2i.gbow") == f.read()
    words, nodes = voc.size(), len(voc.node_parent)
    round_trip = back is not None and vocabulary_equal(voc, back)
    # the kernels launch on the card only (the CPU takes their plain
    # versions: scripts/torch_ablation_phase.py --device cpu)
    launched = (torch.device(dev).type != "cuda"
                or min(launches[k] for k in TRAINER_KERNELS[name]) >= 1)
    ok = (TRAINER_MIN_WORDS < words <= 1000 and words < nodes <= 1111
          and round_trip and embedded and launched)
    line = (f"ablation (phase 2i) {name} vocabulary trainer, "
            f"{TRAINER_VIEWS} views 480x640: {secs:.1f} s; {len(D)} "
            f"descriptors {D.dtype} x{D.shape[1]}; {words} words, {nodes} "
            f"nodes (k 10, L 3); save -> load equal {round_trip}, embedded "
            f"module equal {embedded}; launches " + ", ".join(
                f"{k} {v}" for k, v in launches.items()))
    return line, launches, ok


def torch_sync(dev):
    import torch
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize()


def run_ablation_combo(root, dev, card):
    """ABLATION_COMBO through scripts/torch_batch_evaluate.py in a
    subprocess on `dev`. Returns (its metrics, the JAX package's row of
    doc/ablation_v3_summary.json)."""
    import torch
    here = os.path.dirname(os.path.abspath(__file__))
    out = os.path.join(root, "ablation")
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, os.path.join(
        here, "scripts", "torch_batch_evaluate.py"), out, *ABLATION_COMBO,
        "--device", torch.device(dev).type],
        capture_output=True, text=True, timeout=900)
    secs = time.perf_counter() - t0
    print(r.stdout, end="", flush=True)
    if r.returncode != 0:
        raise AssertionError(f"phase 2i: the harness exited {r.returncode}"
                             f": {r.stderr[-2000:]}")
    sys.path.insert(0, os.path.join(here, "scripts"))
    import torch_batch_evaluate as harness
    name = harness.combo_name([a.split("=") for a in ABLATION_COMBO])
    with open(os.path.join(out, name, "metrics.json")) as f:
        m = json.load(f)
    with open(os.path.join(here, "doc", "ablation_v3_summary.json")) as f:
        ref = json.load(f)[name]
    print(f"ablation (phase 2i) {name} (scripts/torch_batch_evaluate.py, "
          f"{torch.device(dev).type}, {secs:.1f} s with its processes' "
          f"start): "
          f"{1e3 * m['wall_s'] / m['frames']:.1f} ms a frame over "
          f"{m['frames']} frames; tracked {m['tracked_ratio']:.4f}, ATE "
          f"{m['ate_pct']:.4f} % of the span, PSNR {m['psnr']:.4f} dB over "
          f"{m['coverage']:.4f} coverage, loops {m['loops_closed']}, GPS "
          f"fitted {m['gps_fitted']}, fed {m['mosaic_frames']}, refreshed "
          f"{m['frames_refreshed']}, fusion error {m['fusion_error']}; the "
          f"JAX package (CPU, doc/ablation_v3_summary.json): "
          f"{1e3 * ref['wall_s'] / ref['frames']:.1f} ms a frame, tracked "
          f"{ref['tracked_ratio']:.4f}, ATE {ref['ate_pct']:.4f} %, PSNR "
          f"{ref['psnr']:.4f} dB (refresh off: 0.0, a blank canvas); "
          f"launches " + ", ".join(f"{k} {v}" for k, v in
                                   m["launches"].items()) + f" ({card})",
          flush=True)
    return m, ref


def run_ablation_phase(dev, wrappers, card):
    """Phase 2i: both vocabulary trainers on the card at TRAINER_VIEWS
    views (gates: words and nodes, the .gbow's save -> load round trip and
    its embedded module equal, K2 (ORB), K5 and K6 (SIFT) launched; K1 and
    K4 reported: at 480x640 neither takes ORB's pyramid and selection,
    as in the JAX package), then ABLATION_COMBO through the harness in a
    subprocess (gates: tracked share over ABLATION_MIN_TRACKED, a mosaic
    that is not blank (PSNR over 0 dB), no fusion error, K2, K3 and K8
    launched). Returns {kernel: launches over the phase}."""
    import shutil
    import tempfile

    import torch
    from pislamfusion_tpu_torch.ops.features import flatpyr
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, os.path.join(here, "scripts"))
    import torch_train_default_vocab as orb_trainer
    import torch_train_sift_vocab as sift_trainer
    root = tempfile.mkdtemp(prefix="chip_smoke_2i_")
    total = {k: 0 for k in wrappers}
    failed = []
    try:
        for name, trainer in (("orb", orb_trainer), ("sift", sift_trainer)):
            line, launches, ok = run_trainer(name, trainer, root, dev,
                                             wrappers)
            print(line + f" ({card})", flush=True)
            for k, v in launches.items():
                total[k] += v
            if name == "orb":
                p = orb_trainer.ORB_PARAMS
                flat = flatpyr.flat_pyramid_available(
                    480, 640, p.n_levels, p.scale_factor, p.cell)
                print("ablation (phase 2i) at 480x640, 4 levels: K1 "
                      f"launched {launches['flatpyr']} times (the flat "
                      f"plan available: {flat}), K4 "
                      f"{launches['fastselect']} times (it needs a "
                      "keypoint a cell on every level)", flush=True)
            if not ok:
                failed.append(f"{name} trainer")
        m, _ = run_ablation_combo(root, dev, card)
        for k, v in m["launches"].items():
            total[k] += v
        launched = (torch.device(dev).type != "cuda" or min(
            m["launches"][k] for k in ABLATION_KERNELS) >= 1)
        if not (m["tracked_ratio"] > ABLATION_MIN_TRACKED and m["psnr"] > 0
                and not m["fusion_error"] and launched):
            failed.append("the harness's combination")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    print("ablation (phase 2i) launches over the phase: " + ", ".join(
        f"{k} {v}" for k, v in total.items()), flush=True)
    if failed:
        raise AssertionError(f"phase 2i: gates failed in {failed}")
    return total


def run_online_app(ds, poses, root, wrappers, card):
    """Phase 2f's last call: `app.main(["Act=SLAM", ...])` over phase 2e's
    dataset with SLAM.isOnline 1 and SLAM.TrackChain 8 (the tracking
    thread, the mapper's worker and the fusion consumer on one card).
    Gates on phase 2e's liveness: every artifact, the consumer ended
    without error, frames fed; and on the online SLAM's: frames_total =
    frames read, no track error, the thread ended, the mapper drained,
    K1, K4, K2, K3 and K8 launched."""
    out = os.path.join(root, "online")
    slam, fusion, wall, launches, _, mem = run_fused_slam(
        ds, out, wrappers, ("SLAM.isOnline=1", "SLAM.TrackChain=8"),
        "phase 2f")
    K = len(poses)
    frames = [f for f in slam.map.frames()
              if f.n_tracked() > 0 or f.is_keyframe]
    est = np.stack([f.pose_c2w[:3] for f in frames])
    ids = np.asarray([int(round(f.timestamp)) for f in frames])
    ate = geo_ate(est, poses[ids][:, :3])
    lengths = slam.tracker.chain_lengths
    missing = [f for f in ("result.png", "trajectory.txt", "map.ply",
                           "m2df/config.cfg", "map.mf")
               if not os.path.isfile(os.path.join(out, f))]
    peak, held = mem.get("cuda:0", (0, 0))
    print(f"online (phase 2f) Act=SLAM, SLAM.isOnline 1, TrackChain 8, "
          f"phase 2e's dataset: {wall * 1e3 / K:.1f} ms a frame (host "
          f"clock, the whole Act); tracked {slam.frames_tracked}/"
          f"{slam.frames_total} of {K}, keyframes "
          f"{len(slam.map.keyframes())}, GPS fitted {slam.mapper.gps_fitted}"
          f", geo ATE {ate:.3f} m; chains {len(lengths)}, mean length "
          f"{np.mean(lengths) if lengths else 0:.2f}; mosaic fed "
          f"{fusion.frames_fed}, refreshed {fusion.frames_refreshed}; "
          f"consumer alive {fusion.alive()}, error {fusion.error is not None}"
          f"; thread ended {not slam._worker.is_alive()}, mapper pending "
          f"{slam.mapper._pool.pending()}, track errors "
          f"{slam.track_errors + slam.mapper.worker_errors}; launches "
          + ", ".join(f"{k} {launches[k]}" for k in FUSED_KERNELS)
          + f"; peak device memory {peak / 2 ** 20:.1f} MiB above the "
          f"{held / 2 ** 20:.1f} MiB held before the call ({card})")
    if not (not missing and fusion.error is None and not fusion.alive()
            and fusion.frames_fed > 0 and slam.frames_total == K
            and slam.track_errors == 0 and slam.mapper.worker_errors == 0
            and not slam._worker.is_alive()
            and slam.mapper._pool.pending() == 0
            and min(launches[k] for k in FUSED_KERNELS) >= 1):
        raise AssertionError(f"phase 2f Act=SLAM online: gates failed "
                             f"(missing {missing}, error {fusion.error}, fed "
                             f"{fusion.frames_fed}, total "
                             f"{slam.frames_total}, launches {launches})")


# ---------------------------------------------------------------------------
# phase 2g: scale-out over a mesh of 4 shards on the one card
# ---------------------------------------------------------------------------

SCALEOUT_SHARDS = 4
SCALEOUT_SEG_LEN = 7          # frames 0-24 as 4 segments overlapping by 1
SCALEOUT_FRAMES = 25
# the merged canvas against the footprints' union (run_map2d's rule with
# FastVO's half-resolution weight pyrUp, which adds a few pixels a side)
SCALEOUT_COVER_TOL = 0.03
# tests/test_parallel.py's poses bar, 1e-4, is for camera centres ~5 m
# from the origin; phase 2c's are ~120 m out, where f32 steps are
# 7.6e-6 m and the order of the normal equations' sums moves the 10-step
# LM's result by up to 1.45e-4 m (the CPU, 8 threads against the
# chain's run): the quaternions are held to 1e-4, the translations to
# 1e-4 scaled by the problem's size (|t| / 5 m)
SCALEOUT_BA_TOL = 1e-4
SCALEOUT_BA_REF_M = 5.0
SCALEOUT_MOSAIC_ATOL, SCALEOUT_MOSAIC_RTOL = 2e-4, 1e-5
# the 30 %-inlier PnP's budget: a 6-point sample is all inliers with
# p ~ 6e-4, so 4 shards x 4096 (8192 DLT samples) miss with p ~ 0.7 %
SCALEOUT_PNP_ITERS = 4096
SCALEOUT_KERNELS = ("flatpyr", "fastselect", "patchgather", "shearwarp",
                    "bandedsandwich")


def survey_segments(frames, poses, seg_len, device):
    """frames [N, H, W, 3] (a tensor) as segments_from_frames(seg_len,
    overlap 1) cuts them, gathered on `device` (no host copy), with the
    true poses of the segments' first frames as anchors (a tensor there)
    and the first indices."""
    import torch
    from pislamfusion_tpu_torch.parallel import dist_vo
    N = frames.shape[0]
    _, firsts = dist_vo.segments_from_frames(np.arange(N), seg_len,
                                             overlap=1)
    idx = np.minimum(firsts[:, None] + np.arange(seg_len)[None], N - 1)
    segs = frames[torch.as_tensor(idx, device=frames.device)].to(device)
    anchors = torch.as_tensor(poses[firsts]).to(device)
    return segs, anchors, firsts


def footprint_share(vo, covered, poses):
    """Covered canvas pixels over the union of the strip's nadir
    footprints (a rectangle: one footprint plus the track)."""
    H, W = vo.cam.height, vo.cam.width
    fw, fh = W * ALT / vo.cam.fx, H * ALT / vo.cam.fy
    span = poses[:, :2].max(0) - poses[:, :2].min(0)
    union = (fw + span[0]) * (fh + span[1]) / vo.length_pixel ** 2
    return covered.sum() / union


def run_scaleout_phase(frames, poses, fx, dev, wrappers, card, ba_ref):
    """Phase 2g: the parallel/ modules over a mesh of SCALEOUT_SHARDS
    shards on the one card (each shard's work in turn on its default
    stream). `dist_vo.process_survey` over frames 0-24 of the strip (4
    segments of 7 overlapping by 1, the true poses of their first frames
    as anchors), plain and drift-corrected, each after a warm-up pass,
    with every launch count set to 0 just before and read just after,
    beside a serial FastVO.process of the same frames; `dist_ba.
    optimize_sharded` on phase 2c's BA problem (`ba_ref`: (problem,
    huber delta), ba.optimize's result) twice; `dist_mosaic.feed_frames`
    striped against mesh=None on 8 frames; `dist_ransac.find_pnp_sharded`
    on tests/test_parallel.py's 30 %-inlier problem; `batch.
    batched_orb_detect` on 8 frames and `batched_sift_detect` on 4 against
    their per-frame detectors. Returns every kernel's launches over the
    whole phase."""
    import torch
    from pislamfusion_tpu_torch.ops import image as im
    from pislamfusion_tpu_torch.ops import mosaic as M
    from pislamfusion_tpu_torch.ops.features import orb, sift
    from pislamfusion_tpu_torch.parallel import (batch, dist_ba,
                                                 dist_mosaic, dist_ransac,
                                                 dist_vo, make_mesh)
    for fn in wrappers.values():
        fn.launches = 0
    t_phase = time.perf_counter()
    mesh = make_mesh([dev] * SCALEOUT_SHARDS)
    n = SCALEOUT_FRAMES
    fr, ps = frames[:n], poses[:n]
    K, H, W = fr.shape[:3]
    segs, anchors, firsts = survey_segments(fr, ps, SCALEOUT_SEG_LEN, dev)
    S = segs.shape[0]
    stride = SCALEOUT_SEG_LEN - 1

    def make():
        return make_fastvo(H, W, fx, ps, 1000, 8, 5, dev)

    def timed(fn):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ev[0].record()
        out = fn()
        ev[1].record()
        ev[1].synchronize()
        return out, ev[0].elapsed_time(ev[1]), time.perf_counter() - t0

    # the serial path over the same frames
    make().process(fr, ps[0])
    vo_s = make()
    (est_serial, nm_serial), ser_ms, _ = timed(
        lambda: vo_s.process(fr, ps[0]))
    err_serial = np.linalg.norm(est_serial[:, :3] - ps[:, :3], axis=1)
    _, cov_serial = vo_s.blended()
    del vo_s
    print(f"scale-out (phase 2g) {card}: mesh of {mesh.size} shards on "
          f"{dev} ({mesh.shape}); frames 0-{K - 1} of the strip {W}x{H} as "
          f"{S} segments of {SCALEOUT_SEG_LEN} overlapping by 1 (firsts "
          f"{firsts.tolist()}), ORB-1000, 8 levels, 5 bands, window 60; "
          f"serial FastVO.process of the same frames {ser_ms / K:.3f} ms a "
          f"frame (CUDA events), max position error {err_serial.max():.3f}"
          f" m")
    for label, kw in (("plain", {}),
                      ("drift-corrected", dict(correct_drift=True,
                                               anchor_stride=stride))):
        vo = make()
        dist_vo.process_survey(vo, segs, anchors, mesh, **kw)   # warm-up
        vo = make()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        counts = {k: fn.launches for k, fn in wrappers.items()}
        (est_s, nm), dev_ms, wall = timed(
            lambda: dist_vo.process_survey(vo, segs, anchors, mesh, **kw))
        launches = {k: fn.launches - counts[k] for k, fn in wrappers.items()}
        peak = torch.cuda.max_memory_allocated()
        vo2 = make()
        torch.cuda.synchronize()
        _, syncs = count_syncs(lambda: dist_vo.process_survey(
            vo2, segs, anchors, mesh, **kw))
        del vo2
        err = np.linalg.norm(est_s[..., :3] - ps[np.minimum(
            firsts[:, None] + np.arange(SCALEOUT_SEG_LEN), K - 1)][..., :3],
            axis=-1)
        img, covered = vo.blended()
        share = footprint_share(vo, covered, ps)
        cover_vs_serial = covered.sum() / max(cov_serial.sum(), 1)
        print(f"scale-out (phase 2g) process_survey {label}: "
              f"{dev_ms / K:.3f} ms a survey frame ({dev_ms / (S * SCALEOUT_SEG_LEN):.3f} ms a "
              f"segment frame; CUDA events; host clock {wall * 1e3 / K:.3f}"
              f" ms a survey frame) against serial {ser_ms / K:.3f}; peak "
              f"device memory {peak / 2**20:.1f} MiB; synchronising calls "
              f"{syncs}; n_match {nm.tolist()}; max position error "
              f"{err.max():.3f} m (serial {err_serial.max():.3f}); covered "
              f"{share:.4f} of the footprints' union, {cover_vs_serial:.4f}"
              f" of the serial canvas's")
        print(f"scale-out (phase 2g) process_survey {label} launches: "
              + ", ".join(f"{k} {v}" for k, v in launches.items()))
        ok = ((nm[:, 1:] > 50).all() and np.isfinite(est_s).all()
              and err.max() <= err_serial.max() + 0.1
              and abs(share - 1.0) < SCALEOUT_COVER_TOL
              and np.isfinite(img).all()
              and all(launches[k] > 0 for k in SCALEOUT_KERNELS))
        if label != "plain":
            bent = max(np.linalg.norm(est_s[s, stride, :3]
                                      - anchors[s + 1, :3].cpu().numpy())
                       for s in range(S - 1))
            print(f"scale-out (phase 2g) drift-corrected: boundary frames "
                  f"{bent:.2e} m from the next anchor; n_match equal to the "
                  f"plain run's {np.array_equal(nm, plain_nm)}")
            ok = ok and bent < 1e-3
        if not ok:
            raise AssertionError(f"phase 2g process_survey {label}: gates "
                                 "failed")
        plain_nm = nm
        del vo
    # dist_ba on phase 2c's problem, twice
    (prob, hd), (p1, x1, c1) = ba_ref
    runs = []
    for _ in range(2):
        out, ms, _ = timed(lambda: dist_ba.optimize_sharded(
            prob, mesh, iters=10, huber_delta=hd))
        runs.append((out, ms))
    (p4, x4, c4), ms4 = runs[0]
    same = all(torch.equal(a, b) for a, b in zip(runs[0][0], runs[1][0]))
    dq = float((p4[:, 3:] - p1[:, 3:]).abs().max())
    dt = float((p4[:, :3] - p1[:, :3]).abs().max())
    t_tol = SCALEOUT_BA_TOL * max(1.0, float(p1[:, :3].norm(dim=1).max())
                                  / SCALEOUT_BA_REF_M)
    dpts = float((x4 - x1).abs().max())
    print(f"scale-out (phase 2g) dist_ba.optimize_sharded, phase 2c's BA "
          f"({prob.poses.shape[0]} frames, {prob.points.shape[0]} points, "
          f"{prob.obs_uv.shape[0]} observations over {mesh.size} shards, 10"
          f" steps): {ms4:.2f} ms (CUDA events), cost {float(c4):.6g} "
          f"(ba.optimize {float(c1):.6g}), against ba.optimize: max |dq| "
          f"{dq:.2e} (bar {SCALEOUT_BA_TOL:g}), max |dt| {dt:.2e} m (bar "
          f"{t_tol:.2e}), max |point| {dpts:.2e} m; two card runs bit-equal "
          f"{same}")
    if not (dq <= SCALEOUT_BA_TOL and dt <= t_tol and same):
        raise AssertionError("phase 2g dist_ba: gates failed")
    # dist_mosaic: the striped canvas against mesh=None on 8 frames
    vo = make()
    patch = (vo.patch_tiles * 256,) * 2
    hs, oyx = [], []
    for k in range(8):
        o, h = vo._patch_homography(torch.as_tensor(ps[k]).to(dev))
        hs.append(h)
        oyx.append([int(o[1]) * 256, int(o[0]) * 256])
    hs = torch.stack(hs)
    imgs = fr[:8].to(torch.float32)
    outs = []
    for m in (None, mesh):
        lap, w = M.alloc_canvas(vo.canvas_tiles, vo.canvas_tiles, 5, dev)
        out, ms, _ = timed(lambda: dist_mosaic.feed_frames(
            lap, w, imgs, hs, np.asarray(oyx), 5, patch, mesh=m))
        outs.append((dist_mosaic.gather_canvas(*out), ms))
    (ls, ws), ms_single = outs[0]
    (lm, wm), ms_mesh = outs[1]
    d_lap = max(float((a - b).abs().max()) for a, b in zip(ls, lm))
    d_w = max(float((a - b).abs().max()) for a, b in zip(ws, wm))
    close = all(torch.allclose(b, a, atol=SCALEOUT_MOSAIC_ATOL,
                               rtol=SCALEOUT_MOSAIC_RTOL)
                for a, b in zip(ls, lm)) and d_w <= 1e-5
    print(f"scale-out (phase 2g) dist_mosaic.feed_frames, 8 frames, patch "
          f"{patch[0]}^2, canvas {vo.canvas_tiles}^2 tiles, 5 bands, "
          f"striped over {mesh.size} shards: max |mesh - single| Laplacian "
          f"{d_lap:.2e}, weights {d_w:.2e}; {ms_mesh / 8:.3f} ms a frame "
          f"striped, {ms_single / 8:.3f} single (CUDA events)")
    if not close:
        raise AssertionError("phase 2g dist_mosaic: mesh and single differ")
    del vo, outs, ls, ws, lm, wm
    # dist_ransac on the 30 %-inlier PnP
    T_true, p3d, p2n, out = pnp_problem()
    r, ms, _ = timed(lambda: dist_ransac.find_pnp_sharded(
        torch.Generator().manual_seed(5), torch.from_numpy(p3d).to(dev),
        torch.from_numpy(p2n).to(dev),
        torch.ones(p3d.shape[0], dtype=torch.bool, device=dev), mesh=mesh,
        threshold=0.01, iters_per_device=SCALEOUT_PNP_ITERS))
    inl = r.inliers.cpu().numpy()
    err_t = float(np.linalg.norm(r.model.cpu().numpy()[:3] - T_true[:3]))
    print(f"scale-out (phase 2g) dist_ransac.find_pnp_sharded, 30 % "
          f"inliers of {p3d.shape[0]}, {mesh.size} x {SCALEOUT_PNP_ITERS} "
          f"hypotheses: {ms:.2f} ms, ok {bool(r.ok)}, inliers "
          f"{int(inl[~out].sum())}/{int((~out).sum())} true and "
          f"{int(inl[out].sum())}/{int(out.sum())} false, translation error"
          f" {err_t:.4f}")
    if not (bool(r.ok) and inl[~out].sum() > 0.8 * (~out).sum()
            and inl[out].sum() < 0.1 * out.sum() and err_t < 0.05):
        raise AssertionError("phase 2g dist_ransac: gates failed")
    # the batched detectors against their per-frame ones, the frames cut
    # over dp: a (4, 1) mesh of the same shards
    mesh = make_mesh([dev] * SCALEOUT_SHARDS, shape=(SCALEOUT_SHARDS, 1))
    gray = im.rgb_to_gray(fr[:8].to(torch.float32))
    params = orb.OrbParams(n_features=1000, n_levels=8)
    feats, ms_b, _ = timed(lambda: batch.batched_orb_detect(gray, params,
                                                            mesh))
    ok_orb = all(torch.equal(feats[k][b], v) for b in range(8)
                 for k, v in orb.orb_detect(gray[b], params).items())
    sp = sift.SiftParams(n_features=1000)
    sfeats, ms_s, _ = timed(lambda: batch.batched_sift_detect(gray[:4], sp,
                                                              mesh))
    ok_sift = all(torch.equal(sfeats[k][b], v) for b in range(4)
                  for k, v in sift.sift_detect(gray[b], sp).items())
    print(f"scale-out (phase 2g) batch.batched_orb_detect 8 frames over "
          f"dp={mesh.shape['dp']}: {ms_b / 8:.3f} ms a frame, equal to "
          f"orb_detect {ok_orb}; batched_sift_detect 4 frames: "
          f"{ms_s / 4:.3f} ms a frame, equal to sift_detect {ok_sift}")
    if not (ok_orb and ok_sift):
        raise AssertionError("phase 2g batch: a batched detector differs")
    launches = {k: fn.launches for k, fn in wrappers.items()}
    print(f"scale-out (phase 2g) launches over the phase: " + ", ".join(
        f"{k} {v}" for k, v in launches.items())
        + f"; {time.perf_counter() - t_phase:.1f} s")
    return launches


def pnp_problem():
    """tests/test_parallel.py's 30 %-inlier PnP (seed 0): (T_true, p3d,
    p2n, outlier mask), numpy."""
    import torch
    from pislamfusion_tpu_torch.ops import lie
    rng = np.random.default_rng(0)
    N = 256
    T_true = np.array([0.4, -0.2, 0.3, 0.1, 0.05, 0.0, 0.99], np.float32)
    T_true[3:7] /= np.linalg.norm(T_true[3:7])
    pts = rng.uniform(-2, 2, (N, 3)).astype(np.float32)
    pts[:, 2] += 6.0
    pc = lie.se3_apply(torch.from_numpy(T_true).expand(N, 7),
                       torch.from_numpy(pts)).numpy()
    p2n = (pc[:, :2] / pc[:, 2:]).astype(np.float32)
    out = rng.random(N) > 0.3
    p2n[out] += rng.normal(0, 0.3, (out.sum(), 2)).astype(np.float32)
    return T_true, pts, p2n, out


def brief_card_vs_cpu(dev):
    """Phase 3's check of the continuous-angle BRIEF: `orb_detect` with
    OrbParams(angle_bins=0) on frame 0 of the small strip (600x640, 256
    features, 4 levels) on the card against the CPU, at the port's ORB
    bars (tests/test_torch_fastvo.py): >= 98 % of the valid keypoints
    the same (xy, octave), >= 99.9 % of their bits equal."""
    import torch
    from pislamfusion_tpu_torch.ops import image as im
    from pislamfusion_tpu_torch.ops.features import orb
    fr2, _ = render_strip(1, 600, 640, 600.0, 0.24, 1024, "cpu")
    gray = im.rgb_to_gray(fr2[0].to(torch.float32))
    params = orb.OrbParams(n_features=256, n_levels=4, angle_bins=0)
    runs = [{k: v.cpu().numpy() for k, v in orb.orb_detect(
        gray.to(d), params).items()} for d in ("cpu", dev)]

    def keyed(f):
        return {(round(float(x), 3), round(float(y), 3), int(o)): i
                for i, ((x, y), o, v) in enumerate(
                    zip(f["xy"], f["octave"], f["valid"])) if v}
    kc, kg = keyed(runs[0]), keyed(runs[1])
    common = set(kc) & set(kg)
    bits = float(np.mean(runs[1]["desc"][[kg[c] for c in common]]
                         == runs[0]["desc"][[kc[c] for c in common]]))
    share = len(common) / max(len(kc), 1)
    print(f"ORB angle_bins=0 (continuous BRIEF) small strip 640x600, card "
          f"vs CPU: {len(common)}/{len(kc)} keypoints the same ({share:.4f})"
          f", bits equal {bits:.5f}")
    if not (len(kc) > 200 and share >= 0.98 and bits >= 0.999):
        raise AssertionError("ORB angle_bins=0: the card's run disagrees "
                             "with the CPU run")


def survey_card_vs_cpu(dev):
    """Phase 3's scale-out check: `dist_vo.process_survey` on the small
    strip (600x640, 7 frames as 3 segments of 3 overlapping by 1, 256
    features, 4 levels, 3 bands) over 4 shards of the card against 4
    shards of the CPU, at card_vs_cpu's FastVO bars."""
    import torch
    from pislamfusion_tpu_torch.parallel import dist_vo, make_mesh
    h2, w2, fx2 = 600, 640, 600.0
    fr2, p2 = render_strip(7, h2, w2, fx2, 0.24, 1024, "cpu")
    runs = []
    for d in (torch.device("cpu"), dev):
        segs, anchors, firsts = survey_segments(fr2, p2, 3, d)
        v = make_fastvo(h2, w2, fx2, p2, 256, 4, 3, d)
        e, n = dist_vo.process_survey(v, segs, anchors,
                                      make_mesh([d] * SCALEOUT_SHARDS))
        runs.append((e, n) + v.blended())
    (e_c, n_c, i_c, c_c), (e_g, n_g, i_g, c_g) = runs
    both = c_c & c_g
    mse = float(((i_c - i_g)[both] ** 2).mean())
    psnr = 10 * np.log10(255.0 ** 2 / max(mse, 1e-12))
    dt = float(np.abs(e_c[..., :3] - e_g[..., :3]).max())
    print(f"process_survey small strip {w2}x{h2}, {len(firsts)} segments "
          f"of 3 over {SCALEOUT_SHARDS} shards, card vs CPU: n_match "
          f"{n_g.tolist()} vs {n_c.tolist()}, max |dt| {dt:.2e} m, mosaic "
          f"PSNR {psnr:.1f} dB, coverage agreement {(c_c == c_g).mean():.5f}")
    if not (np.abs(n_c - n_g).max() <= 3 and dt <= 5e-3 and psnr >= 40.0):
        raise AssertionError("process_survey: the card's run disagrees with "
                             "the CPU run")


# phase 3's SLAM gates, card against CPU on the survey. The whole runs
# are chaotic in their floats: two CPU runs of the port with 1 and 8
# threads end 0.549 % of the span apart (RMS of Sim3-aligned centres),
# and even one whole step from one state (tracking, then triangulation,
# fusion and local BA) parts by up to 0.38 % between 1 and 8 CPU threads
# when a point or a binding flips (scripts/torch_slam_spread.py); card
# calls read 0.50-1.06 % from one CPU run (PERF.md section 6).
# So the whole runs are held to tests/test_slam.py's bars against the
# truth (SLAM_MIN_TRACKED, SLAM_MAX_ATE_SHARE, more than 300 points) and
# to keyframe counts within SLAM_CARD_KF of each other: the widest gap
# between the keyframe counts of CPU runs on 1, 2, 4 and 8 threads
# (scripts/torch_slam_spread.py: 23, 23, 23, 23 on one 8-core CPU), and
# never below 1. Their agreement is printed. The card's own float path is
# deterministic (ops/ba.py sums its scatters in a fixed order), so two
# card runs of the survey must be equal: the same keyframes and the same
# poses bit for bit. The stages are held on the
# same inputs: at each of SLAM_STEP_FRAMES the
# card run's fused tracking step (`fused_track_packed_feats`, from its
# state, features and staged local map) on the card and on the CPU,
# poses within SLAM_STEP_POSE of the translation scale, inlier counts
# within 2, match masks within 1 %; and SLAM_BA_WINDOWS of the card run's
# local BA windows (`Mapper.solve_local_window`) on both, poses within
# SLAM_BA_POSE and points within SLAM_BA_POINT of the scene depth. Local
# BA's 8 unconverged LM steps are themselves sensitive: points moved by
# 1e-6 relative noise move its poses by up to 1.7e-3 and its points by
# up to 5.1e-3 (scripts/torch_slam_spread.py), and card against CPU read
# poses 3.1e-3-4.4e-3 and points 4.7e-3-1.14e-2 apart (two card runs,
# PERF.md section 6), so its gates sit at 4x the largest of those, where
# a wrong kernel or solver would still fail by orders. The chain
# functions (`fused_track_chain` on the card's features,
# `fused_track_chain_images` on the frames) are held, row by row, over
# SLAM_CHAIN_K frames from the card run's state at each of
# SLAM_CHAIN_FRAMES (inside the survey's three rows), to the step gates
# but for the poses: a chain's rows feed each other, and 1e-7 relative
# noise in its aux moves them by up to 6.6e-5 of the translation scale
# on the CPU (scripts/torch_slam_spread.py, the frame-3 state just after
# the two-view set-up); card against CPU read 5.84e-5 and 9.32e-5 (two
# calls, PERF.md section 6), so SLAM_CHAIN_POSE is 4x the largest,
# rounded up
SLAM_CARD_KF, SLAM_STEP_POSE = 1, 1e-4
SLAM_CHAIN_FRAMES, SLAM_CHAIN_K, SLAM_CHAIN_POSE = (3, 15, 27), 4, 4e-4
SLAM_BA_POSE, SLAM_BA_POINT, SLAM_BA_WINDOWS = 2e-2, 5e-2, 6
SLAM_STEP_FRAMES = (3, 9, 15, 21, 27, 33)


def traj_share(p_a, p_b, ids):
    """RMS of camera centres p_a[i] Sim3-aligned to p_b[i] over `ids`, as a
    share of the span of p_b's, and the largest single share."""
    import torch
    from pislamfusion_tpu_torch.ops import lie, ransac
    a = torch.from_numpy(np.stack([p_a[i][:3] for i in ids]))
    b = torch.from_numpy(np.stack([p_b[i][:3] for i in ids]))
    d = torch.sqrt(((lie.sim3_apply(ransac.sim3_horn(a, b), a) - b) ** 2)
                   .sum(-1)).numpy()
    span = float(np.linalg.norm(b.numpy().max(0) - b.numpy().min(0)))
    return float(np.sqrt((d ** 2).mean())) / span, float(d.max()) / span


def slam_survey_run(device, frames=None, n=None, on_frame=None):
    """The port's SLAM on tests/test_slam.py's survey (320x240, 36 frames,
    its fixture config) on `device`; `on_frame(slam, i)` (when given)
    before frame i. Returns (slam, {frame id: pose}, true poses, frames)."""
    import torch
    from pislamfusion_tpu_torch.core.camera import Camera
    from pislamfusion_tpu_torch.models.slam import create_slam
    cam = Camera(320, 240, 260.0, 260.0, 160.0, 120.0)
    gt = survey_poses()[:n]
    if frames is None:
        ground = torch.from_numpy(survey_ground(np.random.default_rng(11)))
        frames = np.stack([survey_view(ground, cam, p).numpy() for p in gt])
    slam = create_slam(slam_survey_cfg(), cam, device=device)
    tracked = []
    for i, img in enumerate(frames):
        if on_frame is not None:
            on_frame(slam, i)
        n = slam.frames_tracked
        fr = slam.track(img, float(i))
        if slam.frames_tracked > n:
            tracked.append(fr)
    # keyframes' poses as local BA left them
    return slam, {f.id: np.array(f.pose_c2w) for f in tracked}, gt, frames


def slam_track_inputs(slam, image):
    """The fused tracking step's inputs for `image` from a SLAM in the
    TRACKING state, as its tracker stages them: (features, last frame's
    descriptors and valid mask, aux, staged local map (pos, desc, valid),
    camera geometry). Tensors on the SLAM's device."""
    import torch
    from pislamfusion_tpu_torch.models import pipeline
    from pislamfusion_tpu_torch.utils import host_se3 as hse3
    tr = slam.tracker
    last = tr.last_frame
    tr._stage_local_map()
    lpos, ldesc, lvalid, _ = tr._local_stage
    pos, has = tr._gather_frame_points(last)
    T_pred = hse3.se3_inv(hse3.se3_mul(last.pose_c2w, tr.motion))
    aux = np.concatenate([pos.reshape(-1), has.astype(np.float32),
                          np.asarray(T_pred, np.float32)]).astype(np.float32)
    dev = slam.device
    g = torch.from_numpy(np.asarray(image)).to(dev)
    feats = pipeline.fused_extract(g, tr.detector.params,
                                   tr.detector.pyramid)
    cam = last.camera
    geo = dict(fx=cam.fx, fy=cam.fy, cx=cam.cx, cy=cam.cy, width=cam.width,
               height=cam.height)
    return (feats, torch.from_numpy(last.desc).to(dev),
            torch.from_numpy(last.valid).to(dev),
            torch.from_numpy(aux).to(dev), lpos, ldesc, lvalid), geo


def slam_chain_inputs(slam):
    """`pipeline.fused_track_chain*`'s inputs from a SLAM in the TRACKING
    state, as `Tracker.track_chain` stages them: (last frame's descriptors
    and valid mask, aux [4N + 14] = its map points, their mask, its pose
    and the motion model, the staged local map (pos, desc, valid)) as
    tensors on the SLAM's device, and the keywords (camera geometry,
    window radii 20 and 8, chi2 5.991)."""
    import torch
    tr = slam.tracker
    last = tr.last_frame
    tr._stage_local_map()
    lpos, ldesc, lvalid, _ = tr._local_stage
    pos, has = tr._gather_frame_points(last)
    aux = np.concatenate([pos.reshape(-1), has.astype(np.float32),
                          last.pose_c2w, tr.motion]).astype(np.float32)
    dev = slam.device
    cam = last.camera
    kw = dict(fx=cam.fx, fy=cam.fy, cx=cam.cx, cy=cam.cy, width=cam.width,
              height=cam.height, radius=20.0, radius_local=8.0,
              chi2_th=5.991)
    return (torch.from_numpy(last.desc).to(dev),
            torch.from_numpy(last.valid).to(dev),
            torch.from_numpy(aux).to(dev), lpos, ldesc, lvalid), kw


def rows_apart(a, b, n):
    """The step gates' measures between packed rows a and b [..., 16 + 6n +
    2P] (numpy): the largest pose difference as a share of the translation
    scale, the largest inlier count difference, the share of last-frame
    match masks that differ."""
    a, b = np.atleast_2d(a), np.atleast_2d(b)
    pose = max(float(np.abs(a[k][sl] - b[k][sl]).max()) / max(float(
        np.linalg.norm(b[k][8:11])), 1.0) for k in range(len(a))
        for sl in (slice(0, 7), slice(8, 15)))
    inl = int(np.abs(a[:, [7, 15]] - b[:, [7, 15]]).max())
    masks = float(np.mean(a[:, 16 + n:16 + 2 * n] != b[:, 16 + n:16 + 2 * n]))
    return pose, inl, masks


def slam_chain_card_vs_cpu(dev, states, frames):
    """`fused_track_chain` and `fused_track_chain_images` on the card and
    on the CPU from the card run's state at each of SLAM_CHAIN_FRAMES,
    over the next SLAM_CHAIN_K frames (`bench_gray`'s uint8 frames; the
    feature chain fed the card's features on both devices). Returns the
    worst (pose, inliers, masks) of each and the rows' least inlier
    count."""
    import torch
    from pislamfusion_tpu_torch import convert
    from pislamfusion_tpu_torch.core.camera import Camera
    from pislamfusion_tpu_torch.models import pipeline
    from pislamfusion_tpu_torch.models.slam import create_slam
    worst = {"feats": (0.0, 0, 0.0), "images": (0.0, 0, 0.0)}
    least = np.inf

    def cpu(x):
        return x.cpu()
    for i in SLAM_CHAIN_FRAMES:
        s = create_slam(slam_survey_cfg(), Camera(320, 240, 260.0, 260.0,
                                                  160.0, 120.0), device=dev)
        convert.load_worldmap_state(s, states[i])
        ins, kw = slam_chain_inputs(s)
        params = s.detector.params
        imgs = torch.from_numpy(bench_gray(frames[i:i + SLAM_CHAIN_K])).to(
            dev)
        feats = [pipeline.fused_extract(im, params) for im in imgs]
        stacked = [torch.stack([f[k] for f in feats])
                   for k in ("desc", "valid", "xy")]
        got = {"feats": [pipeline.fused_track_chain(
            *[f(x) for x in stacked], *[f(x) for x in ins], **kw).cpu(
            ).numpy() for f in (lambda x: x, cpu)],
            "images": [pipeline.fused_track_chain_images(
                f(imgs), *[f(x) for x in ins], params=params,
                **kw)[0].cpu().numpy() for f in (lambda x: x, cpu)]}
        n = ins[0].shape[0]
        for k, (g, c) in got.items():
            worst[k] = tuple(max(u, v) for u, v in zip(
                worst[k], rows_apart(g, c, n)))
            least = min(least, float(c[:, 15].min()))
    return worst, least


def slam_card_vs_cpu(dev):
    """The port's SLAM over the survey on the card (twice) and on the CPU,
    the same frames and the same RANSAC draws (CPU generators). Gates (see
    SLAM_CARD_KF above): the two card runs equal; each whole run at
    tests/test_slam.py's bars against the truth; keyframe counts; the
    card run's fused tracking steps at SLAM_STEP_FRAMES, its local BA
    windows and the chain functions from its states, each on the card and
    on the CPU from the same inputs. Prints the whole runs' agreement
    (Sim3-aligned camera centres over the first row and the survey) and
    their ATE against the truth."""
    from pislamfusion_tpu_torch import convert
    from pislamfusion_tpu_torch.core.camera import Camera
    from pislamfusion_tpu_torch.models import mapper as tmapper
    from pislamfusion_tpu_torch.models import pipeline
    from pislamfusion_tpu_torch.models.slam import create_slam
    cpu, p_c, gt, frames = slam_survey_run("cpu")
    states, windows = {}, []

    def snapshot(slam, i):
        if i in SLAM_STEP_FRAMES + SLAM_CHAIN_FRAMES:
            states[i] = convert.worldmap_to_numpy(slam)

    solve = tmapper.Mapper.solve_local_window

    def record(*a, **k):
        windows.append((a[:7], {n: k[n] for n in (
            "iters", "huber_delta", "tol", "prior_kw") if n in k}))
        return solve(*a, **k)
    tmapper.Mapper.solve_local_window = staticmethod(record)
    try:
        card, p_g, _, _ = slam_survey_run(dev, frames, on_frame=snapshot)
    finally:
        tmapper.Mapper.solve_local_window = staticmethod(solve)
    card2, p_g2, _, _ = slam_survey_run(dev, frames)
    kf2 = len(card2.map.keyframes())
    same_ids = set(p_g) == set(p_g2)
    twice = max((float(np.abs(p_g[i] - p_g2[i]).max()) for i in p_g
                 if i in p_g2), default=np.inf)
    print(f"SLAM survey 320x240, 36 frames, two card runs: keyframes "
          f"{len(card.map.keyframes())} and {kf2}, tracked "
          f"{card.frames_tracked} and {card2.frames_tracked}, the same "
          f"frames tracked {same_ids}, largest pose difference {twice!r}")
    worst = {"pose": 0.0, "inliers": 0, "masks": 0.0, "ba_pose": 0.0,
             "ba_point": 0.0}
    for i, st in sorted(states.items()):
        if i not in SLAM_STEP_FRAMES:
            continue
        s = create_slam(slam_survey_cfg(), Camera(320, 240, 260.0, 260.0,
                                                  160.0, 120.0), device=dev)
        convert.load_worldmap_state(s, st)
        inputs, geo = slam_track_inputs(s, frames[i])
        kw = dict(radius=20.0, radius_local=8.0, chi2_th=5.991, **geo)
        pk = [pipeline.fused_track_packed_feats(*ins, **kw).cpu().numpy()
              for ins in (inputs, [
                  {k: v.cpu() for k, v in x.items()} if isinstance(x, dict)
                  else x.cpu() for x in inputs])]
        for key, v in zip(("pose", "inliers", "masks"),
                          rows_apart(pk[0], pk[1], inputs[1].shape[0])):
            worst[key] = max(worst[key], v)
    pick = windows[::max(1, len(windows) // SLAM_BA_WINDOWS)][
        :SLAM_BA_WINDOWS]
    for args, kw in pick:
        (pg, xg), (pc, xc) = [tmapper.Mapper.solve_local_window(
            *args, **kw, device=d) for d in (dev, "cpu")]
        depth = float(np.median(np.abs(np.asarray(args[2])[:, 2]
                                       - _centres_z(args[0]))))
        worst["ba_pose"] = max(worst["ba_pose"], float(np.abs(pg - pc).max()))
        worst["ba_point"] = max(worst["ba_point"],
                                float(np.abs(xg - xc).max()) / depth)
    common = sorted(set(p_c) & set(p_g))
    rms_row, max_row = traj_share(p_g, p_c, [i for i in common if i < 12])
    rms, far = traj_share(p_g, p_c, common)
    chain, least = slam_chain_card_vs_cpu(dev, states, frames)
    kf = (len(cpu.map.keyframes()), len(card.map.keyframes()))
    ates = [slam_ate(s, gt) for s in (cpu, card)]
    bars = [s.frames_tracked / s.frames_total > SLAM_MIN_TRACKED
            and a < SLAM_MAX_ATE_SHARE * sp and s.map.point_num() > 300
            and len(s.map.keyframes()) >= 2
            for s, (a, sp, _) in zip((cpu, card), ates)]
    print(f"SLAM chains card vs CPU, {SLAM_CHAIN_K} frames from the card "
          f"run's state at frames {list(SLAM_CHAIN_FRAMES)}, each row: "
          + "; ".join(f"{k} poses within {w[0]:.2e} of the translation "
                      f"scale, inliers within {w[1]}, match masks "
                      f"{w[2] * 100:.2f} % apart" for k, w in chain.items())
          + f"; least inliers of a CPU row {least:g}; gates: poses "
          f"{SLAM_CHAIN_POSE:g}, inliers 2, masks 1 %")
    print(f"SLAM survey 320x240, 36 frames, card vs CPU: keyframes {kf[1]} "
          f"vs {kf[0]}, tracked {card.frames_tracked} vs "
          f"{cpu.frames_tracked}; the card run's fused tracking steps at "
          f"frames {list(SLAM_STEP_FRAMES)} on both: poses within "
          f"{worst['pose']:.2e} of the translation scale, inliers within "
          f"{worst['inliers']}, match masks {worst['masks'] * 100:.2f} % "
          f"apart; {len(pick)} of its {len(windows)} local BA windows on "
          f"both: poses within {worst['ba_pose']:.2e}, points within "
          f"{worst['ba_point']:.2e} of the scene depth; whole runs, "
          f"Sim3-aligned centres, RMS (largest) as a share of the span: "
          f"first row {rms_row * 100:.4f} % ({max_row * 100:.4f} %), survey "
          f"{rms * 100:.4f} % ({far * 100:.4f} %); ATE share card "
          f"{ates[1][0] / ates[1][1] * 100:.3f} %, CPU "
          f"{ates[0][0] / ates[0][1] * 100:.3f} %; tests/test_slam.py's "
          f"bars (tracked > {SLAM_MIN_TRACKED:g}, ATE < "
          f"{SLAM_MAX_ATE_SHARE * 100:g} % of the span, > 300 points) met: "
          f"card {bars[1]}, CPU {bars[0]}; keyframe gate {SLAM_CARD_KF}")
    if not (kf2 == kf[1] and same_ids and twice == 0.0):
        raise AssertionError("SLAM: two card runs of the survey differ")
    if not (all(bars) and least >= 20
            and all(w[0] <= SLAM_CHAIN_POSE and w[1] <= 2 and w[2] <= 0.01
                    for w in chain.values())):
        raise AssertionError("SLAM: a whole run misses its bars or a chain "
                             "disagrees card against CPU")
    if not (abs(kf[0] - kf[1]) <= SLAM_CARD_KF and len(pick) >= 1
            and worst["pose"] <= SLAM_STEP_POSE and worst["inliers"] <= 2
            and worst["masks"] <= 0.01 and worst["ba_pose"] <= SLAM_BA_POSE
            and worst["ba_point"] <= SLAM_BA_POINT):
        raise AssertionError("SLAM: the card's stages disagree with the "
                             "CPU's")


def _centres_z(poses_w2c):
    """The mean z of the camera centres of w2c poses [F, 7] (numpy)."""
    from pislamfusion_tpu_torch.utils import host_se3 as hse3
    return np.mean([hse3.se3_inv(p)[2] for p in np.asarray(poses_w2c)])


# phase 3's solver gates, card against CPU on the same features and
# samples (PERF.md section 7): masks may differ on CARD_MASK_SHARE of the
# matches; BA's poses (translation m, quaternion components) within
# CARD_POSE_TOL, PnP's within CARD_PNP_TOL (its 12 LM steps stop short of
# convergence, from hypotheses whose SVDs differ in the last bits), the
# unit-translation initializers' within CARD_INIT_TOL; BA's cost within
# CARD_COST_RTOL relative
CARD_MASK_SHARE, CARD_POSE_TOL, CARD_INIT_TOL = 0.01, 1e-3, 1e-3
CARD_PNP_TOL, CARD_COST_RTOL = 0.1, 1e-3


def solver_card_vs_cpu(dev):
    """The chain on the small strip (600x640, frames 0-2, ORB-256 with 4
    levels, 64 hypotheses, multih 4 x 64): on the card, then on the CPU
    with the card's features and the same samples (one `Draws`). Gates:
    the initializers' decisions equal, the masks within CARD_MASK_SHARE,
    the poses and BA's cost within their tolerances."""
    import torch
    h2, w2, fx2 = 600, 640, 600.0
    fr2, p2 = render_strip(3, h2, w2, fx2, 0.24, 1024, "cpu")
    draws = Draws(0)
    kw = dict(n_features=256, n_levels=4, iters=64, mh_iters=64,
              draws=draws)
    card = solver_chain(fr2.to(dev), p2, fx2, **kw)
    cpu = solver_chain(fr2, p2, fx2, feats=[
        {k: v.cpu() for k, v in f.items()} for f in card["feats"]], **kw)
    sg, sc = chain_summary(card, p2), chain_summary(cpu, p2)
    n = len(sg["ok"])

    def share(a, b):
        return float(np.mean(np.asarray(a) != np.asarray(b)))
    masks = {"matches": share(sg["ok"], sc["ok"]),
             "svd": share(sg["svd"]["mask"], sc["svd"]["mask"]),
             "opt": share(sg["opt"]["mask"], sc["opt"]["mask"]),
             "plane": share(sg["plane"]["inliers"], sc["plane"]["inliers"]),
             "pnp": share(sg["pnp"][0]["inliers"], sc["pnp"][0]["inliers"]),
             "multih": share(sg["multih"]["ok"], sc["multih"]["ok"])}
    poses = {
        "svd": np.abs(sg["svd"]["T_c2w"] - sc["svd"]["T_c2w"]).max(),
        "opt": np.abs(sg["opt"]["T_c2w"] - sc["opt"]["T_c2w"]).max(),
        "pnp": np.abs(sg["pnp"][0]["T"] - sc["pnp"][0]["T"]).max(),
        "ba": np.abs(sg["ba"]["poses"] - sc["ba"]["poses"]).max(),
        "ba tol>0": np.abs(sg["ba_tol"]["poses"]
                           - sc["ba_tol"]["poses"]).max()}
    cost = abs(sg["ba"]["cost"] - sc["ba"]["cost"]) / max(sc["ba"]["cost"],
                                                          1e-12)
    decisions = all(bool(sg[k][f]) == bool(sc[k][f])
                    for k in ("svd", "opt") for f in ("ok", "used_h"))
    print(f"SLAM solvers small strip {w2}x{h2}, frames 0-2, card vs CPU on "
          f"the card's features and one set of samples: {n} rows; "
          f"decisions equal {decisions} (svd ok {bool(sg['svd']['ok'])} "
          f"used_h {bool(sg['svd']['used_h'])}, opt ok "
          f"{bool(sg['opt']['ok'])}); mask shares differing "
          + ", ".join(f"{k} {v:.4f}" for k, v in masks.items())
          + "; pose max |diff| " + ", ".join(
              f"{k} {v:.2e}" for k, v in poses.items())
          + f"; BA cost {sg['ba']['cost']:.6g} vs {sc['ba']['cost']:.6g} "
          f"(relative {cost:.2e}); card: {chain_line(sg)}")
    init_ok = all(poses[k] <= CARD_INIT_TOL for k in ("svd", "opt")
                  if sg[k]["ok"])
    if not (decisions and max(masks.values()) <= CARD_MASK_SHARE
            and init_ok and poses["pnp"] <= CARD_PNP_TOL
            and max(poses["ba"], poses["ba tol>0"]) <= CARD_POSE_TOL
            and cost <= CARD_COST_RTOL):
        raise AssertionError("SLAM solvers: the card's run disagrees with "
                             "the CPU run")


def map2d_card_vs_cpu(dev):
    """Map2D Types 1-4 (4 with and without EnableSeam) on the small strip
    (600x640, 6 frames, 3 bands, WarpMode shear, RenderBatch 4 so the
    last batch has padding slots), the card against the port's CPU run:
    blended PSNR >= 40 dB over the pixels either covers, coverage equal,
    frames rendered equal."""
    h2, w2, fx2 = 600, 640, 600.0
    fr2, p2 = render_strip(6, h2, w2, fx2, 0.24, 1024, "cpu")
    for typ, seam in ((1, 0), (2, 0), (3, 0), (4, 0), (4, 1)):
        runs = []
        for d in ("cpu", dev):
            m = make_map2d(typ, h2, w2, fx2, p2, d, {
                "Map2D.BandNumber": 3, "Map2D.WarpMode": "shear",
                "Map2D.RenderBatch": 4, "Map2DRender.EnableSeam": seam})
            _feed_all(m, fr2.to(d), p2)
            runs.append(m.blended() + (m.frames_rendered,))
        (i_c, c_c, n_c), (i_g, c_g, n_g) = runs
        either = c_c | c_g
        mse = float(((i_c - i_g)[either] ** 2).mean())
        psnr = 10 * np.log10(255.0 ** 2 / max(mse, 1e-12))
        what = f"Type {typ}" + (" EnableSeam" if seam else "")
        print(f"Map2D {what} small strip {w2}x{h2}, 6 frames, card vs CPU: "
              f"mosaic PSNR {psnr:.1f} dB, coverage equal "
              f"{bool((c_c == c_g).all())} ({c_g.mean():.4f}), rendered "
              f"{n_g} vs {n_c}")
        if not (psnr >= 40.0 and (c_c == c_g).all() and n_c == n_g == 6):
            raise AssertionError(f"Map2D {what}: the card's run disagrees "
                                 "with the CPU run")


# ---------------------------------------------------------------------------
# the FusionSystem's refresh cases (tests/test_refresh.py's three), fed
# through a scripted queue so that a run is one deterministic sequence;
# tests/test_torch_fusion.py runs them against the JAX package
# ---------------------------------------------------------------------------

FUSION_CAM = (320, 240, 260.0, 260.0, 160.0, 120.0)
FUSION_PSNR, FUSION_GAUGE_TOL = 40.0, 1e-6


class ScriptQueue:
    """A trans/plane queue that hands out `items` in order; hooks[i]()
    runs when item i is asked for (i == len(items): after the last)."""

    def __init__(self, items=(), hooks=None):
        self.items = list(items)
        self.hooks = dict(hooks or {})
        self.i = 0

    def consumption(self, timeout=None):
        import queue
        hook = self.hooks.pop(self.i, None)
        if hook is not None:
            hook()
        if self.i >= len(self.items):
            raise queue.Empty
        self.i += 1
        return self.items[self.i - 1]

    def try_consume(self):
        import queue
        try:
            return self.consumption()
        except queue.Empty:
            return None

    def qsize(self):
        return len(self.items) - self.i


class FakeMap:
    """WorldMap stand-in: frame(fid) -> an object with .pose_c2w, or
    None."""

    def __init__(self, poses):
        from types import SimpleNamespace
        self.store = {k: SimpleNamespace(pose_c2w=np.array(v))
                      for k, v in poses.items()}

    def frame(self, fid):
        return self.store.get(fid)


def fusion_world(n=16):
    """tests/test_refresh.py's world: its ground (seed 0) and n lawnmower
    frames [H, W, 3] float32 (numpy), rendered on the CPU."""
    import torch
    from pislamfusion_tpu_torch.core.camera import Camera
    ground = survey_ground(np.random.default_rng(0))
    poses = survey_poses()[:n]
    g = torch.from_numpy(ground)
    frames = [survey_view(g, Camera(*FUSION_CAM), p).numpy()
              for p in poses]
    return ground, poses, frames


def gauge_pose(shift, axis, ang):
    """An SE3 (t, q): `shift`, then `ang` rad about axis 0, 1 or 2."""
    q = np.zeros(4)
    q[axis] = np.sin(ang / 2)
    q[3] = np.cos(ang / 2)
    return np.concatenate([np.asarray(shift, np.float64), q])


def fusion_items(frames, poses, metas):
    return [(f, p.copy(), m) for f, p, m in zip(frames, poses, metas)]


def fusion_new_world(poses):
    """The plane-move refit: yaw 0.2 rad and 15 m."""
    from pislamfusion_tpu_torch.utils import host_se3 as hse3
    g = gauge_pose([15.0, 5.0, 0.0], 2, 0.2)
    return np.stack([hse3.se3_mul(g, p) for p in poses])


def fusion_cases(frames, poses):
    """{name: (items, {index: FakeMap})} for test_refresh.py's three
    cases: a partial deformation (kf 100 moved 3 m, kf 101 not), a small
    rotational gauge (no re-render), a plane move (12 frames in the old
    world, the refit, 4 in the new one: a rebase)."""
    from pislamfusion_tpu_torch.utils import host_se3 as hse3
    p10, f10 = poses[:10], frames[:10]
    drifted = p10.copy()
    drifted[:, 0] += 3.0
    partial = (fusion_items(f10, drifted, [
        (1000 + i, 100, drifted[0].copy()) if i < 5
        else (1000 + i, 101, drifted[5].copy()) for i in range(10)]),
        {10: FakeMap({100: p10[0], 101: drifted[5]})})
    g = gauge_pose([0.3, -0.2, 0.1], 0, 0.008)
    rotational = (fusion_items(f10, p10, [(1000 + i, 1000 + i, p.copy())
                                          for i, p in enumerate(p10)]),
                  {10: FakeMap({1000 + i: hse3.se3_mul(g, p)
                                for i, p in enumerate(p10)})})
    new_world = fusion_new_world(poses)
    fed = np.concatenate([poses[:12], new_world[12:]])
    rebase = (fusion_items(frames, fed, [(1000 + i, 1000 + i, p.copy())
                                         for i, p in enumerate(fed)]),
              {12: FakeMap({1000 + i: m for i, m in enumerate(new_world)})})
    return {"partial_deformation": partial, "rotational_gauge": rotational,
            "plane_move_rebase": rebase}


def fusion_cfg(svar_cls, scale=None, **extra):
    """test_refresh.py's consumer config (3 bands, the plane given,
    PrepareFrameNum 4) as `svar_cls`, Map2D.Scale `scale` if given."""
    cfg = svar_cls()
    cfg.set("Map2D.BandNumber", "3")
    cfg.set("Plane", "0 0 0 0 0 0 1")
    cfg.set("PrepareFrameNum", "4")
    if scale is not None:
        cfg.set("Map2D.Scale", str(scale))
    for k, v in extra.items():
        cfg.set(k, str(v))
    return cfg


def run_fusion(fusion_cls, cfg, camera, items, events, messenger,
               patch=None, **kw):
    """One consumer run of `fusion_cls` (the port's FusionSystem, or the
    JAX package's), inline: `events` {index: map} are published on
    `messenger` when item `index` is asked for; patch(fusion), if given,
    runs just before the first. `kw` goes to the constructor."""
    hooks = {}
    for i, m in events.items():
        def pub(m=m, first=i == min(events)):
            if patch is not None and first:
                patch(fus)
            messenger.advertise("map_transformed").publish(m)
        hooks[i] = pub
    fus = fusion_cls(cfg, camera, trans_q=ScriptQueue(items, hooks),
                     plane_q=ScriptQueue(), **kw)
    fus._finishing.set()
    fus.run()
    if fus.error is not None:
        raise AssertionError(fus.error)
    return fus


def mosaic_psnr(a, b, covered):
    d = (np.asarray(a, np.float64) - b)[covered]
    return 10 * np.log10(255.0 ** 2 / max(float((d ** 2).mean()), 1e-12))


def fusion_card_vs_cpu(dev):
    """The FusionSystem on test_refresh.py's three cases, the card against
    the CPU on the same frames and events: mosaics >= FUSION_PSNR dB,
    coverage equal, frames refreshed equal, feed gauges within
    FUSION_GAUGE_TOL; then `export_geo_tiles` of the two rebased canvases:
    the same tiles, each >= FUSION_PSNR dB."""
    import shutil
    import tempfile
    from pislamfusion_tpu_torch.core.camera import Camera
    from pislamfusion_tpu_torch.core.messenger import messenger
    from pislamfusion_tpu_torch.core.svar import Svar
    from pislamfusion_tpu_torch.io import exporters
    from pislamfusion_tpu_torch.models.fusion import FusionSystem
    from pislamfusion_tpu_torch.models.map2d import read_png
    _, poses, frames = fusion_world()
    last = None
    for name, (items, events) in fusion_cases(frames, poses).items():
        runs = [run_fusion(FusionSystem, fusion_cfg(Svar), Camera(
            *FUSION_CAM), items, events, messenger, device=d)
            for d in ("cpu", dev)]
        (i_c, c_c), (i_g, c_g) = (r.map2d.blended() for r in runs)
        g_c, g_g = (r._feed_gauge for r in runs)
        dg = 0.0 if g_c is None and g_g is None else (
            float(np.abs(g_c - g_g).max()) if g_c is not None
            and g_g is not None else float("inf"))
        psnr = mosaic_psnr(i_g, i_c, c_c | c_g)
        n_c, n_g = (r.frames_refreshed for r in runs)
        print(f"FusionSystem {name} (320x240, {len(items)} frames, 3 "
              f"bands), card vs CPU: mosaic PSNR {psnr:.1f} dB, coverage "
              f"equal {bool((c_c == c_g).all())}, refreshed {n_g} vs "
              f"{n_c}, feed gauge max |diff| {dg:.2e}")
        if not (psnr >= FUSION_PSNR and (c_c == c_g).all() and n_c == n_g
                and dg <= FUSION_GAUGE_TOL):
            raise AssertionError(f"FusionSystem {name}: the card's run "
                                 "disagrees with the CPU run")
        last = runs
    root = tempfile.mkdtemp(prefix="psf_tiles_")
    try:
        sets = []
        for tag, run in zip(("cpu", "card"), last):
            d = os.path.join(root, tag)
            n = exporters.export_geo_tiles(run.map2d, FUSED_ORIGIN, d,
                                           zoom=20)
            assert n >= 1, "no geo tile written"
            sets.append({os.path.relpath(os.path.join(r, f), d): read_png(
                os.path.join(r, f)) for r, _, fs in os.walk(d) for f in fs})
        worst = min((mosaic_psnr(sets[1][k], sets[0][k],
                                 np.ones(sets[0][k].shape[:2], bool))
                     for k in sets[0] if k in sets[1]), default=0.0)
        print(f"export_geo_tiles of the rebased canvases, zoom 20, card vs "
              f"CPU: {len(sets[1])} vs {len(sets[0])} tiles, same set "
              f"{sorted(sets[0]) == sorted(sets[1])}, worst tile PSNR "
              f"{worst:.1f} dB")
        if not (sets[0] and sorted(sets[0]) == sorted(sets[1])
                and worst >= FUSION_PSNR):
            raise AssertionError("export_geo_tiles: the card's tiles "
                                 "disagree with the CPU's")
    finally:
        shutil.rmtree(root, ignore_errors=True)


def card_vs_cpu(detector, dev, **kw):
    """The port on the card against its plain CPU run: 600x640, 3 frames,
    256 features, 3 bands (ORB: 4 levels); `kw` further FastVO
    arguments."""
    h2, w2, fx2 = 600, 640, 600.0
    fr2, p2 = render_strip(3, h2, w2, fx2, 0.24, 1024, "cpu")
    runs = []
    for d in ("cpu", dev):
        v = make_fastvo(h2, w2, fx2, p2, 256, 4, 3, d, detector, **kw)
        e, n = v.process(fr2, p2[0])
        runs.append((e, n) + v.blended())
    (e_c, n_c, i_c, c_c), (e_g, n_g, i_g, c_g) = runs
    both = c_c & c_g
    mse = float(((i_c - i_g)[both] ** 2).mean())
    psnr = 10 * np.log10(255.0 ** 2 / max(mse, 1e-12))
    dt = float(np.abs(e_c[:, :3] - e_g[:, :3]).max())
    what = detector.upper() + "".join(f" ({k}={v})" for k, v in kw.items())
    print(f"{what} small strip {w2}x{h2}, 3 frames, card vs CPU: "
          f"n_match {n_g.tolist()} vs {n_c.tolist()}, max |dt| {dt:.2e} m, "
          f"mosaic PSNR {psnr:.1f} dB, coverage agreement "
          f"{(c_c == c_g).mean():.5f}")
    if not (np.abs(n_c - n_g).max() <= 3 and dt <= 5e-3 and psnr >= 40.0):
        raise AssertionError(f"{what}: the card's run disagrees with the "
                             "CPU run")


if __name__ == "__main__":
    sys.exit(main())
