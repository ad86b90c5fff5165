"""K1-K8 from one checkout of the port, for kernel A/B runs.

    python3 scripts/torch_kernel_ab.py ROOT [ROOT ...]

For each ROOT (a checkout of this repository, say the parent commit
unpacked with `git archive` beside the working tree), in a fresh process
of its own, imports that checkout's `pislamfusion_tpu_torch`, builds its
kernels and times, on the same seeded inputs at the shapes
`chip_smoke.py` checks:

- K1 (`flatpyr.build_flat_pyramid`) on a 1080x1920 gray frame, 8 levels
  (ORB's flat pyramid), held to chip_smoke.py's gate against its plain
  version;
- K5 (`stencil.banded_stack` on `sift._stack_tables`) at SIFT's three
  octave shapes 1080x1920, 540x960 and 270x480 (0..1 inputs, within
  1e-5 of its plain version);
- K8 (`stencil.banded_sandwich` on `image.pyr_tables`) at the Map2D
  patch's 1536^2x3 pyrDown and 768^2x3 pyrUp, the 1536^2x1 weight
  pyrDown, the 1664x1152x3 canvas pyrUp of `blended()`, FastVO's
  768^2x3 pyrDown, its 1080x1920x3 source pyrDown and its 768^2x1 weight
  pyrUp;
- K6 (`patchgather.bilinear_grid`) on a 1080p frame's packed gradient
  image (2217x1920x2) at 1000 keypoints, on the orientation grid (16x16,
  radius 4.5 sigma, unrotated) and the descriptor grid (16x16, radius 3
  sigma, rotated), beside `grid_sample` at the same points;
- K4 (`fastselect.fast_cell_winners`) on the K1 pyramid of bench.py's
  1080p strip frame and of a sigma-40 noise frame (`chip_smoke.k4_cases`),
  equal to its plain version;
- K3 (`shearwarp.warp_patch`'s kernel) on its four cases
  (`chip_smoke.k3_cases`: half and full resolution, survey and turned 100
  degrees), within 1e-3 of its plain version;
- K7 (`packedpyr.build_packed_pyramid`) on the strip frame's gray image,
  8 levels, r = 21, equal to its plain version;
- K2 (`patchgather.gather_patches`) on the ~1000 centres that
  `orb.select_levels` picks on the strip frame's K1 pyramid
  (`torch_k7_k2_sweep.phase1_inputs`, chip_smoke.py's phase-1 input),
  bit-exact.

Each time is the device time of one call from 20 captured in one CUDA
graph, warm (the inputs in L2 from the call before) and cold (a 128 MB
write before each call, its own time subtracted; K6's three times, as
its cold time spreads by some 20 % between graphs): `chip_smoke.graph_ms`
and `graph_ms_cold` of this script's checkout serve every ROOT. Then,
where the kernels run among the paths' other work, SIFT's and ORB's
FastVO paths (`chip_smoke.make_fastvo`, 8 frames of bench.py's 1080p
strip after a warm-up pass) and the Map2D Type 3 feed
(`chip_smoke.make_map2d`, the same 8 frames after a warm-up pass) under
torch.profiler: the device ms a frame of K3, K5, K6 and K8 on SIFT's
path, of K1, K2, K3 and K4 on ORB's, of K7 and K2 on ORB's with
pyramid="packed", and of K3 on the Map2D feed, every launch summed.
Prints one JSON line a ROOT, in the order given: give the roots as A B B
A to see the spread beside the difference. Needs a CUDA device.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# (label, kind, input h, w, output h, w, channels)
K8_CASES = (
    ("Map2D pyrDown 1536^2x3", "down", 1536, 1536, 768, 768, 3),
    ("Map2D pyrUp 768^2x3", "up", 768, 768, 1536, 1536, 3),
    ("Map2D weight pyrDown 1536^2x1", "down", 1536, 1536, 768, 768, 1),
    ("Map2D blended() canvas pyrUp 1664x1152x3", "up", 1152, 1664, 2304,
     3328, 3),
    ("FastVO pyrDown 768^2x3", "down", 768, 768, 384, 384, 3),
    ("FastVO source pyrDown 1080x1920x3", "down", 1080, 1920, 540, 960, 3),
    ("FastVO weight pyrUp 768^2x1", "up", 768, 768, 1536, 1536, 1),
)


def sift_grids(dev, seed: int = 7):
    """A 1080p frame's packed gradient image shape (4 octaves, 48 rows
    between them) with seeded values, 1000 keypoints in octave 0, and the
    orientation and descriptor grids' (centers, rel) around them."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    Hp, W, K, n = 1080 + 540 + 270 + 135 + 4 * 48, 1920, 1000, 16
    grad = torch.from_numpy(rng.normal(0, 30, (Hp, W, 2)).astype(
        np.float32)).to(dev)
    cx = torch.from_numpy(rng.integers(8, W - 8, K).astype(np.float32))
    cy = torch.from_numpy(rng.integers(8, 1080 - 8, K).astype(np.float32))
    sig = torch.from_numpy(rng.uniform(2.0, 3.2, K).astype(np.float32))
    ang = torch.from_numpy(rng.uniform(0, 2 * np.pi, K).astype(np.float32))
    lin = (torch.arange(n, dtype=torch.float32) + 0.5) / n * 2.0 - 1.0
    gv, gu = torch.meshgrid(lin, lin, indexing="ij")
    gu, gv = gu.reshape(1, -1), gv.reshape(1, -1)
    grids = {}
    for label, a, r in (("orientation grid", torch.zeros_like(ang), 4.5),
                        ("descriptor grid", ang, 3.0)):
        rad = (r * sig)[:, None]
        ca, sa = torch.cos(a)[:, None], torch.sin(a)[:, None]
        px = cx[:, None] + rad * (ca * gu - sa * gv)
        py = cy[:, None] + rad * (sa * gu + ca * gv)
        centers = torch.stack([cx, cy], -1).to(torch.int32)
        rel = torch.stack([px - cx[:, None], py - cy[:, None]], 1)
        grids[label] = (centers.to(dev), rel.contiguous().to(dev))
    return grad, grids


# profiler names of each kernel: the parent's K1 was two kernels
_MARKS = {"flatpyr": ("flatpyr_kernel", "::row_pass(", "::col_pass("),
          "patchgather": ("patchgather",),
          "packedpyr": ("packedpyr_kernel",),
          "bandedstack": ("bandedstack_kernel",),
          "bilineargrid": ("bilineargrid_kernel",),
          "bandedsandwich": ("bandedsandwich_kernel",),
          "fastselect": ("fastselect_kernel",),
          "shearwarp": ("shearwarp_kernel",)}


def _profiled(run, kernels, n: int) -> dict:
    """The device ms a frame of each of `kernels` over run() (n frames),
    from torch.profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    us = {name: 0.0 for name in kernels}
    for e in prof.events():
        if e.device_type.name != "CUDA":
            continue
        for name in us:
            if any(m in e.name for m in _MARKS[name]):
                us[name] += e.time_range.end - e.time_range.start
    return {name: t / 1e3 / n for name, t in us.items()}


def path_ms(dev, detector: str, kernels, n: int = 8, **kw) -> dict:
    """The device ms a frame of each of `kernels` on FastVO's path with
    `detector` (and FastVO keywords `kw`) over n frames of bench.py's
    1080p strip, from torch.profiler, after a warm-up pass."""
    from chip_smoke import make_fastvo, render_strip
    H, W, fx = 1080, 1920, 1200.0
    frames, poses = render_strip(n, H, W, fx, 0.12, 6144, dev)
    make = lambda: make_fastvo(H, W, fx, poses, 1000, 8, 5, dev,  # noqa
                               detector, **kw)
    make().process(frames, poses[0])
    vo = make()
    return _profiled(lambda: vo.process(frames, poses[0]), kernels, n)


def map2d_ms(dev, kernels, n: int = 8) -> dict:
    """The same for the Map2D Type 3 feed (`chip_smoke.make_map2d`) over
    n frames of the strip."""
    from chip_smoke import _feed_all, make_map2d, render_strip
    H, W, fx = 1080, 1920, 1200.0
    frames, poses = render_strip(n, H, W, fx, 0.12, 6144, dev)
    _feed_all(make_map2d(3, H, W, fx, poses, dev), frames, poses)
    m = make_map2d(3, H, W, fx, poses, dev)
    return _profiled(lambda: _feed_all(m, frames, poses), kernels, n)


def k4_k3_ms(dev, flush) -> tuple:
    """K4's and K3's warm and cold times on chip_smoke.py's cases, each
    checked against its plain version."""
    import torch
    from chip_smoke import (graph_ms, graph_ms_cold, k3_cases, k4_cases,
                            make_fastvo, render_strip)
    from pislamfusion_tpu_torch.ops import shearwarp as sw
    from pislamfusion_tpu_torch.ops.features import fastselect as fs
    from pislamfusion_tpu_torch.ops.features import orb
    H, W, fx = 1080, 1920, 1200.0
    frames, poses = render_strip(2, H, W, fx, 0.12, 6144, dev)
    p = make_fastvo(H, W, fx, poses, 1000, 8, 5, dev).params
    cell, thr, border = p.cell, p.min_threshold, orb.EDGE_THRESHOLD
    k4 = {}
    for label, packed, offs, shapes in k4_cases(frames[0], p, dev)[::3]:
        fn = lambda: fs.fast_cell_winners(  # noqa: E731
            packed, offs, shapes, cell, thr, border)
        ref = fs.fast_cell_winners_plain(
            [packed[oy:oy + lh, ox:ox + lw]
             for (lh, lw), (ox, oy) in zip(shapes, offs)], cell, thr, border)
        for (kv, ki), (rv, ri) in zip(fn(), ref):
            if not (torch.equal(kv, rv) and torch.equal(ki, ri)):
                raise AssertionError(f"K4 {label}: kernel != plain")
        k4[label] = {"warm": graph_ms(fn), "cold": graph_ms_cold(fn, flush)}
    k3 = {}
    for label, src, h, patch_hw in k3_cases(frames, poses, fx, dev):
        err = float((sw.warp_patch(src, h, patch_hw)[0]
                     - sw.warp_patch_plain(src, h, patch_hw)[0]).abs().max())
        if not err <= 1e-3:
            raise AssertionError(f"K3 {label}: |kernel - plain| {err}")
        tr, prm, win = sw._params(src, h, patch_hw, sw.TILE, 2.2)
        fn = lambda: sw.launch_kernel(src, tr, prm, patch_hw,  # noqa
                                      sw.TILE, win)
        k3[label] = {"warm": graph_ms(fn), "cold": graph_ms_cold(fn, flush)}
    return k4, k3


def k7_k2_ms(dev, flush) -> tuple:
    """K7's and K2's warm and cold times at chip_smoke.py's phase-1
    shapes, each checked against its plain version."""
    import torch
    from chip_smoke import graph_ms, graph_ms_cold
    from pislamfusion_tpu_torch.ops.features import orb, packedpyr
    from pislamfusion_tpu_torch.ops.features import patchgather as pg
    from torch_k7_k2_sweep import phase1_inputs
    gray, params, packed, pxy = phase1_inputs(dev)
    L, sf, r = params.n_levels, params.scale_factor, orb._GATHER_R
    fn = lambda: packedpyr.build_packed_pyramid(gray, L, sf, r)  # noqa
    if not torch.equal(fn(), packedpyr.build_packed_pyramid_plain(
            gray, L, sf, r)):
        raise AssertionError("K7: kernel != plain")
    k7 = {"1080x1920 L=8 r=21": {"warm": graph_ms(fn),
                                 "cold": graph_ms_cold(fn, flush)}}
    fn = lambda: pg.gather_patches(packed, pxy, r)  # noqa: E731
    if not torch.equal(fn(), pg.gather_patches_plain(packed, pxy, r)):
        raise AssertionError("K2: kernel != plain")
    k2 = {f"{pxy.shape[0]} centres r=21": {
        "warm": graph_ms(fn), "cold": graph_ms_cold(fn, flush)}}
    return k7, k2


def one(root: str) -> dict:
    import numpy as np
    import torch
    import torch.nn.functional as F
    # the timing code of this script's checkout, the kernels of ROOT's
    sys.path.insert(0, HERE)
    from chip_smoke import FLUSH_BYTES, graph_ms, graph_ms_cold
    root = os.path.abspath(root)
    sys.path.insert(0, root)
    from pislamfusion_tpu_torch import _build
    from pislamfusion_tpu_torch.ops import image as im
    from pislamfusion_tpu_torch.ops import stencil
    from pislamfusion_tpu_torch.ops.features import flatpyr
    from pislamfusion_tpu_torch.ops.features import patchgather as pg
    from pislamfusion_tpu_torch.ops.features import sift
    _build.build_all()
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    flush = torch.empty(FLUSH_BYTES // 4, dtype=torch.float32, device=dev)
    rng = np.random.default_rng(8)
    gray = torch.from_numpy(rng.uniform(0, 255, (1080, 1920)).astype(
        np.float32)).to(dev)
    fn = lambda: flatpyr.build_flat_pyramid(gray, 8, 1.2, 32)  # noqa: E731
    d = (fn() - flatpyr.build_flat_pyramid_plain(gray, 8, 1.2, 32)).abs()
    if not (float((d <= 1e-3).double().mean()) >= 0.9999
            and float(d.max()) <= 1.0):
        raise AssertionError("K1: kernel disagrees with plain")
    k1 = {"1080x1920 L=8": {"warm": graph_ms(fn),
                            "cold": graph_ms_cold(fn, flush)}}
    sp = sift.SiftParams(n_features=1000)
    k5 = {}
    for h, w in ((1080, 1920), (540, 960), (270, 480)):
        tabs = sift._stack_tables(h, w, sp)
        x = torch.from_numpy(rng.uniform(0, 1, (h, w)).astype(
            np.float32)).to(dev)
        err = float((stencil.banded_stack(x, tabs)
                     - stencil.banded_stack_plain(x, tabs)).abs().max())
        if not err <= 1e-5:
            raise AssertionError(f"K5 {h}x{w}: |kernel - plain| {err}")
        fn = lambda: stencil.banded_stack(x, tabs)  # noqa: E731
        k5[f"{h}x{w}"] = {"warm": graph_ms(fn),
                          "cold": graph_ms_cold(fn, flush)}
    k8 = {}
    for label, kind, h, w, oh, ow, C in K8_CASES:
        tabs = im.pyr_tables(kind, h, w, oh, ow)
        x = torch.from_numpy(rng.uniform(0, 255, (h, w, C)).astype(
            np.float32)).to(dev)
        if not torch.equal(stencil.banded_sandwich(x, tabs),
                           stencil.banded_sandwich_plain(x, tabs)):
            raise AssertionError(f"K8 {label}: kernel != plain")
        fn = lambda: stencil.banded_sandwich(x, tabs)  # noqa: E731
        k8[label] = {"warm": graph_ms(fn), "cold": graph_ms_cold(fn, flush)}
    grad, grids = sift_grids(dev)
    Hp, W, _ = grad.shape
    src = grad.permute(2, 0, 1)[None].contiguous()
    k6 = {}
    for label, (centers, rel) in grids.items():
        R = 16
        err = float((pg.bilinear_grid(grad, centers, rel, R)
                     - pg.bilinear_grid_plain(grad, centers, rel, R))
                    .abs().max())
        if not err <= 1e-4:
            raise AssertionError(f"K6 {label}: |kernel - plain| {err}")
        px = centers[:, 0:1].to(torch.float32) + rel[:, 0]
        py = centers[:, 1:2].to(torch.float32) + rel[:, 1]
        gn = torch.stack([px * (2.0 / (W - 1)) - 1.0,
                          py * (2.0 / (Hp - 1)) - 1.0], -1)[None]
        fn = lambda: pg.bilinear_grid(grad, centers, rel, R)  # noqa: E731
        lib = lambda: F.grid_sample(  # noqa: E731
            src, gn, mode="bilinear", padding_mode="zeros",
            align_corners=True)
        k6[label] = {"warm": graph_ms(fn),
                     "cold": [graph_ms_cold(fn, flush) for _ in range(3)],
                     "grid_sample": graph_ms(lib)}
    k4, k3 = k4_k3_ms(dev, flush)
    k7, k2 = k7_k2_ms(dev, flush)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    return {"root": root, "card": card, "k1_ms": k1, "k5_ms": k5,
            "k8_ms": k8, "k6_ms": k6, "k4_ms": k4, "k3_ms": k3,
            "k7_ms": k7, "k2_ms": k2,
            "sift_path_ms_per_frame": path_ms(
                dev, "sift", ("bandedstack", "bilineargrid",
                              "bandedsandwich", "shearwarp")),
            "orb_path_ms_per_frame": path_ms(
                dev, "orb", ("flatpyr", "fastselect", "shearwarp",
                             "patchgather")),
            "orb_packed_path_ms_per_frame": path_ms(
                dev, "orb", ("packedpyr", "patchgather"),
                pyramid="packed"),
            "map2d_type3_feed_ms_per_frame": map2d_ms(dev, ("shearwarp",))}


def main() -> int:
    if len(sys.argv) == 3 and sys.argv[1] == "--one":
        print(json.dumps(one(sys.argv[2])), flush=True)
        return 0
    if len(sys.argv) < 2:
        print(__doc__, file=sys.stderr)
        return 2
    for root in sys.argv[1:]:
        out = subprocess.run([sys.executable, os.path.abspath(__file__),
                              "--one", root], capture_output=True,
                             text=True)
        if out.returncode != 0:
            print(out.stdout + out.stderr, file=sys.stderr)
            return out.returncode
        print(out.stdout.strip().splitlines()[-1], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
