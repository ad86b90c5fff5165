"""K7 (packed pyramid) and K2 (patch gather) on the card: checks, ablations
and variants.

    python3 scripts/torch_k7_k2_sweep.py [--check | --trace]

Builds the two kernels from this checkout, makes `chip_smoke.py`'s phase-1
inputs (frame 0 of bench.py's 1080p strip: its gray image for K7 at 8
levels and r = 21, the K1 pyramid and its ~1000 selected centres for K2),
and runs `chip_smoke.check_packedpyr` and `check_patchgather` on them
(every gate, warm and cold times, the plan lines). With `--check` it
stops there. Otherwise it then times, each the device time of one call
from 20 captured in one CUDA graph (`chip_smoke.graph_ms`), warm and cold:

- K7 under item-order and phase ablations, each launched through
  `packedpyr.launch_records` on records derived from the plan
  (`ablations`): the pad and zero items alone; level 1 alone; the tiles
  alone, and without waiting (timing only: they read unfinished
  sources); and under other ticket orders (level 1's tiles first, fills
  first, fills last), which are checked equal to the plain version;
- K7 under other plans and launch bounds (`K7_VARIANTS`: every level of
  depth 1, depth 2 from level 4 or 5, other tiles; the plan made with
  those constants of `packedpyr`, the source built with that edit beside
  `_build`), each checked equal to the plain version, and without the
  fence before a tile's count (timing only);
- K7 once with every item timed (`_TRACE`, %globaltimer): the launch's
  span and, per level, its first claim, last finish and each step's mean
  time (wait for its sources, stage, compute, publish, to the next
  claim),
  and the blocks' waiting and idle time (`--trace`: this and the above,
  without the variants);
- K2's stores alone (the patch span written from registers, no source
  read), the kernel, and `aten::index` on the clamped index vectors.

Prints one JSON line. Needs a CUDA device.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def phase1_inputs(dev):
    """chip_smoke.py's phase-1 inputs: the strip's frame 0 as gray, the
    FastVO ORB params, K1's packed pyramid of it and the centres
    select_levels picks there (offset into the buffer)."""
    import torch
    from chip_smoke import make_fastvo, render_strip
    from pislamfusion_tpu_torch.ops import image as im
    from pislamfusion_tpu_torch.ops.features import flatpyr, orb
    H, W, fx = 1080, 1920, 1200.0
    frames, poses = render_strip(2, H, W, fx, 0.12, 6144, dev)
    params = make_fastvo(H, W, fx, poses, 1000, 8, 5, dev).params
    gray = im.rgb_to_gray(frames[0].to(torch.float32))
    L, sf, cell = params.n_levels, params.scale_factor, params.cell
    packed = flatpyr.build_flat_pyramid(gray, L, sf, cell)
    plan = orb._flat_plan(H, W, L, sf, cell)
    views = [packed[b + plan.cell:b + plan.cell + lh,
                    plan.pad_left:plan.pad_left + lw]
             for b, (lh, lw) in zip(plan.bases, plan.shapes)]
    offs = [(plan.pad_left, b + plan.cell) for b in plan.bases]
    picks = orb.select_levels(packed, views, offs, params)
    pxy = torch.cat([xy + torch.tensor(
        [[plan.pad_left, b + plan.cell]], dtype=torch.int32, device=dev)
        for (xy, _, _), b in zip(picks, plan.bases)])
    return gray, params, packed, pxy


def ablations(kp):
    """{label: (records, checked)}: K7's plan records reordered or cut.
    `checked` is whether the variant computes the whole function."""
    import numpy as np
    from pislamfusion_tpu_torch.ops.features import packedpyr as pp
    rec = kp.records
    tile = rec[:, 0] == pp.KIND_TILE
    fills, tiles = rec[~tile], rec[tile]
    nowait = tiles.copy()
    nowait[:, 13] = 0
    first = np.concatenate([tiles[tiles[:, 1] == 1], rec[
        (rec[:, 0] != pp.KIND_TILE) | (rec[:, 1] != 1)]])
    return {
        "plan": (rec, True),
        "level 1's tiles first": (first, True),
        "fills first": (np.concatenate([fills, tiles]), True),
        "fills last": (np.concatenate([tiles, fills]), True),
        "pad and zero items alone": (fills, False),
        "level 1 alone": (tiles[tiles[:, 1] == 1], False),
        "tiles alone": (tiles, False),
        "tiles without waiting": (nowait, False),
    }


# (label, {packedpyr constant: value} for the plan, (old, new) edits of
# csrc/packedpyr.cu, checked)
_B5 = [("constexpr int BLOCKS = 6;", "constexpr int BLOCKS = 5;")]
K7_VARIANTS = (
    ("every level of depth 1", {"K7_FUSE_FROM": 99}, [], True),
    ("depth 2 from level 3", {"K7_FUSE_FROM": 3}, [], True),
    ("depth 2 from level 4", {"K7_FUSE_FROM": 4}, [], True),
    ("depth 2 from level 6", {"K7_FUSE_FROM": 6}, [], True),
    ("depth-2 tiles of 8x256, 5 blocks an SM", {
        "K7_FUSED_TILES": ((8, 256),), "K7_BLOCKS": 5}, _B5, True),
    ("depth-1 tiles of 8x128", {"K7_TILES": ((8, 128),)}, [], True),
    ("pad and zero items of 64 KB", {"K7_FILL_BYTES": 64 << 10}, [], True),
    ("pad and zero items of 128 KB", {"K7_FILL_BYTES": 128 << 10}, [],
     True),
    ("polls 32 ns apart", {}, [("__nanosleep(100);", "__nanosleep(32);")],
     True),
    ("polls 400 ns apart", {}, [("__nanosleep(100);", "__nanosleep(400);")],
     True),
    ("no fence before a tile's count", {},
     [("      __threadfence();\n      atomicAdd(p.ctr + own, 1u);",
       "      atomicAdd(p.ctr + own, 1u);")], False),
)


def k7_variants(gray, params, r, flush) -> dict:
    """K7 under each of K7_VARIANTS, then the plan's again."""
    import torch
    from chip_smoke import graph_ms, graph_ms_cold, k7_agrees
    from pislamfusion_tpu_torch import _build
    from pislamfusion_tpu_torch.ops.features import packedpyr as pp
    from torch_k5_k1_sweep import _patched
    L, sf = params.n_levels, params.scale_factor
    names = ("K7_TILES", "K7_FUSED_TILES", "K7_FUSE_FROM", "K7_BLOCKS",
             "K7_FILL_BYTES")
    base = {n: getattr(pp, n) for n in names}
    lib0 = _build.load("packedpyr")
    res = {}
    for label, consts, edits, checked in K7_VARIANTS + (
            ("the plan", {}, [], True),):
        _build._LIBS["packedpyr"] = (_patched("packedpyr", "".join(
            ch for ch in label if ch.isalnum()), edits) if edits else lib0)
        for n, v in {**base, **consts}.items():
            setattr(pp, n, v)
        pp.K7_SMEM = (pp.SM_SMEM // pp.K7_BLOCKS) - pp.SM_BLOCK_RESERVED
        for f in (pp.kernel_plan, pp._device_plan, pp._launch_fn):
            f.cache_clear()
        fn = lambda: pp.build_packed_pyramid(gray, L, sf, r)  # noqa
        if checked and not k7_agrees(fn(), gray, L, sf, r)[0]:
            raise AssertionError(f"K7 {label}: kernel != plain")
        kp = pp.kernel_plan(*gray.shape, L, sf, r)
        res[label] = {"smem": kp.smem, "blocks_per_sm": pp.occupancy(
            kp, gray.device), "items": int(kp.records.shape[0]),
            "warm": graph_ms(fn), "cold": graph_ms_cold(fn, flush)}
        torch.cuda.synchronize()
    _build._LIBS["packedpyr"] = lib0
    for n, v in base.items():
        setattr(pp, n, v)
    pp.K7_SMEM = (pp.SM_SMEM // pp.K7_BLOCKS) - pp.SM_BLOCK_RESERVED
    for f in (pp.kernel_plan, pp._device_plan, pp._launch_fn):
        f.cache_clear()
    return res


# text edits that time each item with %globaltimer into g_trace: [item][8]
# = claimed, waited, staged, computed, published, done, -, block | SM << 32
_TRACE = [
    ("#include <stdint.h>\n", """#include <stdint.h>
__device__ unsigned long long* g_trace;
__shared__ unsigned s_trace_i;
__device__ __forceinline__ unsigned long long trace_now() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
#define TRACE(k) do { if (threadIdx.x == 0 && g_trace) \\
    g_trace[8ull * s_trace_i + (k)] = trace_now(); } while (0)
extern "C" int packedpyr_set_trace(unsigned long long* p) {
  return (int)cudaMemcpyToSymbol(g_trace, &p, sizeof(p));
}
"""),
    ("    if (i >= (unsigned)p.n_items) break;\n",
     """    if (i >= (unsigned)p.n_items) break;
    if (threadIdx.x == 0 && g_trace) {
      unsigned sm;
      asm volatile("mov.u32 %0, %%smid;" : "=r"(sm));
      s_trace_i = i;
      g_trace[8ull * i + 7] = blockIdx.x | ((unsigned long long)sm << 32);
    }
    TRACE(0);
"""),
    ("    __threadfence();\n  }\n  __syncthreads();\n",
     "    __threadfence();\n  }\n  __syncthreads();\n  TRACE(1);\n"),
    ("S, p.pitch);\n    cp_commit_wait_all();\n    __syncthreads();\n",
     "S, p.pitch);\n    cp_commit_wait_all();\n    __syncthreads();\n"
     "    TRACE(2);\n"),
    ("A, pf);\n    cp_commit_wait_all();\n    __syncthreads();\n",
     "A, pf);\n    cp_commit_wait_all();\n    __syncthreads();\n"
     "    TRACE(2);\n"),
    ("  // load overlap the fence\n  __syncthreads();\n",
     "  // load overlap the fence\n  __syncthreads();\n  TRACE(3);\n"),
    ("    if (tid < RS) s_rec[tid] = r4;\n",
     "    if (tid < RS) s_rec[tid] = r4;\n    TRACE(4);\n"),
    ("    __syncthreads();\n  }\n  // the last block out",
     "    __syncthreads();\n    TRACE(5);\n  }\n  // the last block out"),
]


def k7_trace(gray, params, r) -> dict:
    """One call of K7 built with the _TRACE edits: the launch's span, and
    per level (0: the pad and zero items) the first claim, the last
    finish and the mean time of each of an item's steps, all in us."""
    import ctypes
    import numpy as np
    import torch
    from pislamfusion_tpu_torch import _build
    from pislamfusion_tpu_torch.ops.features import packedpyr as pp
    from torch_k5_k1_sweep import _patched
    L, sf = params.n_levels, params.scale_factor
    base = _build.load("packedpyr")
    lib = _patched("packedpyr", "trace", _TRACE)
    _build._LIBS["packedpyr"] = lib
    pp._launch_fn.cache_clear()
    kp = pp.kernel_plan(*gray.shape, L, sf, r)
    n = kp.records.shape[0]
    buf = torch.zeros((n, 8), dtype=torch.int64, device=gray.device)
    lib.packedpyr_set_trace.argtypes = [ctypes.c_void_p]
    res = {}
    try:
        for _ in range(3):
            pp.build_packed_pyramid(gray, L, sf, r)
        torch.cuda.synchronize()
        if lib.packedpyr_set_trace(buf.data_ptr()):
            raise RuntimeError("packedpyr_set_trace failed")
        pp.build_packed_pyramid(gray, L, sf, r)
        torch.cuda.synchronize()
        t = buf.cpu().numpy()
    finally:
        _build._LIBS["packedpyr"] = base
        pp._launch_fn.cache_clear()
    t0 = t[:, 0].min()
    us = (t[:, :6] - t0) / 1e3
    level = np.where(kp.records[:, 0] == pp.KIND_TILE, kp.records[:, 1], 0)
    res["span_us"] = float(us[:, 5].max())
    res["timer_steps_ns"] = sorted(set(np.diff(np.unique(t[:, 0]))
                                       .tolist()))[:4]
    for lvl in range(L):
        m = us[level == lvl]
        row = {"items": int(m.shape[0]), "first_claim": float(m[:, 0].min()),
               "last_done": float(m[:, 5].max())}
        if lvl:
            for k, step in enumerate(("wait", "stage", "compute", "publish",
                                      "to next")):
                row[step] = float((m[:, k + 1] - m[:, k]).mean())
        else:
            row["item"] = float((m[:, 5] - m[:, 0]).mean())
        res[f"level {lvl}" if lvl else "pad and zero"] = row
    # the blocks' time between items and after their last one
    blocks = t[:, 7] & 0xffffffff
    idle = 0.0
    for b in np.unique(blocks):
        m = np.sort(us[blocks == b][:, [0, 5]], axis=0)
        idle += float((m[1:, 0] - m[:-1, 1]).clip(0).sum()
                      + res["span_us"] - m[-1, 1] + m[0, 0])
    res["blocks"] = int(np.unique(blocks).size)
    res["idle_block_us"] = idle
    res["waiting_block_us"] = float((us[:, 1] - us[:, 0])[level > 0].sum())
    res["busy_block_us"] = float((us[:, 5] - us[:, 0]).sum())
    return res


def k7_sweep(gray, params, r, flush) -> dict:
    import numpy as np
    import torch
    from chip_smoke import graph_ms, graph_ms_cold, k7_agrees
    from pislamfusion_tpu_torch.ops.features import packedpyr as pp
    H, W = gray.shape
    L, sf = params.n_levels, params.scale_factor
    kp = pp.kernel_plan(H, W, L, sf, r)
    plan = pp.pyramid_plan(H, W, L, sf, r)
    res = {}
    for label, (rec, checked) in ablations(kp).items():
        rd = torch.from_numpy(np.ascontiguousarray(rec)).to(gray.device)
        out = torch.zeros((plan.total_rows, plan.wpl), dtype=torch.float32,
                          device=gray.device)
        fn = lambda: pp.launch_records(gray, out, (L, sf, r), rd)  # noqa
        fn()
        if checked and not k7_agrees(out, gray, L, sf, r)[0]:
            raise AssertionError(f"K7 {label}: kernel != plain")
        res[label] = {"items": int(rec.shape[0]), "warm": graph_ms(fn),
                      "cold": graph_ms_cold(fn, flush)}
    return res


def k2_sweep(packed, pxy, r, flush) -> dict:
    import torch
    from chip_smoke import graph_ms, graph_ms_cold
    from pislamfusion_tpu_torch.ops.features import patchgather as pg
    G = 2 * r + 1
    ar = torch.arange(G, device=packed.device)
    xy = pxy.to(torch.int64)
    iy = (xy[:, 1:2] - r + ar).clamp(0, packed.shape[0] - 1)
    ix = (xy[:, 0:1] - r + ar).clamp(0, packed.shape[1] - 1)
    out = torch.empty((pxy.shape[0], G, G), dtype=torch.float32,
                      device=packed.device)
    fns = {"kernel": lambda: pg.gather_patches(packed, pxy, r),
           "stores alone (fill_ of the output)": lambda: out.fill_(0.0),
           "aten::index": lambda: packed[iy[:, :, None], ix[:, None, :]]}
    return {k: {"warm": graph_ms(f), "cold": graph_ms_cold(f, flush)}
            for k, f in fns.items()}


def main() -> int:
    sys.path[:0] = [HERE, os.path.join(HERE, "scripts")]
    import torch
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    from chip_smoke import (FLUSH_BYTES, check_packedpyr,
                            check_patchgather)
    from pislamfusion_tpu_torch import _build
    from pislamfusion_tpu_torch.ops.features import orb
    logs = _build.build_all(("packedpyr", "patchgather", "flatpyr",
                             "fastselect"))
    for name in ("packedpyr", "patchgather"):
        for ln in logs[name].splitlines():
            if "registers" in ln or "spill" in ln:
                print(f"  {name}: {ln.strip()}")
    dev = torch.device("cuda")
    flush = torch.empty(FLUSH_BYTES // 4, dtype=torch.float32, device=dev)
    gray, params, packed, pxy = phase1_inputs(dev)
    r = orb._GATHER_R
    k2 = check_patchgather(packed, pxy, r, flush)
    _, k7 = check_packedpyr(gray, params, r, flush)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    res = {"card": card, "k7": k7, "k2": k2}
    if "--check" not in sys.argv:
        res["k7_sweep"] = k7_sweep(gray, params, r, flush)
        res["k7_trace"] = k7_trace(gray, params, r)
        if "--trace" not in sys.argv:
            res["k7_variants"] = k7_variants(gray, params, r, flush)
        res["k2_sweep"] = k2_sweep(packed, pxy, r, flush)
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
