"""K5's and K1's launch plans against the other cuts they could launch.

    python3 scripts/torch_k5_k1_sweep.py [--out PATH] [--k1]

On the card:

- K5 (`stencil.banded_stack`) at SIFT's three 1080p octave shapes: the
  kernel under every forced cut (`stencil.stack_plan(..., tiles=...)`:
  16 or 32 tile rows; the tile widths of each t1 column budget of 96-320
  by the plan's rule, and one width of 32-256 for every scale), each
  checked within 1e-5 of the plain version and timed; the plan's pick
  beside the fastest cut; the pick's time for each scale alone (a
  one-scale table of that scale); and the pick under register budgets of
  3 and 4 resident blocks an SM, each with row groups of 16 and 8 rows
  (`K5_BLOCKS_3`, `K5_ROWS_8` with `stencil.K5_ROWS`).
- K1 (`flatpyr.build_flat_pyramid`) at 1080x1920 with 8 levels: with 8
  and 12 source loads a thread in flight (`K1_LOADS_12`); with one phase
  taken out (its source loads, its row pass, or its column pass's taps:
  `K1_ABLATIONS`, timing only); under shared-memory budgets of 2, 3 and 4
  blocks an SM (`flatpyr.K1_BLOCKS`), each checked against the plain
  version's gate; the default plan's items of each level alone, and all
  of them in other orders (`flatpyr.launch_records`).

Each variant of a kernel is a text edit of its source (`_patched`), built
beside `_build`'s libraries. `--k1` runs K1's part alone. Seeded inputs
(0..1 for K5, 0..255 for K1); each time the device time of one call from
10 captured in one CUDA graph, warm L2. Prints one JSON line a case;
`--out` writes every K5 cut's time as JSON. Needs a CUDA device.
"""
from __future__ import annotations

import ctypes
import dataclasses
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _patched(name: str, tag: str, edits) -> ctypes.CDLL:
    """csrc/<name>.cu with each (old, new) text edit of `edits` applied
    (each `old` found exactly once), built with `_build`'s flags into a
    library of its own under _build/."""
    from pislamfusion_tpu_torch import _build
    with open(os.path.join(_build.CSRC, f"{name}.cu")) as f:
        text = f.read()
    for old, new in edits:
        if text.count(old) != 1:
            raise RuntimeError(f"{name} {tag}: {old!r} not found once")
        text = text.replace(old, new)
    path = os.path.join(_build.BUILD_DIR, f"{name}-{tag}.cu")
    with open(path, "w") as f:
        f.write(text)
    out = path[:-3] + ".so"
    res = subprocess.run([_build._nvcc()] + _build.NVCC_FLAGS + [
        "-I", _build.CSRC, "-o", out, path], capture_output=True, text=True)
    if res.returncode:
        raise RuntimeError(res.stdout + res.stderr)
    for ln in (res.stdout + res.stderr).splitlines():
        if "registers" in ln or "spill" in ln:
            print(f"  {name} {tag}: {ln.strip()}", flush=True)
    return ctypes.CDLL(out)


# K5's row groups of 8 rows (stencil.K5_ROWS with it) and a register
# budget of 3 blocks an SM
K5_ROWS_8 = ("constexpr int RR = 16;", "constexpr int RR = 8;")
K5_BLOCKS_3 = ("__launch_bounds__(THREADS, 4)\n    bandedstack_kernel",
               "__launch_bounds__(THREADS, 3)\n    bandedstack_kernel")
# K1 with 12 source loads a thread in flight, and with one phase taken
# out (timing only, the output is wrong)
K1_LOADS_12 = ("constexpr int NB = 8;", "constexpr int NB = 12;")
K1_ABLATIONS = {
    "no source loads": (
        "if (x < p.w) v[b] = __ldg(reinterpret_cast<const float4*>(gr));",
        ""),
    "no row pass": ("for (int r = warp; r < nr; r += WARPS) {",
                    "for (int r = warp; r < 0; r += WARPS) {"),
    "no column pass taps": ("      if (k < n) acc = fmaf(",
                            "      if (k < 0) acc = fmaf("),
}


def _one_scale(tabs, p: int):
    """`tabs` cut to its scale p alone (a key of its own)."""
    def cut(a):
        return a[p:p + 1]
    return dataclasses.replace(
        tabs, key=tabs.key + (("scale", p),),
        **{f.name: cut(getattr(tabs, f.name))
           for f in dataclasses.fields(tabs) if f.name != "key"})


def main() -> int:
    out_path = sys.argv[sys.argv.index("--out") + 1] \
        if "--out" in sys.argv else None
    sys.path.insert(0, ROOT)
    import numpy as np
    import torch
    from chip_smoke import graph_ms
    from pislamfusion_tpu_torch import _build
    from pislamfusion_tpu_torch.ops import stencil as st
    from pislamfusion_tpu_torch.ops.features import flatpyr
    from pislamfusion_tpu_torch.ops.features import sift
    if not torch.cuda.is_available():
        print("torch_k5_k1_sweep: needs a CUDA device", file=sys.stderr)
        return 2
    _build.build_all(("bandedstack", "flatpyr"))
    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    rng = np.random.default_rng(0)
    sp = sift.SiftParams(n_features=1000)
    every = {}
    for h, w in () if "--k1" in sys.argv else (
            (1080, 1920), (540, 960), (270, 480)):
        tabs = sift._stack_tables(h, w, sp)
        x = torch.from_numpy(rng.uniform(0, 1, (h, w)).astype(
            np.float32)).to(dev)
        plain = st.banded_stack_plain(x, tabs)
        out = torch.empty_like(plain)

        def run(plan, t=tabs, o=out, ref=plain):
            on = st.stack_plan_on_device(plan, dev)
            o.zero_()
            st.launch_stack(x, o, on)
            err = float((o - ref).abs().max())
            if not err <= 1e-5:
                raise AssertionError(f"K5 {h}x{w} {plan.th} {plan.tw}: "
                                     f"|kernel - plain| {err}")
            return graph_ms(lambda: st.launch_stack(x, o, on), 10)
        rs = sorted((int(r) for r in tabs.radius), reverse=True)
        cuts = set()
        for th in (16, 32):
            for cmax in range(96, 321, 32):
                tws = st._tile_widths(rs, cmax, w)
                if tws is not None:
                    cuts.add((th, tuple(tws)))
            for tw in range(32, 257, 32):
                cuts.add((th, (tw,) * len(rs)))
        rows = []
        for th, tws in sorted(cuts):
            try:
                plan = st.stack_plan(tabs, tiles=(th, tws))
            except ValueError:
                continue
            rows.append((run(plan), th, list(tws), plan.n_items))
        pick = st.stack_plan(tabs, st.K5_BLOCKS * sms)
        ms = run(pick)
        scales = {}
        for p in range(tabs.scales):
            one = _one_scale(tabs, p)
            o1 = torch.empty((1, h, w), dtype=torch.float32, device=dev)
            s1 = st.stack_plan(one, tiles=(pick.th, (
                pick.tw[pick.order.index(p)],)))
            scales[int(tabs.radius[p])] = run(
                s1, one, o1, plain[p:p + 1])
        lib = _build._LIBS.get("bandedstack")
        variants = {}
        for group in (16, 8):
            st.K5_ROWS = group
            plan = st.stack_plan(tabs, st.K5_BLOCKS * sms)
            for nb in (3, 4):
                edits = ([K5_ROWS_8] if group == 8 else []) + (
                    [K5_BLOCKS_3] if nb == 3 else [])
                _build._LIBS["bandedstack"] = (
                    _patched("bandedstack", f"rows{group}-blocks{nb}", edits)
                    if edits else lib)
                variants[f"{group} rows, {nb} blocks"] = run(plan)
        st.K5_ROWS = 16
        _build._LIBS["bandedstack"] = lib
        best = min(rows)
        every[f"K5 {h}x{w}"] = rows
        print(json.dumps({"kernel": "K5", "shape": f"{h}x{w}", "card": card,
                          "pick": [pick.th, list(pick.tw), pick.n_items, ms],
                          "fastest": [best[1], best[2], best[3], best[0]],
                          "pick_over_fastest": ms / best[0],
                          "pick_by_scale_ms": scales,
                          "pick_by_variant_ms": variants,
                          "cuts": len(rows)}), flush=True)
    gray = torch.from_numpy(rng.uniform(0, 255, (1080, 1920)).astype(
        np.float32)).to(dev)
    args = (1080, 1920, 8, 1.2, 32)
    plain = flatpyr.build_flat_pyramid_plain(gray, *args[2:])
    k1 = {}
    lib = _build._LIBS.get("flatpyr")
    for label, lib_k1 in (
            ("8 loads in flight", lib),
            ("12 loads in flight", _patched("flatpyr", "loads12",
                                            [K1_LOADS_12]))) + tuple(
            (label, _patched("flatpyr", "".join(
                ch for ch in label if ch.isalnum()), [edit]))
            for label, edit in K1_ABLATIONS.items()):
        _build._LIBS["flatpyr"] = lib_k1
        flatpyr._device_plan.cache_clear()
        k1[label] = graph_ms(
            lambda: flatpyr.build_flat_pyramid(gray, *args[2:]), 10)
    _build._LIBS["flatpyr"] = lib
    for nb in (2, 3, 4):
        flatpyr.K1_BLOCKS = nb
        flatpyr.K1_SMEM = st.SM_SMEM // nb - st.SM_BLOCK_RESERVED
        flatpyr.kernel_plan.cache_clear()
        flatpyr._device_plan.cache_clear()
        kp = flatpyr.kernel_plan(*args)
        got = flatpyr.build_flat_pyramid(gray, *args[2:])
        d = (got - plain).abs()
        if not (float((d <= 1e-3).double().mean()) >= 0.9999
                and float(d.max()) <= 1.0):
            raise AssertionError(f"K1 {nb} blocks: kernel != plain")
        ms = graph_ms(lambda: flatpyr.build_flat_pyramid(gray, *args[2:]),
                      10)
        k1[nb] = {"tiles": kp.tiles, "smem": kp.smem, "ms": ms,
                  "occupancy": flatpyr.occupancy(kp, dev)}
    # the default plan's items: each level's alone, and all of them in
    # other orders
    flatpyr.K1_BLOCKS = 4
    flatpyr.K1_SMEM = st.SM_SMEM // 4 - st.SM_BLOCK_RESERVED
    flatpyr.kernel_plan.cache_clear()
    flatpyr._device_plan.cache_clear()
    kp = flatpyr.kernel_plan(*args)
    out = torch.empty_like(plain)
    rec = kp.records
    lvl = rec[:, 0]

    def timed(records):
        r = torch.from_numpy(np.ascontiguousarray(records)).to(dev)
        return graph_ms(lambda: flatpyr.launch_records(
            gray, out, args[2:], r), 10)
    by_level = {int(v): timed(rec[lvl == v]) for v in np.unique(lvl)}
    deep_first = rec[np.argsort(-lvl, kind="stable")]
    orders = {"plan": timed(rec),
              "levels deepest first, level 0 last": timed(deep_first),
              "level 0 first": timed(deep_first[::-1][np.argsort(
                  deep_first[::-1, 0], kind="stable")]),
              "shuffled": timed(rec[rng.permutation(rec.shape[0])])}
    print(json.dumps({"kernel": "K1", "shape": "1080x1920 L=8",
                      "card": card, "by_blocks": k1,
                      "by_level_ms": by_level, "by_order_ms": orders}),
          flush=True)
    if out_path:
        with open(out_path, "w") as f:
            json.dump(every, f)
    return 0


if __name__ == "__main__":
    sys.exit(main())
