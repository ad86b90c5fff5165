"""What limits K4 (fused FAST+NMS+select) and K3 (shear warp), measured.

    python3 scripts/torch_k4_k3_sweep.py [--k3]

On the card, at `chip_smoke.py`'s shapes and inputs:

- the f32 issue rates of the card's `min.f32` / `max.f32` and of its
  `add.rn.f32` (`f32_rates`: one kernel, 8 independent chains a thread,
  132 x 16 blocks of 256 threads), the rates K4's operations bound is
  reckoned from;
- K4 (`fastselect.fast_cell_winners`) on the strip's 1080p K1 pyramid
  and on the sigma-40 noise pyramid: the kernel, its phases taken out
  one at a time (the slab load alone, the pretest alone, without pass 2's
  scoring) and the pretest turned off (every pixel scored: the parent's
  dense score inside this kernel), the pretest on {0, 4, 8, 12} alone
  (5 reads, more candidates), the slab staged by 4-byte copies alone,
  and runs of 1 and 2 cells a block;
- K3 (`shearwarp.launch_kernel`) on its four cases (FastVO's half
  resolution and the Map2D engine's full resolution, each survey and
  turned 100 degrees): the kernel, an all-dead patch (the zero stores
  alone), without the source reads, pass 1 alone, the transposed cases
  through the untransposed pass 1 (strided reads), 1 and 4 rows' reads
  a thread in flight (2 by default), 8 and 16 staged transposed reads a
  thread in flight (4 by default), register budgets of 3 and 4 blocks
  an SM, 256 threads a block (288 by default), and strips of 2 and 8 rows
  (4 by default).

The variants are text edits of the sources (`torch_k5_k1_sweep._patched`)
built beside `_build`'s libraries; an ablation's output is wrong, and is
timed only. The kernel and each variant that computes the function are
checked against the plain version (K4 equal, K3 within 1e-3). Each time
is the device time of one call from 20 captured in one CUDA graph, warm
L2. Prints one JSON line a kernel; `--k3` skips K4's cases. Needs a
CUDA device.
"""
from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_RATE_SRC = r"""
#include <cuda_runtime.h>
// 8 independent chains a thread, each step two dependent operations
template <int OP>
__global__ void rate_kernel(const float* in, float* out, int iters) {
  float a[8], b[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    a[i] = in[(threadIdx.x + i) & 255];
    b[i] = in[(threadIdx.x * 7 + i + 3) & 255];
  }
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int u = 0; u < 16; ++u) {
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        if (OP == 0) {
          asm("min.f32 %0, %0, %1;" : "+f"(a[i]) : "f"(b[i]));
          asm("max.f32 %0, %0, %1;" : "+f"(b[i]) : "f"(a[i]));
        } else {
          asm("add.rn.f32 %0, %0, %1;" : "+f"(a[i]) : "f"(b[i]));
          asm("add.rn.f32 %0, %0, %1;" : "+f"(b[i]) : "f"(a[i]));
        }
      }
    }
  }
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < 8; ++i) s += a[i] + b[i];
  if (s == 1234.5f) out[threadIdx.x] = s;
}
extern "C" int rate_launch(int op, const float* in, float* out, int iters,
                           int blocks, void* stream) {
  if (op == 0)
    rate_kernel<0><<<blocks, 256, 0, (cudaStream_t)stream>>>(in, out, iters);
  else
    rate_kernel<1><<<blocks, 256, 0, (cudaStream_t)stream>>>(in, out, iters);
  return (int)cudaGetLastError();
}
"""


def _rate_lib() -> ctypes.CDLL:
    """The rate kernel, built with `_build`'s flags under _build/."""
    from pislamfusion_tpu_torch import _build
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    path = os.path.join(_build.BUILD_DIR, "f32rate.cu")
    with open(path, "w") as f:
        f.write(_RATE_SRC)
    out = path[:-3] + f"-{os.getpid()}.so"
    res = subprocess.run([_build._nvcc()] + _build.NVCC_FLAGS + [
        "-o", out, path], capture_output=True, text=True)
    if res.returncode:
        raise RuntimeError(res.stdout + res.stderr)
    lib = ctypes.CDLL(out)
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.rate_launch.restype = I
    lib.rate_launch.argtypes = [I, P, P, I, I, P]
    return lib


def f32_rates(dev) -> dict:
    """Measured f32 operations a second on `dev`: {"minmax": min.f32 and
    max.f32, "add": add.rn.f32}, each from one launch of 132 x 16 blocks
    of 256 threads, 8 chains a thread (CUDA events, after a warm-up
    launch)."""
    import torch
    lib = _rate_lib()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    blocks, iters = sms * 16, 2048
    x = torch.rand(256, device=dev) + 1.0
    out = torch.zeros(256, device=dev)
    rates = {}
    for name, op in (("minmax", 0), ("add", 1)):
        stream = torch.cuda.current_stream(dev).cuda_stream
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        for k in range(2):                   # warm-up, then timed
            ev[0].record()
            err = lib.rate_launch(op, x.data_ptr(), out.data_ptr(), iters,
                                  blocks, stream)
            ev[1].record()
            if err:
                raise RuntimeError(f"rate kernel: CUDA error {err}")
        torch.cuda.synchronize()
        ops = blocks * 256.0 * iters * 16 * 8 * 2
        rates[name] = ops / (ev[0].elapsed_time(ev[1]) * 1e-3)
    return rates


# K4 variants: (label, text edits of csrc/fastselect.cu, run, checked)
K4_VARIANTS = (
    ("slab load alone", [("__syncthreads();  // slab staged",
                          "__syncthreads(); return;")], 0, False),
    ("pretest alone", [("__syncthreads();  // pretest done",
                        "__syncthreads(); return;")], 0, False),
    ("without pass 2", [("for (int k = threadIdx.x; k < n; k += THREADS) {"
                         "  // pass 2: score",
                         "for (int k = threadIdx.x; k < 0; k += THREADS) {")],
     0, False),
    ("dense score (no pretest)", [
        ("(hi - c0 > thr || lo - c0 < -thr)", "true"),
        ("may_pass(slab + (r + FR) * sw + c + FR, sw, thr)", "true")], 0,
     True),
    ("pretest on {0, 4, 8, 12} alone", [
        ("fminf(fmaxf(r2[0], l2[4]), fmaxf(r2[4], l2[0])));", "INFINITY);"),
        ("fmaxf(fminf(r2[0], l2[4]), fminf(r2[4], l2[0])));", "-INFINITY);"),
        ("fminf(fmaxf(v2, v10), fmaxf(v6, v14)));", "INFINITY);"),
        ("fmaxf(fminf(v2, v10), fminf(v6, v14)));", "-INFINITY);")], 0,
     True),
    ("slab by 4-byte copies", [("const bool vec = (sw & 3) == 0",
                                "const bool vec = false && (sw & 3) == 0")],
     0, True),
    ("runs of 2 cells", [], 2, True),
    ("runs of 1 cell", [], 1, True),
)

# K3 variants: (label, text edits of csrc/shearwarp.cu, checked): rows a
# strip (R), rows whose reads a thread has in flight (RB), warps a block,
# a register budget
def _R(n):
    return ("constexpr int R = 4;", f"constexpr int R = {n};")


def _RB(n):
    return ("constexpr int RB = 2;", f"constexpr int RB = {n};")


_REGS64 = ("__launch_bounds__(THREADS)\n    shearwarp_kernel",
           "__launch_bounds__(THREADS, 3)\n    shearwarp_kernel")

K3_VARIANTS = (
    ("all-dead patch", [("if (is_live == 0) {", "if (true) {")], False),
    ("without the source reads", [
        ("val[b][j][c] = __ldg(img + pix[b][j] + c);",
         "val[b][j][c] = (float)(pix[b][j] + c);"),
        ("v[q] = idx < n ? __ldg(img + at + f) : 0.f;",
         "v[q] = idx < n ? (float)(at + f) : 0.f;")], False),
    ("pass 1 alone", [("__syncthreads();  // pass 1 done",
                       "__syncthreads(); return;")], False),
    ("transposed through the untransposed pass 1", [(
        "if (tr && s.xlen * sp + 2 * s.xlen <= room) {", "if (false) {")],
     True),
    ("1 row in flight", [_RB(1)], True),
    ("4 rows in flight", [_RB(4)], True),
    ("8 staged reads in flight", [("constexpr int NS = 4;",
                                   "constexpr int NS = 8;")], True),
    ("16 staged reads in flight", [("constexpr int NS = 4;",
                                    "constexpr int NS = 16;")], True),
    ("3 blocks' registers", [_REGS64], True),
    ("4 blocks' registers", [(_REGS64[0], _REGS64[1].replace(", 3)",
                                                             ", 4)"))],
     True),
    ("288 threads", [("constexpr int WARPS = 8;", "constexpr int WARPS = 9;")],
     True),
    ("2-row strips", [_R(2)], True),
)

def main() -> int:
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.join(ROOT, "scripts"))
    import torch
    import chip_smoke as cs
    from torch_k5_k1_sweep import _patched
    from pislamfusion_tpu_torch import _build
    from pislamfusion_tpu_torch.ops import shearwarp as sw
    from pislamfusion_tpu_torch.ops.features import fastselect as fs
    from pislamfusion_tpu_torch.ops.features import orb
    if not torch.cuda.is_available():
        print("torch_k4_k3_sweep: needs a CUDA device", file=sys.stderr)
        return 2
    _build.build_all(("fastselect", "shearwarp", "flatpyr"))
    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    rates = f32_rates(dev)
    print(json.dumps({"f32_ops_per_s": rates, "card": card}), flush=True)
    frames, poses = cs.render_strip(2, 1080, 1920, 1200.0, 0.12, 6144, dev)
    vo = cs.make_fastvo(1080, 1920, 1200.0, poses, 1000, 8, 5, dev)
    p = vo.params
    cell, thr, border = p.cell, p.min_threshold, orb.EDGE_THRESHOLD
    k4_cases = cs.k4_cases(frames[0], p, dev)[::3]  # the strip and noise
    k4 = {}

    def libs(name, variants):
        """{label: library} of the kernel and each variant, built once."""
        out = {"kernel": _build.load(name)}
        for v in variants:
            if v[1]:
                out[v[0]] = _patched(name, "".join(
                    ch for ch in v[0] if ch.isalnum()), v[1])
        return out
    k4_libs = libs("fastselect", K4_VARIANTS)
    for label, packed, offs, shapes in ([] if "--k3" in sys.argv
                                        else k4_cases):
        shapes, offs = tuple(shapes), tuple(offs)
        ref = fs.fast_cell_winners_plain(
            [packed[oy:oy + lh, ox:ox + lw]
             for (lh, lw), (ox, oy) in zip(shapes, offs)], cell, thr, border)
        row = {}
        for vlabel, _, run, checked in (("kernel", [], 0, True),) \
                + K4_VARIANTS:
            lib = k4_libs.get(vlabel, k4_libs["kernel"])
            plan = fs.winner_plan(shapes, offs, cell, run)
            levels, blocks = fs._device_plan(shapes, offs, cell, str(dev),
                                             run)
            cv = torch.empty(plan.n_cells, device=dev)
            ci = torch.empty(plan.n_cells, dtype=torch.int32, device=dev)
            P, I = ctypes.c_void_p, ctypes.c_int
            lib.fastselect_launch.restype = I
            lib.fastselect_launch.argtypes = [P, I, P, P, I, I, I,
                                              ctypes.c_float, I, P, P, P]

            def launch():
                err = lib.fastselect_launch(
                    packed.data_ptr(), packed.stride(0), levels.data_ptr(),
                    blocks.data_ptr(), plan.blocks.shape[0], cell, plan.run,
                    float(thr), border, cv.data_ptr(), ci.data_ptr(),
                    torch.cuda.current_stream(dev).cuda_stream)
                if err:
                    raise RuntimeError(f"K4 {vlabel}: CUDA error {err}")
            launch()
            torch.cuda.synchronize()
            if checked:
                first = 0
                for (rv, ri), (ncy, ncx) in zip(ref, plan.grids):
                    n = ncy * ncx
                    if not (torch.equal(cv[first:first + n].view(ncy, ncx),
                                        rv) and torch.equal(
                            ci[first:first + n].view(ncy, ncx), ri)):
                        raise AssertionError(f"K4 {label} {vlabel}: "
                                             "kernel != plain")
                    first += n
            row[vlabel] = cs.graph_ms(launch)
        k4[label] = row
    print(json.dumps({"kernel": "K4", "card": card, "ms": k4}), flush=True)
    k3 = {}
    k3_libs = libs("shearwarp", K3_VARIANTS)
    for label, src, h, patch_hw in cs.k3_cases(frames, poses, 1200.0, dev):
        tr, prm, win = sw._params(src, h, patch_hw, sw.TILE, 2.2)
        ref = sw.warp_patch_plain(src, h, patch_hw)[0]
        row = {}
        for vlabel, _, checked in (("kernel", [], True),) + K3_VARIANTS:
            _build._LIBS["shearwarp"] = k3_libs[vlabel]
            fn = lambda: sw.launch_kernel(src, tr, prm, patch_hw,  # noqa
                                          sw.TILE, win)
            out = fn()
            torch.cuda.synchronize()
            if checked and not float((out - ref).abs().max()) <= 1e-3:
                raise AssertionError(f"K3 {label} {vlabel}: kernel != "
                                     "plain")
            row[vlabel] = cs.graph_ms(fn)
        _build._LIBS["shearwarp"] = k3_libs["kernel"]
        k3[label] = row
    print(json.dumps({"kernel": "K3", "card": card, "ms": k3}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
