// K8: one banded sandwich per channel, out[b, :, :, c] = mh @ x[b, :, :, c] @ mw^T.
//
// Replaces pislamfusion_tpu/ops/stencil_pallas.py banded_sandwich_pallas
// (pallas_call in _sandwich_call at :178): the separable stencils of
// ops/image.py's `_matmul_sep`. Here it serves every pyrDown and pyrUp
// (image.pyr_down / pyr_up), so the Laplacian pyramids of the mosaic feed,
// the weight pyramids and the canvas reconstruction.
//
// With the nonzero span of each matrix row from host tables
// (ops/stencil.py SandwichTables):
//   t1[y, q]      = sum_k row_w[y, k] * x[row_start[y] + k, q]     (rows)
//   out[y, xo, c] = sum_k col_w[xo, k] * t1[y, col_start[xo] + k, c]
// with q = (column, channel) interleaved as in memory. Every product and
// every sum is rounded on its own (__fmul_rn / __fadd_rn, never an FMA) and
// the taps are summed in order from 0.f, which is exactly what the plain
// PyTorch version's separate tensor operations do: the two are equal, not
// merely close. No TF32 (the TPU kernel ran at Precision.HIGHEST).
//
// Bound on the H100: bytes. A 1536^2 x 3 pyrDown reads 28.3 MB and writes
// 7.1 MB against ~0.05 G one-operation f32 instructions. The design keeps
// the HBM busy:
// - A persistent grid (as many blocks as fit, each walking output tiles
//   blockIdx.x, + gridDim.x, ...) stages the NEXT tile's input slab and
//   span tables into a second shared buffer with cp.async while it computes
//   the current one (double buffering, commit_group / wait_group 1).
// - Tiles are TR output rows x TC output columns with all channels, chosen
//   on the host (stencil.sandwich_plan) so that the slab, its twin and the
//   row-pass result fit 4 or more blocks an SM (32 warps at the 1536^2 x 3
//   pyrDown: 8 x 40 tiles, 49 KB).
// - Slab rows are copied 16 bytes at a time when a row of x is a whole
//   number of 16-byte words (W * C % 4 == 0 and x 16-byte aligned): the
//   copy starts at the aligned word below the window and the slab keeps
//   that `lead` (0-3 floats); otherwise 4 bytes at a time, lead 0. One
//   code path.
// - No division or global table read inside the loops: C (1 or 3) and the
//   tap bound K (3 for pyrUp, 5 for pyrDown) are template parameters, the
//   taps loop is unrolled with `if (k < n)` (the order kept, no zero tap
//   added), the per-tile span tables sit in shared memory, and both passes
//   map threads in 2D with power-of-two widths. The row pass reads and
//   writes float4; the column pass gives consecutive lanes consecutive
//   output words, so a warp's stores are one coalesced 128-byte row
//   segment and its shared reads at most 2-way conflicted (a float4 a
//   lane would read 8 words apart: 8-way).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

struct Plan {
  int B, H, W, Ho, Wo;
  int ntr, ntc, tr, tc;   // tiles down and across, output rows and columns a tile
  int sr, pitch;          // slab rows, floats a slab row (a multiple of 4)
  int rm, cm;             // words of a row tile's / column tile's span table
  int lgr;                // log2 of the row pass's threads a row (<= 8)
  int lgw;                // log2 of the column pass's warps a row (<= 3)
  int vec;                // 16-byte copies of x
  const int* tile_r0;     // [ntr] first input row of a tile row
  const int* tile_rn;     // [ntr] input rows it reads
  const int* tile_c0;     // [ntc] first input column of a tile column
  const int* tile_cn;     // [ntc] input columns it reads
  // [ntr, rm]: offset of each row's span in the slab [tr], its length [tr],
  // its weights (float bits) [K][tr]; [ntc, cm] the same for the columns,
  // offsets in floats
  const int* rmeta;
  const int* cmeta;
};

struct Tile {
  int b, tyt, txt, r0, rn, c0, qn, lead;
};

__device__ __forceinline__ void cp_async16(void* s, const void* g) {
  const unsigned sa = (unsigned)__cvta_generic_to_shared(s);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(sa),
               "l"(g)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* s, const void* g) {
  const unsigned sa = (unsigned)__cvta_generic_to_shared(s);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(sa),
               "l"(g)
               : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_wait_all_but_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

template <int C>
__device__ __forceinline__ Tile tile_of(const Plan& p, int t) {
  Tile T;
  T.txt = t % p.ntc;          // once a tile, not in a loop
  const int rest = t / p.ntc;
  T.tyt = rest % p.ntr;
  T.b = rest / p.ntr;
  T.r0 = __ldg(p.tile_r0 + T.tyt);
  T.rn = __ldg(p.tile_rn + T.tyt);
  T.c0 = __ldg(p.tile_c0 + T.txt);
  T.qn = __ldg(p.tile_cn + T.txt) * C;
  T.lead = p.vec ? (T.c0 * C) & 3 : 0;
  return T;
}

// Issue the copies of tile T's slab and span tables into one stage.
template <int C>
__device__ __forceinline__ void stage_tile(const Plan& p,
                                           const float* __restrict__ x,
                                           const Tile& T, float* slab,
                                           int* rmeta, int* cmeta) {
  const int tid = threadIdx.x;
  const long long rstride = (long long)p.W * C;
  const float* src =
      x + ((long long)T.b * p.H + T.r0) * rstride + (long long)T.c0 * C -
      T.lead;
  if (p.vec) {
    const int n4 = (T.lead + T.qn + 3) >> 2;
    const int lx = p.lgr;
    for (int r = tid >> lx; r < T.rn; r += THREADS >> lx)
      for (int c = tid & ((1 << lx) - 1); c < n4; c += 1 << lx)
        cp_async16(slab + r * p.pitch + 4 * c, src + r * rstride + 4 * c);
  } else {
    const int lx = min(p.lgr + 2, 8);
    for (int r = tid >> lx; r < T.rn; r += THREADS >> lx)
      for (int c = tid & ((1 << lx) - 1); c < T.qn; c += 1 << lx)
        cp_async4(slab + r * p.pitch + c, src + r * rstride + c);
  }
  const int* rs = p.rmeta + (long long)T.tyt * p.rm;
  for (int i = tid; i < (p.rm >> 2); i += THREADS)
    cp_async16(rmeta + 4 * i, rs + 4 * i);
  const int* cs = p.cmeta + (long long)T.txt * p.cm;
  for (int i = tid; i < (p.cm >> 2); i += THREADS)
    cp_async16(cmeta + 4 * i, cs + 4 * i);
}

__device__ __forceinline__ void tap4(float4& acc, float w, const float4& v) {
  acc.x = __fadd_rn(acc.x, __fmul_rn(w, v.x));
  acc.y = __fadd_rn(acc.y, __fmul_rn(w, v.y));
  acc.z = __fadd_rn(acc.z, __fmul_rn(w, v.z));
  acc.w = __fadd_rn(acc.w, __fmul_rn(w, v.w));
}

// Rows: t1[ty, :] from the slab, a float4 a thread, 1 << lgr threads a row.
// Rows past Ho have length 0 and give 0.
template <int K>
__device__ __forceinline__ void row_pass(const Plan& p, const Tile& T,
                                         const float* slab, const int* rm,
                                         float* t1) {
  const int tid = threadIdx.x;
  const int n4 = (T.lead + T.qn + 3) >> 2;
  const int lx = p.lgr;
  const int p4 = p.pitch >> 2;
  const float4* s4 = reinterpret_cast<const float4*>(slab);
  float4* o4 = reinterpret_cast<float4*>(t1);
  for (int ty = tid >> lx; ty < p.tr; ty += THREADS >> lx) {
    const int off = rm[ty];
    const int n = rm[p.tr + ty];
    float w[K];
#pragma unroll
    for (int k = 0; k < K; ++k) w[k] = __int_as_float(rm[(2 + k) * p.tr + ty]);
    for (int c = tid & ((1 << lx) - 1); c < n4; c += 1 << lx) {
      float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int k = 0; k < K; ++k)
        if (k < n) tap4(acc, w[k], s4[(off + k) * p4 + c]);
      o4[ty * p4 + c] = acc;
    }
  }
}

// Columns: each lane one output word j = xo * C + c of a row, 32 << lgw
// lanes a row, 8 >> lgw rows at a time; its span's table read once for
// all the rows it takes.
template <int C, int K>
__device__ __forceinline__ void col_pass(const Plan& p, const Tile& T,
                                         const float* t1, const int* cm,
                                         float* __restrict__ out) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int jg = warp & ((1 << p.lgw) - 1);
  const int rstep = (THREADS >> 5) >> p.lgw;
  const int x0 = T.txt * p.tc;
  const int y0 = T.tyt * p.tr;
  const int nj = min(p.tc, p.Wo - x0) * C;
  const int yn = min(p.tr, p.Ho - y0);
  const long long ostride = (long long)p.Wo * C;
  float* ob = out + ((long long)T.b * p.Ho + y0) * ostride + (long long)x0 * C;
  for (int j = (jg << 5) + lane; j < nj; j += 32 << p.lgw) {
    const int xo = j / C;       // C is a compile-time constant
    const int c = j - xo * C;
    const int n = cm[p.tc + xo];
    float w[K];
#pragma unroll
    for (int k = 0; k < K; ++k) w[k] = __int_as_float(cm[(2 + k) * p.tc + xo]);
    const float* src = t1 + T.lead + cm[xo] + c;
    for (int ty = warp >> p.lgw; ty < yn; ty += rstep) {
      const float* s = src + ty * p.pitch;
      float acc = 0.f;
#pragma unroll
      for (int k = 0; k < K; ++k)
        if (k < n) acc = __fadd_rn(acc, __fmul_rn(w[k], s[k * C]));
      ob[ty * ostride + j] = acc;
    }
  }
}

template <int C, int K>
__global__ void __launch_bounds__(THREADS, 4)
    bandedsandwich_kernel(const float* __restrict__ x,
                          float* __restrict__ out, const Plan p) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int stage = p.sr * p.pitch + p.rm + p.cm;   // floats a stage
  float* t1 = smem + 2 * stage;
  const int ntiles = p.B * p.ntr * p.ntc;
  int t = blockIdx.x;
  if (t >= ntiles) return;
  Tile cur = tile_of<C>(p, t);
  stage_tile<C>(p, x, cur, smem, reinterpret_cast<int*>(smem + p.sr * p.pitch),
                reinterpret_cast<int*>(smem + p.sr * p.pitch + p.rm));
  cp_commit();
  for (int s = 0;; s ^= 1) {
    const int tn = t + gridDim.x;
    Tile nxt = cur;
    if (tn < ntiles) {
      nxt = tile_of<C>(p, tn);
      float* nb = smem + (s ^ 1) * stage;
      stage_tile<C>(p, x, nxt, nb, reinterpret_cast<int*>(nb + p.sr * p.pitch),
                    reinterpret_cast<int*>(nb + p.sr * p.pitch + p.rm));
    }
    cp_commit();              // an empty group on the last tile
    cp_wait_all_but_one();    // the current tile's copies have landed
    __syncthreads();
    const float* slab = smem + s * stage;
    const int* rm = reinterpret_cast<const int*>(slab + p.sr * p.pitch);
    row_pass<K>(p, cur, slab, rm, t1);
    __syncthreads();
    col_pass<C, K>(p, cur, t1, rm + p.rm, out);
    __syncthreads();          // this stage is refilled next iteration
    if (tn >= ntiles) break;
    t = tn;
    cur = nxt;
  }
}

typedef void (*KernelFn)(const float*, float*, const Plan);

KernelFn pick(int C, int K) {
  if (C == 1 && K == 3) return bandedsandwich_kernel<1, 3>;
  if (C == 1 && K == 5) return bandedsandwich_kernel<1, 5>;
  if (C == 3 && K == 3) return bandedsandwich_kernel<3, 3>;
  if (C == 3 && K == 5) return bandedsandwich_kernel<3, 5>;
  return nullptr;
}

}  // namespace

// Blocks of the (C, K) kernel resident on one SM with `smem` bytes of
// dynamic shared memory each (registers included), or -1 on an error.
extern "C" int bandedsandwich_occupancy(int C, int K, int smem) {
  KernelFn fn = pick(C, K);
  if (fn == nullptr) return -1;
  if (cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           smem) != cudaSuccess)
    return -1;
  int blocks = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn, THREADS,
                                                    smem) != cudaSuccess)
    return -1;
  return blocks;
}

// x: [B, H, W, C] f32, out: [B, Ho, Wo, C] f32, both contiguous; the plan's
// tables on the device (stencil.sandwich_plan); `grid` persistent blocks.
extern "C" int bandedsandwich_launch(
    const float* x, int B, int H, int W, int C, int K, int Ho, int Wo,
    int ntr, int ntc, int tr, int tc, int sr, int pitch, int rm, int cm,
    int lgr, int lgw, int vec, const int* tile_r0, const int* tile_rn,
    const int* tile_c0, const int* tile_cn, const int* rmeta,
    const int* cmeta, int smem, int grid, float* out, void* stream) {
  KernelFn fn = pick(C, K);
  if (fn == nullptr) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  Plan p{B,   H,       W,       Ho,      Wo,      ntr,     ntc,   tr,
         tc,  sr,      pitch,   rm,      cm,      lgr,     lgw,   vec,
         tile_r0, tile_rn, tile_c0, tile_cn, rmeta, cmeta};
  fn<<<grid, THREADS, smem, (cudaStream_t)stream>>>(x, out, p);
  return (int)cudaGetLastError();
}
