// K1: the flat ORB pyramid, every level straight from level 0.
//
// Replaces pislamfusion_tpu/ops/features/flatpyr_pallas.py
// build_flat_pyramid (pallas_call at :227).
//
// For level l >= 1, with the composed bilinear matrices mr_l [rows, h] and
// mc_l [wp, w] (both rounded to bf16 on the host):
//   t1    = bf16( sum_q mr_l[r, q] * bf16(img[q, x]) )        (row pass)
//   out_l = sum_q t1[r, q] * mc_l[c, q]                        (col pass)
// and level 0's block is the exact f32 edge pad of img.
//
// Bound on the H100: bytes. 1080p / 8 levels reads 8.3 MB and writes a
// 51 MB packed buffer; the banded products are ~0.1 GFLOP. The matrices are
// banded, so each output walks only its row's nonzero span (host tables:
// start, length, weights). Products of two bf16 values are exact in f32, so
// only the summation order differs from a dense product. One launch writes
// the whole buffer, each byte once, and t1 never leaves the SM:
// - A block takes one item (ops/features/flatpyr.py kernel_plan; one
//   32-byte record it reads with two loads): an output tile of one level,
//   whose size the plan picks per level so that 3 blocks fit an SM (32 x 256
//   at level 1 down to 8 x 128 at level 7, whose source window is ~3.6x its
//   extent plus an 18-tap halo), or 8 rows of level 0's edge pad, copied a
//   float4 a thread. The deepest levels go first, level 0's copies spread
//   among them.
// - A level item stages its tile's two span tables with cp.async and its
//   source window with float4 loads from L2 (the 8.3 MB image stays there
//   across the levels; a thread one float4 column, 8 rows in flight),
//   rounded to bf16 as they land and kept as bf16: half the shared memory
//   and half the row pass's shared reads of f32.
// - The row pass writes the bf16 t1 tile to shared memory (a thread 4
//   columns of one row, the row's weights in registers); the column pass
//   gives a thread one output column, its weights in registers, and a
//   warp's stores are one whole 128-byte line of a packed row. The columns
//   of a tile row past the level's last live one are one item of zeros
//   (float4 stores, nothing staged).
// - The tap loops unroll to a compile-time bound (4, 8, 12 or 20 by level)
//   with `if (k < n)`; no index loop divides.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int MAXL = 16;
constexpr int NB = 8;    // source float4 loads a thread keeps in flight

struct Level {
  int tr, tc, lgtc, K, base, rows;
};

struct Params {
  Level lv[MAXL];
  int h, w, wp, cell, pad_left, vec;
  const int* rmeta;
  const int* cmeta;
  // per item two int4: level, first source row, source rows, rmeta offset;
  // first source column, pitch, cmeta offset, first output row << 16 |
  // first output column (level 0: 0, first packed row, rows, ...)
  const int4* records;
};

// 16-byte asynchronous copy of `bytes` (the rest zero-filled)
__device__ __forceinline__ void cp_async16(void* s, const void* g, int bytes) {
  const unsigned sa = (unsigned)__cvta_generic_to_shared(s);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(sa),
               "l"(g), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_commit_wait_all() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Level 0: packed rows [r0, r0 + n) of the edge pad, a float4 a thread.
__device__ void copy_pad(const float* __restrict__ img, const Params& p,
                         int r0, int n, float* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int q4 = p.wp >> 2;
  for (int rr = threadIdx.x >> 5; rr < n; rr += WARPS) {
    const int y = min(max(r0 + rr - p.cell, 0), p.h - 1);
    const float* src = img + (long long)y * p.w;
    float4* dst = reinterpret_cast<float4*>(out + (long long)(r0 + rr) * p.wp);
#pragma unroll 4
    for (int q = lane; q < q4; q += 32) {
      const int x = 4 * q - p.pad_left;
      float4 v;
      if (p.vec && x >= 0 && x + 4 <= p.w) {
        v = __ldg(reinterpret_cast<const float4*>(src + x));
      } else {
        v.x = __ldg(src + min(max(x, 0), p.w - 1));
        v.y = __ldg(src + min(max(x + 1, 0), p.w - 1));
        v.z = __ldg(src + min(max(x + 2, 0), p.w - 1));
        v.w = __ldg(src + min(max(x + 3, 0), p.w - 1));
      }
      dst[q] = v;
    }
  }
}

// 4 floats rounded to bf16 (nearest even), packed as 8 bytes
__device__ __forceinline__ uint2 pack_bf16(float4 v) {
  const __nv_bfloat162 a = __floats2bfloat162_rn(v.x, v.y);
  const __nv_bfloat162 b = __floats2bfloat162_rn(v.z, v.w);
  return make_uint2(*reinterpret_cast<const unsigned*>(&a),
                    *reinterpret_cast<const unsigned*>(&b));
}

__device__ __forceinline__ float lo_bf16(unsigned u) {
  return __uint_as_float(u << 16);
}

__device__ __forceinline__ float hi_bf16(unsigned u) {
  return __uint_as_float(u & 0xffff0000u);
}

__device__ __forceinline__ float4 unpack_bf16(uint2 u) {
  return make_float4(lo_bf16(u.x), hi_bf16(u.x), lo_bf16(u.y), hi_bf16(u.y));
}

template <int K>
__device__ void level_tile(const float* __restrict__ img, const Params& p,
                           const Level& L, int4 tr_, int4 tc_,
                           float* __restrict__ out, float* smem) {
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int r0 = tc_.w >> 16, c0 = tc_.w & 0xffff;
  const int rn = tr_.z;                         // source rows
  const int nr = min(L.tr, L.rows - r0);        // output rows of the tile
  float* ob = out + (long long)(L.base + r0) * p.wp + c0;
  const int pitch = tc_.y;
  if (pitch == 0) {   // the row's columns from c0 on are outside the level
    const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int r = warp; r < nr; r += WARPS)
      for (int q = lane; q < (tc_.x >> 2); q += 32)
        reinterpret_cast<float4*>(ob + (long long)r * p.wp)[q] = z;
    return;
  }
  const int mr = ((2 + K) * L.tr + 3) & ~3;     // words of the row table
  const int mc = ((2 + K) * L.tc + 3) & ~3;
  int* rm = reinterpret_cast<int*>(smem);
  int* cm = rm + mr;
  // the source window and t1 as bf16, 4 values (8 bytes) a unit
  uint2* src = reinterpret_cast<uint2*>(cm + mc);   // [rn][pitch / 4]
  uint2* t1 = src + rn * (pitch >> 2);              // [tr][pitch / 4]
  const int p4 = pitch >> 2;
  // the span tables by cp.async; the window by float4 loads from L2 (the
  // 8.3 MB image stays there across the levels), NB a thread in flight,
  // rounded to bf16 as they land (zeros past the image's right edge)
  for (int i = tid; i < (mr >> 2); i += THREADS)
    cp_async16(rm + 4 * i, p.rmeta + tr_.w + 4 * i, 16);
  for (int i = tid; i < (mc >> 2); i += THREADS)
    cp_async16(cm + 4 * i, p.cmeta + tc_.z + 4 * i, 16);
  {
    // a thread one float4 column q of the window and every rstep-th row,
    // NB rows a batch in flight
    const int rstep = THREADS / p4;             // once an item (p4 <= 256)
    const int phase = tid / p4;
    const int q = tid - phase * p4;
    const int x = tc_.x + 4 * q;
    const float* g = img + (long long)tr_.y * p.w + x;
    if (phase < rstep) {
      for (int r = phase; r < rn; r += NB * rstep) {
        float4 v[NB];
#pragma unroll
        for (int b = 0; b < NB; ++b) {
          const int rr = r + b * rstep;
          const float* gr = g + (long long)rr * p.w;
          v[b] = make_float4(0.f, 0.f, 0.f, 0.f);
          if (rr < rn) {
            if (p.vec) {
              if (x < p.w) v[b] = __ldg(reinterpret_cast<const float4*>(gr));
            } else {
              if (x < p.w) v[b].x = __ldg(gr);
              if (x + 1 < p.w) v[b].y = __ldg(gr + 1);
              if (x + 2 < p.w) v[b].z = __ldg(gr + 2);
              if (x + 3 < p.w) v[b].w = __ldg(gr + 3);
            }
          }
        }
#pragma unroll
        for (int b = 0; b < NB; ++b)
          if (r + b * rstep < rn)
            src[(r + b * rstep) * p4 + q] = pack_bf16(v[b]);
      }
    }
  }
  cp_commit_wait_all();
  __syncthreads();
  // row pass: t1[r][:] = bf16(sum_k w_r[k] * src[off_r + k][:])
  for (int r = warp; r < nr; r += WARPS) {
    const int off = rm[r];
    const int n = rm[L.tr + r];
    float wk[K];
#pragma unroll
    for (int k = 0; k < K; ++k) wk[k] = __int_as_float(rm[(2 + k) * L.tr + r]);
    for (int q = lane; q < p4; q += 32) {
      float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int k = 0; k < K; ++k) {
        if (k < n) {
          const float4 u = unpack_bf16(src[(off + k) * p4 + q]);
          acc.x = fmaf(wk[k], u.x, acc.x);
          acc.y = fmaf(wk[k], u.y, acc.y);
          acc.z = fmaf(wk[k], u.z, acc.z);
          acc.w = fmaf(wk[k], u.w, acc.w);
        }
      }
      t1[r * p4 + q] = pack_bf16(acc);
    }
  }
  __syncthreads();
  // column pass: a thread one output column, THREADS / tc rows at a time
  const int c = tid & (L.tc - 1);
  if (c0 + c >= p.wp) return;
  const int off = cm[c];
  const int n = cm[L.tc + c];
  float wk[K];
#pragma unroll
  for (int k = 0; k < K; ++k) wk[k] = __int_as_float(cm[(2 + k) * L.tc + c]);
  const unsigned short* t1h = reinterpret_cast<const unsigned short*>(t1);
#pragma unroll 4
  for (int r = tid >> L.lgtc; r < nr; r += THREADS >> L.lgtc) {
    const unsigned short* row = t1h + r * pitch + off;
    float acc = 0.f;
#pragma unroll
    for (int k = 0; k < K; ++k)
      if (k < n) acc = fmaf(__uint_as_float((unsigned)row[k] << 16), wk[k],
                            acc);
    ob[(long long)r * p.wp + c] = acc;
  }
}

__global__ void __launch_bounds__(THREADS, 4)
    flatpyr_kernel(const float* __restrict__ img, float* __restrict__ out,
                   const __grid_constant__ Params p) {
  extern __shared__ float4 smem4[];
  // the item's record: tr_ = level, source rows and row table; tc_ =
  // source columns, column table and the output tile's corner
  const int4 tr_ = __ldg(p.records + 2 * blockIdx.x);
  const int4 tc_ = __ldg(p.records + 2 * blockIdx.x + 1);
  if (tr_.x == 0) {
    copy_pad(img, p, tr_.y, tr_.z, out);
    return;
  }
  const Level& L = p.lv[tr_.x];
  float* smem = reinterpret_cast<float*>(smem4);
  switch (L.K) {
    case 4: level_tile<4>(img, p, L, tr_, tc_, out, smem); break;
    case 8: level_tile<8>(img, p, L, tr_, tc_, out, smem); break;
    case 12: level_tile<12>(img, p, L, tr_, tc_, out, smem); break;
    default: level_tile<20>(img, p, L, tr_, tc_, out, smem); break;
  }
}

}  // namespace

// Resident blocks of the kernel on one SM with `smem` bytes of dynamic
// shared memory each (registers included), or -1 on an error.
extern "C" int flatpyr_occupancy(int smem) {
  if (cudaFuncSetAttribute(flatpyr_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           smem) != cudaSuccess)
    return -1;
  int blocks = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &blocks, flatpyr_kernel, THREADS, smem) != cudaSuccess)
    return -1;
  return blocks;
}

// img: [h, w] f32 contiguous; out: the packed [rows, wp] f32 buffer. levels
// (host): [MAXL][6] tile rows, tile columns, log2 tile columns, tap bound,
// first packed row, rows (level 0 unused); the plan's tables on the device
// (ops/features/flatpyr.py kernel_plan); one block an item.
extern "C" int flatpyr_launch(const float* img, int h, int w,
                              const int* levels, int wp, int cell,
                              int pad_left, const int* rmeta,
                              const int* cmeta, const int* records,
                              int n_items, int smem, float* out,
                              void* stream) {
  cudaError_t e = cudaFuncSetAttribute(
      flatpyr_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  Params p;
  for (int l = 0; l < MAXL; ++l) {
    const int* d = levels + 6 * l;
    p.lv[l] = Level{d[0], d[1], d[2], d[3], d[4], d[5]};
  }
  p.h = h;
  p.w = w;
  p.wp = wp;
  p.cell = cell;
  p.pad_left = pad_left;
  p.vec = (w % 4 == 0) && (pad_left % 4 == 0) && ((uintptr_t)img % 16 == 0);
  p.rmeta = rmeta;
  p.cmeta = cmeta;
  p.records = reinterpret_cast<const int4*>(records);
  flatpyr_kernel<<<n_items, THREADS, smem, (cudaStream_t)stream>>>(img, out,
                                                                   p);
  return (int)cudaGetLastError();
}
