// K3: tiled shear-decomposed homography warp (the mosaic feed's warp).
//
// Replaces pislamfusion_tpu/ops/shearwarp.py warp_patch_pallas
// (pallas_call at :505).
//
// Per T-px destination tile t with window-local affine (a00, a01, tx,
// a10, a11, ty), window origin (wy, wx) and liveness, each output pixel is
// the two-pass (Catmull-Smith) resample of the TPU kernel:
//   I[v, x]   = sum_j w1_j(v, x) * win[(m1(v) + j + n1(x)) mod WH, x]
//   out[v, u] = sum_i w2_i(v, u) * I[v, (m2(u) + i + n2(v)) mod WW]
// where win[r, c] = src[min(wy + r, sh-1), min(wx + c, sw-1)] and src is the
// image or, when *transpose is set, its transpose (read in place). Phases
// and tent weights follow shearwarp._pass_phases / _tap_weights; m is
// clipped to [0, W-3] and shears wrap around the window as the TPU kernel's
// roll network does. Dead tiles are written as exact zeros.
//
// Bound on the H100: bytes (the source read once, the patch written once).
// At the feed's shapes a live strip's dependent steps bound it instead:
// a third of the tiles are live. One block of 8 warps takes a strip of
// R = 4 output rows of one tile, with one barrier between pass 1 and pass
// 2 (three on the transposed path):
//   - a dead tile's strip writes its zeros with 16-byte stores and exits
//     (its parameters are read before the liveness test, so the loads
//     overlap);
//   - every thread computes the tile's constants (alpha, beta, gamma,
//     the biases) and the strip's limits alike, with no barrier to wait
//     on: the per-row phases m1, g1, n2 for each of its rows, the
//     per-column phases n1(x), f1(x) where it uses them;
//   - pass 1 computes each I[v, x] that the strip's outputs read once,
//     into shared memory (row v's columns m2(0) + n2(v) .. m2(T-1) + 2 +
//     n2(v), at most WW of them), its phases where it uses them. The
//     plain orientation maps a thread to a window column x of every row,
//     so lanes read neighbouring source pixels of one source row, RB
//     rows' reads in flight. The transposed one reads the source along
//     its rows too: for each window column x the strip reads, a warp
//     stages the segment of the source row wx + x that the strip's rows
//     read (the L window rows from m1 of its first row, plus the 3 taps)
//     into shared memory: a thread an x records where its run starts,
//     then the block copies all runs with flat, coalesced reads, NS a
//     thread in flight; after a barrier the threads combine the taps from
//     there. A strip whose segments do not fit beside I takes the plain
//     orientation's path (strided reads);
//   - pass 2: a warp per row, 4 output pixels a lane, 3 reads of I each,
//     written as C 16-byte stores.
// The wrapped indices take a compare-and-add wrap where the strip's
// limits prove them within one period of the range (checked once a
// strip), else the true modulo. Every product and sum is rounded on its
// own (__fmul_rn / __fadd_rn, never contracted into an FMA), in the order
// of the plain PyTorch version's separate tensor ops: the phases feed
// floor(), so one contracted FMA can move a tap by a rounding step, and on
// sharp edges that alone showed as 8.6e-3 gray between kernel and plain
// version. Each I[v, x] and each output take the same operations in the
// same order as when every output evaluated its own three I values.
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int R = 4;                 // output rows a block
constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int RB = 2;                // rows whose reads a thread has in flight
constexpr int SMEM = 13824;          // floats of shared memory a block
constexpr int NS = 4;                // staged reads a thread has in flight

__device__ __forceinline__ int wrap_mod(int a, int n) {
  int r = a % n;
  return r < 0 ? r + n : r;
}

// a mod n for a in [-n, 2n)
__device__ __forceinline__ int wrap_near(int a, int n) {
  return a < 0 ? a + n : (a >= n ? a - n : a);
}

template <bool NEAR>
__device__ __forceinline__ int wrapn(int a, int n) {
  return NEAR ? wrap_near(a, n) : wrap_mod(a, n);
}

__device__ __forceinline__ void tent(float gf, float w[3]) {
  w[0] = fmaxf(0.f, 1.f - gf);
  w[1] = 1.f - fabsf(gf - 1.f);
  w[2] = fmaxf(0.f, gf - 1.f);
}

// resample phase at output index i of slope p: m (clipped to [0, n-3]), g
__device__ __forceinline__ int resample_m(float slope, float bias, int i,
                                          int n, float& g) {
  const float pv = __fmul_rn(slope, (float)i);
  g = pv - floorf(pv);
  return min(max((int)(floorf(pv) + bias), 0), n - 3);
}

// shear phase at index i: the integer part, and its fraction in f
__device__ __forceinline__ int shear_n(float slope, float off, float bias,
                                       int i, float& f) {
  const float sx = __fsub_rn(__fadd_rn(__fmul_rn(slope, (float)i), off),
                             bias);
  const float fl = floorf(sx);
  f = sx - fl;
  return (int)fl;
}

// I[r][c][k] at r * C * P + c * P + k + (k >> 5): one padding word every
// 32 keeps pass 2's lanes (k about 4 * |a00| apart) on distinct banks
__device__ __forceinline__ int pad(int k) { return k + (k >> 5); }

// The strip's constants, which every thread computes alike (no barrier
// waits for them): the tile's (alpha, beta, gamma, the biases), and the
// strip's limits. m2 and n2 are monotone in u and v, so their ends bound
// them: row v reads window columns X = m2lo + n2(v) + k, 0 <= k < span,
// before the wrap, all within [xmin, xmin + xlen).
struct Strip {
  float a00, a01, tx, alpha, beta, gamma, bias1, bias2;
  int m2lo, span, xmin, xlen, m1lo, m1hi;
  bool near;           // every wrapped index proven within one period
};

__device__ __forceinline__ Strip strip_of(const float* a, int v0, int T,
                                          int WH, int WW) {
  Strip s;
  const float a00 = a[0], a01 = a[1], tx = a[2], a10 = a[3], a11 = a[4],
              ty = a[5];
  const float safe = fabsf(a00) < 1e-6f ? 1e-6f : a00;
  s.a00 = a00;
  s.a01 = a01;
  s.tx = tx;
  s.alpha = a10 / safe;
  s.beta = __fsub_rn(__fmul_rn(a00, a11), __fmul_rn(a01, a10)) / safe;
  s.gamma = __fsub_rn(ty, __fmul_rn(s.alpha, tx));
  const float tm1 = (float)(T - 1);
  // the biases keep m >= 0
  s.bias1 = ceilf(fmaxf(0.f, -fminf(0.f, __fmul_rn(s.beta, tm1))));
  s.bias2 = ceilf(fmaxf(0.f, -fminf(0.f, __fmul_rn(a00, tm1))));
  float g;
  const int m2a = resample_m(a00, s.bias2, 0, WW, g);
  const int m2b = resample_m(a00, s.bias2, T - 1, WW, g);
  s.m2lo = min(m2a, m2b);
  s.span = max(m2a, m2b) - s.m2lo + 3;
  const int n2a = shear_n(a01, tx, s.bias2, v0, g);
  const int n2b = shear_n(a01, tx, s.bias2, v0 + R - 1, g);
  s.xmin = s.m2lo + min(n2a, n2b);
  s.xlen = s.m2lo + s.span - 1 + max(n2a, n2b) - s.xmin + 1;
  const int m1a = resample_m(s.beta, s.bias1, v0, WH, g);
  const int m1b = resample_m(s.beta, s.bias1, v0 + R - 1, WH, g);
  s.m1lo = min(m1a, m1b);
  s.m1hi = max(m1a, m1b);
  // the wraps take a compare-and-add where [xmin, xmin + xlen) lies
  // within one period of [0, WW) and the window rows m1 + j + n1(x) within
  // one period of [0, WH); n1 is monotone in x, so its values at the ends
  // of each unwrapped run of window columns bound it
  s.near = false;
  if (s.xmin >= -WW && s.xmin + s.xlen - 1 < 2 * WW) {
    int xe[4], ne = 2;
    if (s.xlen >= WW) {
      xe[0] = 0;
      xe[1] = WW - 1;
    } else {
      xe[0] = wrap_near(s.xmin, WW);
      xe[1] = wrap_near(s.xmin + s.xlen - 1, WW);
      if (xe[1] < xe[0]) {            // the run wraps: [xa, WW) and [0, xb]
        xe[2] = 0;
        xe[3] = WW - 1;
        ne = 4;
      }
    }
    int lo = INT_MAX, hi = INT_MIN;
    for (int i = 0; i < ne; ++i) {
      const int n1 = shear_n(s.alpha, s.gamma, s.bias1, xe[i], g);
      lo = min(lo, n1);
      hi = max(hi, n1);
    }
    s.near = s.m1lo + lo >= -WH && s.m1hi + 2 + hi < 2 * WH;
  }
  return s;
}

// Pass 1 of a strip: I[v, x] once each, its phases computed where they
// are used. NEAR: the strip's limits put every wrapped index within one
// period (else the true modulo). The source's pixel (row, col) of the
// window's orientation is at row * rstride + col * cstride. S: room for
// `room` floats of staged source segments.
template <int C, bool NEAR>
__device__ __forceinline__ void pass1(const Strip& s, const float* img,
                                      int v0, int wy, int wx, int sh, int sw,
                                      int rstride, int cstride, bool tr,
                                      int WH, int WW, float* I, int P,
                                      float* S, int room) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int L = s.m1hi - s.m1lo + 3;   // window rows a column's strip reads
  const int sp = (L * C) | 1;          // a segment's pitch in S (odd)
  int m1[R], xlo[R];
  float g1[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    float f2;
    m1[r] = resample_m(s.beta, s.bias1, v0 + r, WH, g1[r]);
    xlo[r] = s.m2lo + shear_n(s.a01, s.tx, s.bias2, v0 + r, f2);
  }
  if (tr && s.xlen * sp + 2 * s.xlen <= room) {
    // transposed: the source's rows are the window's columns. For each
    // window column x the strip reads (X = xmin + i), its segment is the L
    // window rows m1lo + n1(x) + e of source row wx + x: one run of L * C
    // floats unless a wrap or the clamp at the source's edge falls inside
    // it. A thread an X records the run's start (or -1 - x) and f1(x);
    // then the block stages every run into S with flat, coalesced reads,
    // NS a thread in flight; then a thread a window column k of every row
    // combines the taps from S.
    int* run = reinterpret_cast<int*>(S + s.xlen * sp);   // [xlen]
    float* ph = S + s.xlen * sp + s.xlen;                   // [xlen] f1
    for (int i = threadIdx.x; i < s.xlen; i += THREADS) {
      const int x = wrapn<NEAR>(s.xmin + i, WW);
      const int row0 = s.m1lo + shear_n(s.alpha, s.gamma, s.bias1, x, ph[i]);
      run[i] = NEAR && row0 >= 0 && row0 + L <= WH && wy + row0 + L <= sh
                   ? (min(wx + x, sw - 1) * cstride + wy + row0) * C
                   : -1 - x;
    }
    __syncthreads();  // runs recorded
    const int LC = L * C, n = s.xlen * LC;
    const unsigned magic = 0xffffffffu / (unsigned)LC + 1u;  // ceil(2^32/LC)
    for (int i0 = threadIdx.x; i0 < n; i0 += NS * THREADS) {
      float v[NS];
#pragma unroll
      for (int q = 0; q < NS; ++q) {
        const int idx = i0 + q * THREADS;
        const int i = (int)__umulhi((unsigned)idx, magic);   // idx / LC
        const int f = idx - i * LC;
        int at = -1;
        if (idx < n) {
          at = run[i];
          if (at < 0) {          // a wrap or the clamp inside the run
            const int x = -1 - at, e = f / C;
            float f1;
            const int n1 = shear_n(s.alpha, s.gamma, s.bias1, x, f1);
            at = (min(wx + x, sw - 1) * cstride +
                  min(wy + wrapn<NEAR>(s.m1lo + n1 + e, WH), sh - 1)) * C -
                 e * C;
          }
        }
        v[q] = idx < n ? __ldg(img + at + f) : 0.f;
      }
#pragma unroll
      for (int q = 0; q < NS; ++q) {
        const int idx = i0 + q * THREADS;
        if (idx < n) {
          const int i = (int)__umulhi((unsigned)idx, magic);
          S[i * sp + idx - i * LC] = v[q];
        }
      }
    }
    __syncthreads();  // segments staged
    for (int k = threadIdx.x; k < s.span; k += THREADS) {
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int i = xlo[r] + k - s.xmin;
        float w1[3];
        tent(g1[r] + ph[i], w1);
        const float* seg = S + i * sp + (m1[r] - s.m1lo) * C;
#pragma unroll
        for (int c = 0; c < C; ++c) {
          float iv = 0.f;
#pragma unroll
          for (int j = 0; j < 3; ++j)
            iv = __fadd_rn(iv, __fmul_rn(w1[j], seg[j * C + c]));
          I[(r * C + c) * P + pad(k)] = iv;
        }
      }
    }
    return;
  }
  // lanes along x: a thread takes column k of every row of the strip, RB
  // rows' 3 x C source reads issued before any is combined. The 3 taps
  // are consecutive window rows unless the wrap or the clamp at the
  // source's edge falls between them.
  for (int k = threadIdx.x; k < s.span; k += THREADS) {
#pragma unroll
    for (int r0 = 0; r0 < R; r0 += RB) {
      int pix[RB][3];
      float w1[RB][3];
#pragma unroll
      for (int b = 0; b < RB; ++b) {
        const int r = r0 + b;
        const int x = wrapn<NEAR>(xlo[r] + k, WW);
        float f1;
        const int row0 = m1[r] + shear_n(s.alpha, s.gamma, s.bias1, x, f1);
        const int ct = min(wx + x, sw - 1) * cstride;
        tent(g1[r] + f1, w1[b]);
        if (NEAR && row0 >= 0 && row0 + 2 < WH && wy + row0 + 2 < sh) {
          pix[b][0] = ((wy + row0) * rstride + ct) * C;
          pix[b][1] = pix[b][0] + rstride * C;
          pix[b][2] = pix[b][1] + rstride * C;
        } else {
#pragma unroll
          for (int j = 0; j < 3; ++j)
            pix[b][j] =
                (min(wy + wrapn<NEAR>(row0 + j, WH), sh - 1) * rstride +
                 ct) * C;
        }
      }
      float val[RB][3][C];
#pragma unroll
      for (int b = 0; b < RB; ++b)
#pragma unroll
        for (int j = 0; j < 3; ++j)
#pragma unroll
          for (int c = 0; c < C; ++c)
            val[b][j][c] = __ldg(img + pix[b][j] + c);
#pragma unroll
      for (int b = 0; b < RB; ++b)
#pragma unroll
        for (int c = 0; c < C; ++c) {
          float iv = 0.f;
#pragma unroll
          for (int j = 0; j < 3; ++j)
            iv = __fadd_rn(iv, __fmul_rn(w1[b][j], val[b][j][c]));
          I[((r0 + b) * C + c) * P + pad(k)] = iv;
        }
    }
  }
}

template <int C>
__global__ void __launch_bounds__(THREADS)
    shearwarp_kernel(const float* __restrict__ img, int H, int W,
                     const int* __restrict__ transpose,
                     const float* __restrict__ affine,
                     const int* __restrict__ window,
                     const int* __restrict__ live, int pw, int T, int WH,
                     int WW, float* __restrict__ out) {
  extern __shared__ float smem[];                   // SMEM floats
  const int ntx = pw / T, spt = T / R;              // strips a tile
  const int t = blockIdx.x / spt, v0 = (blockIdx.x - t * spt) * R;
  const int ty = t / ntx;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long pitch = (long long)pw * C;        // floats an output row
  float* orow0 = out + (long long)(ty * T + v0) * pitch +
                 (long long)(t - ty * ntx) * T * C;
  // the tile's parameters are read with its liveness, so that the loads
  // overlap; a dead tile ignores them
  const int is_live = live[t];
  const float* a = affine + 6 * t;
  float av[6];
#pragma unroll
  for (int i = 0; i < 6; ++i) av[i] = __ldg(a + i);
  const int wy = window[2 * t], wx = window[2 * t + 1];
  const bool tr = transpose[0] != 0;
  if (is_live == 0) {
    const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int i = threadIdx.x; i < R * T * C / 4; i += THREADS) {
      const int r = i / (T * C / 4);
      reinterpret_cast<float4*>(orow0 + r * pitch)[i - r * (T * C / 4)] = z;
    }
    return;
  }
  const int sh = tr ? W : H;
  const int sw = tr ? H : W;
  const Strip s = strip_of(av, v0, T, WH, WW);
  // I [R, C, P] at the strip's padded span (at most the window's width,
  // which SMEM holds at C <= 4), then the transposed path's staging
  const int P = s.span + (s.span >> 5) + 1;
  float* I = smem;
  float* S = smem + R * C * P;
  // ---- pass 1: I[v, x] once each; the wraps' branch is taken once here
  const int rstride = tr ? 1 : W, cstride = tr ? W : 1;
  if (s.near)
    pass1<C, true>(s, img, v0, wy, wx, sh, sw, rstride, cstride, tr, WH, WW,
                   I, P, S, SMEM - R * C * P);
  else
    pass1<C, false>(s, img, v0, wy, wx, sh, sw, rstride, cstride, tr, WH,
                    WW, I, P, S, SMEM - R * C * P);
  __syncthreads();  // pass 1 done
  // ---- pass 2: a warp a row, 4 pixels a lane, C 16-byte stores
  for (int r = warp; r < R; r += WARPS) {
    float f2;
    shear_n(s.a01, s.tx, s.bias2, v0 + r, f2);
    const float* Ir = I + r * C * P;
    float4* orow = reinterpret_cast<float4*>(orow0 + r * pitch);
    for (int u0 = lane * 4; u0 < T; u0 += 128) {
      float o[4 * C];
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        float g2;
        const int kk = resample_m(s.a00, s.bias2, u0 + p, WW, g2) - s.m2lo;
        float w2[3];
        tent(f2 + g2, w2);
#pragma unroll
        for (int c = 0; c < C; ++c) {
          float acc = 0.f;
#pragma unroll
          for (int i = 0; i < 3; ++i)
            acc = __fadd_rn(acc, __fmul_rn(w2[i], Ir[c * P + pad(kk + i)]));
          o[p * C + c] = acc;
        }
      }
#pragma unroll
      for (int q = 0; q < C; ++q)
        orow[u0 * C / 4 + q] =
            make_float4(o[4 * q], o[4 * q + 1], o[4 * q + 2], o[4 * q + 3]);
    }
  }
}

// Raise the kernel's dynamic shared-memory limit once for each larger size
// (the default 48 KB counts the static shared memory too), per device and channel count.
template <int C>
int set_smem(int smem) {
  static int done[64];
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64)
    return (int)cudaErrorInvalidDevice;
  if (smem <= done[dev]) return 0;
  const cudaError_t e = cudaFuncSetAttribute(
      shearwarp_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (e == cudaSuccess) done[dev] = smem;
  return (int)e;
}

template <int C>
int occupancy(int smem) {
  if (set_smem<C>(smem) != 0) return -1;
  int blocks = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &blocks, shearwarp_kernel<C>, THREADS, smem) != cudaSuccess)
    return -1;
  return blocks;
}

template <int C>
int launch(const float* img, int H, int W, const int* transpose,
           const float* affine, const int* window, const int* live, int ph,
           int pw, int T, int WH, int WW, int smem, float* out,
           cudaStream_t stream) {
  const int e = set_smem<C>(smem);
  if (e != 0) return e;
  const int blocks = (ph / T) * (pw / T) * (T / R);
  shearwarp_kernel<C><<<blocks, THREADS, smem, stream>>>(
      img, H, W, transpose, affine, window, live, pw, T, WH, WW, out);
  return (int)cudaGetLastError();
}

}  // namespace

// Dynamic shared memory of a block: SMEM floats, which hold I of R rows x
// C channels at the window's padded width (else -1), and with I at a
// strip's own span the transposed path's staged segments.
extern "C" int shearwarp_smem(int C, int WW) {
  const int P = WW + (WW >> 5) + 1;
  return R * C * P <= SMEM ? SMEM * (int)sizeof(float) : -1;
}

// Resident blocks an SM at that shared memory (registers included), or -1.
extern "C" int shearwarp_occupancy(int C, int WW) {
  const int smem = shearwarp_smem(C, WW);
  if (smem < 0) return -1;
  switch (C) {
    case 1: return occupancy<1>(smem);
    case 2: return occupancy<2>(smem);
    case 3: return occupancy<3>(smem);
    case 4: return occupancy<4>(smem);
    default: return -1;
  }
}

// img: [H, W, C] f32 contiguous (C = 1..4); out: [ph, pw, C] f32. Needs
// T % R == 0 and T % 4 == 0 (the wrapper checks).
extern "C" int shearwarp_launch(const float* img, int H, int W, int C,
                                const int* transpose, const float* affine,
                                const int* window, const int* live, int ph,
                                int pw, int tile, int WH, int WW,
                                float* out, void* stream) {
  if (tile % R || tile % 4 || ph % tile || pw % tile)
    return (int)cudaErrorInvalidValue;
  const int smem = shearwarp_smem(C, WW);
  if (smem < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (C) {
    case 1:
      return launch<1>(img, H, W, transpose, affine, window, live, ph, pw,
                       tile, WH, WW, smem, out, s);
    case 2:
      return launch<2>(img, H, W, transpose, affine, window, live, ph, pw,
                       tile, WH, WW, smem, out, s);
    case 3:
      return launch<3>(img, H, W, transpose, affine, window, live, ph, pw,
                       tile, WH, WW, smem, out, s);
    case 4:
      return launch<4>(img, H, W, transpose, affine, window, live, ph, pw,
                       tile, WH, WW, smem, out, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
