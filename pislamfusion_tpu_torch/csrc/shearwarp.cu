// K3: tiled shear-decomposed homography warp (the mosaic feed's warp).
//
// Replaces pislamfusion_tpu/ops/shearwarp.py warp_patch_pallas
// (pallas_call at :505).
//
// Per 128-px destination tile t with window-local affine (a00, a01, tx,
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
// Bound on the H100: bytes (a 768^2 x 3 patch from a 540x960x3 source moves
// ~13 MB; ~30 flops per output value). The TPU kernel built the shears from
// log-depth roll networks and the resamples from one-hot MXU matmuls
// because a TPU cannot gather; here each thread evaluates its pixel
// directly: the 3 pass-2 columns, the 3x3 window rows they need and their
// weights once, then 9 reads per channel, served from L2 (the source is
// 6 MB).
//
// Every product and sum is rounded on its own (__fmul_rn / __fadd_rn, which
// nvcc never contracts into an FMA), in the order of the plain PyTorch
// version's separate tensor ops: the phases feed floor(), so one contracted
// FMA can move a tap by a rounding step, and on sharp edges that alone
// showed as 8.6e-3 gray between kernel and plain version.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ int wrap(int a, int n) {
  int r = a % n;
  return r < 0 ? r + n : r;
}

__device__ __forceinline__ void tent(float gf, float w[3]) {
  w[0] = fmaxf(0.f, 1.f - gf);
  w[1] = 1.f - fabsf(gf - 1.f);
  w[2] = fmaxf(0.f, gf - 1.f);
}

__global__ void shearwarp_kernel(const float* __restrict__ img, int H,
                                 int W, int C,
                                 const int* __restrict__ transpose,
                                 const float* __restrict__ affine,
                                 const int* __restrict__ window,
                                 const int* __restrict__ live, int ph,
                                 int pw, int T, int WH, int WW,
                                 float* __restrict__ out) {
  const int U = blockIdx.x * blockDim.x + threadIdx.x;
  const int V = blockIdx.y * blockDim.y + threadIdx.y;
  if (U >= pw || V >= ph) return;
  const int ntx = pw / T;
  const int t = (V / T) * ntx + U / T;
  float* o = out + ((long long)V * pw + U) * C;
  if (live[t] == 0) {
    for (int c = 0; c < C; ++c) o[c] = 0.f;
    return;
  }
  const bool tr = transpose[0] != 0;
  const int sh = tr ? W : H;
  const int sw = tr ? H : W;
  const float* a = affine + 6 * t;
  const float a00 = a[0], a01 = a[1], tx = a[2], a10 = a[3], a11 = a[4],
              ty = a[5];
  const int wy = window[2 * t], wx = window[2 * t + 1];
  const float safe = fabsf(a00) < 1e-6f ? 1e-6f : a00;
  const float alpha = a10 / safe;
  const float beta = __fsub_rn(__fmul_rn(a00, a11), __fmul_rn(a01, a10)) / safe;
  const float gamma = __fsub_rn(ty, __fmul_rn(alpha, tx));
  const float v = (float)(V % T);
  const float u = (float)(U % T);
  const float tm1 = (float)(T - 1);
  // pass 1 resample phase of output row v (the bias keeps m >= 0)
  const float bias1 = ceilf(fmaxf(0.f, -fminf(0.f, __fmul_rn(beta, tm1))));
  const float pv1 = __fmul_rn(beta, v);
  const int m1 = min(max((int)(floorf(pv1) + bias1), 0), WH - 3);
  const float g1 = pv1 - floorf(pv1);
  // pass 2 phases: resample at column u, shear at row v
  const float bias2 = ceilf(fmaxf(0.f, -fminf(0.f, __fmul_rn(a00, tm1))));
  const float pv2 = __fmul_rn(a00, u);
  const int m2 = min(max((int)(floorf(pv2) + bias2), 0), WW - 3);
  const float g2 = pv2 - floorf(pv2);
  const float sx2 = __fsub_rn(__fadd_rn(__fmul_rn(a01, v), tx), bias2);
  const float fl2 = floorf(sx2);
  const int n2 = (int)fl2;
  float w2[3];
  tent((sx2 - fl2) + g2, w2);
  // the 3x3 source pixels this output reads and their pass-1 weights
  long long pix[3][3];
  float w1[3][3];
  for (int i = 0; i < 3; ++i) {
    const int x = wrap(m2 + i + n2, WW);
    const float sx1 =
        __fsub_rn(__fadd_rn(__fmul_rn(alpha, (float)x), gamma), bias1);
    const float fl1 = floorf(sx1);
    const int n1 = (int)fl1;
    tent(g1 + (sx1 - fl1), w1[i]);
    const int sc = min(wx + x, sw - 1);
    for (int j = 0; j < 3; ++j) {
      const int sr = min(wy + wrap(m1 + j + n1, WH), sh - 1);
      pix[i][j] = (tr ? (long long)sc * W + sr : (long long)sr * W + sc) * C;
    }
  }
  for (int c = 0; c < C; ++c) {
    float acc = 0.f;
    for (int i = 0; i < 3; ++i) {
      float iv = 0.f;
      for (int j = 0; j < 3; ++j)
        iv = __fadd_rn(iv, __fmul_rn(w1[i][j], img[pix[i][j] + c]));
      acc = __fadd_rn(acc, __fmul_rn(w2[i], iv));
    }
    o[c] = acc;
  }
}

}  // namespace

extern "C" int shearwarp_launch(const float* img, int H, int W, int C,
                                const int* transpose, const float* affine,
                                const int* window, const int* live, int ph,
                                int pw, int tile, int WH, int WW, float* out,
                                void* stream) {
  dim3 block(32, 8);
  dim3 grid((pw + 31) / 32, (ph + 7) / 8);
  shearwarp_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      img, H, W, C, transpose, affine, window, live, ph, pw, tile, WH, WW,
      out);
  return (int)cudaGetLastError();
}
