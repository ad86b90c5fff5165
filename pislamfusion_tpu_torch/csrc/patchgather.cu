// K2: edge-clamped square patches around integer centers.
//
// Replaces pislamfusion_tpu/ops/features/patchgather.py
// gather_patches_pallas (pallas_call at :148).
//
// out[n, i, j] = img[clamp(y_n - r + i, 0, H-1), clamp(x_n - r + j, 0, W-1)]
//
// Bound on the H100: bytes (an exact copy, no arithmetic). The TPU kernel
// DMA'd aligned slabs and selected each patch with one-hot MXU matmuls.
// Here one block copies one patch, its centre read once, at ORB's shape
// (G = 43, C = 1, a compile-time instantiation; the wrapper raises on
// others): a warp a source row, lanes along it (coalesced), into shared
// memory at the patch's own offset past a 16-byte boundary; then the
// patch's span (1849 words, so patch n starts n mod 4 words past a
// boundary) goes out as scalar head words, 16-byte body stores read
// aligned from shared memory, and scalar tail words. No index divides.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;

template <int G>
__global__ void __launch_bounds__(THREADS)
    patchgather_kernel(const float* __restrict__ img, int H, int W,
                       const int* __restrict__ xy,
                       float* __restrict__ out) {
  constexpr int R = G / 2;
  constexpr int WORDS = G * G;
  __shared__ __align__(16) float s[WORDS + 3];
  const int n = blockIdx.x;
  const int x0 = __ldg(xy + 2 * n) - R;
  const int y0 = __ldg(xy + 2 * n + 1) - R;
  float* dst = out + (long long)n * WORDS;
  // words from the last 16-byte boundary to the patch's first word; word e
  // of the patch sits at s[phase + e], so the boundaries line up
  const int phase = (int)((reinterpret_cast<uintptr_t>(dst) >> 2) & 3);
  const int lane = threadIdx.x & 31;
  for (int i = threadIdx.x >> 5; i < G; i += WARPS) {
    const float* row = img + (long long)min(max(y0 + i, 0), H - 1) * W;
#pragma unroll
    for (int j = lane; j < G; j += 32)
      s[phase + i * G + j] = __ldg(row + min(max(x0 + j, 0), W - 1));
  }
  __syncthreads();
  const int head = (4 - phase) & 3;
  const int nvec = (WORDS - head) >> 2;
  const int tail = head + 4 * nvec;           // first word of the tail
  const int t = threadIdx.x;
  if (t < head) dst[t] = s[phase + t];
  if (t < WORDS - tail) dst[tail + t] = s[phase + tail + t];
  const float4* s4 = reinterpret_cast<const float4*>(s + phase + head);
  float4* d4 = reinterpret_cast<float4*>(dst + head);
#pragma unroll 4
  for (int k = t; k < nvec; k += THREADS) d4[k] = s4[k];
}

}  // namespace

// img: [H, W] f32; xy: [N, 2] int32 (x, y); out: [N, 43, 43] f32; one
// block a patch.
extern "C" int patchgather_launch(const float* img, int H, int W,
                                  const int* xy, int N, float* out,
                                  void* stream) {
  patchgather_kernel<43><<<N, THREADS, 0, (cudaStream_t)stream>>>(
      img, H, W, xy, out);
  return (int)cudaGetLastError();
}
