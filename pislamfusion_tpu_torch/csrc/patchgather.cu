// K2: edge-clamped square patches around integer centers.
//
// Replaces pislamfusion_tpu/ops/features/patchgather.py
// gather_patches_pallas (pallas_call at :148).
//
// out[n, i, j, c] = img[clamp(y_n - r + i, 0, H-1), clamp(x_n - r + j, 0, W-1), c]
//
// Bound on the H100: bytes (an exact copy, no arithmetic). The TPU kernel
// DMA'd aligned slabs and selected each patch with one-hot MXU matmuls;
// here one thread writes one output word, so consecutive threads write
// consecutive addresses and read consecutive pixels of one patch row.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void patchgather_kernel(const float* __restrict__ img, int H,
                                   int W, int C,
                                   const int* __restrict__ xy, int N, int r,
                                   float* __restrict__ out) {
  const int G = 2 * r + 1;
  const long long total = (long long)N * G * G * C;
  for (long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       e < total; e += (long long)gridDim.x * blockDim.x) {
    long long q = e;
    const int c = (int)(q % C);
    q /= C;
    const int j = (int)(q % G);
    q /= G;
    const int i = (int)(q % G);
    const int n = (int)(q / G);
    int y = xy[2 * n + 1] - r + i;
    int x = xy[2 * n] - r + j;
    y = min(max(y, 0), H - 1);
    x = min(max(x, 0), W - 1);
    out[e] = img[((long long)y * W + x) * C + c];
  }
}

}  // namespace

extern "C" int patchgather_launch(const float* img, int H, int W, int C,
                                  const int* xy, int N, int r, float* out,
                                  void* stream) {
  const int G = 2 * r + 1;
  const long long total = (long long)N * G * G * C;
  const int threads = 256;
  long long blocks = (total + threads - 1) / threads;
  if (blocks > 65535LL * 32) blocks = 65535LL * 32;
  patchgather_kernel<<<(unsigned)blocks, threads, 0,
                       (cudaStream_t)stream>>>(img, H, W, C, xy, N, r, out);
  return (int)cudaGetLastError();
}
