// Across-channel local response normalization, NHWC — the Norm module (paper
// Table III, 'LRN').
//
// Replaces: src/repro/kernels/lrn.py lrn_pallas (body _lrn_kernel):
//     y = x / (k + alpha/n * sum_{n channels around c} x^2) ^ beta
// with the channel window zero-padded at the edges (lrn.py:28-31), computed
// in fp32 and written in the input dtype.
//
// What bounds it on the H100: about 2n + 4 operations per element (14 for
// n = 5) against 8 bytes moved in fp32: the bytes bound it (LRN1 at batch 64:
// 74 MB in, 74 MB out).
//
// What the design does about it: one thread per element, with c the fastest
// index, so a warp reads and writes 32 neighbouring channels of one pixel
// (128 contiguous bytes in fp32).  The n - 1 neighbouring channels a thread
// also reads are its warp-mates' elements, served from L1, so device memory
// sees each input byte about once.
#include <math.h>

#include "common.cuh"

namespace {
using namespace repro;

template <typename T>
__global__ void lrn_kernel(const T* __restrict__ x, T* __restrict__ out,
                           int64_t pixels, int C, int local_size, float k,
                           float scale, float beta) {
  const int64_t total = pixels * C;
  const int half = local_size / 2;
  for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; i < total;
       i += (int64_t)gridDim.x * blockDim.x) {
    const int c = i % C;
    const T* row = x + (i - c);
    float acc = 0.f;
    // window taps in the reference's order, channels off the edge adding 0
    for (int j = c - half; j <= c + half; ++j) {
      if (j < 0 || j >= C) continue;
      const float v = to_float(row[j]);
      acc += v * v;
    }
    const float v = to_float(row[c]);
    out[i] = from_float<T>(v / powf(k + scale * acc, beta));
  }
}

template <typename T>
cudaError_t run(const void* x, void* out, int64_t pixels, int c,
                int local_size, float k, float scale, float beta,
                cudaStream_t stream) {
  const int64_t total = pixels * c;
  const int threads = 256;
  const int64_t blocks = (total + threads - 1) / threads;
  const int grid = (int)(blocks < 132 * 64 ? blocks : 132 * 64);
  lrn_kernel<T><<<grid, threads, 0, stream>>>(static_cast<const T*>(x),
                                              static_cast<T*>(out), pixels, c,
                                              local_size, k, scale, beta);
  return cudaGetLastError();
}
}  // namespace

// out = lrn(x) over the last (channel) axis of x, viewed as (pixels, c);
// scale = alpha / local_size
extern "C" int repro_lrn(const void* x, void* out, long long pixels, int c,
                         int local_size, float k, float scale, float beta,
                         int dtype, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == kBFloat16)
    return run<__nv_bfloat16>(x, out, pixels, c, local_size, k, scale, beta,
                              s);
  return run<float>(x, out, pixels, c, local_size, k, scale, beta, s);
}
