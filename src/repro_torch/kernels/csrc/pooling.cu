// VALID max / average pooling, NHWC — the Pool module (paper Table III,
// 'Pooling').
//
// Replaces: src/repro/kernels/pooling.py pool_pallas (body _pool_kernel):
// window x window taps at a stride, max, or a mean taken in fp32 and written
// in the input dtype (pooling.py:29).
//
// What bounds it on the H100: one compare or add per tap, 9 per output for
// AlexNet's 3x3 windows, against 4 bytes read per tap in fp32: the bytes bound
// it (Pool1 at batch 64: 74 MB in, 18 MB out).
//
// What the design does about it: one thread per output element (n, oh, ow,
// c) with c the fastest index, so a warp's loads of one tap are 32
// neighbouring channels (128 contiguous bytes in fp32).  Overlapping windows
// (stride 2 < window 3) re-read their shared taps, mostly from L1/L2, not HBM.
// The max starts from -inf, as the reference's reduce_window does.
#include <math.h>

#include "common.cuh"

namespace {
using namespace repro;

template <typename T>
__global__ void pool_kernel(const T* __restrict__ x, T* __restrict__ out,
                            int N, int H, int W, int C, int OH, int OW,
                            int window, int stride, int is_max) {
  const int64_t total = (int64_t)N * OH * OW * C;
  for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; i < total;
       i += (int64_t)gridDim.x * blockDim.x) {
    const int c = i % C;
    int64_t p = i / C;
    const int ow = p % OW;
    p /= OW;
    const int oh = p % OH;
    const int n = p / OH;
    const T* base =
        x + (((int64_t)n * H + oh * stride) * W + ow * stride) * C + c;
    float acc = is_max ? -INFINITY : 0.f;
    for (int kh = 0; kh < window; ++kh)
      for (int kw = 0; kw < window; ++kw) {
        const float v = to_float(base[((int64_t)kh * W + kw) * C]);
        acc = is_max ? fmaxf(acc, v) : acc + v;
      }
    if (!is_max) acc /= (float)(window * window);
    out[i] = from_float<T>(acc);
  }
}

template <typename T>
cudaError_t run(const void* x, void* out, int n, int h, int w, int c, int oh,
                int ow, int window, int stride, int is_max,
                cudaStream_t stream) {
  const int64_t total = (int64_t)n * oh * ow * c;
  const int threads = 256;
  const int64_t blocks = (total + threads - 1) / threads;
  const int grid = (int)(blocks < 132 * 64 ? blocks : 132 * 64);
  pool_kernel<T><<<grid, threads, 0, stream>>>(static_cast<const T*>(x),
                                               static_cast<T*>(out), n, h, w,
                                               c, oh, ow, window, stride,
                                               is_max);
  return cudaGetLastError();
}
}  // namespace

// out (n, oh, ow, c) = max or mean over window x window taps of x (n, h, w, c)
extern "C" int repro_pool(const void* x, void* out, int n, int h, int w,
                          int c, int oh, int ow, int window, int stride,
                          int is_max, int dtype, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == kBFloat16)
    return run<__nv_bfloat16>(x, out, n, h, w, c, oh, ow, window, stride,
                              is_max, s);
  return run<float>(x, out, n, h, w, c, oh, ow, window, stride, is_max, s);
}
