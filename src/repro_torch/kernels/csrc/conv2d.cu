// Implicit-GEMM convolution with a fused bias + activation epilogue — the Conv
// module (paper Table III, 'Conv Layer').
//
// Replaces: src/repro/kernels/conv2d.py conv2d_pallas (body _conv2d_kernel):
// NHWC convolution with stride and zero padding, filters taken tap-major as a
// (KH*KW*IC, OC) matrix, then bias and activation, written in the input dtype.
//
// What bounds it on the H100: every AlexNet conv at serving batch does
// hundreds of flops per byte it must move (Conv2 at batch 64: 57 GFLOP over
// 68 MB), far above the fp32 ridge of 20 flop/byte (67 TFLOP/s over
// 3.35 TB/s): the fp32 operations bound it.
//
// What the design does about it: it is one GEMM of (N*OH*OW) output pixels by
// OC filters over K = KH*KW*IC, with no im2col matrix in device memory.  The
// A loader computes each patch element's NHWC address from the pixel and the
// tap, in the same tap-major order as the Pallas kernel (conv2d.py:37-38,70),
// and returns 0 for a tap that falls in the padding, so padding costs no
// padded copy of the input.  Blocks tile output pixels, not images: the
// Pallas grid runs one image per step (conv2d.py:79), which at small batch
// would fill a handful of the 132 SMs, while 64-pixel tiles give Conv3-5 at
// batch 64 over 1000 blocks.  Each thread keeps a 4x4 register tile and
// issues FFMA on the CUDA cores; the tensor cores (wgmma) are left to a later
// change.  The wrapper (kernels/conv2d.py) hands the filters over already in
// the (KH, KW, IC, OC) order, so the B loader reads rows of OC contiguously.
#include <climits>

#include "common.cuh"

namespace {
using namespace repro;

template <typename T>
__global__ void __launch_bounds__(kGemmThreads)
    conv2d_kernel(const T* __restrict__ x, const T* __restrict__ w_mat,
                  const T* __restrict__ bias, T* __restrict__ out, int N,
                  int H, int W, int IC, int OC, int KH, int KW, int OH,
                  int OW, int stride, int pad, int act) {
  const int M = N * OH * OW, K = KH * KW * IC;
  const int row0 = blockIdx.x * BM, col0 = blockIdx.y * BN;

  // per output pixel of this tile: its image's offset and the input
  // coordinates of its window's top-left tap
  __shared__ int64_t img_base[BM];
  __shared__ int ih0[BM], iw0[BM];
  for (int r = threadIdx.x; r < BM; r += blockDim.x) {
    const int m = row0 + r;
    if (m < M) {
      const int n = m / (OH * OW), p = m % (OH * OW);
      img_base[r] = (int64_t)n * H * W * IC;
      ih0[r] = (p / OW) * stride - pad;
      iw0[r] = (p % OW) * stride - pad;
    } else {
      img_base[r] = 0;
      ih0[r] = INT_MIN / 2;  // every tap of a row past M reads as padding
      iw0[r] = INT_MIN / 2;
    }
  }
  __syncthreads();

  auto load_x = [&](int r, int k) -> float {
    if (k >= K) return 0.f;
    const int tap = k / IC, ic = k - tap * IC;
    const int kh = tap / KW, kw = tap - kh * KW;
    const int ih = ih0[r] + kh, iw = iw0[r] + kw;
    if (ih < 0 || ih >= H || iw < 0 || iw >= W) return 0.f;
    return to_float(x[img_base[r] + ((int64_t)ih * W + iw) * IC + ic]);
  };
  auto load_w = [&](int k, int c) -> float {
    const int oc = col0 + c;
    return (k < K && oc < OC) ? to_float(w_mat[(int64_t)k * OC + oc]) : 0.f;
  };
  float acc[TM][TN];
  gemm_tile(K, load_x, load_w, acc);

  const int tx = threadIdx.x % (BN / TN), ty = threadIdx.x / (BN / TN);
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = row0 + ty * TM + i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int oc = col0 + tx * TN + j;
      if (oc >= OC) continue;
      float v = acc[i][j];
      if (bias != nullptr) v += to_float(bias[oc]);
      out[(int64_t)m * OC + oc] = from_float<T>(activate(v, act));
    }
  }
}

template <typename T>
cudaError_t run(const void* x, const void* w_mat, const void* bias, void* out,
                int n, int h, int w, int ic, int oc, int kh, int kw, int oh,
                int ow, int stride, int pad, int act, cudaStream_t stream) {
  const int m = n * oh * ow;
  const dim3 grid((m + BM - 1) / BM, (oc + BN - 1) / BN);
  conv2d_kernel<T><<<grid, kGemmThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w_mat),
      static_cast<const T*>(bias), static_cast<T*>(out), n, h, w, ic, oc, kh,
      kw, oh, ow, stride, pad, act);
  return cudaGetLastError();
}
}  // namespace

// out (n, oh, ow, oc) = act(conv(x (n, h, w, ic), w_mat) + bias (oc)), where
// w_mat is the filter bank as (kh, kw, ic, oc); bias may be null.
extern "C" int repro_conv2d(const void* x, const void* w_mat, const void* bias,
                            void* out, int n, int h, int w, int ic, int oc,
                            int kh, int kw, int oh, int ow, int stride,
                            int pad, int act, int dtype, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == kBFloat16)
    return run<__nv_bfloat16>(x, w_mat, bias, out, n, h, w, ic, oc, kh, kw,
                              oh, ow, stride, pad, act, s);
  return run<float>(x, w_mat, bias, out, n, h, w, ic, oc, kh, kw, oh, ow,
                    stride, pad, act, s);
}
