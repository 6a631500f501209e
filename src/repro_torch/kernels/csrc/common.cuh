// Helpers shared by the kernels: element types, the fused activation, and the
// register-tiled fp32 GEMM main loop that matmul.cu and conv2d.cu both run.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace repro {

// dtype codes passed from Python (kernels/_build.py DTYPES)
enum DType { kFloat32 = 0, kBFloat16 = 1 };

// activation codes (kernels/matmul.py ACTIVATIONS)
enum Activation { kNone = 0, kRelu = 1, kSigmoid = 2, kTanh = 3 };

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T> __device__ __forceinline__ T from_float(float v);
template <> __device__ __forceinline__ float from_float<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

__device__ __forceinline__ float activate(float v, int act) {
  switch (act) {
    case kRelu: return fmaxf(v, 0.f);
    case kSigmoid: return 1.f / (1.f + expf(-v));
    case kTanh: return tanhf(v);
    default: return v;
  }
}

// One block computes a BM x BN tile of C = A @ B with K = the reduction
// length.  Each of the 256 threads owns a TM x TN micro-tile in registers.
// A and B are read through the loaders, which return 0 outside the matrix,
// so ragged edges need no padded copies.  Each BK slice is summed into a
// fresh partial before it joins the running sum: a two-level sum keeps the
// fp32 rounding error of long reductions (FC6: K = 9216) near that of a
// blocked library GEMM.
constexpr int BM = 64, BN = 64, BK = 16, TM = 4, TN = 4;
constexpr int kGemmThreads = (BM / TM) * (BN / TN);  // 256

template <class LoadA, class LoadB>
__device__ __forceinline__ void gemm_tile(int K, LoadA load_a, LoadB load_b,
                                          float (&acc)[TM][TN]) {
  __shared__ float as[BK][BM + 4];  // k-major; +4 staggers the banks
  __shared__ float bs[BK][BN];
  const int tid = threadIdx.x;
  const int tx = tid % (BN / TN), ty = tid / (BN / TN);
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += BK) {
    // consecutive threads take consecutive k of one A row (contiguous in
    // memory for both callers) and consecutive columns of one B row
    for (int e = tid; e < BM * BK; e += kGemmThreads)
      as[e % BK][e / BK] = load_a(e / BK, k0 + e % BK);
    for (int e = tid; e < BK * BN; e += kGemmThreads)
      bs[e / BN][e % BN] = load_b(k0 + e / BN, e % BN);
    __syncthreads();
    float part[TM][TN] = {};
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[TM], b[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = as[kk][ty * TM + i];
#pragma unroll
      for (int j = 0; j < TN; ++j) b[j] = bs[kk][tx * TN + j];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) part[i][j] = fmaf(a[i], b[j], part[i][j]);
    }
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] += part[i][j];
    __syncthreads();
  }
}

}  // namespace repro
