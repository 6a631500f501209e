// Tiled GEMM with a fused bias + activation epilogue — the FC module (paper
// Table III, 'FC').
//
// Replaces: src/repro/kernels/matmul.py matmul_pallas (bodies _matmul_kernel,
// _matmul_with_bias_kernel): (M, K) @ (K, N) with an fp32 accumulator, then
// bias and relu / sigmoid / tanh, written in the input dtype.
//
// What bounds it on the H100: an FC layer at serving batch M does 2*M flops
// per 4-byte weight element; the fp32 CUDA cores (67 TFLOP/s) outrun HBM
// (3.35 TB/s) at 20 flop/byte.  So below M = 40 the weight bytes bound it
// (FC6: 151 MB in fp32), and at M = 64 the fp32 operations do, by 1.6x.
//
// What the design does about it: each weight element is read from device
// memory by one block only (a grid of 64-row tiles by N/64 column tiles), the
// epilogue is fused so the output is written once, and edges are masked in
// the loaders so no padded copies are made (the Pallas wrapper pads to blocks,
// kernels/ops.py:53-58).  It runs on the CUDA cores in FFMA, not on the
// tensor cores.  Known limit, left to a later change: with M <= 64 there are
// only N/64 blocks (64 for FC6/FC7, 16 for FC8) on 132 SMs, too few to pull
// full HBM bandwidth; a split-K or GEMV path would fill the card.
#include "common.cuh"

namespace {
using namespace repro;

template <typename T>
__global__ void __launch_bounds__(kGemmThreads)
    matmul_kernel(const T* __restrict__ x, const T* __restrict__ w,
                  const T* __restrict__ bias, T* __restrict__ out, int M,
                  int N, int K, int act) {
  const int row0 = blockIdx.x * BM, col0 = blockIdx.y * BN;
  auto load_x = [&](int r, int k) -> float {
    const int gr = row0 + r;
    return (gr < M && k < K) ? to_float(x[(int64_t)gr * K + k]) : 0.f;
  };
  auto load_w = [&](int k, int c) -> float {
    const int gc = col0 + c;
    return (k < K && gc < N) ? to_float(w[(int64_t)k * N + gc]) : 0.f;
  };
  float acc[TM][TN];
  gemm_tile(K, load_x, load_w, acc);

  const int tx = threadIdx.x % (BN / TN), ty = threadIdx.x / (BN / TN);
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = row0 + ty * TM + i;
    if (r >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int c = col0 + tx * TN + j;
      if (c >= N) continue;
      float v = acc[i][j];
      if (bias != nullptr) v += to_float(bias[c]);
      out[(int64_t)r * N + c] = from_float<T>(activate(v, act));
    }
  }
}

template <typename T>
cudaError_t run(const void* x, const void* w, const void* bias, void* out,
                int m, int n, int k, int act, cudaStream_t stream) {
  const dim3 grid((m + BM - 1) / BM, (n + BN - 1) / BN);
  matmul_kernel<T><<<grid, kGemmThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w),
      static_cast<const T*>(bias), static_cast<T*>(out), m, n, k, act);
  return cudaGetLastError();
}
}  // namespace

// out (m, n) = act(x (m, k) @ w (k, n) + bias (n)); bias may be null.
extern "C" int repro_matmul(const void* x, const void* w, const void* bias,
                            void* out, int m, int n, int k, int act,
                            int dtype, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == kBFloat16)
    return run<__nv_bfloat16>(x, w, bias, out, m, n, k, act, s);
  return run<float>(x, w, bias, out, m, n, k, act, s);
}
