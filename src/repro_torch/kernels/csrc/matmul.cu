// Split-K pipelined GEMM with a fused bias + activation epilogue — the FC
// module (paper Table III, 'FC').
//
// Replaces: src/repro/kernels/matmul.py matmul_pallas (bodies _matmul_kernel,
// _matmul_with_bias_kernel): (M, K) @ (K, N) with an fp32 accumulator, then
// bias and relu / sigmoid / tanh, written in the input dtype.
//
// What bounds it on the H100: an FC layer at serving batch M does 2*M flops
// per weight element; in fp32 the CUDA cores (67 TFLOP/s) outrun HBM
// (3.35 TB/s) at 20 flop/byte, so at M = 64 (AlexNet FC6-8) the fp32
// operations bound it, and below M = 40 the weight bytes do.  It runs in
// full fp32 on the CUDA cores (FFMA), as torch.addmm does with TF32 off:
// 1xTF32 on the tensor cores keeps ~3 digits, too few at K = 9216 for the
// fp32 tolerance, and 3xTF32 would need the bound restated at a tensor-core
// rate (left to a later change).
//
// What the design does about it (gemm_pipelined.cuh):
// - Split K.  A 64 x 128 tile at M = 64 gives only N / 128 blocks (32 for
//   FC6/FC7, 8 for FC8) on 132 SMs, so the host (kernels/matmul.py
//   split_k) cuts K into S slices of a multiple of 16 and launches
//   tiles x S blocks, at least two per SM.  Each slice's block writes its
//   fp32 partial tile to a workspace (S, M, N) the wrapper allocates; a
//   second kernel sums the S partials in a fixed order, adds the bias,
//   applies the activation and writes the output once, so results are
//   bitwise repeatable (no atomics).  Where S = 1 the epilogue is fused.
//   (Summing in the last block of each tile, found by a counter, measured
//   1.5-4.5x slower: one block's 128 threads then read S partial tiles.)
// - Copies overlap compute: a 4-stage cp.async ring, 16-byte copies.
// - 8 x 8 register tiles from 4-wide shared loads: 16 FMAs per shared load.
// - Ragged edges stay in the kernel: rows past M, columns past N and k past
//   the slice are zero-filled by the copy.  Shapes whose rows are not
//   16-byte multiples (K or N not a multiple of 16 / sizeof(T)) take a
//   scalar, bounds-checked loader in the same kernel, chosen in the C entry
//   point; nothing is padded or routed elsewhere.
#include "gemm_pipelined.cuh"

namespace {
using namespace repro;
using namespace repro::pipe;

// Copies slice `step` of the block's K range into a stage: A (x rows m0..,
// k contiguous) and B (w rows k.., n contiguous).  kVec: 16-byte cp.async,
// which needs K and N multiples of 16 / sizeof(T) and aligned bases; else
// one element at a time, zero outside the matrix.
template <typename T, bool kVec>
struct Loader {
  const T* x;
  const T* w;
  int M, N, K, m0, n0, k_begin, k_end;

  __device__ __forceinline__ void operator()(int step, T* a, T* b) const {
    const int kb = k_begin + step * kTileK;
    if constexpr (kVec) {
      constexpr int V = 16 / sizeof(T);          // elements per copy
      constexpr int kARow = kTileK / V, kBRow = kTileN / V;
      for (int c = threadIdx.x; c < kTileM * kARow; c += kThreads) {
        const int r = c / kARow, kc = (c % kARow) * V;
        const bool ok = m0 + r < M && kb + kc < k_end;
        const T* src = ok ? x + (int64_t)(m0 + r) * K + kb + kc : x;
        cp_async16(a + r * kTileK + kc, src, ok ? 16 : 0);
      }
      for (int c = threadIdx.x; c < kTileK * kBRow; c += kThreads) {
        const int r = c / kBRow, nc = (c % kBRow) * V;
        const bool ok = kb + r < k_end && n0 + nc < N;
        const T* src = ok ? w + (int64_t)(kb + r) * N + n0 + nc : w;
        cp_async16(b + r * kTileN + nc, src, ok ? 16 : 0);
      }
    } else {
      for (int e = threadIdx.x; e < kTileM * kTileK; e += kThreads) {
        const int r = e / kTileK, kk = kb + e % kTileK;
        a[e] = (m0 + r < M && kk < k_end) ? x[(int64_t)(m0 + r) * K + kk]
                                          : from_float<T>(0.f);
      }
      for (int e = threadIdx.x; e < kTileK * kTileN; e += kThreads) {
        const int kk = kb + e / kTileN, c = n0 + e % kTileN;
        b[e] = (kk < k_end && c < N) ? w[(int64_t)kk * N + c]
                                     : from_float<T>(0.f);
      }
    }
  }
};

// Grid (N tiles, M tiles, S slices).  partial == nullptr: S == 1, write
// act(acc + bias) in T; else write the fp32 partial of slice blockIdx.z.
template <typename T, bool kVec>
__global__ void __launch_bounds__(kThreads)
    matmul_kernel(const T* __restrict__ x, const T* __restrict__ w,
                  const T* __restrict__ bias, T* __restrict__ out,
                  float* __restrict__ partial, int M, int N, int K,
                  int slice_k, int act) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  const int n0 = blockIdx.x * kTileN, m0 = blockIdx.y * kTileM;
  const int k_begin = blockIdx.z * slice_k;
  const int k_end = min(K, k_begin + slice_k);
  const Loader<T, kVec> load{x, w, M, N, K, m0, n0, k_begin, k_end};
  float acc[kRegM][kRegN];
  mainloop<T>((k_end - k_begin + kTileK - 1) / kTileK, smem, load, acc);

  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  float* part = partial == nullptr
                    ? nullptr
                    : partial + (int64_t)blockIdx.z * M * N;
#pragma unroll
  for (int i = 0; i < kRegM; ++i) {
    const int r = m0 + row_of(ty, i);
    if (r >= M) continue;
#pragma unroll
    for (int j = 0; j < kRegN; ++j) {
      const int c = n0 + col_of(tx, j);
      if (c >= N) continue;
      if (part != nullptr) {
        part[(int64_t)r * N + c] = acc[i][j];
      } else {
        float v = acc[i][j];
        if (bias != nullptr) v += to_float(bias[c]);
        out[(int64_t)r * N + c] = from_float<T>(activate(v, act));
      }
    }
  }
}

// out = act(sum over s of partial[s] + bias), the slices summed in order
template <typename T>
__global__ void splitk_epilogue(const float* __restrict__ partial,
                                const T* __restrict__ bias,
                                T* __restrict__ out, int64_t mn, int N,
                                int splits, int act) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= mn) return;
  float v = 0.f;
  for (int s = 0; s < splits; ++s) v += partial[s * mn + i];
  if (bias != nullptr) v += to_float(bias[i % N]);
  out[i] = from_float<T>(activate(v, act));
}

template <typename T, bool kVec>
cudaError_t launch_main(const T* x, const T* w, const T* bias, T* out,
                        float* partial, int m, int n, int k, int splits,
                        int slice_k, int act, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<T>();
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        matmul_kernel<T, kVec>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((n + kTileN - 1) / kTileN, (m + kTileM - 1) / kTileM,
                  splits);
  matmul_kernel<T, kVec><<<grid, kThreads, smem, stream>>>(
      x, w, bias, out, partial, m, n, k, slice_k, act);
  return cudaGetLastError();
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

template <typename T>
cudaError_t run(const void* xv, const void* wv, const void* bv, void* ov,
                void* ws, int m, int n, int k, int splits, int slice_k,
                int act, cudaStream_t stream) {
  const T* x = static_cast<const T*>(xv);
  const T* w = static_cast<const T*>(wv);
  const T* bias = static_cast<const T*>(bv);
  T* out = static_cast<T*>(ov);
  float* partial = splits > 1 ? static_cast<float*>(ws) : nullptr;
  constexpr int V = 16 / sizeof(T);
  const bool vec = k % V == 0 && n % V == 0 && aligned16(x) && aligned16(w);
  cudaError_t err =
      vec ? launch_main<T, true>(x, w, bias, out, partial, m, n, k, splits,
                                 slice_k, act, stream)
          : launch_main<T, false>(x, w, bias, out, partial, m, n, k, splits,
                                  slice_k, act, stream);
  if (err != cudaSuccess || splits == 1) return err;
  const int64_t mn = (int64_t)m * n;
  const int threads = 256;
  splitk_epilogue<T><<<(unsigned)((mn + threads - 1) / threads), threads, 0,
                       stream>>>(partial, bias, out, mn, n, splits, act);
  return cudaGetLastError();
}
}  // namespace

// out (m, n) = act(x (m, k) @ w (k, n) + bias (n)); bias may be null.  K is
// cut into `splits` slices of `slice_k` (a multiple of 16; the last may be
// shorter); with splits > 1, ws holds splits * m * n floats of scratch.
extern "C" int repro_matmul(const void* x, const void* w, const void* bias,
                            void* out, void* ws, int m, int n, int k,
                            int splits, int slice_k, int act, int dtype,
                            void* stream) {
  if (m < 1 || n < 1 || k < 1 || splits < 1 || slice_k < 1 ||
      slice_k % kTileK != 0 || (int64_t)(splits - 1) * slice_k >= k ||
      (int64_t)splits * slice_k < k || splits > 65535 ||
      (splits > 1 && ws == nullptr))
    return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == kBFloat16)
    return run<__nv_bfloat16>(x, w, bias, out, ws, m, n, k, splits, slice_k,
                              act, s);
  return run<float>(x, w, bias, out, ws, m, n, k, splits, slice_k, act, s);
}
