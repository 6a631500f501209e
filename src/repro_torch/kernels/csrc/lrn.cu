// Across-channel local response normalization, NHWC — the Norm module (paper
// Table III, 'LRN').
//
// Replaces: src/repro/kernels/lrn.py lrn_pallas (body _lrn_kernel):
//     y = x / (k + alpha/n * sum_{window of n channels} x^2) ^ beta
// with the window of channel c running over [c - n/2, c - n/2 + n), zero-
// padded at the edges (lrn.py:28-31: the squares padded by n/2 on both sides,
// n shifted slices added in order), for odd and even n and n > C; computed in
// fp32 and written in the input dtype.
//
// What bounds it on the H100: about 2n + 6 operations per element (16 for
// n = 5) against 8 bytes moved in fp32: the bytes bound it (LRN1 at batch 64:
// 74 MB in, 74 MB out).
//
// What the design does about it: one block per tile of pixels, on a 2-D
// block (x over a pixel's 16-byte channel vectors, y over pixels), so no
// index is recovered by division.  Each thread loads its vector (4 fp32 or 8
// bf16) once, keeps it in registers and writes its squares, in fp32, into
// its pixel's zero-padded row of shared memory with 16-byte stores.  The
// window length n is a template argument (1..kMaxN), so after one barrier
// each thread reads the aligned span of squares that its vector's windows
// cover with 16-byte loads and sums every window from registers, in the
// reference's order.  y = x * 2^(-beta * log2(d)) replaces x / powf(d,
// beta).  One vector a thread keeps many small blocks on an SM, whose loads
// and exp2/log2 overlap.  A C that is not a multiple of the vector, an
// unaligned pointer, a wider window or a C above kThreads vectors takes the
// plain kernel: one channel per thread, its window read from device memory
// (the L1 serves the neighbours' loads).
#include <math.h>

#include "common.cuh"

namespace {
using namespace repro;

constexpr int kMaxN = 9;        // widest window with a vector kernel
constexpr int kThreads = 256;

__device__ __forceinline__ float normalize(float v, float sum, float k,
                                           float scale, float neg_beta) {
  return v * exp2f(neg_beta * log2f(k + scale * sum));
}

// Shared row of one pixel: kOff zeros, C squares, zeros to a multiple of 4;
// channel c's window starts at float c + kOff - N/2 (kOff = N/2 rounded up
// to 4, so squares are stored, and spans read, as aligned float4s).
template <int N>
struct Row {
  static constexpr int kOff = (N / 2 + 3) / 4 * 4;
  static constexpr int kShift = kOff - N / 2;
  static __host__ __device__ int floats(int C) {
    return (kOff + C + N - 1 - N / 2 + 3) / 4 * 4;
  }
};

template <typename T, int N>
__global__ void __launch_bounds__(kThreads)
lrn_vec_kernel(const T* __restrict__ x, T* __restrict__ out, int64_t pixels,
               int C, float k, float scale, float neg_beta) {
  constexpr int VEC = 16 / sizeof(T);
  using R = Row<N>;
  // floats of the aligned span that covers VEC windows of N
  constexpr int kSpan = (R::kShift + VEC + N - 1 + 3) / 4 * 4;
  extern __shared__ __align__(16) float sq[];
  const int c = threadIdx.x * VEC;
  const int64_t p = (int64_t)blockIdx.x * blockDim.y + threadIdx.y;
  float* row = sq + threadIdx.y * R::floats(C);

  float v[VEC];
  if (p < pixels) {
    load_vec<T, VEC>(x + p * C + c, v);
#pragma unroll
    for (int i = 0; i < VEC; i += 4)
      *reinterpret_cast<float4*>(row + R::kOff + c + i) =
          make_float4(v[i] * v[i], v[i + 1] * v[i + 1], v[i + 2] * v[i + 2],
                      v[i + 3] * v[i + 3]);
    const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
    if (threadIdx.x == 0)
      for (int i = 0; i < R::kOff; i += 4)
        *reinterpret_cast<float4*>(row + i) = zero;
    if (threadIdx.x == blockDim.x - 1)
      for (int i = R::kOff + C; i < R::floats(C); i += 4)
        *reinterpret_cast<float4*>(row + i) = zero;
  }
  __syncthreads();
  if (p >= pixels) return;
  float span[kSpan];
#pragma unroll
  for (int i = 0; i < kSpan; i += 4) {
    const float4 f = *reinterpret_cast<const float4*>(row + c + i);
    span[i] = f.x;
    span[i + 1] = f.y;
    span[i + 2] = f.z;
    span[i + 3] = f.w;
  }
  float y[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) {
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < N; ++j) sum += span[R::kShift + i + j];
    y[i] = normalize(v[i], sum, k, scale, neg_beta);
  }
  store_vec<T, VEC>(out + p * C + c, y);
}

// Any C, n and alignment: one channel per thread, the window from device
// memory, channels off the edge skipped (they add zeros in the reference).
template <typename T>
__global__ void __launch_bounds__(kThreads)
lrn_plain_kernel(const T* __restrict__ x, T* __restrict__ out, int64_t pixels,
                 int C, int n, float k, float scale, float neg_beta) {
  const int64_t p = (int64_t)blockIdx.x * blockDim.y + threadIdx.y;
  if (p >= pixels) return;
  const T* row = x + p * C;
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    const int lo = c - n / 2;
    const int j1 = min(lo + n, C);
    float sum = 0.f;
    for (int j = max(lo, 0); j < j1; ++j) {
      const float t = to_float(row[j]);
      sum += __fmul_rn(t, t);      // the square rounded, as the reference's
    }
    out[p * C + c] =
        from_float<T>(normalize(to_float(row[c]), sum, k, scale, neg_beta));
  }
}

template <typename T, int N>
cudaError_t launch_vec(const T* x, T* out, int64_t pixels, int C, float k,
                       float scale, float neg_beta, cudaStream_t stream) {
  constexpr int VEC = 16 / sizeof(T);
  const int bx = C / VEC;
  const int by = kThreads / bx;
  // + 4 floats: the last row's span may read past its end (values unused)
  const size_t smem = ((size_t)by * Row<N>::floats(C) + 4) * sizeof(float);
  auto kernel = lrn_vec_kernel<T, N>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int64_t blocks = (pixels + by - 1) / by;
  kernel<<<(unsigned)blocks, dim3(bx, by), smem, stream>>>(
      x, out, pixels, C, k, scale, neg_beta);
  return cudaGetLastError();
}

template <typename T, int N = 1>
cudaError_t dispatch_vec(const T* x, T* out, int64_t pixels, int C, int n,
                         float k, float scale, float neg_beta,
                         cudaStream_t stream) {
  if (n == N)
    return launch_vec<T, N>(x, out, pixels, C, k, scale, neg_beta, stream);
  if constexpr (N < kMaxN)
    return dispatch_vec<T, N + 1>(x, out, pixels, C, n, k, scale, neg_beta,
                                  stream);
  return cudaErrorInvalidValue;
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

template <typename T>
cudaError_t run(const void* xv, void* ov, int64_t pixels, int c,
                int local_size, float k, float scale, float beta,
                cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  const T* x = static_cast<const T*>(xv);
  T* out = static_cast<T*>(ov);
  if (c % kVec == 0 && c / kVec <= kThreads && local_size <= kMaxN &&
      aligned16(x) && aligned16(out))
    return dispatch_vec<T>(x, out, pixels, c, local_size, k, scale, -beta,
                           stream);
  const int bx = c < kThreads ? c : kThreads;
  const int by = kThreads / bx;
  const int64_t blocks = (pixels + by - 1) / by;
  lrn_plain_kernel<T><<<(unsigned)blocks, dim3(bx, by), 0, stream>>>(
      x, out, pixels, c, local_size, k, scale, -beta);
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
