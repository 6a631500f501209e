// VALID max / average pooling, NHWC — the Pool module (paper Table III,
// 'Pooling').
//
// Replaces: src/repro/kernels/pooling.py pool_pallas (body _pool_kernel):
// window x window taps at a stride, max, or a mean taken in fp32 and written
// in the input dtype (pooling.py:29).  The max propagates NaN, as the
// reference's jax.lax.max does: a NaN tap makes its window's output NaN.
//
// What bounds it on the H100: one compare or add per tap, 9 per output for
// AlexNet's 3x3 windows, against 4 bytes read per tap in fp32: the bytes bound
// it (Pool1 at batch 64: 74 MB in, 18 MB out).
//
// What the design does about it: one block per (image, band of output rows,
// tile of output columns), on a 3-D grid, so no index is recovered by
// division.  The input rows the tile's windows cover ((band - 1) * stride +
// window of them, each a contiguous run of columns x C elements in NHWC) are
// staged once in shared memory with 16-byte cp.async copies, so device
// memory sees each input byte about once (the rows and columns neighbouring
// tiles share come from the L2).  Each thread then takes one output (a
// 16-byte vector of channels, 4 fp32 or 8 bf16, at a column and row of the
// tile) and reduces separably from shared memory: each window row along W,
// then the rows along H; the average sums in fp32.  Outputs leave as 16-byte
// stores.  kernels/pooling.py plans the tile: the one that stages the fewest
// bytes within SMEM_BUDGET (eight blocks of kThreads to an SM, which fills
// its threads); where no tile fits, the same kernel reads its taps straight
// from device memory.  A C that is not a multiple of the vector, or an
// unaligned pointer, takes the scalar instantiation: one channel per thread,
// plain loads and stores.
#include <math.h>

#include "common.cuh"

namespace {
using namespace repro;

constexpr int kThreads = 256;   // threads per block (kernels/pooling.py)
constexpr int kMaxSmem = 232448;    // the most a block can have on sm_90

struct Geometry {
  int H, W, C, OH, OW, window, stride, band, owt;
};

template <bool kMax>
__device__ __forceinline__ float combine(float acc, float v) {
  if constexpr (kMax)
    return (v > acc || v != v) ? v : acc;   // NaN wins, as in jax.lax.max
  else
    return acc + v;
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(src)
               : "memory");
}

// Copy `rows` runs of `seg` elements, `src_row` apart in device memory, into
// consecutive runs of the shared tile.
template <typename T, int VEC>
__device__ __forceinline__ void stage(T* tile, const T* src, int rows,
                                      int seg, int64_t src_row, int tid,
                                      int nthreads) {
  if constexpr (VEC > 1) {
    const uint32_t base =
        static_cast<uint32_t>(__cvta_generic_to_shared(tile));
    const int chunks = seg / VEC;           // 16-byte chunks of one run
    for (int r = 0; r < rows; ++r)
      for (int i = tid; i < chunks; i += nthreads)
        cp_async16(base + (r * chunks + i) * 16u,
                   src + r * src_row + (int64_t)i * VEC);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  } else {
    for (int r = 0; r < rows; ++r)
      for (int i = tid; i < seg; i += nthreads)
        tile[r * seg + i] = src[r * src_row + i];
  }
}

template <typename T, int VEC, bool kStaged, bool kMax>
__global__ void __launch_bounds__(kThreads)
pool_kernel(const T* __restrict__ x, T* __restrict__ out, Geometry g) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int n = blockIdx.z;
  const int oh0 = blockIdx.y * g.band, ow0 = blockIdx.x * g.owt;
  const int nb = min(g.band, g.OH - oh0), nw = min(g.owt, g.OW - ow0);
  const int64_t x_row = (int64_t)g.W * g.C;
  const T* src = x + ((int64_t)n * g.H + (int64_t)oh0 * g.stride) * x_row +
                 (int64_t)ow0 * g.stride * g.C;

  // where the taps are read: the staged rows, or the input itself
  const T* in = src;
  int64_t in_row = x_row;
  if constexpr (kStaged) {
    T* tile = reinterpret_cast<T*>(smem);
    const int rows = (nb - 1) * g.stride + g.window;
    const int seg = ((nw - 1) * g.stride + g.window) * g.C;
    stage<T, VEC>(tile, src, rows, seg, x_row,
                  (threadIdx.z * blockDim.y + threadIdx.y) * blockDim.x +
                      threadIdx.x,
                  blockDim.x * blockDim.y * blockDim.z);
    __syncthreads();
    in = tile;
    in_row = seg;
  }

  // thread (x, y, z): a vector of channels, an output column, an output row
  const int cvs = g.C / VEC;
  const float init = kMax ? -INFINITY : 0.f;
  for (int j = threadIdx.z; j < nb; j += blockDim.z)
    for (int ow = threadIdx.y; ow < nw; ow += blockDim.y)
      for (int cv = threadIdx.x; cv < cvs; cv += blockDim.x) {
        const T* corner = in + j * g.stride * in_row +
                          (int64_t)ow * g.stride * g.C + cv * VEC;
        float acc[VEC];
#pragma unroll
        for (int i = 0; i < VEC; ++i) acc[i] = init;
        for (int kh = 0; kh < g.window; ++kh) {
          float h[VEC];                  // the window's row kh along W ...
#pragma unroll
          for (int i = 0; i < VEC; ++i) h[i] = init;
          const T* tap = corner + kh * in_row;
          for (int kw = 0; kw < g.window; ++kw) {
            float v[VEC];
            load_vec<T, VEC>(tap + kw * g.C, v);
#pragma unroll
            for (int i = 0; i < VEC; ++i) h[i] = combine<kMax>(h[i], v[i]);
          }
#pragma unroll
          for (int i = 0; i < VEC; ++i)   // ... then along H
            acc[i] = combine<kMax>(acc[i], h[i]);
        }
        if constexpr (!kMax) {
          const float taps = (float)(g.window * g.window);
#pragma unroll
          for (int i = 0; i < VEC; ++i) acc[i] /= taps;
        }
        store_vec<T, VEC>(
            out + (((int64_t)n * g.OH + oh0 + j) * g.OW + ow0 + ow) * g.C +
                cv * VEC,
            acc);
      }
}

template <typename T, int VEC, bool kStaged, bool kMax>
cudaError_t launch(const T* x, T* out, int n, const Geometry& g, int smem,
                   cudaStream_t stream) {
  auto kernel = pool_kernel<T, VEC, kStaged, kMax>;
  if (kStaged) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  // up to kThreads threads: x over the vectors of C, y over the tile's
  // output columns, z over its output rows
  const int cvs = g.C / VEC;
  const int bx = cvs < kThreads ? cvs : kThreads;
  const int by = kThreads / bx < g.owt ? kThreads / bx : g.owt;
  const int bz = kThreads / (bx * by) < g.band ? kThreads / (bx * by) : g.band;
  const dim3 grid((g.OW + g.owt - 1) / g.owt, (g.OH + g.band - 1) / g.band,
                  n);
  kernel<<<grid, dim3(bx, by, bz), kStaged ? smem : 0, stream>>>(x, out, g);
  return cudaGetLastError();
}

template <typename T, int VEC>
cudaError_t run_vec(const T* x, T* out, int n, const Geometry& g, int smem,
                    int is_max, cudaStream_t stream) {
  if (smem > 0)
    return is_max ? launch<T, VEC, true, true>(x, out, n, g, smem, stream)
                  : launch<T, VEC, true, false>(x, out, n, g, smem, stream);
  return is_max ? launch<T, VEC, false, true>(x, out, n, g, 0, stream)
                : launch<T, VEC, false, false>(x, out, n, g, 0, stream);
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

template <typename T>
cudaError_t run(const void* xv, void* ov, int n, const Geometry& g, int smem,
                int is_max, cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  const T* x = static_cast<const T*>(xv);
  T* out = static_cast<T*>(ov);
  if (g.C % kVec == 0 && aligned16(x) && aligned16(out))
    return run_vec<T, kVec>(x, out, n, g, smem, is_max, stream);
  // scalar staging holds the same rows: smem was planned for this C
  return run_vec<T, 1>(x, out, n, g, smem, is_max, stream);
}
}  // namespace

// out (n, oh, ow, c) = max or mean over window x window taps of x (n, h, w,
// c).  Each block covers `band` output rows and `owt` output columns of one
// image; smem > 0 is the shared memory its staged input rows take, 0 reads
// the taps from device memory (kernels/pooling.py plan).
extern "C" int repro_pool(const void* x, void* out, int n, int h, int w,
                          int c, int oh, int ow, int window, int stride,
                          int is_max, int band, int owt, int smem, int dtype,
                          void* stream) {
  if (band < 1 || owt < 1 || smem < 0 || smem > kMaxSmem)
    return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  const Geometry g{h, w, c, oh, ow, window, stride, band, owt};
  if (dtype == kBFloat16)
    return run<__nv_bfloat16>(x, out, n, g, smem, is_max, s);
  return run<float>(x, out, n, g, smem, is_max, s);
}
