// A pipelined fp32-accumulating GEMM main loop for one 64 x 128 output tile:
// a ring of kStages shared-memory slices fed by cp.async, 128 threads each
// owning an 8 x 8 register tile.  matmul.cu runs it; the loader is a
// parameter so that an implicit-GEMM convolution can feed it patches.
//
// Shared memory per stage: A as [kTileM][kTileK] (k contiguous, as the rows
// of x are) and B as [kTileK][kTileN] (n contiguous, as the rows of w are),
// both in the input type.  A thread reads its 8 rows of A as 4-wide vectors
// along k and its 8 columns of B as two 4-wide vectors 64 columns apart, so
// every shared load is a broadcast or conflict-free, and each 16 FMAs cost
// one shared load.  bf16 tiles are widened to fp32 on that read.
#pragma once

#include "common.cuh"

namespace repro {
namespace pipe {

constexpr int kTileM = 64, kTileN = 128, kTileK = 16, kStages = 4;
constexpr int kThreads = 128;                 // 8 row groups x 16 col groups
constexpr int kRegM = 8, kRegN = 8;

constexpr int kStageElems = kTileM * kTileK + kTileK * kTileN;

template <typename T>
constexpr size_t smem_bytes() {
  return sizeof(T) * (size_t)kStages * kStageElems;
}

// rows ty*4 + {0..3} and 32 + ty*4 + {0..3}; columns tx*4 + {0..3} and
// 64 + tx*4 + {0..3}
__device__ __forceinline__ int row_of(int ty, int i) {
  return (i < 4 ? 0 : 32) + ty * 4 + (i & 3);
}
__device__ __forceinline__ int col_of(int tx, int j) {
  return (j < 4 ? 0 : 64) + tx * 4 + (j & 3);
}

// 16-byte global -> shared copy; src_bytes 0 writes zeros and reads nothing
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void load4(const float* p, float (&v)[4]) {
  const float4 f = *reinterpret_cast<const float4*>(p);
  v[0] = f.x; v[1] = f.y; v[2] = f.z; v[3] = f.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float (&v)[4]) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 lo = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 hi = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&u.y));
  v[0] = lo.x; v[1] = lo.y; v[2] = hi.x; v[3] = hi.y;
}

// acc += A_stage @ B_stage for one kTileK slice
template <typename T>
__device__ __forceinline__ void mma_stage(const T* __restrict__ a,
                                          const T* __restrict__ b, int tx,
                                          int ty,
                                          float (&acc)[kRegM][kRegN]) {
#pragma unroll
  for (int kq = 0; kq < kTileK; kq += 4) {
    float af[kRegM][4];
#pragma unroll
    for (int i = 0; i < kRegM; ++i)
      load4(a + row_of(ty, i) * kTileK + kq, af[i]);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      float b0[4], b1[4];
      const T* br = b + (kq + kk) * kTileN + tx * 4;
      load4(br, b0);
      load4(br + 64, b1);
#pragma unroll
      for (int i = 0; i < kRegM; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          acc[i][j] = fmaf(af[i][kk], b0[j], acc[i][j]);
          acc[i][j + 4] = fmaf(af[i][kk], b1[j], acc[i][j + 4]);
        }
    }
  }
}

// Runs `steps` kTileK slices through the ring.  issue(step, a, b) starts the
// copies of slice `step` into stage buffers a ([kTileM][kTileK]) and b
// ([kTileK][kTileN]); it may copy synchronously.  While slice s is
// multiplied, slices s+1 .. s+kStages-1 are in flight.
template <typename T, class Issue>
__device__ __forceinline__ void mainloop(int steps, T* smem, Issue issue,
                                         float (&acc)[kRegM][kRegN]) {
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  constexpr int kA = kTileM * kTileK;
  constexpr int kStage = kStageElems;
#pragma unroll
  for (int i = 0; i < kRegM; ++i)
#pragma unroll
    for (int j = 0; j < kRegN; ++j) acc[i][j] = 0.f;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < steps) issue(s, smem + s * kStage, smem + s * kStage + kA);
    cp_async_commit();
  }
  for (int step = 0; step < steps; ++step) {
    cp_async_wait<kStages - 2>();   // slice `step` has landed ...
    __syncthreads();                // ... for every thread, and slice
                                    // step - 1's buffers are free again
    const int next = step + kStages - 1;
    if (next < steps) {
      T* st = smem + (next % kStages) * kStage;
      issue(next, st, st + kA);
    }
    cp_async_commit();
    const T* cur = smem + (step % kStages) * kStage;
    mma_stage(cur, cur + kA, tx, ty, acc);
  }
  cp_async_wait<0>();
}

}  // namespace pipe
}  // namespace repro
