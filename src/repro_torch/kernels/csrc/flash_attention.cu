// Flash attention forward: causal (optionally sliding-window) GQA attention
// with an online softmax over key tiles; the (S, T) score matrix never
// leaves the block.
//
// Replaces: src/repro/kernels/flash_attention.py flash_attention_pallas (body
// _flash_kernel): q (B, HQ, S, D) against k/v (B, HK, T, D), each query head
// reading its group's kv head; tiles wholly above the causal diagonal or
// left of the window are skipped, the diagonal tiles masked elementwise.
// Unlike the Pallas kernel, which assumes S == T and block-aligned lengths
// (its wrapper pads), this kernel masks keys t >= T and rows >= S itself.
// Query i sits at key position i + q_offset, in the masks and in the bounds
// of the key tiles a query tile visits: q_offset = 0 aligns query starts
// with key starts, as the Pallas kernel does, and T - S aligns query ends
// with key ends (the wrapper's default).  A row with no key to attend is
// written as zeros.
//
// What bounds it on the H100: causal prefill does about 2 * S * T * D * HQ
// operations (half of 4 S T D HQ) and moves 2 * (2 S HQ + 2 T HK) * D bytes
// in bf16 (Q, K, V in, O out).  With qwen2-1.5B's 12 heads of 128 (2 kv
// heads) that is ~220 operations per byte at S = T = 512 (the bytes bound
// it) and ~880 at 2048 (the operations do; the crossover at ~295 is near
// 700 tokens).  Either way the products have to run on the tensor cores:
// in FFMA (67 TFLOP/s) one 64-query tile against 512 keys alone takes
// ~33 us on its SM.
//
// Two bodies, chosen by dtype in the C entry point:
//
// bf16 (every prefill path) — tensor cores.  A block is one consumer
// warpgroup (64 query rows of one head) and one producer warp.  The
// producer loads Q once and streams K and V tiles (64 keys) through 2-stage
// shared-memory rings with TMA: 3-D tensor maps (D, rows, heads), so rows
// past S or T come back as zeros rather than the next head's, 128-byte
// (D = 32: 64-byte) swizzle, mbarriers for each stage full and freed, K and
// V apart so a K stage is refilled as soon as Q K^T has read it.  The
// consumer runs S = Q K^T as wgmma m64n64k16 with both operands K-major in
// shared memory, masks and runs the online softmax on the fp32 accumulator
// fragment (row max and sum over the 4 lanes of a quad), turns P into bf16
// A fragments in registers (the accumulator layout is the A layout) and
// runs O += P V as wgmma m64nDk16 with A from registers and V read N-major
// through the descriptor's transpose bit: nothing is staged as fp32,
// transposed by hand, or sent through shared memory.  The loop is software
// pipelined: Q K_i^T and P_{i-1} V_{i-1} are issued together behind one
// fence, and the softmax of tile i runs on the CUDA cores while the tensor
// cores finish P_{i-1} V_{i-1}.  A cycle trace of one warpgroup showed the
// softmax taking most of a tile (its 16-long max and sum chains, and the
// mask tests); the row max and sum are now trees over both rows at once,
// exp2 is one ex2.approx, and a diagonal tile compares each column with two
// per-row bounds.  P is rounded to bf16 before P V, where the Pallas
// kernel multiplies in fp32; sums stay fp32.  Measured and dropped: two
// query heads of a kv group per block sharing each K/V tile (one block per
// SM, its two warpgroups in lockstep), and Q K_{i+1}^T issued under the
// softmax of tile i (ptxas serialized the products).
//
// fp32 — the CUDA cores.  A block of 256 threads owns 64 query rows of one
// head; each thread holds a 4 x 4 tile of scores and a 4 x D/16 tile of the
// output in registers, with the running max and denominator of its 4 rows.
// Q and each K tile are staged transposed in shared memory as fp32, V
// reuses K's buffer, and the probabilities go through shared memory into
// the P @ V product.  Kept because wgmma has no fp32 inputs (tf32 would not
// hold the fp32 tolerance).
//
// Both launch the longest causal query tiles first (blockIdx.x reversed).
#include <cuda.h>  // tensor-map types; the encoder is fetched at run time
#include <math.h>

#include "common.cuh"
#include "wgmma.cuh"

namespace {
using namespace repro;

constexpr int BQ = 64, BKV = 64;

// ------------------------------------------------------------------ fp32
constexpr int kThreads = 256, kPad = 4;
constexpr float kNegInf = -1e30f;

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_ffma_kernel(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, float* __restrict__ out,
                  int hq, int hk, int S, int Tk, int q_offset, int causal,
                  int window, float scale) {
  constexpr int DC = D / 16;             // output columns per thread
  constexpr int LQ = BQ + kPad, LK = BKV + kPad;
  extern __shared__ float smem[];
  float* qt = smem;                      // (D, BQ + pad): Q^T, scaled
  float* kv = qt + D * LQ;               // (D, BKV + pad) K^T, then (BKV, D) V
  float* pt = kv + D * LK;               // (BKV, BQ + pad): P^T

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int bh = blockIdx.y, b = bh / hq, h = bh % hq;
  const int kh = h / (hq / hk);
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;
  const int off = q_offset;             // query i sits at position i + off
  const float* qb = q + ((size_t)bh * S) * D;
  const float* kb = k + ((size_t)(b * hk + kh) * Tk) * D;
  const float* vb = v + ((size_t)(b * hk + kh) * Tk) * D;

  for (int e = tid; e < BQ * D; e += kThreads) {
    const int r = e / D, c = e % D;
    qt[c * LQ + r] = (q0 + r < S) ? qb[(size_t)(q0 + r) * D + c] * scale
                                  : 0.f;
  }

  float m[4], l[4], acc[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DC; ++j) acc[i][j] = 0.f;
  }

  // the key range any row of this tile may attend (uniform over the block)
  const int last_row = min(q0 + BQ, S) - 1;
  int k_end = Tk, k_begin = 0;
  if (causal) k_end = min(Tk, last_row + off + 1);
  if (window > 0) k_begin = max(0, q0 + off - window + 1);
  k_begin = (k_begin / BKV) * BKV;

  for (int k0 = k_begin; k0 < k_end; k0 += BKV) {
    __syncthreads();                     // previous tile's V reads are done
    for (int e = tid; e < BKV * D; e += kThreads) {
      const int t = e / D, c = e % D;
      kv[c * LK + t] = (k0 + t < Tk) ? kb[(size_t)(k0 + t) * D + c] : 0.f;
    }
    __syncthreads();
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int c = 0; c < D; ++c) {
      float a[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = qt[c * LQ + ty * 4 + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = kv[c * LK + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], bv[j], s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty * 4 + i;
      const int qpos = row + off;
      bool valid[4];
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + tx + 16 * j;
        valid[j] = row < S && col < Tk && (!causal || col <= qpos) &&
                   (window <= 0 || col > qpos - window);
        if (!valid[j]) s[i][j] = kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int w = 8; w >= 1; w >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, w));
      const float m_new = fmaxf(m[i], mx);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = valid[j] ? expf(s[i][j] - m_new) : 0.f;
        pt[(tx + 16 * j) * LQ + ty * 4 + i] = p;
        sum += p;
      }
#pragma unroll
      for (int w = 8; w >= 1; w >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, w);
      const float alpha = expf(m[i] - m_new);
      l[i] = l[i] * alpha + sum;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < DC; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();                     // K^T reads done, P^T written
    for (int e = tid; e < BKV * D; e += kThreads) {
      const int t = e / D;
      kv[e] = (k0 + t < Tk) ? vb[(size_t)k0 * D + e] : 0.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int t = 0; t < BKV; ++t) {
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = pt[t * LQ + ty * 4 + i];
#pragma unroll
      for (int j = 0; j < DC; ++j) {
        const float vv = kv[t * D + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(p[i], vv, acc[i][j]);
      }
    }
  }

  float* ob = out + ((size_t)bh * S) * D;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= S) continue;
#pragma unroll
    for (int j = 0; j < DC; ++j)
      ob[(size_t)row * D + tx + 16 * j] =
          l[i] == 0.f ? 0.f : acc[i][j] / l[i];
  }
}

template <int D>
cudaError_t run_ffma(const void* q, const void* k, const void* v, void* out,
                     int b, int hq, int hk, int s, int t, int q_offset,
                     int causal, int window, float scale,
                     cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * ((size_t)D * (BQ + kPad) + (size_t)D * (BKV + kPad) +
                       (size_t)BKV * (BQ + kPad));
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_ffma_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
  }
  dim3 grid((s + BQ - 1) / BQ, b * hq);
  flash_ffma_kernel<D><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), hq, hk, s, t,
      q_offset, causal, window, scale);
  return cudaGetLastError();
}

// ------------------------------------------------------------------ bf16
using bf16 = __nv_bfloat16;
constexpr int kWgThreads = 128 + 32;   // consumer warpgroup + producer warp

// Shared-memory geometry of one 64-row bf16 tile for head dim D: kChunks
// column chunks of kRowBytes per row (the swizzle span), one TMA box each.
template <int D>
struct Tile {
  static constexpr int kRowBytes = D * 2 < 128 ? D * 2 : 128;
  static constexpr int kChunkCols = kRowBytes / 2;
  static constexpr int kChunks = D / kChunkCols;
  static constexpr int kChunkBytes = 64 * kRowBytes;
  static constexpr int kBytes = 64 * D * 2;
  // wgmma descriptor layout: 1 = 128-byte swizzle, 2 = 64-byte
  static constexpr uint64_t kLayout = kRowBytes == 128 ? 1 : 2;
  // smem: Q, K[2], V[2], then 9 mbarriers; + slack to align to 1024
  static constexpr size_t kSmem = 5 * (size_t)kBytes + 9 * 8 + 1024;
};

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}
// Wait for the completion of the barrier's phase of this parity.  A phase
// that never completes (a lost copy) traps after ~2^26 polls, seconds at
// the least, so the launch fails with an error instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  for (uint32_t polls = 0;; ++polls) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (polls == (1u << 26)) __trap();
  }
}
__device__ __forceinline__ void tma_load_3d(uint32_t dst,
                                            const CUtensorMap* map, int c0,
                                            int c1, int c2, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(bar)
      : "memory");
}
// 2^x in one MUFU op (flushes denormals; the probabilities need none)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

// d (m64 x n64, fp32) (+)= A (smem, K-major) @ B (smem, K-major)^T
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t a,
                                             uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(scale_d));
}

// d (m64 x n32, fp32) += A (registers, bf16) @ B (smem, N-major)
__device__ __forceinline__ void wgmma_rs(float (&d)[16],
                                         const uint32_t (&a)[4],
                                         uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d (m64 x n64, fp32) += A (registers, bf16) @ B (smem, N-major)
__device__ __forceinline__ void wgmma_rs(float (&d)[32],
                                         const uint32_t (&a)[4],
                                         uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d (m64 x n128, fp32) += A (registers, bf16) @ B (smem, N-major)
__device__ __forceinline__ void wgmma_rs(float (&d)[64],
                                         const uint32_t (&a)[4],
                                         uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// Descriptors of a whole tile; the k16 step kk adds k_step<D>(kk) or
// n_step<D>(kk) to them (shared addresses are 16-byte units in the low 14
// bits, which no tile offset carries out of).
// K-major operand (Q or K tile): 8-row groups SBO apart.
template <int D>
__device__ __forceinline__ uint64_t desc_k_major(uint32_t tile) {
  using G = Tile<D>;
  return make_desc(tile, 16, 8 * G::kRowBytes, G::kLayout);
}
// k16 step kk along D: its chunk, then 32 bytes per step inside the span
template <int D>
__device__ __forceinline__ uint64_t k_step(int kk) {
  using G = Tile<D>;
  constexpr int kSteps = G::kChunkCols / 16;        // k16 steps per chunk
  return ((kk / kSteps) * G::kChunkBytes + (kk % kSteps) * 32) >> 4;
}
// N-major operand (V tile): 8-row groups SBO apart along the keys, column
// chunks LBO apart along D
template <int D>
__device__ __forceinline__ uint64_t desc_n_major(uint32_t tile) {
  using G = Tile<D>;
  return make_desc(tile, G::kChunkBytes, 8 * G::kRowBytes, G::kLayout);
}
// keys 16 kk .. 16 kk + 15
template <int D>
__device__ __forceinline__ uint64_t n_step(int kk) {
  return (kk * 16 * Tile<D>::kRowBytes) >> 4;
}

template <int D>
__global__ void __launch_bounds__(kWgThreads)
flash_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                   const __grid_constant__ CUtensorMap tk,
                   const __grid_constant__ CUtensorMap tv,
                   bf16* __restrict__ out, int hq, int hk, int S, int Tk,
                   int q_offset, int causal, int window, float scale_log2) {
  using G = Tile<D>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  // Q, K stages 0-1, V stages 0-1, then the barriers: Q full, K full x 2,
  // V full x 2, K stage freed x 2, V stage freed x 2 (addresses as
  // functions of the stage: nothing is indexed at run time)
  const uint32_t q_s = base, bars = base + 5 * G::kBytes, q_full = bars;
  auto k_s = [=](int st) { return base + (1 + st) * G::kBytes; };
  auto v_s = [=](int st) { return base + (3 + st) * G::kBytes; };
  auto k_full = [=](int st) { return bars + 8 + 8 * st; };
  auto v_full = [=](int st) { return bars + 24 + 8 * st; };
  auto k_freed = [=](int st) { return bars + 40 + 8 * st; };
  auto v_freed = [=](int st) { return bars + 56 + 8 * st; };

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int bh = blockIdx.y, b = bh / hq, h = bh % hq;
  const int kvh = b * hk + h / (hq / hk);
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;
  const int off = q_offset;             // query i sits at position i + off
  const int last_row = min(q0 + BQ, S) - 1;
  int k_end = Tk, k_begin = 0;
  if (causal) k_end = min(Tk, last_row + off + 1);
  if (window > 0) k_begin = max(0, q0 + off - window + 1);
  k_begin = (k_begin / BKV) * BKV;
  const int n_kv = k_end > k_begin ? (k_end - k_begin + BKV - 1) / BKV : 0;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < 2; ++s) {
      mbar_init(k_full(s), 1);
      mbar_init(v_full(s), 1);
      mbar_init(k_freed(s), 128);
      mbar_init(v_freed(s), 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == 4) {                       // producer warp: one lane issues
    if (lane == 0 && n_kv > 0) {
      mbar_expect_tx(q_full, G::kBytes);
      for (int c = 0; c < G::kChunks; ++c)
        tma_load_3d(q_s + c * G::kChunkBytes, &tq, c * G::kChunkCols, q0, bh,
                    q_full);
      for (int i = 0; i < n_kv; ++i) {
        const int st = i & 1, k0 = k_begin + i * BKV;
        if (i >= 2) mbar_wait(k_freed(st), ((i >> 1) - 1) & 1);
        mbar_expect_tx(k_full(st), G::kBytes);
        for (int c = 0; c < G::kChunks; ++c)
          tma_load_3d(k_s(st) + c * G::kChunkBytes, &tk, c * G::kChunkCols,
                      k0, kvh, k_full(st));
        if (i >= 2) mbar_wait(v_freed(st), ((i >> 1) - 1) & 1);
        mbar_expect_tx(v_full(st), G::kBytes);
        for (int c = 0; c < G::kChunks; ++c)
          tma_load_3d(v_s(st) + c * G::kChunkBytes, &tv, c * G::kChunkCols,
                      k0, kvh, v_full(st));
      }
    }
    return;
  }

  // consumer warpgroup: thread owns rows r0 and r0 + 8, and in each n8
  // column block j the columns 8 j + 2 t and 8 j + 2 t + 1
  const int g = lane / 4, t = lane % 4;
  const int r0 = q0 + warp * 16 + g;
  float o[D / 2];
#pragma unroll
  for (int e = 0; e < D / 2; ++e) o[e] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f};
  float s[32], alpha[2];
  uint32_t pa[4][4];

  // issue S = Q K_i^T (one commit group)
  const uint64_t q_desc = desc_k_major<D>(q_s);
  // O += P_i V_i from the A fragments in pa (one commit group)
  auto mma_pv = [&](int i) {
    const uint64_t v_desc = desc_n_major<D>(v_s(i & 1));
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs(o, pa[kk], v_desc + n_step<D>(kk));
    wgmma_commit();
  };
  // issue S = Q K_i^T (one commit group) and, for i > 0, O += P_{i-1}
  // V_{i-1} (a second), behind one fence
  auto issue = [&](int i) {
    const int st = i & 1;
    mbar_wait(k_full(st), (i >> 1) & 1);
    if (i > 0) mbar_wait(v_full((i - 1) & 1), ((i - 1) >> 1) & 1);
    fence_regs(s);                       // kk = 0 overwrites s (scale_d 0)
    fence_regs(o);
    wgmma_fence();
    const uint64_t k_desc = desc_k_major<D>(k_s(st));
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss_n64(s, q_desc + k_step<D>(kk), k_desc + k_step<D>(kk), kk);
    wgmma_commit();
    if (i > 0) mma_pv(i - 1);
  };
  // mask tile i's scores, update the running max and sum: s becomes P,
  // alpha the factor O must be rescaled by once the pending P V is done.
  // The two rows run side by side and every max and sum is a tree, so the
  // dependent chains are 4 deep, not 16.
  auto softmax = [&](int i) {
    const int k0 = k_begin + i * BKV;
    // every key of the tile valid for every row of the block?
    const bool full = k0 + BKV <= Tk &&
                      (!causal || k0 + BKV - 1 <= q0 + off) &&
                      (window <= 0 || k0 > last_row + off - window);
    if (!full) {
      // row r attends keys lo..hi; in the thread's column c = 8 j + e
      // (key k0 + 2 t + c) that is lo_c <= c <= hi_c
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int qpos = r0 + 8 * r + off, first = k0 + 2 * t;
        const int hi_c = (causal ? min(Tk - 1, qpos) : Tk - 1) - first;
        const int lo_c = (window > 0 ? qpos - window + 1 : 0) - first;
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            if (8 * j + e > hi_c || 8 * j + e < lo_c)
              s[4 * j + 2 * r + e] = -INFINITY;
      }
    }
    // row r's 16 values are s[4 j + 2 r + e], j < 8, e < 2
    float mx[2], m_use[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float v[8];
#pragma unroll
      for (int j = 0; j < 8; ++j)
        v[j] = fmaxf(s[4 * j + 2 * r], s[4 * j + 2 * r + 1]);
#pragma unroll
      for (int w = 4; w >= 1; w >>= 1)
#pragma unroll
        for (int j = 0; j < w; ++j) v[j] = fmaxf(v[j], v[j + w]);
      mx[r] = v[0];
    }
#pragma unroll
    for (int w = 1; w <= 2; w <<= 1)
#pragma unroll
      for (int r = 0; r < 2; ++r)
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], w));
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float m_new = fmaxf(m_run[r], mx[r] * scale_log2);
      m_use[r] = m_new == -INFINITY ? 0.f : m_new;
      alpha[r] = ex2(m_run[r] - m_use[r]);
      m_run[r] = m_new;
    }
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int idx = 4 * j + 2 * r + e;
          s[idx] = ex2(fmaf(s[idx], scale_log2, -m_use[r]));
        }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float v[8];
#pragma unroll
      for (int j = 0; j < 8; ++j)
        v[j] = s[4 * j + 2 * r] + s[4 * j + 2 * r + 1];
#pragma unroll
      for (int w = 4; w >= 1; w >>= 1)
#pragma unroll
        for (int j = 0; j < w; ++j) v[j] += v[j + w];
      l_run[r] = l_run[r] * alpha[r] + v[0];  // this thread's columns only
    }
  };
  // P as the A operand: k16 step kk holds keys 16 kk .. 16 kk + 15, the
  // accumulator's column blocks 2 kk and 2 kk + 1
  auto pack_p = [&]() {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int x = 0; x < 4; ++x)
        pa[kk][x] = pack_bf16(s[8 * kk + 2 * x], s[8 * kk + 2 * x + 1]);
  };

  // Software pipeline: the softmax of tile i runs on the CUDA cores while
  // the tensor cores do P_{i-1} V_{i-1}; O is rescaled once that is done.
  if (n_kv > 0) {
    mbar_wait(q_full, 0);
    issue(0);
    wgmma_wait<0>();
    fence_regs(s);
    mbar_arrive(k_freed(0));
    softmax(0);                          // O is still zero: no rescale
    pack_p();
    for (int i = 1; i < n_kv; ++i) {
      issue(i);
      wgmma_wait<1>();                   // S_i is in; P_{i-1} V_{i-1} may run
      fence_regs(s);
      mbar_arrive(k_freed(i & 1));
      softmax(i);
      wgmma_wait<0>();
      fence_regs(o);
      mbar_arrive(v_freed((i - 1) & 1));
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          o[4 * j + 2 * r] *= alpha[r];
          o[4 * j + 2 * r + 1] *= alpha[r];
        }
      pack_p();
    }
    mbar_wait(v_full((n_kv - 1) & 1), ((n_kv - 1) >> 1) & 1);
    fence_regs(o);
    wgmma_fence();
    mma_pv(n_kv - 1);
    wgmma_wait<0>();
    fence_regs(o);
    mbar_arrive(v_freed((n_kv - 1) & 1));
  }

  bf16* ob = out + (size_t)bh * S * D;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = l_run[r];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const float inv = l > 0.f ? 1.f / l : 0.f;
    const int row = r0 + 8 * r;
    if (row >= S) continue;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<uint32_t*>(ob + (size_t)row * D + 8 * j + 2 * t) =
          pack_bf16(o[4 * j + 2 * r] * inv, o[4 * j + 2 * r + 1] * inv);
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// the driver's tensor-map encoder, through the runtime (no -lcuda)
EncodeTiled encoder() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult status;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &status) != cudaSuccess ||
        status != cudaDriverEntryPointSuccess)
      p = nullptr;
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

// (D, rows, heads) bf16 tensor, boxes of (chunk, 64 rows, 1 head)
template <int D>
bool encode(CUtensorMap* map, const void* base, int rows, int heads) {
  using G = Tile<D>;
  const EncodeTiled fn = encoder();
  if (fn == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)D, (cuuint64_t)rows,
                              (cuuint64_t)heads};
  const cuuint64_t strides[2] = {(cuuint64_t)D * 2, (cuuint64_t)rows * D * 2};
  const cuuint32_t box[3] = {(cuuint32_t)G::kChunkCols, 64, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base),
            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
            G::kRowBytes == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                                : CU_TENSOR_MAP_SWIZZLE_64B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D>
cudaError_t run_wgmma(const void* q, const void* k, const void* v, void* out,
                      int b, int hq, int hk, int s, int t, int q_offset,
                      int causal, int window, float scale,
                      cudaStream_t stream) {
  const uintptr_t any_bits = reinterpret_cast<uintptr_t>(q) |
                             reinterpret_cast<uintptr_t>(k) |
                             reinterpret_cast<uintptr_t>(v);
  if (any_bits % 16 != 0) return cudaErrorMisalignedAddress;  // TMA bases
  CUtensorMap tq, tk, tv;
  if (!encode<D>(&tq, q, s, b * hq) || !encode<D>(&tk, k, t, b * hk) ||
      !encode<D>(&tv, v, t, b * hk))
    return cudaErrorInvalidValue;
  constexpr size_t smem = Tile<D>::kSmem;
  cudaError_t err = cudaFuncSetAttribute(
      flash_wgmma_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((s + BQ - 1) / BQ, b * hq);
  flash_wgmma_kernel<D><<<grid, kWgThreads, smem, stream>>>(
      tq, tk, tv, static_cast<bf16*>(out), hq, hk, s, t, q_offset, causal,
      window, scale * 1.4426950408889634f);
  return cudaGetLastError();
}

template <int D>
cudaError_t run(const void* q, const void* k, const void* v, void* out, int b,
                int hq, int hk, int s, int t, int q_offset, int causal,
                int window, float scale, int dtype, cudaStream_t stream) {
  if (dtype == kBFloat16)
    return run_wgmma<D>(q, k, v, out, b, hq, hk, s, t, q_offset, causal,
                        window, scale, stream);
  return run_ffma<D>(q, k, v, out, b, hq, hk, s, t, q_offset, causal, window,
                     scale, stream);
}
}  // namespace

// out (B, HQ, S, D) = softmax(q k^T * scale + mask) v for q (B, HQ, S, D),
// k/v (B, HK, T, D), query i at key position i + q_offset; window <= 0
// means no window; D in {32, 64, 128}.
extern "C" int repro_flash_attention(const void* q, const void* k,
                                     const void* v, void* out, int b, int hq,
                                     int hk, int s, int t, int d,
                                     int q_offset, int causal, int window,
                                     float scale, int dtype, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 32:
      return run<32>(q, k, v, out, b, hq, hk, s, t, q_offset, causal, window,
                     scale, dtype, st);
    case 64:
      return run<64>(q, k, v, out, b, hq, hk, s, t, q_offset, causal, window,
                     scale, dtype, st);
    case 128:
      return run<128>(q, k, v, out, b, hq, hk, s, t, q_offset, causal,
                      window, scale, dtype, st);
    default:
      return cudaErrorInvalidValue;
  }
}
