// Flash attention forward: causal (optionally sliding-window) GQA attention
// with an online softmax over key tiles; the (S, T) score matrix never
// leaves the block.
//
// Replaces: src/repro/kernels/flash_attention.py flash_attention_pallas (body
// _flash_kernel): q (B, HQ, S, D) against k/v (B, HK, T, D), each query head
// reading its group's kv head; tiles wholly above the causal diagonal or
// left of the window are skipped, the diagonal tiles masked elementwise.
// Unlike the Pallas kernel, which assumes S == T and block-aligned lengths
// (its wrapper pads), this kernel masks keys t >= T and rows >= S itself and
// aligns query ends with key ends (query i sits at position i + T - S, as
// the plain version does); a row with no key to attend is written as zeros.
//
// What bounds it on the H100: causal prefill does about 2 * S * T * D * HQ
// operations (half of 4 S T D HQ) and moves 2 * (2 S HQ + 2 T HK) * D bytes
// in bf16 (Q, K, V in, O out).  With qwen2-1.5B's 12 heads of 128 (2 kv
// heads) that is ~220 operations per byte at S = T = 512 (the bytes bound
// it) and ~880 at 2048 (the operations do; the crossover at ~295 is near
// 700 tokens).
//
// What the design does about it (first version, no tensor cores): a block
// of 256 threads owns 64 query rows of one head; each thread holds a 4 x 4
// tile of scores and a 4 x D/16 tile of the output in registers, with the
// running max and denominator of its 4 rows.  Q and each K tile are staged
// transposed in shared memory as fp32 (so a thread's reads over d are
// broadcast or consecutive across the warp), V reuses K's buffer, and the
// probabilities go through shared memory into the P @ V product.  Row
// reductions are shuffles within the 16 lanes that share a row.  All sums
// are fp32.  Moving both products onto wgmma with TMA-fed tiles is the known
// next step.
#include <math.h>

#include "common.cuh"

namespace {
using namespace repro;

constexpr int BQ = 64, BKV = 64, kThreads = 256, kPad = 4;
constexpr float kNegInf = -1e30f;

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out, int hq,
                       int hk, int S, int Tk, int causal, int window,
                       float scale) {
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
  const int q0 = blockIdx.x * BQ;
  const int off = Tk - S;                // query i sits at position i + off
  const T* qb = q + ((size_t)bh * S) * D;
  const T* kb = k + ((size_t)(b * hk + kh) * Tk) * D;
  const T* vb = v + ((size_t)(b * hk + kh) * Tk) * D;

  for (int e = tid; e < BQ * D; e += kThreads) {
    const int r = e / D, c = e % D;
    qt[c * LQ + r] = (q0 + r < S) ? to_float(qb[(size_t)(q0 + r) * D + c])
                                       * scale : 0.f;
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
      kv[c * LK + t] = (k0 + t < Tk) ? to_float(kb[(size_t)(k0 + t) * D + c])
                                     : 0.f;
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
      kv[e] = (k0 + t < Tk) ? to_float(vb[(size_t)k0 * D + e]) : 0.f;
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

  T* ob = out + ((size_t)bh * S) * D;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= S) continue;
#pragma unroll
    for (int j = 0; j < DC; ++j)
      ob[(size_t)row * D + tx + 16 * j] =
          from_float<T>(l[i] == 0.f ? 0.f : acc[i][j] / l[i]);
  }
}

template <typename T, int D>
cudaError_t run(const void* q, const void* k, const void* v, void* out, int b,
                int hq, int hk, int s, int t, int causal, int window,
                float scale, cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * ((size_t)D * (BQ + kPad) + (size_t)D * (BKV + kPad) +
                       (size_t)BKV * (BQ + kPad));
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_attention_kernel<T, D>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  dim3 grid((s + BQ - 1) / BQ, b * hq);
  flash_attention_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), hq, hk, s, t, causal,
      window, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(const void* q, const void* k, const void* v, void* out,
                       int b, int hq, int hk, int s, int t, int d, int causal,
                       int window, float scale, cudaStream_t stream) {
  switch (d) {
    case 32:
      return run<T, 32>(q, k, v, out, b, hq, hk, s, t, causal, window, scale,
                        stream);
    case 64:
      return run<T, 64>(q, k, v, out, b, hq, hk, s, t, causal, window, scale,
                        stream);
    case 128:
      return run<T, 128>(q, k, v, out, b, hq, hk, s, t, causal, window, scale,
                         stream);
    default:
      return cudaErrorInvalidValue;
  }
}
}  // namespace

// out (B, HQ, S, D) = softmax(q k^T * scale + mask) v for q (B, HQ, S, D),
// k/v (B, HK, T, D); window <= 0 means no window; D in {32, 64, 128}.
extern "C" int repro_flash_attention(const void* q, const void* k,
                                     const void* v, void* out, int b, int hq,
                                     int hk, int s, int t, int d, int causal,
                                     int window, float scale, int dtype,
                                     void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  if (dtype == kBFloat16)
    return dispatch_d<__nv_bfloat16>(q, k, v, out, b, hq, hk, s, t, d, causal,
                                     window, scale, st);
  return dispatch_d<float>(q, k, v, out, b, hq, hk, s, t, d, causal, window,
                           scale, st);
}
