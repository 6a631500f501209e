// Paged decode attention: one query token per slot against a block-paged KV
// arena, read through the slot's block table.
//
// Replaces: src/repro/kernels/paged_attention.py paged_attention_pallas (body
// _paged_kernel): q (B, HQ, 1, D) attends over the positions <= pos[b] of
// slot b, whose keys and values live in the pages block_tables[b, j] of the
// (TB, HK, BS, D) arenas (page j holds positions [j*BS, (j+1)*BS)); the GQA
// group of HQ / HK query heads shares one kv head; an online softmax folds
// the pages together, and a row with nothing to attend is written as zeros.
//
// What bounds it on the H100: the bytes.  Each attended page is read once
// (2 * BS * D elements for K and V) for about 4 * G * BS * D operations on
// them, G = HQ / HK (6 for qwen2-1.5B): some 6 operations per bf16 byte, far
// below the ~295 at which the tensor cores would become the limit.
//
// What the design does about it: one thread block per (slot, kv head), so
// the G query rows of a group share every page load and a page is read from
// device memory once per step, never gathered into a dense row.  The block
// walks only the pages with j * BS <= pos, so the work follows the slot's
// length, not the table's width, and table entries past the written pages
// are never dereferenced.  A page's K and V are staged in shared memory as
// fp32 (rows padded by one element, so threads on different keys hit
// different banks); the scores, running max, denominator and the G x D
// accumulator stay in shared memory, and every sum is fp32.  The number of
// blocks is B * HK (16 at 8 slots), far below 132 SMs: a split over pages
// with a combine pass (flash-decoding) is the known next step.
#include <math.h>

#include "common.cuh"

namespace {
using namespace repro;

constexpr int kThreads = 128;
constexpr float kNegInf = -1e30f;

template <typename T>
__global__ void paged_attention_kernel(
    const T* __restrict__ q, const T* __restrict__ k_arena,
    const T* __restrict__ v_arena, const int* __restrict__ block_tables,
    const int* __restrict__ pos, T* __restrict__ out, int hk, int group,
    int bs, int d, int nb, float scale) {
  extern __shared__ float smem[];
  const int dp = d + 1;                  // padded row of a staged page
  float* ks = smem;                      // (bs, d + 1)
  float* vs = ks + bs * dp;              // (bs, d + 1)
  float* qs = vs + bs * dp;              // (group, d)
  float* acc = qs + group * d;           // (group, d)
  float* sc = acc + group * d;           // (group, bs) scores, then probs
  float* m = sc + group * bs;            // (group,) running max
  float* l = m + group;                  // (group,) running denominator
  float* alpha = l + group;              // (group,) rescale of this page

  const int b = blockIdx.x / hk, h = blockIdx.x % hk;
  const int tid = threadIdx.x;
  const int p = pos[b];
  const int hq0 = h * group;             // first query head of the group
  const T* qb = q + ((size_t)b * hk * group + hq0) * d;
  for (int e = tid; e < group * d; e += kThreads) {
    qs[e] = to_float(qb[e]) * scale;
    acc[e] = 0.f;
  }
  for (int g = tid; g < group; g += kThreads) {
    m[g] = kNegInf;
    l[g] = 0.f;
  }
  int n_pages = p / bs + 1;              // pages holding positions <= p
  if (p < 0) n_pages = 0;
  if (n_pages > nb) n_pages = nb;
  __syncthreads();

  for (int j = 0; j < n_pages; ++j) {
    const int phys = block_tables[(size_t)b * nb + j];
    const size_t page = ((size_t)phys * hk + h) * bs * d;
    for (int e = tid; e < bs * d; e += kThreads) {
      const int t = e / d, c = e % d;
      ks[t * dp + c] = to_float(k_arena[page + e]);
      vs[t * dp + c] = to_float(v_arena[page + e]);
    }
    __syncthreads();
    // scores: one (row, key) pair per thread
    for (int e = tid; e < group * bs; e += kThreads) {
      const int g = e / bs, t = e % bs;
      float s = kNegInf;
      if (j * bs + t <= p) {
        const float* qr = qs + g * d;
        const float* kr = ks + t * dp;
        s = 0.f;
        for (int c = 0; c < d; ++c) s = fmaf(qr[c], kr[c], s);
      }
      sc[e] = s;
    }
    __syncthreads();
    // online softmax update: one thread per query row
    for (int g = tid; g < group; g += kThreads) {
      float mx = m[g];
      for (int t = 0; t < bs; ++t) mx = fmaxf(mx, sc[g * bs + t]);
      float sum = 0.f;
      for (int t = 0; t < bs; ++t) {
        const float pr = (j * bs + t <= p) ? expf(sc[g * bs + t] - mx) : 0.f;
        sc[g * bs + t] = pr;
        sum += pr;
      }
      alpha[g] = expf(m[g] - mx);
      l[g] = alpha[g] * l[g] + sum;
      m[g] = mx;
    }
    __syncthreads();
    // acc = acc * alpha + probs @ V: one (row, dim) element per thread
    for (int e = tid; e < group * d; e += kThreads) {
      const int g = e / d, c = e % d;
      float a = acc[e] * alpha[g];
      const float* pr = sc + g * bs;
      for (int t = 0; t < bs; ++t) a = fmaf(pr[t], vs[t * dp + c], a);
      acc[e] = a;
    }
    __syncthreads();
  }

  T* ob = out + ((size_t)b * hk * group + hq0) * d;
  for (int e = tid; e < group * d; e += kThreads) {
    const float den = l[e / d];
    ob[e] = from_float<T>(den == 0.f ? 0.f : acc[e] / den);
  }
}

size_t smem_bytes(int group, int bs, int d) {
  return sizeof(float) *
         (2 * (size_t)bs * (d + 1) + 2 * (size_t)group * d +
          (size_t)group * bs + 3 * (size_t)group);
}

template <typename T>
cudaError_t run(const void* q, const void* k_arena, const void* v_arena,
                const int* block_tables, const int* pos, void* out, int b,
                int hk, int group, int bs, int d, int nb, float scale,
                cudaStream_t stream) {
  const size_t smem = smem_bytes(group, bs, d);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        paged_attention_kernel<T>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  paged_attention_kernel<T><<<b * hk, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_arena),
      static_cast<const T*>(v_arena), block_tables, pos, static_cast<T*>(out),
      hk, group, bs, d, nb, scale);
  return cudaGetLastError();
}
}  // namespace

// out (B, HK * group, 1, D) = attention of q (same shape) over the pages
// block_tables (B, nb) names in the (TB, HK, bs, D) arenas, positions <= pos.
extern "C" int repro_paged_attention(const void* q, const void* k_arena,
                                     const void* v_arena,
                                     const void* block_tables,
                                     const void* pos, void* out, int b,
                                     int hk, int group, int bs, int d, int nb,
                                     float scale, int dtype, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  auto bt = static_cast<const int*>(block_tables);
  auto ps = static_cast<const int*>(pos);
  if (dtype == kBFloat16)
    return run<__nv_bfloat16>(q, k_arena, v_arena, bt, ps, out, b, hk, group,
                              bs, d, nb, scale, s);
  return run<float>(q, k_arena, v_arena, bt, ps, out, b, hk, group, bs, d, nb,
                    scale, s);
}
