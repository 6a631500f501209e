// Paged decode attention: one query token per slot against a block-paged KV
// arena, read through the slot's block table; each slot's page walk is split
// over blocks, and the parts are combined in a fixed order (flash-decoding).
//
// Replaces: src/repro/kernels/paged_attention.py paged_attention_pallas (body
// _paged_kernel): q (B, HQ, 1, D) attends over the positions <= pos[b] of
// slot b, whose keys and values live in the pages block_tables[b, j] of the
// (TB, HK, BS, D) arenas (page j holds positions [j*BS, (j+1)*BS)); the GQA
// group of G = HQ / HK query heads shares one kv head; the softmax sums are
// fp32, and a row with nothing to attend (pos < 0) is written as zeros.
//
// What bounds it on the H100: the bytes.  Each attended page is read once
// (2 * BS * D elements for K and V) for about 4 * G * BS * D operations on
// them (G = 6 for qwen2-1.5B): some 6 operations per bf16 byte, far below
// the ~295 at which the tensor cores would become the limit.  But the bytes
// are few (8 slots at position 2047: 5.1 MB, ~1.5 us at 3.35 TB/s), so what
// costs time is latency: a block that walks its slot's pages one after
// another waits for each page in turn (~11 us a page in the first design,
// one block per (slot, kv head): 16 blocks on 132 SMs).
//
// What the design does about it:
// - Many blocks.  One block per (split, slot, kv head); a split is
//   kPagesPerSplit consecutive pages of the slot's table.  The grid is sized
//   from the table width NB (a static shape), so the host reads no pos; a
//   block whose split starts past its slot's last page exits at once.
// - Every copy of a split in flight at once.  The block reads pos and the
//   split's table entries together, then issues 16-byte cp.async copies of
//   all its K pages (one group) and all its V pages (a second), so the page
//   loads cost one memory latency, and the scores start while V still
//   lands.
// - Warp-parallel arithmetic.  Scores: 8 lanes per key, each multiplying
//   16-byte chunks of the key against the fp32 query rows of the group, then
//   3 shuffles; the G rows share every key load.  Softmax: a warp per row,
//   max and sum by shuffles.  P V: a thread per head dimension, the
//   probabilities read 4 keys at a time.
// - Each split writes its partial (m, l, acc[G][D]) in fp32 to a workspace
//   the wrapper allocates; a second kernel, one block per query row, merges
//   a slot's partials in split order: M = max m_s, L = sum l_s e^(m_s - M),
//   O = sum acc_s e^(m_s - M) / L.  No atomics: a slot's split boundaries
//   and the merge order follow from its own pos and kPagesPerSplit alone,
//   never from B, NB or the other slots, so a slot's output is the same bits
//   whatever it is batched with.  A slot with one split goes through the
//   same merge (e^0 = 1 exactly).
// - Keys past pos are never read, and pages past the slot's last are never
//   dereferenced (their table entries may be garbage).
#include <math.h>

#include "common.cuh"

namespace {
using namespace repro;

constexpr int kPagesPerSplit = 4;
constexpr int kThreads = 128;
constexpr int kLanesPerKey = 8;     // lanes that share one key's dot product
constexpr int kRowChunk = 8;        // query rows held in registers at once

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// pages of slot b that hold positions <= pos (0 for pos < 0), at most nb
__device__ __forceinline__ int pages_of(int pos, int bs, int nb) {
  return pos < 0 ? 0 : min(nb, pos / bs + 1);
}

__device__ __forceinline__ void widen(const float4& u, float (&v)[4]) {
  v[0] = u.x; v[1] = u.y; v[2] = u.z; v[3] = u.w;
}
__device__ __forceinline__ void widen(const float4& u, float (&v)[8]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

// Shared memory: K and V of the split's pages (input type), then the
// group's query rows (fp32) and the scores / probabilities (fp32).
size_t split_smem_bytes(int group, int bs, int d, int elem) {
  const size_t keys = (size_t)kPagesPerSplit * bs;
  return 2 * keys * d * elem + (size_t)group * d * 4 + (size_t)group * keys * 4;
}

// Grid (splits, B * HK).  part_acc (B * HK, splits, G, D) and part_ml
// (B * HK, splits, G, 2) receive this split's unnormalized output, row max
// and row sum.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    paged_attention_split_kernel(
        const T* __restrict__ q, const T* __restrict__ k_arena,
        const T* __restrict__ v_arena, const int* __restrict__ block_tables,
        const int* __restrict__ pos, float* __restrict__ part_acc,
        float* __restrict__ part_ml, int hk, int group, int bs, int d, int nb,
        float scale) {
  constexpr int kElems = 16 / sizeof(T);       // elements per 16-byte chunk
  const int split = blockIdx.x, splits = gridDim.x;
  const int bh = blockIdx.y, b = bh / hk, h = bh % hk;
  const int first = split * kPagesPerSplit;
  // the split's table entries are read beside pos (one memory latency for
  // both); pages past the slot's last are never dereferenced
  int phys[kPagesPerSplit];
#pragma unroll
  for (int j = 0; j < kPagesPerSplit; ++j)
    phys[j] = first + j < nb ? block_tables[(size_t)b * nb + first + j] : 0;
  const int p = pos[b];
  const int n_pages = pages_of(p, bs, nb);
  if (first >= n_pages) return;                // the whole block leaves
  const int pages = min(kPagesPerSplit, n_pages - first);
  const int keys = min(pages * bs, p + 1 - first * bs);
  const int max_keys = kPagesPerSplit * bs;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* ks = reinterpret_cast<T*>(smem_raw);      // (max_keys, d)
  T* vs = ks + (size_t)max_keys * d;           // (max_keys, d)
  float* qs = reinterpret_cast<float*>(vs + (size_t)max_keys * d);  // (G, d)
  float* sc = qs + group * d;                  // (G, max_keys)

  const int tid = threadIdx.x;
  // every page of the split in flight at once: K, then V
  const int chunks = bs * d / kElems;          // 16-byte chunks per page
  const size_t page_elems = (size_t)bs * d;
#pragma unroll
  for (int pass = 0; pass < 2; ++pass) {
    const T* arena = pass == 0 ? k_arena : v_arena;
    T* dst = pass == 0 ? ks : vs;
    for (int e = tid; e < pages * chunks; e += kThreads) {
      const int j = e / chunks, c = e - j * chunks;
      int pj = phys[0];
#pragma unroll
      for (int i = 1; i < kPagesPerSplit; ++i)
        if (j == i) pj = phys[i];
      cp_async16(dst + j * page_elems + (size_t)c * kElems,
                 arena + ((size_t)pj * hk + h) * page_elems +
                     (size_t)c * kElems);
    }
    cp_async_commit();
  }
  const T* qb = q + ((size_t)bh * group) * d;
  for (int e = tid; e < group * d; e += kThreads) qs[e] = to_float(qb[e]);
  cp_async_wait<1>();                          // K has landed
  __syncthreads();

  // scores: a warp takes 4 keys at a time, 8 lanes each
  const int warp = tid / 32, lane = tid % 32;
  const int sub = lane / kLanesPerKey, l8 = lane % kLanesPerKey;
  const int row_chunks = d / kElems;
  constexpr int kKeysPerPass = kThreads / kLanesPerKey;   // 16
  for (int t0 = warp * (32 / kLanesPerKey); t0 < keys; t0 += kKeysPerPass) {
    const int t = t0 + sub;
    for (int g0 = 0; g0 < group; g0 += kRowChunk) {
      float dot[kRowChunk];
#pragma unroll
      for (int g = 0; g < kRowChunk; ++g) dot[g] = 0.f;
      if (t < keys) {
        for (int c = l8; c < row_chunks; c += kLanesPerKey) {
          float kv[kElems];
          widen(*reinterpret_cast<const float4*>(ks + (size_t)t * d +
                                                 c * kElems), kv);
#pragma unroll
          for (int g = 0; g < kRowChunk; ++g) {
            if (g0 + g >= group) break;
            const float* qr = qs + (g0 + g) * d + c * kElems;
#pragma unroll
            for (int e = 0; e < kElems; ++e)
              dot[g] = fmaf(qr[e], kv[e], dot[g]);
          }
        }
      }
#pragma unroll
      for (int g = 0; g < kRowChunk; ++g)
#pragma unroll
        for (int off = kLanesPerKey / 2; off >= 1; off >>= 1)
          dot[g] += __shfl_xor_sync(0xffffffffu, dot[g], off);
      if (t < keys && l8 == 0) {
#pragma unroll
        for (int g = 0; g < kRowChunk; ++g)
          if (g0 + g < group) sc[(g0 + g) * max_keys + t] = dot[g] * scale;
      }
    }
  }
  __syncthreads();

  // softmax of each row over the split's keys: a warp per row
  float* ml = part_ml + ((size_t)bh * splits + split) * group * 2;
  for (int g = warp; g < group; g += kThreads / 32) {
    float* row = sc + g * max_keys;
    float mx = -INFINITY;
    for (int t = lane; t < keys; t += 32) mx = fmaxf(mx, row[t]);
#pragma unroll
    for (int off = 16; off >= 1; off >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    float sum = 0.f;
    for (int t = lane; t < keys; t += 32) {
      const float e = expf(row[t] - mx);
      row[t] = e;
      sum += e;
    }
#pragma unroll
    for (int off = 16; off >= 1; off >>= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, off);
    if (lane == 0) {
      ml[2 * g] = mx;
      ml[2 * g + 1] = sum;
    }
  }
  cp_async_wait<0>();                          // V has landed
  __syncthreads();

  // acc[g][c] = sum over keys of p[g][t] v[t][c]: a thread per dimension
  float* acc_out = part_acc + ((size_t)bh * splits + split) * group * d;
  const int keys4 = keys & ~3;
  for (int c = tid; c < d; c += kThreads) {
    for (int g0 = 0; g0 < group; g0 += kRowChunk) {
      float acc[kRowChunk];
#pragma unroll
      for (int g = 0; g < kRowChunk; ++g) acc[g] = 0.f;
      for (int t = 0; t < keys4; t += 4) {
        float v[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          v[i] = to_float(vs[(size_t)(t + i) * d + c]);
#pragma unroll
        for (int g = 0; g < kRowChunk; ++g) {
          if (g0 + g >= group) break;
          const float4 pr =
              *reinterpret_cast<const float4*>(sc + (g0 + g) * max_keys + t);
          acc[g] = fmaf(pr.x, v[0], acc[g]);
          acc[g] = fmaf(pr.y, v[1], acc[g]);
          acc[g] = fmaf(pr.z, v[2], acc[g]);
          acc[g] = fmaf(pr.w, v[3], acc[g]);
        }
      }
      for (int t = keys4; t < keys; ++t) {
        const float v = to_float(vs[(size_t)t * d + c]);
#pragma unroll
        for (int g = 0; g < kRowChunk; ++g) {
          if (g0 + g >= group) break;
          acc[g] = fmaf(sc[(g0 + g) * max_keys + t], v, acc[g]);
        }
      }
#pragma unroll
      for (int g = 0; g < kRowChunk; ++g)
        if (g0 + g < group) acc_out[(size_t)(g0 + g) * d + c] = acc[g];
    }
  }
}

// Grid (G, B * HK), D threads at most: block (g, b * HK + h) merges query
// row g of slot b's partials in split order into out (B, HQ, 1, D); a slot
// with no page (pos < 0) gets zeros.  The splits' weights e^(m_s - M) and
// sums l_s are staged in shared memory (dynamic: one float pair a split),
// so each output element is one pass of independent loads.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    paged_attention_combine_kernel(const float* __restrict__ part_acc,
                                   const float* __restrict__ part_ml,
                                   const int* __restrict__ pos,
                                   T* __restrict__ out, int hk, int group,
                                   int bs, int d, int nb, int splits) {
  extern __shared__ float weights[];       // f[s], then l[s]
  __shared__ float warp_max[kThreads / 32];
  const int g = blockIdx.x, bh = blockIdx.y, b = bh / hk;
  const int tid = threadIdx.x;
  const int used = (pages_of(pos[b], bs, nb) + kPagesPerSplit - 1) /
                   kPagesPerSplit;
  T* ob = out + ((size_t)bh * group + g) * d;
  if (used == 0) {
    for (int c = tid; c < d; c += kThreads) ob[c] = from_float<T>(0.f);
    return;
  }
  const float* ml = part_ml + (size_t)bh * splits * group * 2;
  float m = -INFINITY;
  for (int s = tid; s < used; s += kThreads)
    m = fmaxf(m, ml[(s * group + g) * 2]);
#pragma unroll
  for (int off = 16; off >= 1; off >>= 1)
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
  if (tid % 32 == 0) warp_max[tid / 32] = m;
  __syncthreads();
#pragma unroll
  for (int w = 0; w < kThreads / 32; ++w) m = fmaxf(m, warp_max[w]);
  float* f = weights;
  float* l = weights + used;
  for (int s = tid; s < used; s += kThreads) {
    f[s] = expf(ml[(s * group + g) * 2] - m);
    l[s] = ml[(s * group + g) * 2 + 1];
  }
  __syncthreads();
  float den = 0.f;                       // the same sum in every thread
  for (int s = 0; s < used; ++s) den = fmaf(l[s], f[s], den);
  const float* acc = part_acc + ((size_t)bh * splits * group + g) * d;
  for (int c = tid; c < d; c += kThreads) {
    float o = 0.f;
#pragma unroll 4
    for (int s = 0; s < used; ++s)
      o = fmaf(acc[(size_t)s * group * d + c], f[s], o);
    ob[c] = from_float<T>(o / den);
  }
}

template <typename T>
cudaError_t run(const void* q, const void* k_arena, const void* v_arena,
                const int* block_tables, const int* pos, void* out, void* ws,
                int b, int hk, int group, int bs, int d, int nb, float scale,
                cudaStream_t stream) {
  if ((d * (int)sizeof(T)) % 16 != 0) return cudaErrorInvalidValue;
  const size_t smem = split_smem_bytes(group, bs, d, sizeof(T));
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        paged_attention_split_kernel<T>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const int splits = (nb + kPagesPerSplit - 1) / kPagesPerSplit;
  float* part_acc = static_cast<float*>(ws);
  float* part_ml = part_acc + (size_t)b * hk * splits * group * d;
  paged_attention_split_kernel<T><<<dim3(splits, b * hk), kThreads, smem,
                                    stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_arena),
      static_cast<const T*>(v_arena), block_tables, pos, part_acc, part_ml,
      hk, group, bs, d, nb, scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t combine_smem = 2 * sizeof(float) * (size_t)splits;
  if (combine_smem > 48 * 1024) {
    err = cudaFuncSetAttribute(paged_attention_combine_kernel<T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)combine_smem);
    if (err != cudaSuccess) return err;
  }
  paged_attention_combine_kernel<T><<<dim3(group, b * hk), kThreads,
                                      combine_smem, stream>>>(
      part_acc, part_ml, pos, static_cast<T*>(out), hk, group, bs, d, nb,
      splits);
  return cudaGetLastError();
}
}  // namespace

// out (B, HK * group, 1, D) = attention of q (same shape) over the pages
// block_tables (B, nb) names in the (TB, HK, bs, D) arenas, positions <= pos.
// ws holds B * HK * ceil(nb / 4) * group * (D + 2) floats of scratch (the
// splits' partials).
extern "C" int repro_paged_attention(const void* q, const void* k_arena,
                                     const void* v_arena,
                                     const void* block_tables,
                                     const void* pos, void* out, void* ws,
                                     int b, int hk, int group, int bs, int d,
                                     int nb, float scale, int dtype,
                                     void* stream) {
  if (b < 1 || hk < 1 || group < 1 || bs < 1 || d < 1 || nb < 1 ||
      ws == nullptr || (nb + kPagesPerSplit - 1) / kPagesPerSplit > 65535 ||
      b * hk > 65535 || group > 65535)
    return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  auto bt = static_cast<const int*>(block_tables);
  auto ps = static_cast<const int*>(pos);
  if (dtype == kBFloat16)
    return run<__nv_bfloat16>(q, k_arena, v_arena, bt, ps, out, ws, b, hk,
                              group, bs, d, nb, scale, s);
  return run<float>(q, k_arena, v_arena, bt, ps, out, ws, b, hk, group, bs,
                    d, nb, scale, s);
}
