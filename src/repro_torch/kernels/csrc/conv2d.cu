// Implicit-GEMM convolution on the tensor cores in 3xTF32, with a fused
// bias + activation epilogue — the Conv module (paper Table III, 'Conv
// Layer').
//
// Replaces: src/repro/kernels/conv2d.py conv2d_pallas (body _conv2d_kernel):
// NHWC convolution with stride and zero padding, filters taken tap-major as a
// (KH*KW*IC, OC) matrix, then bias and activation, written in the input
// dtype; output geometry by floor division.
//
// What bounds it on the H100: fp32-accurate operations.  Every AlexNet conv
// at serving batch does hundreds of operations per byte it must move (Conv2
// at batch 64: 57 GFLOP over 68 MB), far above the ridge.  Direct
// convolution at batch 64 does 13.5 (Conv1), 57.3 (Conv2) and 67.0 (Conv3-5)
// GFLOP: at the 67 TFLOP/s FFMA peak at least 0.20, 0.86 and 1.00 ms, and at
// the ~47 % of that peak the pipelined FFMA GEMM of matmul.cu reaches, about
// 4 ms in all, slower than cuDNN's 2.7 ms (Winograd and FFT at Conv2).  So
// the CUDA cores cannot win here; the tensor cores must do the products.
// Plain TF32 keeps ~3 digits and breaks the fp32 gates at these K
// (2,304-3,456).  3xTF32 keeps fp32 accuracy: each operand x is split into
// hi = tf32(x) and lo = tf32(x - hi) (cvt.rna, round to nearest), and
// hi*hi + hi*lo + lo*hi is summed in the fp32 accumulator (lo*lo, below fp32
// rounding, is dropped).  Three TF32 products at the 495 TFLOP/s dense rate
// give 165 TFLOP/s of fp32-accurate product, 2.5x the FFMA peak.
//
// The design:
// - GEMM view.  M = N*OH*OW output pixels, N = OC, K = KH*KW*IC in tap-major
//   order (kh, kw, ic), as conv2d_pallas orders it.  No im2col matrix goes
//   to device memory; a padding tap is read as zeros.
// - B (filters).  A pre-pass kernel (split_filters_kernel) reads the
//   (OC, IC, KH, KW) filters once per call and writes w_hi and w_lo as
//   (OC, Kp) fp32, K-major, tap-major, zero past K (Kp = K rounded up to
//   kBK): wgmma's TF32 form takes K-major B only.  Its time counts in the
//   kernel's.  The main kernel copies B_hi and B_lo tiles into shared memory
//   in the 128-byte-swizzled K-major layout wgmma reads (a tile row is one
//   filter's 32 k values, 128 bytes; 16-byte chunk c of row n sits at chunk
//   c ^ (n % 8)).
// - A (patches).  cp.async copies each output pixel's patch slice into a
//   ring of kStages shared-memory stages, issued right after a stage's
//   products so that the copies run under them.  Where IC % 4 == 0
//   (Conv2-5: 96, 256, 384) one 16-byte copy moves 4 channels of one tap; a
//   thread's chunk has the same k in all its rows, whose patch origins it
//   keeps in registers, and its tap advances by kBK a stage with no
//   division.  Conv1 (IC = 3: K = 363, rows not 16-byte multiples) takes a
//   4-byte cp.async loader in the same kernel, chosen in the C entry point;
//   nothing is padded or routed elsewhere.
// - Products.  A leaves shared memory into registers, in the wgmma A
//   fragment layout, and is split into hi and lo there (two integer
//   operations each); each k8 step issues three wgmma m64nNk8 TF32 products
//   (A_hi B_hi, A_hi B_lo, A_lo B_hi).  The tensor cores round their sums
//   toward zero, which over K = 3456 cost 1.7-2.6e-5 of a layer's largest
//   output (measured): so each stage's products go into a fresh fp32
//   partial that joins the running sum in one fp32 add, rounded to nearest
//   (4-7e-7, as close as cuDNN's fp32 convolution).
// - bf16 inputs take one TF32 product: a bf16 value is exact in TF32, so
//   its lo parts are zero.  They load A through a synchronous scalar loader
//   that widens to fp32 in shared memory (bf16 is off AlexNet's path).
// - Epilogue.  Bias and activation on the accumulator; the output is
//   written once.
// - Filling the card.  A block is one warpgroup of 64 output pixels; two
//   blocks share an SM (~86 KB of shared memory and under 256 registers a
//   thread each), so one block's copies, splits and waits run under the
//   other's products.  N is 96 or 128, whichever takes fewer waves of 264
//   blocks times the tile's width.  At batch 64: Conv1 (N 96) 3,025 blocks,
//   11.5 waves; Conv2 (128) 1,458, 5.5; Conv3-4 (128) 507, 1.9; Conv5 (96:
//   OC 256 as 3 tiles) 507, 1.9 (N 128 would give 338 blocks in 2 waves).
//   Measured against one block of two warpgroups sharing the B tiles (4
//   stages), this was 4 % faster over Conv1-5 (21 % at Conv1).
#include <climits>

#include "common.cuh"
#include "wgmma.cuh"

namespace {
using namespace repro;

constexpr int kBM = 64;            // output pixels per block: one warpgroup
constexpr int kBK = 32;            // k per stage: one 128-byte row of fp32
constexpr int kStages = 2;
constexpr int kThreads = 128;
constexpr int kBlocksPerSM = 2;
constexpr int kAPad = 4;           // A rows padded to kBK + 4 floats
constexpr int kALd = kBK + kAPad;  // (fragment reads then hit 32 banks)
constexpr int kNarrowN = 96;       // the two N tiles
constexpr int kWideN = 128;
constexpr int kSMs = 132;
static_assert(kBK == 32, "a B tile row is one 128-byte swizzle span");

// Shared memory of one block: kStages x (B_hi, B_lo, A), then the per-row
// patch origins; the B tiles 1024-byte aligned for the 128-byte swizzle.
template <int BN>
struct Smem {
  static constexpr int kBBytes = BN * kBK * 4;
  static constexpr int kABytes = kBM * kALd * 4;
  static constexpr int kStageBytes = 2 * kBBytes + kABytes;
  static_assert(kStageBytes % 1024 == 0, "stages keep 1024-byte alignment");
  static constexpr size_t kBytes =
      (size_t)kStages * kStageBytes + kBM * 16 + 1024;
  static_assert(kBytes <= 232448, "227 KB of shared memory per block");
};

// x rounded to TF32 (10 mantissa bits), to nearest, ties away from zero:
// cvt.rna.tf32.f32's rule, in two integer operations (half a TF32 ulp added
// to the magnitude, the 13 low bits cleared)
__device__ __forceinline__ uint32_t tf32_bits(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
}

// w (OC, IC, KH, KW) -> w_hi, w_lo (OC, kp) fp32, tap-major, zero past K
template <typename T>
__global__ void split_filters_kernel(const T* __restrict__ w,
                                     float* __restrict__ w_hi,
                                     float* __restrict__ w_lo, int OC, int IC,
                                     int KH, int KW, int kp) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (int64_t)OC * kp) return;
  const int oc = (int)(i / kp), k = (int)(i % kp);
  float hi = 0.f, lo = 0.f;
  if (k < KH * KW * IC) {
    const int tap = k / IC, ic = k - tap * IC;
    const int kh = tap / KW, kw = tap - kh * KW;
    const float v = to_float(w[(((int64_t)oc * IC + ic) * KH + kh) * KW + kw]);
    hi = __uint_as_float(tf32_bits(v));
    lo = __uint_as_float(tf32_bits(v - hi));
  }
  w_hi[i] = hi;
  w_lo[i] = lo;
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
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

// d (m64 x n96, fp32) += A (registers, tf32) @ B (smem, K-major, tf32)
__device__ __forceinline__ void wgmma_tf32(float (&d)[48],
                                           const uint32_t (&a)[4],
                                           uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %53, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47"
      "}, {%48, %49, %50, %51}, %52, p, 1, 1;\n}\n"
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
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

// d (m64 x n128, fp32) += A (registers, tf32) @ B (smem, K-major, tf32)
__device__ __forceinline__ void wgmma_tf32(float (&d)[64],
                                           const uint32_t (&a)[4],
                                           uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
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
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

struct Geometry {
  int M, H, W, IC, OC, KW, OH, OW, stride, pad, K, kp;
};

// A thread's place in the reduction: k, its tap (kh, kw) and channel ic,
// and their offset from a patch origin in the NHWC image.  Stages are
// issued in order, so where IC >= kBK the tap advances by kBK with at most
// one carry and no division: channels are contiguous, and a wrap of kw into
// the next kh skips W - KW pixels.
struct Tap {
  int k, kh, kw, ic, off;
  __device__ __forceinline__ Tap(const Geometry& g, int k0) : k(k0) {
    const int t = k0 / g.IC;
    ic = k0 - t * g.IC;
    kh = t / g.KW;
    kw = t - kh * g.KW;
    off = (kh * g.W + kw) * g.IC + ic;
  }
  __device__ __forceinline__ void advance(const Geometry& g) {
    k += kBK;
    ic += kBK;
    off += kBK;
    while (ic >= g.IC) {
      ic -= g.IC;
      if (++kw == g.KW) {
        kw = 0;
        ++kh;
        off += (g.W - g.KW) * g.IC;
      }
    }
  }
};

// One thread's share of the copies into a stage, issued stage after stage.
// A: kBM rows x kBK k of patches.  kVec (IC % 4 == 0, fp32, 16-byte
// aligned x): 16-byte copies of 4 channels of one tap, the thread's kRows
// rows kept in registers, the tap advanced stage by stage; else one element
// at a time (fp32: 4-byte cp.async; bf16: a load widened to fp32 and a
// shared store), the rows' origins read from shared memory, the tap found
// by division (at IC = 3 a stage crosses ~10 taps).  B_hi / B_lo: BN rows
// x kBK k; the thread's 16-byte chunk c of filter n lands at chunk
// c ^ (n % 8) of its 128-byte row (the 128-byte swizzle).
template <typename T, int BN, bool kVec, int kProducts>
struct Loader {
  static constexpr int kCols = kVec ? kBK / 4 : kBK;   // copies per A row
  static constexpr int kRowStep = kThreads / kCols;
  static constexpr int kRows = kBM / kRowStep;         // A rows per thread
  static constexpr int kBPerRow = kBK / 4;             // B chunks per row
  static constexpr int kNStep = kThreads / kBPerRow;
  static constexpr int kBCopies = BN / kNStep;         // B chunks per thread
  static_assert(BN % kNStep == 0 && kNStep % 8 == 0, "B copy layout");

  const Geometry& g;
  const T* x;
  Tap tap;
  int row0;
  const T* src[kVec ? kRows : 1];      // patch origins (kVec)
  int ih0[kVec ? kRows : 1], iw0[kVec ? kRows : 1];
  const int* s_ih0;                    // patch origins in shared memory
  const int* s_iw0;
  const int64_t* s_off;
  const float* b_src;                  // this thread's first B chunk, hi
  int64_t b_lo;                        // lo chunk = hi chunk + b_lo
  int b_step;                          // between its B chunks (floats)
  uint32_t b_dst;                      // its first chunk's tile offset
  int b_rows_ok;                       // its chunks j < b_rows_ok are filters

  __device__ __forceinline__ Loader(const Geometry& g_, const T* x_,
                                    const float* w_hi, const float* w_lo,
                                    int m0, int n0, const int64_t* off,
                                    const int* ih, const int* iw)
      : g(g_), x(x_),
        tap(g_, kVec ? 4 * (threadIdx.x % kCols) : threadIdx.x % kCols),
        row0(threadIdx.x / kCols), s_ih0(ih), s_iw0(iw), s_off(off) {
    if constexpr (kVec) {
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const int r = row0 + i * kRowStep;
        src[i] = x + off[r];
        ih0[i] = ih[r];
        iw0[i] = iw[r];
      }
    }
    const int n = threadIdx.x / kBPerRow, c = threadIdx.x % kBPerRow;
    b_src = w_hi + (int64_t)(n0 + n) * g.kp + 4 * c;
    b_lo = w_lo - w_hi;
    b_step = kNStep * g.kp;
    b_dst = (n / 8) * 1024 + (n % 8) * 128 + ((c ^ (n % 8)) * 16);
    b_rows_ok = n0 + n >= g.OC ? 0 : (g.OC - 1 - n0 - n) / kNStep + 1;
  }

  __device__ __forceinline__ bool inside(int ih, int iw) const {
    return tap.k < g.K && (unsigned)(ih + tap.kh) < (unsigned)g.H &&
           (unsigned)(iw + tap.kw) < (unsigned)g.W;
  }

  // issue the copies of the next stage into a, b_hi_s, b_lo_s
  __device__ __forceinline__ void issue(uint32_t a, uint32_t b_hi_s,
                                        uint32_t b_lo_s) {
    if constexpr (kVec) {
      const uint32_t col = 4 * (threadIdx.x % kCols);
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const bool ok = inside(ih0[i], iw0[i]);
        cp_async16(a + ((row0 + i * kRowStep) * kALd + col) * 4,
                   ok ? src[i] + tap.off : x, ok ? 16 : 0);
      }
    } else {
      const uint32_t col = threadIdx.x % kCols;
      tap = Tap(g, tap.k);
#pragma unroll 4
      for (int i = 0; i < kRows; ++i) {
        const int r = row0 + i * kRowStep;
        const bool ok = inside(s_ih0[r], s_iw0[r]);
        const uint32_t dst = a + (r * kALd + col) * 4;
        if constexpr (sizeof(T) == 4) {
          cp_async4(dst, ok ? x + s_off[r] + tap.off : x, ok ? 4 : 0);
        } else {
          const float v = ok ? to_float(x[s_off[r] + tap.off]) : 0.f;
          asm volatile("st.shared.f32 [%0], %1;\n" ::"r"(dst), "f"(v)
                       : "memory");
        }
      }
    }
#pragma unroll
    for (int j = 0; j < kBCopies; ++j) {
      const bool ok = j < b_rows_ok;
      const uint32_t dst = b_dst + j * (kNStep / 8) * 1024;
      const float* src = b_src + (int64_t)j * b_step;
      // a chunk past OC reads nothing and is zero-filled (x: any valid
      // address)
      const void* none = x;
      cp_async16(b_hi_s + dst, ok ? (const void*)src : none, ok ? 16 : 0);
      if constexpr (kProducts > 1)
        cp_async16(b_lo_s + dst, ok ? (const void*)(src + b_lo) : none,
                   ok ? 16 : 0);
    }
    if constexpr (kVec)
      tap.advance(g);
    else
      tap.k += kBK;
    b_src += kBK;
  }
};

// K-major B tile of BN rows, 128-byte swizzle: 8-row groups 1024 bytes apart
__device__ __forceinline__ uint64_t desc_b(uint32_t tile) {
  return make_desc(tile, 16, 1024, 1);
}

template <typename T, int BN, bool kVec, int kProducts>
__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
    conv2d_tf32_kernel(const T* __restrict__ x, const float* __restrict__ w_hi,
                       const float* __restrict__ w_lo,
                       const T* __restrict__ bias, T* __restrict__ out,
                       Geometry g, int act) {
  using S = Smem<BN>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  unsigned char* gbase = smem_raw + (base - raw);
  int64_t* row_off =
      reinterpret_cast<int64_t*>(gbase + (size_t)kStages * S::kStageBytes);
  int* ih0 = reinterpret_cast<int*>(row_off + kBM);
  int* iw0 = ih0 + kBM;

  const int tid = threadIdx.x;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * kBM;
  // each output pixel's patch origin: its window's top-left tap (possibly
  // in the padding) and that tap's offset in x; rows past M read padding
  for (int r = tid; r < kBM; r += kThreads) {
    const int m = m0 + r;
    if (m < g.M) {
      const int n = m / (g.OH * g.OW), p = m % (g.OH * g.OW);
      ih0[r] = (p / g.OW) * g.stride - g.pad;
      iw0[r] = (p % g.OW) * g.stride - g.pad;
      row_off[r] = ((int64_t)n * g.H * g.W + (int64_t)ih0[r] * g.W + iw0[r]) *
                   g.IC;
    } else {
      ih0[r] = INT_MIN / 2;
      iw0[r] = INT_MIN / 2;
      row_off[r] = 0;
    }
  }
  __syncthreads();
  Loader<T, BN, kVec, kProducts> load(g, x, w_hi, w_lo, m0, n0, row_off, ih0,
                                      iw0);

  constexpr int kAcc = BN / 2;
  float acc[kAcc], part[kAcc];
#pragma unroll
  for (int i = 0; i < kAcc; ++i) acc[i] = part[i] = 0.f;

  // this thread's A fragment: rows warp*16 + gr (+8), k t (+4)
  const int warp = tid / 32, lane = tid % 32;
  const int gr = lane / 4, t = lane % 4;
  const float* a_frag = reinterpret_cast<const float*>(gbase + 2 * S::kBBytes) +
                        (warp * 16 + gr) * kALd + t;

  const int steps = g.kp / kBK;
  // stage st: B_hi, B_lo, A
  auto stage = [=](int st) { return base + st * S::kStageBytes; };
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < steps)
      load.issue(stage(s) + 2 * S::kBBytes, stage(s), stage(s) + S::kBBytes);
    cp_async_commit();
  }
  int st = 0, next = kStages - 1;      // ring slots of `step`, step + S - 1
  for (int step = 0; step < steps; ++step) {
    cp_async_wait<kStages - 2>();    // this thread's copies of `step` landed
    // make them visible to wgmma's (async proxy) reads of B
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();                 // ... every thread's; and stage
                                     // step - 1 is free again
    const float* a = a_frag + st * (S::kStageBytes / 4);
    uint32_t a_hi[kBK / 8][4], a_lo[kBK / 8][4];
#pragma unroll
    for (int kk = 0; kk < kBK / 8; ++kk) {
      const float v[4] = {a[kk * 8], a[8 * kALd + kk * 8], a[kk * 8 + 4],
                          a[8 * kALd + kk * 8 + 4]};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        a_hi[kk][e] = tf32_bits(v[e]);
        a_lo[kk][e] = tf32_bits(v[e] - __uint_as_float(a_hi[kk][e]));
      }
    }
    const uint64_t d_hi = desc_b(stage(st)),
                   d_lo = desc_b(stage(st) + S::kBBytes);
    fence_regs(part);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 8; ++kk) {
      // k8 step kk: 32 bytes further along each 128-byte row
      const uint64_t off = (kk * 32) >> 4;
      // the stage's first product starts a fresh partial (scale_d 0)
      wgmma_tf32(part, a_hi[kk], d_hi + off, kk > 0);
      if constexpr (kProducts > 1) {
        wgmma_tf32(part, a_hi[kk], d_lo + off, 1);
        wgmma_tf32(part, a_lo[kk], d_hi + off, 1);
      }
    }
    wgmma_commit();
    // the next copies go out while the tensor cores work
    if (step + kStages - 1 < steps)
      load.issue(stage(next) + 2 * S::kBBytes, stage(next),
                 stage(next) + S::kBBytes);
    cp_async_commit();
    wgmma_wait<0>();
    fence_regs(part);
    // the tensor cores round their sums toward zero: each stage's partial
    // joins the running sum in an fp32 add, rounded to nearest
#pragma unroll
    for (int i = 0; i < kAcc; ++i) acc[i] += part[i];
    st = st + 1 == kStages ? 0 : st + 1;
    next = next + 1 == kStages ? 0 : next + 1;
  }
  cp_async_wait<0>();

  // accumulator: rows gr and gr + 8 of the warp's 16, in each n8 block j
  // the columns 8 j + 2 t and 8 j + 2 t + 1
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int m = m0 + warp * 16 + gr + 8 * r;
    if (m >= g.M) continue;
    T* orow = out + (int64_t)m * g.OC;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int oc = n0 + 8 * j + 2 * t + e;
        if (oc >= g.OC) continue;
        float v = acc[4 * j + 2 * r + e];
        if (bias != nullptr) v += to_float(bias[oc]);
        orow[oc] = from_float<T>(activate(v, act));
      }
    }
  }
}

// The N tile: the one whose grid costs less in waves of kSMs *
// kBlocksPerSM blocks times the tile's width; the narrow one on a tie.  OC
// 96 takes 96; at batch 64 Conv2-4 take 128, Conv5 (OC 256, 169 M tiles)
// 96: 507 blocks in 2 waves rather than 338 in 2, each a third narrower.
bool narrow_tile(int m, int oc) {
  const int64_t m_tiles = (m + kBM - 1) / kBM;
  auto cost = [&](int bn) {
    const int64_t blocks = m_tiles * ((oc + bn - 1) / bn);
    return (blocks + kSMs * kBlocksPerSM - 1) / (kSMs * kBlocksPerSM) * bn;
  };
  return cost(kNarrowN) <= cost(kWideN);
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

template <typename T, int BN, bool kVec>
cudaError_t launch_main(const T* x, const float* w_hi, const float* w_lo,
                        const T* bias, T* out, const Geometry& g, int act,
                        cudaStream_t stream) {
  constexpr int kProducts = sizeof(T) == 4 ? 3 : 1;
  auto kernel = conv2d_tf32_kernel<T, BN, kVec, kProducts>;
  constexpr size_t smem = Smem<BN>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((g.OC + BN - 1) / BN, (g.M + kBM - 1) / kBM);
  kernel<<<grid, kThreads, smem, stream>>>(x, w_hi, w_lo, bias, out, g, act);
  return cudaGetLastError();
}

template <typename T>
cudaError_t run(const void* xv, const void* wv, const void* bv, void* ov,
                void* ws, int n, int h, int w, int ic, int oc, int kh, int kw,
                int oh, int ow, int stride, int pad, int act,
                cudaStream_t stream) {
  const T* x = static_cast<const T*>(xv);
  const T* bias = static_cast<const T*>(bv);
  T* out = static_cast<T*>(ov);
  const int K = kh * kw * ic, kp = (K + kBK - 1) / kBK * kBK;
  float* w_hi = static_cast<float*>(ws);
  float* w_lo = w_hi + (size_t)oc * kp;
  const int64_t total = (int64_t)oc * kp;
  split_filters_kernel<T><<<(unsigned)((total + 255) / 256), 256, 0, stream>>>(
      static_cast<const T*>(wv), w_hi, w_lo, oc, ic, kh, kw, kp);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const Geometry g{n * oh * ow, h, w, ic, oc, kw, oh, ow, stride, pad, K, kp};
  const bool vec = sizeof(T) == 4 && ic % 4 == 0 && aligned16(x);
  if (narrow_tile(g.M, oc))
    return vec ? launch_main<T, kNarrowN, true>(x, w_hi, w_lo, bias, out, g,
                                                act, stream)
               : launch_main<T, kNarrowN, false>(x, w_hi, w_lo, bias, out, g,
                                                 act, stream);
  return vec ? launch_main<T, kWideN, true>(x, w_hi, w_lo, bias, out, g, act,
                                            stream)
             : launch_main<T, kWideN, false>(x, w_hi, w_lo, bias, out, g, act,
                                             stream);
}
}  // namespace

// out (n, oh, ow, oc) = act(conv(x (n, h, w, ic), w (oc, ic, kh, kw)) +
// bias (oc)); bias may be null.  ws holds 2 * oc * kp floats of scratch
// (the split filters), kp = kh * kw * ic rounded up to a multiple of 32.
extern "C" int repro_conv2d(const void* x, const void* w, const void* bias,
                            void* out, void* ws, int n, int h, int wd, int ic,
                            int oc, int kh, int kw, int oh, int ow,
                            int stride, int pad, int act, int dtype,
                            void* stream) {
  if (n < 1 || ic < 1 || oc < 1 || oh < 1 || ow < 1 || ws == nullptr ||
      (int64_t)n * oh * ow > (int64_t)65535 * kBM)
    return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == kBFloat16)
    return run<__nv_bfloat16>(x, w, bias, out, ws, n, h, wd, ic, oc, kh, kw,
                              oh, ow, stride, pad, act, s);
  return run<float>(x, w, bias, out, ws, n, h, wd, ic, oc, kh, kw, oh, ow,
                    stride, pad, act, s);
}
