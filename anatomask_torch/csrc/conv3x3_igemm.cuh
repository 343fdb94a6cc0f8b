// The implicit-GEMM stride-1 3x3x3 convolution for Hopper (sm_90a), NDHWC x
// DHWIO, shared by csrc/conv3x3.cu (one rounding) and csrc/zslab_conv.cu (each
// first-axis tap rounded to the output type).
//
// Padding P in {0, 1, 2} on every side: output voxel o reads input voxels
// o + t - P, t = 0, 1, 2, so an output extent is the input's + 2P - 2. P = 1
// is the "same" conv of the dense paths; P = 0 the VALID conv of a halo'd
// block (e^3 -> (e-2)^3, the block-sparse encoder's forward); P = 2 the
// "full" conv ((e-2)^3 -> e^3), which is that forward's dx.
//
// Form: M = B*Xo*Yo*Zo output voxels (z fastest), N = F, K = 27*C ordered
// (tap = dx*9 + dy*3 + dz, c), so the first-axis taps are the K ranges
// [0, 9C), [9C, 18C), [18C, 27C). The input tile is gathered on the fly (the
// zero halo and the ragged edges are masked in the load, never padded in
// device memory). Every term accumulates in fp32.
//
// Bound on the H100: the paths' convs (C, F >= 32) do at least 2*27*32 FLOP
// per byte moved, far above the card's ~295 FLOP/byte ridge, so they are bound
// by operations: 989 TFLOP/s bf16 on the tensor cores, reachable only through
// wgmma. In fp32 the FP32 pipe gives 67 TFLOP/s; the tensor cores' 495 TFLOP/s
// of TF32 keep 11 significant bits, so a product accurate to fp32 takes three
// of them (below): 165 TFLOP/s. Three variants here, and the stems of both
// dtypes (C <= 8, bound by bytes) in conv3x3_stem.cuh; ops/conv3x3.py
// `conv_variant` picks one from dtype, shape and alignment alone:
//
// hopper (namespace hopper): bf16 with C % 32 == 0, F % 32 == 0 and 16-byte
//   aligned pointers, the weight repacked K-major to (F, 27*C). A 256-thread
//   block (two warpgroups) owns a 128 x BN output tile, BN the largest of 128,
//   64, 32 dividing F (so F = 32 fills its tile), and walks K in BK steps
//   (BK = 64 where C % 64 == 0, else 32; BK divides C, so a step lies in one
//   tap). Every thread issues 16-byte cp.async copies of the A (im2col) and B
//   tiles into a 4-stage ring in dynamic shared memory, swizzled as wgmma's
//   128-byte (BK = 64) or 64-byte (BK = 32) K-major layout; a halo or ragged
//   row copies with src-size 0, which zero-fills. Each warpgroup multiplies its
//   64 rows with wgmma.m64nBNk16 (inline PTX, shared-memory descriptors), one
//   commit group a K step, one group kept in flight while the next stages
//   land. The address math is hoisted: each row's voxel and its 27-bit mask of
//   in-volume taps are computed once a block, and so are the two wgmma
//   descriptors; a K step advances a (tap, channel) counter, reads one tap
//   offset and adds a stage offset to the descriptors (no division).
//   The tensor cores' fp32 accumulation drifts over a long chain of products
//   (on an NVIDIA H100 80GB HBM3 at 700 W the taps of a 9C = 1728 chain
//   rounded to the other bf16 value 4.3x as often as a round-to-nearest fp32
//   sum, 63% of them toward zero; kernel #1's sums of 27C = 2592 to 41472
//   products 8-24x as often), so both flags run one K loop that chains a
//   group of K steps (PROMOTE = 4 per tap, PROMOTE_ONCE = 8 rounded once) at
//   a time from scale-d = 0 and adds each retired group to an fp32 sum on
//   the FP32 pipe; a group
//   ends at its segment's end, and its first step, after issuing its copies,
//   waits for the group before and folds it (the other steps carry no
//   branch). PER_TAP = false: the segment is all of K and the sum is rounded
//   once, in the epilogue. PER_TAP = true: a segment is a tap, whose sum is
//   rounded in registers to bf16 as it is folded and added, in fp32 then
//   rounded, to a running sum held as packed bf16x2
//   (tests/torch_zslab_roundoff.py measures both). The sum's registers would
//   halve the blocks an SM of the BN <= 64 tiles, so those are held to 128
//   registers a thread (two blocks). The epilogue stores bf16x2 straight from
//   the registers, masked at ragged M.
//
// tf32x3 (namespace tf32x3): fp32 with C % 32 == 0, F % 32 == 0 and 16-byte
//   aligned pointers: every fp32 conv of the paths but the stems. It is the
//   hopper variant's block and ring on TF32 wgmma with each product split in
//   three: a = a_hi + a_lo with a_hi = tf32(a), a_lo = tf32(a - a_hi) (a_hi +
//   a_lo is a to within 2^-22 of a), and a*b ~ a_lo*b_hi + a_hi*b_lo +
//   a_hi*b_hi; a_lo*b_lo (below 2^-22 of a*b) is left out. The weight comes
//   split, as two K-major (F, 27*C) planes (pack_weight "tf32x3"); the
//   im2col tile is copied as fp32 (K steps of BK = 32 channels, 128-byte
//   rows, the 128-byte swizzle) and each thread splits its A fragments in
//   registers (wgmma.m64nBNk8.tf32 with A from registers, B from shared
//   memory), which keeps shared memory to one read of A a step (with A split
//   in shared memory, as hi and lo planes behind a second barrier a step, the
//   products read it three times and the split wrote it twice: 8-15% slower,
//   PERF.md). BN is 64 where it divides F,
//   else 32. Against the drift of the tensor cores' accumulation over long
//   chains (fault 11 in the hopper variant; here a chain would be up to 27 *
//   512 products a term), a K step's 12 products chain from scale-d = 0 and,
//   once retired, are added to the sum on the FP32 pipe: every 32 channels of
//   K are summed in fp32. The fold waits for the step's products: reading
//   accumulators of a wgmma that may be in flight (a second accumulator set
//   folded while the next step's products run) makes ptxas serialize every
//   wgmma (C7514). PER_TAP sums each first-axis tap so, then adds the three in
//   fp32 (rounding a tap to fp32 changes nothing), as the JAX package sums
//   three fp32 convs (conv3d_zconcat). TMA is not used: it raised an illegal
//   instruction on this card (PERF.md section 6).
//
// simple (the kernel below): every shape that neither the hopper, the
//   tf32x3 nor the stem variant takes (no path launches it). A 128-thread
//   block owns a 64 x 64 tile and walks K in 32-wide steps through one
//   shared-memory stage: bf16 on nvcuda::wmma 16x16x16 fragments, fp32 by
//   plain FMA. PER_TAP (bf16) sends the fp32 accumulators through shared
//   memory at each tap's end (wmma's fragment layout is opaque), rounds them
//   and adds them to a running bf16 sum kept in shared memory; a tap's
//   products chain on the tensor cores from its first to its last (no
//   PROMOTE groups: the variant runs no bf16 conv of the paths). In fp32
//   rounding a tap's sum changes nothing, so both flags run the one loop.
//
// In all, the output is written once, at the end.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

namespace conv3x3_igemm {

constexpr int BM = 64;       // output voxels per block
constexpr int BN = 64;       // output channels per block
constexpr int BK = 32;       // K (= tap * C + c) per shared-memory step
constexpr int THREADS = 128; // four warps
constexpr int LDC = BN + 4;  // fp32 staging tile, row stride
constexpr int PER_THREAD = BM * BN / THREADS;  // tile elements a thread rounds per tap

using bf16 = __nv_bfloat16;

template <typename T>
struct Pad;  // row padding of the shared tiles (keeps 16-byte rows, breaks bank conflicts)
template <>
struct Pad<bf16> { static constexpr int value = 8; };
template <>
struct Pad<float> { static constexpr int value = 4; };

template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) { return v; }
template <>
__device__ __forceinline__ bf16 from_float<bf16>(float v) { return __float2bfloat16(v); }

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

struct Rows {
  int x[BM], y[BM], z[BM];  // the row's output voxel
  long long base[BM];  // element offset of the input voxel at those coordinates, channel 0
};

// Offset of input element (row r, k) or -1 where it falls in the zero halo or
// at or beyond kend (the end of K, or of the current tap). X, Y, Z are the
// input's extents. VEC consecutive k share one tap when C % VEC == 0.
__device__ __forceinline__ long long a_offset(const Rows& rows, int r, int k, int kend,
                                              int X, int Y, int Z, int C, int P) {
  if (k >= kend) return -1;
  const int tap = k / C;
  const int c = k - tap * C;
  const int dx = tap / 9 - P, dy = (tap / 3) % 3 - P, dz = tap % 3 - P;
  const int xs = rows.x[r] + dx, ys = rows.y[r] + dy, zs = rows.z[r] + dz;
  if (xs < 0 || xs >= X || ys < 0 || ys >= Y || zs < 0 || zs >= Z) return -1;
  return rows.base[r] + ((long long)(dx * Y + dy) * Z + dz) * C + c;
}

template <typename T, int LDA>
__device__ __forceinline__ void load_a(T* As, const T* __restrict__ x, const Rows& rows,
                                       int k0, int kend, int X, int Y, int Z, int C, int P,
                                       bool vec) {
  constexpr int VEC = 16 / sizeof(T);
  if (vec) {
    constexpr int VPR = BK / VEC;
    for (int v = threadIdx.x; v < BM * VPR; v += THREADS) {
      const int r = v / VPR, kk = (v % VPR) * VEC;
      const long long off = a_offset(rows, r, k0 + kk, kend, X, Y, Z, C, P);
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (off >= 0) val = *reinterpret_cast<const uint4*>(x + off);
      *reinterpret_cast<uint4*>(As + r * LDA + kk) = val;
    }
  } else {
    for (int v = threadIdx.x; v < BM * BK; v += THREADS) {
      const int r = v / BK, kk = v % BK;
      const long long off = a_offset(rows, r, k0 + kk, kend, X, Y, Z, C, P);
      As[r * LDA + kk] = off >= 0 ? x[off] : from_float<T>(0.f);
    }
  }
}

// Weight rows k0 .. k0 + BK - 1; rows outside [kbeg, kend) are zeros.
template <typename T, int LDB>
__device__ __forceinline__ void load_b(T* Bs, const T* __restrict__ w, int k0, int n0,
                                       int kbeg, int kend, int F, bool vec) {
  constexpr int VEC = 16 / sizeof(T);
  if (vec) {
    constexpr int VPR = BN / VEC;
    for (int v = threadIdx.x; v < BK * VPR; v += THREADS) {
      const int r = v / VPR, nn = (v % VPR) * VEC;
      const int k = k0 + r, n = n0 + nn;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (k >= kbeg && k < kend && n < F)
        val = *reinterpret_cast<const uint4*>(w + (long long)k * F + n);
      *reinterpret_cast<uint4*>(Bs + r * LDB + nn) = val;
    }
  } else {
    for (int v = threadIdx.x; v < BK * BN; v += THREADS) {
      const int r = v / BN, nn = v % BN;
      const int k = k0 + r, n = n0 + nn;
      Bs[r * LDB + nn] = (k >= kbeg && k < kend && n < F) ? w[(long long)k * F + n]
                                                           : from_float<T>(0.f);
    }
  }
}

template <typename T, bool PER_TAP>
__global__ void __launch_bounds__(THREADS)
conv3x3_kernel(const T* __restrict__ x, const T* __restrict__ w, T* __restrict__ y,
               int M, int X, int Y, int Z, int C, int F, int P, int vec_a, int vec_b) {
  constexpr int LDA = BK + Pad<T>::value;
  constexpr int LDB = BN + Pad<T>::value;
  __shared__ __align__(128) T As[BM * LDA];
  __shared__ __align__(128) T Bs[BK * LDB];
  __shared__ __align__(128) float Cs[BM * LDC];
  __shared__ Rows rows;

  const int tid = threadIdx.x;
  const long long m0 = (long long)blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int K = 27 * C;
  const int Xo = X + 2 * P - 2, Yo = Y + 2 * P - 2, Zo = Z + 2 * P - 2;

  if (tid < BM) {
    const long long m = m0 + tid;
    if (m < M) {
      long long t = m;
      rows.z[tid] = (int)(t % Zo); t /= Zo;
      rows.y[tid] = (int)(t % Yo); t /= Yo;
      rows.x[tid] = (int)(t % Xo); t /= Xo;
      rows.base[tid] = (((t * X + rows.x[tid]) * Y + rows.y[tid]) * Z + rows.z[tid]) * C;
    } else {  // past the end: every tap lands outside the volume
      rows.x[tid] = -4; rows.y[tid] = 0; rows.z[tid] = 0; rows.base[tid] = 0;
    }
  }
  __syncthreads();

  if constexpr (std::is_same<T, bf16>::value) {
    using namespace nvcuda;
    const int warp = tid / 32, wm = warp / 2, wn = warp % 2;  // 2x2 warps, 32x32 each
    // K segments: the whole of K, or one first-axis tap each
    constexpr int SEGS = PER_TAP ? 3 : 1;
    const int KS = K / SEGS;
    // the running bf16 sum of the rounded taps; in shared memory, as 32 more
    // registers a thread would cost a resident block per SM
    __shared__ bf16 run[PER_TAP ? BM * BN : 1];
    for (int s = 0; s < SEGS; ++s) {
      const int kbeg = s * KS, kend = kbeg + KS;
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);
      for (int k0 = kbeg; k0 < kend; k0 += BK) {
        load_a<T, LDA>(As, x, rows, k0, kend, X, Y, Z, C, P, vec_a);
        load_b<T, LDB>(Bs, w, k0, n0, kbeg, kend, F, vec_b);
        __syncthreads();
#pragma unroll
        for (int kk = 0; kk < BK; kk += 16) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a[2];
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b[2];
#pragma unroll
          for (int i = 0; i < 2; ++i)
            wmma::load_matrix_sync(a[i], As + (wm * 32 + i * 16) * LDA + kk, LDA);
#pragma unroll
          for (int j = 0; j < 2; ++j)
            wmma::load_matrix_sync(b[j], Bs + kk * LDB + wn * 32 + j * 16, LDB);
#pragma unroll
          for (int i = 0; i < 2; ++i)
#pragma unroll
            for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
        }
        __syncthreads();
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::store_matrix_sync(Cs + (wm * 32 + i * 16) * LDC + wn * 32 + j * 16, acc[i][j],
                                  LDC, wmma::mem_row_major);
      if constexpr (PER_TAP) {
        __syncthreads();
        // round the tap, add it in bf16; the staging tile also takes the sum
        // so far, which the writer below reads after the last tap. A thread
        // reads and writes only its own elements of `run`.
#pragma unroll 4
        for (int j = 0; j < PER_THREAD; ++j) {
          const int idx = tid + j * THREADS;
          float& c = Cs[(idx / BN) * LDC + idx % BN];
          const float tap = round_bf16(c);
          const float sum = s == 0 ? tap : round_bf16(__bfloat162float(run[idx]) + tap);
          run[idx] = __float2bfloat16(sum);
          c = sum;
        }
        __syncthreads();  // the next tap's accumulators overwrite Cs
      }
    }
  } else {
    const int tr = tid / 8, tc = tid % 8;  // 4 rows x 8 columns per thread
    float acc[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
    for (int k0 = 0; k0 < K; k0 += BK) {
      load_a<T, LDA>(As, x, rows, k0, K, X, Y, Z, C, P, vec_a);
      load_b<T, LDB>(Bs, w, k0, n0, 0, K, F, vec_b);
      __syncthreads();
#pragma unroll 4
      for (int kk = 0; kk < BK; ++kk) {
        float a[4], b[8];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = As[(tr * 4 + i) * LDA + kk];
#pragma unroll
        for (int j = 0; j < 8; ++j) b[j] = Bs[kk * LDB + tc * 8 + j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) Cs[(tr * 4 + i) * LDC + tc * 8 + j] = acc[i][j];
  }
  __syncthreads();

  for (int idx = tid; idx < BM * BN; idx += THREADS) {
    const int r = idx / BN, n = idx % BN;
    const long long m = m0 + r;
    if (m < M && n0 + n < F) y[m * F + n0 + n] = from_float<T>(Cs[r * LDC + n]);
  }
}

// Output voxels of a (B, X, Y, Z) input at padding P, or -1 where P is not
// 0, 1 or 2 or an output extent is empty.
inline long long out_voxels(int B, int X, int Y, int Z, int P) {
  if (P < 0 || P > 2 || B <= 0 || X + 2 * P - 2 <= 0 || Y + 2 * P - 2 <= 0 || Z + 2 * P - 2 <= 0)
    return -1;
  return (long long)B * (X + 2 * P - 2) * (Y + 2 * P - 2) * (Z + 2 * P - 2);
}

// x: (B, X, Y, Z, C) contiguous; w: (27*C, F) contiguous; y: (B, X + 2P - 2,
// Y + 2P - 2, Z + 2P - 2, F). dtype: 0 = float32, 1 = bfloat16. vec_a /
// vec_b: 16-byte loads are allowed (C resp. F is a multiple of 16 bytes'
// worth of elements and the pointer is 16-byte aligned). Launches on
// `stream`; returns cudaGetLastError().
template <bool PER_TAP>
int launch(const void* x, const void* w, void* y, int B, int X, int Y, int Z, int C, int F,
           int P, int dtype, int vec_a, int vec_b, void* stream) {
  const long long M = out_voxels(B, X, Y, Z, P);
  if (M <= 0 || M > 0x7fffffffLL || C <= 0 || F <= 0 || 27LL * C > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)((M + BM - 1) / BM), (unsigned)((F + BN - 1) / BN));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    conv3x3_kernel<bf16, PER_TAP><<<grid, THREADS, 0, s>>>(
        static_cast<const bf16*>(x), static_cast<const bf16*>(w), static_cast<bf16*>(y),
        (int)M, X, Y, Z, C, F, P, vec_a, vec_b);
  } else if (dtype == 0) {
    conv3x3_kernel<float, PER_TAP><<<grid, THREADS, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(w), static_cast<float*>(y),
        (int)M, X, Y, Z, C, F, P, vec_a, vec_b);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

namespace hopper {

#ifndef CONV3X3_PROMOTE
#define CONV3X3_PROMOTE 4
#endif
#ifndef CONV3X3_PROMOTE_ONCE
#define CONV3X3_PROMOTE_ONCE 8
#endif
// K steps a group of products chained on the tensor cores: PROMOTE where each
// tap is rounded (kernel #2), PROMOTE_ONCE where the sum is rounded once
// (kernel #1: at the STUNet-H step's shapes it rounds at most 1.32x as many
// elements otherwise than float64 as the plain version at 8, 0.74x at 4, in
// 5% less time; NVIDIA H100 80GB HBM3, 700 W, PERF.md). Compile-time
// constants, which tests/torch_zslab_roundoff.py `variants` and `k1variants`
// set
constexpr int PROMOTE = CONV3X3_PROMOTE;
constexpr int PROMOTE_ONCE = CONV3X3_PROMOTE_ONCE;
constexpr int BM = 128;       // output voxels per block, 64 per warpgroup
constexpr int THREADS = 256;  // two warpgroups; all of them copy and multiply
constexpr int STAGES = 4;     // shared-memory ring depth

// (BK, BN) tiles built; ops/conv3x3.py `igemm_tile` picks among these
#define CONV3X3_HOPPER_TILES(TILE) \
  TILE(32, 32) TILE(32, 64) TILE(32, 128) TILE(64, 32) TILE(64, 64) TILE(64, 128)

template <int BK, int BN>
struct Tile {
  static constexpr int ROWB = BK * 2;                  // bytes of one tile row (a voxel or an f)
  static constexpr int CPR = BK / 8;                   // 16-byte chunks a row
  static constexpr int A_BYTES = BM * ROWB;
  static constexpr int STAGE_BYTES = (BM + BN) * ROWB;  // a multiple of 1024
  static constexpr int SMEM = STAGES * STAGE_BYTES + 1024;  // + slack to align the ring
  static constexpr int A_ITERS = BM * CPR / THREADS;   // A chunks a thread copies a step
  static constexpr int B_ITERS = (BN * CPR + THREADS - 1) / THREADS;
  static constexpr uint64_t SWIZZLE = BK == 64 ? 1 : 2;  // descriptor mode: 128-, 64-byte
  static constexpr int NACC = BN / 2;                  // fp32 accumulators a thread
};

// byte offset of chunk j of row r in a swizzled tile: the 16-byte chunk index
// (address bits 4..6) XOR the address bits 7..9 (128-byte swizzle; bits 7..8
// for the 64-byte one), as wgmma reads it from a tile aligned to 1024 bytes
template <int BK>
__device__ __forceinline__ uint32_t swizzle(int r, int j) {
  const uint32_t off = r * (BK * 2) + j * 16;
  return off ^ (((off >> 7) & (BK / 8 - 1)) << 4);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte asynchronous copy to shared memory; src_bytes = 0 reads nothing and
// zero-fills. L1 keeps the gathered input rows (.ca), which the block's
// neighbouring taps read again; the weight goes through L2 only (.cg).
template <bool L1>
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int src_bytes) {
  if constexpr (L1)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
                 "r"(src_bytes)
                 : "memory");
  else
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
                 "r"(src_bytes)
                 : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// shared-memory writes of the generic proxy (cp.async) made visible to the
// async proxy, through which wgmma reads its operands
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keeps the compiler from moving accumulator reads or writes across an
// asynchronous wgmma
template <int N>
__device__ __forceinline__ void fence_operand(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// K-major operand descriptor: start address >> 4, leading byte offset 1
// (unused by the swizzled K-major layouts), stride byte offset = 8 rows >> 4,
// swizzle mode in bits 62..63. Advancing K by 16 elements adds 32 >> 4.
template <int BK>
__device__ __forceinline__ uint64_t make_desc(uint32_t addr) {
  using T = Tile<BK, 32>;
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)((8 * T::ROWB) >> 4) << 32) | (T::SWIZZLE << 62);
}

#define CONV3X3_R8(i)                                                                 \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]),        \
      "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

// D (64 x BN, fp32 in registers) = A (64 x 16) * B (16 x BN) + (scale_d ? D : 0),
// A and B bf16 K-major in shared memory
template <int BN>
struct Wgmma;

template <>
struct Wgmma<32> {
  __device__ __forceinline__ static void mma(float (&d)[16], uint64_t a, uint64_t b,
                                             int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
        "%16, %17, p, 1, 1, 0, 0;\n}\n"
        : CONV3X3_R8(0), CONV3X3_R8(8)
        : "l"(a), "l"(b), "r"(scale_d));
  }
};

template <>
struct Wgmma<64> {
  __device__ __forceinline__ static void mma(float (&d)[32], uint64_t a, uint64_t b,
                                             int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "%32, %33, p, 1, 1, 0, 0;\n}\n"
        : CONV3X3_R8(0), CONV3X3_R8(8), CONV3X3_R8(16), CONV3X3_R8(24)
        : "l"(a), "l"(b), "r"(scale_d));
  }
};

template <>
struct Wgmma<128> {
  __device__ __forceinline__ static void mma(float (&d)[64], uint64_t a, uint64_t b,
                                             int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
        "%64, %65, p, 1, 1, 0, 0;\n}\n"
        : CONV3X3_R8(0), CONV3X3_R8(8), CONV3X3_R8(16), CONV3X3_R8(24), CONV3X3_R8(32),
          CONV3X3_R8(40), CONV3X3_R8(48), CONV3X3_R8(56)
        : "l"(a), "l"(b), "r"(scale_d));
  }
};

#undef CONV3X3_R8

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ float2 unpack_bf16x2(uint32_t v) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v));
}

// x: (B, X, Y, Z, C) bf16; wt: (F, 27*C) bf16, K contiguous; y: (M output
// voxels, F) bf16 at padding P. Grid (ceil(M / 128), F / BN).
// BN <= 64: at most 128 registers, two blocks an SM (the ring's shared
// memory allows it; the fp32 sum of the groups would take more)
template <int BK, int BN, bool PER_TAP>
__global__ void __launch_bounds__(THREADS, BN <= 64 ? 2 : 1)
conv3x3_wgmma(const bf16* __restrict__ x, const bf16* __restrict__ wt, bf16* __restrict__ y,
              int M, int X, int Y, int Z, int C, int F, int P) {
  using T = Tile<BK, BN>;
  extern __shared__ uint8_t smem_raw[];
  __shared__ long long tap_off[27];  // element offset of each tap's input voxel

  const int tid = threadIdx.x;
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int K = 27 * C;
  const uint32_t ring = (smem_u32(smem_raw) + 1023u) & ~1023u;

  const int Xo = X + 2 * P - 2, Yo = Y + 2 * P - 2, Zo = Z + 2 * P - 2;
  if (tid < 27) {
    const int dx = tid / 9 - P, dy = tid / 3 % 3 - P, dz = tid % 3 - P;
    tap_off[tid] = (long long)((dx * Y + dy) * Z + dz) * C;
  }
  // A: this thread copies chunk `ja` of rows tid / CPR + i * (THREADS / CPR)
  const int ja = tid % T::CPR;
  const bf16* a_src[T::A_ITERS];
  uint32_t a_taps[T::A_ITERS];  // bit t: tap t of the row lies inside the volume
  uint32_t a_dst[T::A_ITERS];
#pragma unroll
  for (int i = 0; i < T::A_ITERS; ++i) {
    const int r = tid / T::CPR + i * (THREADS / T::CPR);
    const int m = m0 + r;
    a_dst[i] = swizzle<BK>(r, ja);
    a_taps[i] = 0;
    a_src[i] = x;
    if (m < M) {
      int t = m;
      const int vz = t % Zo; t /= Zo;
      const int vy = t % Yo; t /= Yo;
      const int vx = t % Xo; t /= Xo;
      // bit d: input coordinate o + d - P lies inside [0, extent)
      auto inside = [P](int o, int n) {
        uint32_t bits = 0;
#pragma unroll
        for (int d = 0; d < 3; ++d) bits |= (uint32_t)((unsigned)(o + d - P) < (unsigned)n) << d;
        return bits;
      };
      const uint32_t mx = inside(vx, X), my = inside(vy, Y), mz = inside(vz, Z);
#pragma unroll
      for (int tap = 0; tap < 27; ++tap)
        a_taps[i] |= ((mx >> (tap / 9)) & (my >> (tap / 3 % 3)) & (mz >> (tap % 3)) & 1u) << tap;
      // the input voxel at the output's coordinates (outside the input where
      // P = 2; only its in-volume taps are read)
      a_src[i] = x + ((((long long)t * X + vx) * Y + vy) * Z + vz) * C + ja * 8;
    }
  }
  // B: chunk idx = tid + i * THREADS of the BN x CPR chunks
  const bf16* b_src[T::B_ITERS];
  uint32_t b_dst[T::B_ITERS];
#pragma unroll
  for (int i = 0; i < T::B_ITERS; ++i) {
    const int idx = tid + i * THREADS;
    const int n = idx / T::CPR, j = idx % T::CPR;
    b_src[i] = wt + (long long)(n0 + n) * K + j * 8;
    b_dst[i] = T::A_BYTES + swizzle<BK>(n, j);
  }
  __syncthreads();  // tap_off

  const int KT = K / BK;
  // steps are loaded in order; BK divides C, so a step lies in one tap, and
  // (tap, c0) of the next step to load advance by counting, not dividing
  int ld_tap = 0, ld_c0 = 0;
  auto load = [&](int step) {
    const uint32_t stage = ring + (step % STAGES) * T::STAGE_BYTES;
    const long long koff = tap_off[ld_tap] + ld_c0;
    const uint32_t bit = 1u << ld_tap;
#pragma unroll
    for (int i = 0; i < T::A_ITERS; ++i) {
      const bool in = a_taps[i] & bit;
      cp_async16<true>(stage + a_dst[i], in ? a_src[i] + koff : x, in ? 16 : 0);
    }
#pragma unroll
    for (int i = 0; i < T::B_ITERS; ++i)
      if (T::B_ITERS * THREADS == BN * T::CPR || tid + i * THREADS < BN * T::CPR)
        cp_async16<false>(stage + b_dst[i], b_src[i] + step * BK, 16);
    ld_c0 += BK;
    if (ld_c0 == C) {
      ld_c0 = 0;
      ++ld_tap;
    }
  };

  float acc[T::NACC];
#pragma unroll
  for (int i = 0; i < T::NACC; ++i) acc[i] = 0.f;
  uint32_t run[PER_TAP ? T::NACC / 2 : 1];  // the running bf16x2 sum of the rounded taps
  // a tap's sum (all of its products retired): rounded, then added to the running sum
  auto add_tap = [&](const float(&sum)[T::NACC], bool first) {
#pragma unroll
    for (int i = 0; i < T::NACC; i += 2) {
      const float t0 = round_bf16(sum[i]), t1 = round_bf16(sum[i + 1]);
      if (first) {
        run[i / 2] = pack_bf16x2(t0, t1);
      } else {
        const float2 s = unpack_bf16x2(run[i / 2]);
        run[i / 2] = pack_bf16x2(s.x + t0, s.y + t1);
      }
    }
  };
  const int seg = PER_TAP ? KT / 3 : KT;  // K steps a segment: a tap, or all of K
  // descriptors of stage 0: this warpgroup's 64 rows of A, and B; a stage's
  // are these plus its byte offset >> 4 (in the 14-bit start address field)
  const uint64_t desc_a = make_desc<BK>(ring + (tid / 128) * 64 * T::ROWB);
  const uint64_t desc_b = make_desc<BK>(ring + T::A_BYTES);

#pragma unroll 1
  for (int s = 0; s < STAGES - 2; ++s) {
    load(s);
    cp_async_commit();
  }
  // step kt has landed (for this thread), then for every thread; the barrier
  // also follows every warpgroup's retirement of step kt - 2, whose stage the
  // copies below refill. Returns the step's descriptors' stage offset.
  auto next_stage = [&](int kt) {
    cp_async_wait<STAGES - 3>();
    fence_proxy_async();
    __syncthreads();
    if (kt + STAGES - 2 < KT) load(kt + STAGES - 2);
    cp_async_commit();
    return (uint64_t)((kt % STAGES) * (T::STAGE_BYTES >> 4));
  };

  // The tensor cores' fp32 accumulation loses more to round-off over a long
  // chain than round-to-nearest adds do, so K runs in groups of GROUP steps
  // that never cross a segment's end: a group's products chain in `acc` from
  // scale-d = 0, and once they retire the FP32 pipe adds them to the
  // segment's sum `tot`. A segment is a tap (PER_TAP: its sum is rounded and
  // added to `run`) or all of K. A group's first step folds the group before
  // it, after issuing its own copies; its other steps run branch-free.
  constexpr int GROUP = PER_TAP ? PROMOTE : PROMOTE_ONCE;
  float tot[T::NACC];
  bool first = true;  // the group in flight is its segment's first
  auto step = [&](uint64_t off, int keep) {  // a K step's products, one step kept in flight
    fence_operand(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      Wgmma<BN>::mma(acc, desc_a + off + 2 * kk, desc_b + off + 2 * kk, kk > 0 || keep);
    wgmma_commit();
    wgmma_wait<1>();  // the step before retired: its stage may be refilled
    fence_operand(acc);
  };
  auto fold = [&]() {  // the retired group into tot
#pragma unroll
    for (int i = 0; i < T::NACC; ++i) tot[i] = first ? acc[i] : tot[i] + acc[i];
  };
  int kt = 0;
#pragma unroll 1
  for (int s = 0; s < KT / seg; ++s) {
#pragma unroll 1
    for (int g = 0; g < seg; g += GROUP) {
      const uint64_t off = next_stage(kt);
      if (kt > 0) {  // the group before, retired, into tot; the tap it closed into run
        wgmma_wait<0>();
        fence_operand(acc);
        fold();
        if constexpr (PER_TAP) {
          if (g == 0) add_tap(tot, s == 1);
        }
      }
      first = g == 0;
      step(off, 0);
      ++kt;
      const int n = min(GROUP, seg - g);
#pragma unroll 1
      for (int j = 1; j < n; ++j, ++kt) step(next_stage(kt), 1);
    }
  }
  wgmma_wait<0>();
  fence_operand(acc);
  fold();
  if constexpr (PER_TAP) add_tap(tot, false);  // the last of the three taps

  // accumulator (i, i + 1) of thread t: row 16 * warp + lane / 4 + 8 * (i / 2 % 2),
  // columns 8 * (i / 4) + 2 * (lane % 4) + {0, 1} of the warpgroup's 64 x BN tile
  const int lane = tid % 32, warp = tid % 128 / 32;
  const int row0 = m0 + (tid / 128) * 64 + warp * 16 + lane / 4;
  const int col0 = n0 + (lane % 4) * 2;
#pragma unroll
  for (int i = 0; i < T::NACC; i += 2) {
    const int m = row0 + 8 * (i / 2 % 2);
    if (m < M) {
      uint32_t v;
      if constexpr (PER_TAP) v = run[i / 2];
      else v = pack_bf16x2(tot[i], tot[i + 1]);
      *reinterpret_cast<uint32_t*>(y + (long long)m * F + col0 + 8 * (i / 4)) = v;
    }
  }
}

template <int BK, int BN, bool PER_TAP>
int launch_tile(const void* x, const void* wt, void* y, int M, int X, int Y, int Z, int C, int F,
                int P, cudaStream_t stream) {
  auto kernel = conv3x3_wgmma<BK, BN, PER_TAP>;
  const int smem = Tile<BK, BN>::SMEM;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((M + BM - 1) / BM), (unsigned)(F / BN));
  kernel<<<grid, THREADS, smem, stream>>>(static_cast<const bf16*>(x),
                                          static_cast<const bf16*>(wt), static_cast<bf16*>(y),
                                          M, X, Y, Z, C, F, P);
  return (int)cudaGetLastError();
}

// x: (B, X, Y, Z, C) bf16; wt: (F, 27*C) bf16 (K contiguous); y: (B, X + 2P -
// 2, Y + 2P - 2, Z + 2P - 2, F) bf16; all 16-byte aligned. (bk, bn) must be one
// of CONV3X3_HOPPER_TILES with bk dividing C and bn dividing F. Launches on
// `stream`; returns the CUDA error.
template <bool PER_TAP>
int launch(const void* x, const void* wt, void* y, int B, int X, int Y, int Z, int C, int F,
           int P, int bk, int bn, void* stream) {
  const long long M = out_voxels(B, X, Y, Z, P);
  if (M <= 0 || M > 0x7fffffffLL - BM || C <= 0 || F <= 0 || 27LL * C > 0x7fffffffLL ||
      C % bk != 0 || F % bn != 0 ||
      ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(wt) |
        reinterpret_cast<uintptr_t>(y)) & 15) != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define CONV3X3_HOPPER_CASE(BK_, BN_) \
  if (bk == BK_ && bn == BN_) return launch_tile<BK_, BN_, PER_TAP>(x, wt, y, (int)M, X, Y, Z, C, F, P, s);
  CONV3X3_HOPPER_TILES(CONV3X3_HOPPER_CASE)
#undef CONV3X3_HOPPER_CASE
  return (int)cudaErrorInvalidValue;
}

}  // namespace hopper

namespace tf32x3 {

using hopper::cp_async16;
using hopper::cp_async_commit;
using hopper::cp_async_wait;
using hopper::fence_operand;
using hopper::fence_proxy_async;
using hopper::smem_u32;
using hopper::swizzle;
using hopper::wgmma_commit;
using hopper::wgmma_fence;
using hopper::wgmma_wait;

constexpr int BM = 128;       // output voxels per block, 64 per warpgroup
constexpr int BK = 32;        // K (fp32 channels of one tap) per step: 128-byte tile rows
constexpr int THREADS = 256;  // two warpgroups; all of them copy and multiply
constexpr int STAGES = 4;     // shared-memory ring depth

// the BN built; ops/conv3x3.py `tf32_tile` picks among these
#define CONV3X3_TF32X3_TILES(TILE) TILE(32) TILE(64)

template <int BN>
struct Tile {
  static constexpr int ROWB = BK * 4;                     // bytes of a tile row (a voxel or an f)
  static constexpr int CPR = ROWB / 16;                   // 16-byte chunks a row
  static constexpr int A_BYTES = BM * ROWB;               // A as copied (fp32)
  static constexpr int B_BYTES = BN * ROWB;               // one plane of B (hi or lo)
  static constexpr int STAGE_BYTES = A_BYTES + 2 * B_BYTES;
  static constexpr int SMEM = STAGES * STAGE_BYTES + 1024;  // + slack to align the ring
  static constexpr int A_ITERS = BM * CPR / THREADS;      // A chunks a thread copies a step
  static constexpr int B_ITERS = 2 * BN * CPR / THREADS;  // B chunks (both planes)
  static constexpr int NACC = BN / 2;                     // fp32 accumulators a thread
};

// round to the nearest TF32 value (10 stored mantissa bits), ties away from
// zero; the low 13 bits of the result are zero
__device__ __forceinline__ float to_tf32(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(v));
  return __uint_as_float(r);
}

#define CONV3X3_R8(i)                                                                 \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]),        \
      "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

// D (64 x BN, fp32 in registers) = A (64 x 8) * B (8 x BN) + (scale_d ? D : 0):
// A tf32 in registers (a warp's 16 rows as mma.m16n8k8's A fragment: a[0] row
// g, column t; a[1] row g + 8, column t; a[2], a[3] the same at column t + 4;
// g = lane / 4, t = lane % 4), B tf32 K-major in shared memory (128-byte
// swizzled rows)
template <int BN>
struct Wgmma;

template <>
struct Wgmma<32> {
  __device__ __forceinline__ static void mma(float (&d)[16], const uint32_t (&a)[4], uint64_t b,
                                             int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
        "{%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
        : CONV3X3_R8(0), CONV3X3_R8(8)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
  }
};

template <>
struct Wgmma<64> {
  __device__ __forceinline__ static void mma(float (&d)[32], const uint32_t (&a)[4], uint64_t b,
                                             int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
        : CONV3X3_R8(0), CONV3X3_R8(8), CONV3X3_R8(16), CONV3X3_R8(24)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
  }
};

#undef CONV3X3_R8

// keeps A fragments alive (unmoved, unreused) until the wgmma reading them retires
__device__ __forceinline__ void fence_frags(uint32_t (&r)[BK / 8][4]) {
#pragma unroll
  for (int i = 0; i < BK / 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

// x: (B, X, Y, Z, C) fp32; wt: (2, F, 27*C) fp32, the weight's TF32 hi and lo
// planes, K contiguous; y: (M output voxels, F) fp32 at padding P. Grid
// (ceil(M / 128), F / BN).
template <int BN, bool PER_TAP>
__global__ void __launch_bounds__(THREADS, 1)
conv3x3_tf32x3(const float* __restrict__ x, const float* __restrict__ wt, float* __restrict__ y,
               int M, int X, int Y, int Z, int C, int F, int P) {
  using T = Tile<BN>;
  extern __shared__ uint8_t smem_raw[];
  __shared__ long long tap_off[27];  // element offset of each tap's input voxel

  const int tid = threadIdx.x;
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int K = 27 * C;
  const uint32_t ring = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint8_t* const ring_ptr = smem_raw + (ring - smem_u32(smem_raw));

  const int Xo = X + 2 * P - 2, Yo = Y + 2 * P - 2, Zo = Z + 2 * P - 2;
  if (tid < 27) {
    const int dx = tid / 9 - P, dy = tid / 3 % 3 - P, dz = tid % 3 - P;
    tap_off[tid] = (long long)((dx * Y + dy) * Z + dz) * C;
  }
  // A: this thread copies chunk `ja` of rows tid / CPR + i * (THREADS / CPR)
  const int ja = tid % T::CPR;
  const float* a_src[T::A_ITERS];
  uint32_t a_taps[T::A_ITERS];  // bit t: tap t of the row lies inside the volume
  uint32_t a_dst[T::A_ITERS];
#pragma unroll
  for (int i = 0; i < T::A_ITERS; ++i) {
    const int r = tid / T::CPR + i * (THREADS / T::CPR);
    const int m = m0 + r;
    a_dst[i] = swizzle<64>(r, ja);  // 128-byte rows, as the bf16 tiles' at BK = 64
    a_taps[i] = 0;
    a_src[i] = x;
    if (m < M) {
      int t = m;
      const int vz = t % Zo; t /= Zo;
      const int vy = t % Yo; t /= Yo;
      const int vx = t % Xo; t /= Xo;
      auto inside = [P](int o, int n) {
        uint32_t bits = 0;
#pragma unroll
        for (int d = 0; d < 3; ++d) bits |= (uint32_t)((unsigned)(o + d - P) < (unsigned)n) << d;
        return bits;
      };
      const uint32_t mx = inside(vx, X), my = inside(vy, Y), mz = inside(vz, Z);
#pragma unroll
      for (int tap = 0; tap < 27; ++tap)
        a_taps[i] |= ((mx >> (tap / 9)) & (my >> (tap / 3 % 3)) & (mz >> (tap % 3)) & 1u) << tap;
      a_src[i] = x + ((((long long)t * X + vx) * Y + vy) * Z + vz) * C + ja * 4;
    }
  }
  // B: chunk idx = tid + i * THREADS of the 2 x BN x CPR chunks (hi plane, then lo)
  const float* b_src[T::B_ITERS];
  uint32_t b_dst[T::B_ITERS];
#pragma unroll
  for (int i = 0; i < T::B_ITERS; ++i) {
    const int idx = tid + i * THREADS;
    const int plane = idx / (BN * T::CPR), n = idx / T::CPR % BN, j = idx % T::CPR;
    b_src[i] = wt + ((long long)plane * F + n0 + n) * K + j * 4;
    b_dst[i] = T::A_BYTES + plane * T::B_BYTES + swizzle<64>(n, j);
  }
  __syncthreads();  // tap_off

  const int KT = K / BK;
  int ld_tap = 0, ld_c0 = 0;  // (tap, c0) of the next step to load; BK divides C
  auto load = [&](int step) {
    const uint32_t stage = ring + (step % STAGES) * T::STAGE_BYTES;
    const long long koff = tap_off[ld_tap] + ld_c0;
    const uint32_t bit = 1u << ld_tap;
#pragma unroll
    for (int i = 0; i < T::A_ITERS; ++i) {
      const bool in = a_taps[i] & bit;
      cp_async16<true>(stage + a_dst[i], in ? a_src[i] + koff : x, in ? 16 : 0);
    }
#pragma unroll
    for (int i = 0; i < T::B_ITERS; ++i)
      cp_async16<false>(stage + b_dst[i], b_src[i] + step * BK, 16);
    ld_c0 += BK;
    if (ld_c0 == C) {
      ld_c0 = 0;
      ++ld_tap;
    }
  };
  // this thread's A fragments of a step, split: rows g and g + 8 of its warp's
  // 16, columns t and t + 4 of each k8 slice. Chunk j of row r sits at chunk j
  // ^ (r % 8) of the 128-byte swizzle, and r % 8 = g for both rows, so the
  // warp's 32 loads of a slice hit 32 distinct banks.
  const int lane = tid % 32, g = lane / 4;
  const int frag_off = ((tid / 128) * 64 + (tid % 128 / 32) * 16 + g) * T::ROWB + lane % 4 * 4;
  uint32_t hi[BK / 8][4], lo[BK / 8][4];
  auto split = [&](int step) {
    const uint8_t* const a = ring_ptr + (step % STAGES) * T::STAGE_BYTES + frag_off;
#pragma unroll
    for (int k = 0; k < BK / 8; ++k) {
      const int c0 = ((2 * k) ^ g) << 4, c1 = ((2 * k + 1) ^ g) << 4;
      const float v[4] = {*reinterpret_cast<const float*>(a + c0),
                          *reinterpret_cast<const float*>(a + 8 * T::ROWB + c0),
                          *reinterpret_cast<const float*>(a + c1),
                          *reinterpret_cast<const float*>(a + 8 * T::ROWB + c1)};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float h = to_tf32(v[e]);
        hi[k][e] = __float_as_uint(h);
        lo[k][e] = __float_as_uint(to_tf32(v[e] - h));
      }
    }
  };

  // a step's 12 products chain in `acc` from scale-d = 0; once they retire,
  // the FP32 pipe adds them to `tot`, the sum of K so far (PER_TAP: of the tap)
  float acc[T::NACC], tot[T::NACC];
  float run[PER_TAP ? T::NACC : 1];  // PER_TAP: the fp32 sum of the finished taps
  const int seg = PER_TAP ? KT / 3 : KT;  // K steps a tap, or all of K
  const uint64_t desc_b = hopper::make_desc<64>(ring + T::A_BYTES);
  constexpr uint64_t B_LO = T::B_BYTES >> 4;  // the lo plane, a plane further

#pragma unroll 1
  for (int s = 0; s < STAGES - 2; ++s) {
    load(s);
    cp_async_commit();
  }
  int pos = 0, taps = 0;  // the step's place in its tap, the taps finished
  // step kt: its copies landed for every thread (the barrier also follows
  // every warpgroup's retirement of step kt - 1, and so of kt - 2, whose stage
  // the copies below refill), its A fragments split, then 4 k8 slices x 3
  // products: lo*hi, hi*lo, hi*hi (lo*lo, below 2^-22 of the product, is left
  // out), the small ones first. The products are waited for and folded at the
  // step's end: reading the accumulators of a wgmma that may be in flight
  // would make ptxas serialize every wgmma of the kernel.
#pragma unroll 1
  for (int kt = 0; kt < KT; ++kt) {
    cp_async_wait<STAGES - 3>();
    fence_proxy_async();
    __syncthreads();
    if (kt + STAGES - 2 < KT) load(kt + STAGES - 2);
    cp_async_commit();
    split(kt);
    const uint64_t b0 = desc_b + (uint64_t)((kt % STAGES) * (T::STAGE_BYTES >> 4));
    fence_operand(acc);
    wgmma_fence();
#pragma unroll
    for (int k = 0; k < BK / 8; ++k) {
      Wgmma<BN>::mma(acc, lo[k], b0 + 2 * k, k > 0);
      Wgmma<BN>::mma(acc, hi[k], b0 + 2 * k + B_LO, 1);
      Wgmma<BN>::mma(acc, hi[k], b0 + 2 * k, 1);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_operand(acc);
    fence_frags(hi);
    fence_frags(lo);
#pragma unroll
    for (int i = 0; i < T::NACC; ++i) tot[i] = pos == 0 ? acc[i] : tot[i] + acc[i];
    if (++pos == seg) {
      pos = 0;
      if constexpr (PER_TAP) {  // the tap's sum (fp32: its rounding changes nothing) into run
#pragma unroll
        for (int i = 0; i < T::NACC; ++i) run[i] = taps == 0 ? tot[i] : run[i] + tot[i];
        ++taps;
      }
    }
  }

  // accumulator (i, i + 1) of thread t: row 16 * warp + lane / 4 + 8 * (i / 2 % 2),
  // columns 8 * (i / 4) + 2 * (lane % 4) + {0, 1} of the warpgroup's 64 x BN tile
  const int warp = tid % 128 / 32;
  const int row0 = m0 + (tid / 128) * 64 + warp * 16 + lane / 4;
  const int col0 = n0 + (lane % 4) * 2;
#pragma unroll
  for (int i = 0; i < T::NACC; i += 2) {
    const int m = row0 + 8 * (i / 2 % 2);
    if (m < M) {
      float2 v;
      if constexpr (PER_TAP) v = make_float2(run[i], run[i + 1]);
      else v = make_float2(tot[i], tot[i + 1]);
      *reinterpret_cast<float2*>(y + (long long)m * F + col0 + 8 * (i / 4)) = v;
    }
  }
}

template <int BN, bool PER_TAP>
int launch_tile(const void* x, const void* wt, void* y, int M, int X, int Y, int Z, int C, int F,
                int P, cudaStream_t stream) {
  auto kernel = conv3x3_tf32x3<BN, PER_TAP>;
  const int smem = Tile<BN>::SMEM;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((M + BM - 1) / BM), (unsigned)(F / BN));
  kernel<<<grid, THREADS, smem, stream>>>(static_cast<const float*>(x),
                                          static_cast<const float*>(wt), static_cast<float*>(y),
                                          M, X, Y, Z, C, F, P);
  return (int)cudaGetLastError();
}

// x: (B, X, Y, Z, C) fp32, C % 32 == 0; wt: (2, F, 27*C) fp32, the TF32 hi
// and lo planes of the weight (K contiguous; ops/conv3x3.py pack_weight); y:
// (B, X + 2P - 2, Y + 2P - 2, Z + 2P - 2, F) fp32; all 16-byte aligned. bn must
// be one of CONV3X3_TF32X3_TILES dividing F. Launches on `stream`; returns the
// CUDA error.
template <bool PER_TAP>
int launch(const void* x, const void* wt, void* y, int B, int X, int Y, int Z, int C, int F,
           int P, int bn, void* stream) {
  const long long M = out_voxels(B, X, Y, Z, P);
  if (M <= 0 || M > 0x7fffffffLL - BM || C <= 0 || F <= 0 || 27LL * C > 0x7fffffffLL ||
      C % BK != 0 || F % bn != 0 ||
      ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(wt) |
        reinterpret_cast<uintptr_t>(y)) & 15) != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define CONV3X3_TF32X3_CASE(BN_) \
  if (bn == BN_) return launch_tile<BN_, PER_TAP>(x, wt, y, (int)M, X, Y, Z, C, F, P, s);
  CONV3X3_TF32X3_TILES(CONV3X3_TF32X3_CASE)
#undef CONV3X3_TF32X3_CASE
  return (int)cudaErrorInvalidValue;
}

}  // namespace tf32x3

}  // namespace conv3x3_igemm
