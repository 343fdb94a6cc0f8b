// The implicit-GEMM stride-1 "same" 3x3x3 convolution for Hopper (sm_90a),
// NDHWC x (27*C, F), shared by csrc/conv3x3.cu (one rounding) and
// csrc/zslab_conv.cu (each first-axis tap rounded to the output type).
//
// Form: M = B*X*Y*Z output voxels (z fastest), N = F, K = 27*C ordered
// (tap, c), so the weight is the DHWIO tensor reshaped to (27*C, F). A block
// computes a BM x BN output tile; it walks K in BK steps, gathering the input
// tile (with the zero halo and the ragged edges masked in the load, never
// padded in device memory) and the weight slice into shared memory. bf16
// multiplies on the tensor cores through nvcuda::wmma 16x16x16 fragments; fp32
// (the exactness check) uses plain FMA. Every term accumulates in fp32.
//
// PER_TAP = false: one K loop over all 27*C terms, rounded once to the output
// type. PER_TAP = true (bf16): the K loop is cut at the three first-axis tap
// boundaries, 9*C terms each. At the end of a tap the fp32 accumulators go
// through shared memory, each thread rounds its elements to bf16 and adds them
// to their running sum, held in bf16 in shared memory (an fp32 add of two bf16
// values rounded once is the bf16 add), and the accumulators restart at zero. In fp32 rounding a
// tap's sum to the output type changes nothing, so both flags run the one loop.
// The output is written once, at the end.

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
  int x[BM], y[BM], z[BM];
  long long base[BM];  // element offset of the row's voxel, channel 0
};

// Offset of input element (row r, k) or -1 where it falls in the zero halo or
// at or beyond kend (the end of K, or of the current tap). VEC consecutive k
// share one tap when C % VEC == 0.
__device__ __forceinline__ long long a_offset(const Rows& rows, int r, int k, int kend,
                                              int X, int Y, int Z, int C) {
  if (k >= kend) return -1;
  const int tap = k / C;
  const int c = k - tap * C;
  const int dx = tap / 9, dy = (tap / 3) % 3, dz = tap % 3;
  const int xs = rows.x[r] + dx - 1, ys = rows.y[r] + dy - 1, zs = rows.z[r] + dz - 1;
  if (xs < 0 || xs >= X || ys < 0 || ys >= Y || zs < 0 || zs >= Z) return -1;
  return rows.base[r] + ((long long)((dx - 1) * Y + (dy - 1)) * Z + (dz - 1)) * C + c;
}

template <typename T, int LDA>
__device__ __forceinline__ void load_a(T* As, const T* __restrict__ x, const Rows& rows,
                                       int k0, int kend, int X, int Y, int Z, int C,
                                       bool vec) {
  constexpr int VEC = 16 / sizeof(T);
  if (vec) {
    constexpr int VPR = BK / VEC;
    for (int v = threadIdx.x; v < BM * VPR; v += THREADS) {
      const int r = v / VPR, kk = (v % VPR) * VEC;
      const long long off = a_offset(rows, r, k0 + kk, kend, X, Y, Z, C);
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (off >= 0) val = *reinterpret_cast<const uint4*>(x + off);
      *reinterpret_cast<uint4*>(As + r * LDA + kk) = val;
    }
  } else {
    for (int v = threadIdx.x; v < BM * BK; v += THREADS) {
      const int r = v / BK, kk = v % BK;
      const long long off = a_offset(rows, r, k0 + kk, kend, X, Y, Z, C);
      As[r * LDA + kk] = off >= 0 ? x[off] : from_float<T>(0.f);
    }
  }
}

template <typename T, int LDB>
__device__ __forceinline__ void load_b(T* Bs, const T* __restrict__ w, int k0, int n0,
                                       int kend, int F, bool vec) {
  constexpr int VEC = 16 / sizeof(T);
  if (vec) {
    constexpr int VPR = BN / VEC;
    for (int v = threadIdx.x; v < BK * VPR; v += THREADS) {
      const int r = v / VPR, nn = (v % VPR) * VEC;
      const int k = k0 + r, n = n0 + nn;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (k < kend && n < F) val = *reinterpret_cast<const uint4*>(w + (long long)k * F + n);
      *reinterpret_cast<uint4*>(Bs + r * LDB + nn) = val;
    }
  } else {
    for (int v = threadIdx.x; v < BK * BN; v += THREADS) {
      const int r = v / BN, nn = v % BN;
      const int k = k0 + r, n = n0 + nn;
      Bs[r * LDB + nn] = (k < kend && n < F) ? w[(long long)k * F + n] : from_float<T>(0.f);
    }
  }
}

template <typename T, bool PER_TAP>
__global__ void __launch_bounds__(THREADS)
conv3x3_kernel(const T* __restrict__ x, const T* __restrict__ w, T* __restrict__ y,
               int M, int X, int Y, int Z, int C, int F, int vec_a, int vec_b) {
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

  if (tid < BM) {
    const long long m = m0 + tid;
    if (m < M) {
      long long t = m;
      rows.z[tid] = (int)(t % Z); t /= Z;
      rows.y[tid] = (int)(t % Y); t /= Y;
      rows.x[tid] = (int)(t % X);
      rows.base[tid] = m * C;
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
        load_a<T, LDA>(As, x, rows, k0, kend, X, Y, Z, C, vec_a);
        load_b<T, LDB>(Bs, w, k0, n0, kend, F, vec_b);
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
      load_a<T, LDA>(As, x, rows, k0, K, X, Y, Z, C, vec_a);
      load_b<T, LDB>(Bs, w, k0, n0, K, F, vec_b);
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

// x: (B, X, Y, Z, C) contiguous; w: (27*C, F) contiguous; y: (B, X, Y, Z, F).
// dtype: 0 = float32, 1 = bfloat16. vec_a / vec_b: 16-byte loads are allowed
// (C resp. F is a multiple of 16 bytes' worth of elements and the pointer is
// 16-byte aligned). Launches on `stream`; returns cudaGetLastError().
template <bool PER_TAP>
int launch(const void* x, const void* w, void* y, int B, int X, int Y, int Z, int C, int F,
           int dtype, int vec_a, int vec_b, void* stream) {
  const long long M = (long long)B * X * Y * Z;
  if (M <= 0 || M > 0x7fffffffLL || C <= 0 || F <= 0 || 27LL * C > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)((M + BM - 1) / BM), (unsigned)((F + BN - 1) / BN));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    conv3x3_kernel<bf16, PER_TAP><<<grid, THREADS, 0, s>>>(
        static_cast<const bf16*>(x), static_cast<const bf16*>(w), static_cast<bf16*>(y),
        (int)M, X, Y, Z, C, F, vec_a, vec_b);
  } else if (dtype == 0) {
    conv3x3_kernel<float, PER_TAP><<<grid, THREADS, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(w), static_cast<float*>(y),
        (int)M, X, Y, Z, C, F, vec_a, vec_b);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace conv3x3_igemm
