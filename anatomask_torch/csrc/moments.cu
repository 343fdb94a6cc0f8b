// Per-row fp32 moments of an NDHWC activation for Hopper (sm_90a):
//
//   s[b, c]  = sum_v m[b, v] * x[b, v, c]
//   ss[b, c] = sum_v m[b, v] * x[b, v, c]^2
//
// over the V = X*Y*Z voxels of sample b, with m the optional visibility mask
// (absent = every voxel counts). These are the statistics of every instance
// norm of the port, masked (SparseInstanceNorm) and plain (InstanceNorm).
//
// Replaces the TPU kernel probes/probe_rowstats.py `pallas_moments` (body
// `_kern`): fp32 sums of x and x*x over H of an (N, H, W*C) view, finished by
// a W reduce to per-row (N, C). As there, each element is widened to fp32
// before it is squared and every sum accumulates in fp32. (The JAX package's
// shipped reduction, ops/moments.py `folded_row_sums`, squares in the input
// dtype; at bf16 the two differ by the rounding of x*x only.)
//
// Bound on the H100: each input byte is read once for 3 flops per element, so
// the 3.35 TB/s of device memory bounds it, not arithmetic. The design keeps
// the read streaming:
// - pass 1, grid (voxel chunks, channel tiles, B): a block owns one chunk of
//   voxels of one sample and up to THREADS vector columns of VEC channels
//   (16-byte loads along the contiguous C; element loads where C or the
//   pointer does not allow them). Its threads form R rows x G columns; row r
//   reads voxels v0 + r, v0 + r + R, ..., so a warp reads one contiguous run
//   of memory. Each thread keeps 2*VEC fp32 sums in registers; the R rows are
//   then added in a fixed order through shared memory and the block writes
//   its partial sums to a workspace;
// - pass 2: one thread per (b, c) adds the chunks' partials in chunk order.
// No atomics, so two runs on the same input give the same bits.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int ITERS = 32;      // voxels each row of a block reads per chunk
constexpr int MAX_VEC = 8;     // bf16 elements in 16 bytes

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(bf16 v) { return __bfloat162float(v); }

template <typename T, int VEC>
__device__ __forceinline__ void load_vec(const T* __restrict__ p, float (&e)[VEC]) {
  if constexpr (VEC == 1) {
    e[0] = to_float(p[0]);
  } else {
    static_assert(VEC * sizeof(T) == 16, "vector loads are 16 bytes");
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
    const T* v = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int i = 0; i < VEC; ++i) e[i] = to_float(v[i]);
  }
}

struct Plan {
  int ncols;     // vector columns of C
  int gt;        // columns per block (channel tile)
  int rows;      // R = THREADS / gt
  int ntiles;    // channel tiles
  long long nchunks;  // voxel chunks per sample
};

Plan make_plan(long long V, int C, int vec) {
  Plan p;
  p.ncols = C / vec;
  p.gt = p.ncols < THREADS ? p.ncols : THREADS;
  p.rows = THREADS / p.gt;
  p.ntiles = (p.ncols + p.gt - 1) / p.gt;
  const long long per_chunk = (long long)p.rows * ITERS;
  p.nchunks = (V + per_chunk - 1) / per_chunk;
  return p;
}

template <typename T, int VEC>
__global__ void __launch_bounds__(THREADS)
moments_partial(const T* __restrict__ x, const unsigned char* __restrict__ mask,
                float* __restrict__ work, long long V, int C, int ncols, int gt,
                long long nchunks) {
  __shared__ float sm_s[THREADS * MAX_VEC];
  __shared__ float sm_ss[THREADS * MAX_VEC];
  const long long chunk = blockIdx.x;
  const int tile = blockIdx.y, b = blockIdx.z;
  const int R = THREADS / gt;
  const int r = threadIdx.x / gt, g = threadIdx.x % gt;
  const int col = tile * gt + g;
  const int width = min(gt, ncols - tile * gt) * VEC;  // channels of this tile

  float s[VEC], ss[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) s[i] = ss[i] = 0.f;
  if (r < R && col < ncols) {
    const long long v0 = chunk * R * ITERS + r;
    const T* xb = x + (long long)b * V * C + (long long)col * VEC;
    const unsigned char* mb = mask == nullptr ? nullptr : mask + (long long)b * V;
#pragma unroll 8
    for (int it = 0; it < ITERS; ++it) {
      const long long v = v0 + (long long)it * R;
      if (v < V && (mb == nullptr || mb[v])) {
        float e[VEC];
        load_vec<T, VEC>(xb + v * C, e);
#pragma unroll
        for (int i = 0; i < VEC; ++i) {
          s[i] += e[i];
          ss[i] += e[i] * e[i];
        }
      }
    }
  }
  if (r < R) {
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      sm_s[r * gt * VEC + g * VEC + i] = s[i];
      sm_ss[r * gt * VEC + g * VEC + i] = ss[i];
    }
  }
  __syncthreads();
  float* w = work + ((long long)b * nchunks + chunk) * 2 * C + (long long)tile * gt * VEC;
  for (int j = threadIdx.x; j < width; j += THREADS) {
    float a = 0.f, q = 0.f;
    for (int rr = 0; rr < R; ++rr) {
      a += sm_s[rr * gt * VEC + j];
      q += sm_ss[rr * gt * VEC + j];
    }
    w[j] = a;
    w[C + j] = q;
  }
}

__global__ void __launch_bounds__(THREADS)
moments_finish(const float* __restrict__ work, float* __restrict__ s, float* __restrict__ ss,
               int C, long long nchunks) {
  const int c = blockIdx.x * THREADS + threadIdx.x;
  const long long b = blockIdx.y;
  if (c >= C) return;
  const float* w = work + b * nchunks * 2 * C + c;
  float a = 0.f, q = 0.f;
#pragma unroll 8
  for (long long k = 0; k < nchunks; ++k) {
    a += w[k * 2 * C];
    q += w[k * 2 * C + C];
  }
  s[b * C + c] = a;
  ss[b * C + c] = q;
}

template <typename T, int VEC>
void launch(const void* x, const unsigned char* mask, float* s, float* ss, float* work,
            long long B, long long V, int C, const Plan& p, cudaStream_t stream) {
  const dim3 grid1((unsigned)p.nchunks, (unsigned)p.ntiles, (unsigned)B);
  moments_partial<T, VEC><<<grid1, THREADS, 0, stream>>>(
      static_cast<const T*>(x), mask, work, V, C, p.ncols, p.gt, p.nchunks);
  const dim3 grid2((unsigned)((C + THREADS - 1) / THREADS), (unsigned)B);
  moments_finish<<<grid2, THREADS, 0, stream>>>(work, s, ss, C, p.nchunks);
}

}  // namespace

// vec: 1 when C is a multiple of 16 bytes' worth of elements and x is 16-byte
// aligned (16-byte loads), else 0 (element loads).
static int vec_width(int dtype, int vec) {
  return vec ? (dtype == 1 ? 8 : 4) : 1;
}

// fp32 elements of workspace that row_moments_forward needs for this shape.
extern "C" long long row_moments_workspace(long long B, long long V, int C, int dtype,
                                           int vec) {
  if (B <= 0 || V <= 0 || C <= 0) return 0;
  const Plan p = make_plan(V, C, vec_width(dtype, vec));
  return B * p.nchunks * 2 * C;
}

// x: (B, V, C) contiguous, dtype 0 = float32, 1 = bfloat16; mask: (B, V) bytes
// of 0/1 or NULL; s, ss: (B, C) float32 outputs; work: row_moments_workspace()
// floats. Launches both passes on `stream`; returns cudaGetLastError().
extern "C" int row_moments_forward(const void* x, const void* mask, void* s, void* ss,
                                   void* work, long long B, long long V, int C, int dtype,
                                   int vec, void* stream) {
  if (B <= 0 || V <= 0 || C <= 0 || B > 65535 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  const int w = vec_width(dtype, vec);
  if (C % w != 0) return (int)cudaErrorInvalidValue;
  const Plan p = make_plan(V, C, w);
  if (p.nchunks > 0x7fffffffLL || p.ntiles > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned char* m = static_cast<const unsigned char*>(mask);
  float* fs = static_cast<float*>(s);
  float* fss = static_cast<float*>(ss);
  float* fw = static_cast<float*>(work);
  if (dtype == 1) {
    if (w == 8) launch<bf16, 8>(x, m, fs, fss, fw, B, V, C, p, st);
    else launch<bf16, 1>(x, m, fs, fss, fw, B, V, C, p, st);
  } else {
    if (w == 4) launch<float, 4>(x, m, fs, fss, fw, B, V, C, p, st);
    else launch<float, 1>(x, m, fs, fss, fw, B, V, C, p, st);
  }
  return (int)cudaGetLastError();
}
