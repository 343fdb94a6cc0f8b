// Per-row fp32 moments of an NDHWC activation for Hopper (sm_90a):
//
//   s[b, c]  = sum_v m[b, v] * e[b, v, c]
//   ss[b, c] = sum_v m[b, v] * sq(e[b, v, c])
//
// over the V = X*Y*Z voxels of sample b, with m the optional visibility mask
// (absent = every voxel counts) and e = x, or with the optional per-channel
// bias e = x + bias[c] rounded to x's dtype (the bias itself rounded to it
// first), as the model's conv adds its bias before the norm reads it. These
// are the statistics of every instance norm of the port, masked
// (SparseInstanceNorm) and plain (InstanceNorm); the bias serves the no-grad
// forward, whose conv leaves its bias to the norm (ops/norm_act.py), so the
// biased conv output is never written to device memory.
//
// Replaces the TPU kernel probes/probe_rowstats.py `pallas_moments` (body
// `_kern`): fp32 sums of x and x*x over H of an (N, H, W*C) view, finished by
// a W reduce to per-row (N, C). Every sum accumulates in fp32. sq(x) is x*x
// in fp32 as there (x widened first), or, with `square_in_dtype`, x*x rounded
// to bf16 before it is widened: the model path's rounding, as the JAX
// package's norms square in the compute dtype (models/layers.py
// `jnp.square(x)`, ssl/sparse.py `_masked_moments`, ops/moments.py
// `folded_row_sums`). For fp32 input the two are the same.
//
// Bound on the H100: each input byte is read once for 3 flops an element, so
// the 3.35 TB/s of device memory bounds a large call. A small one (the
// norms at <= 16^3 hold 0.1-3 MB) is bound by fixed costs: launches, the host
// path, one DRAM round trip. The design:
// - one launch a call. Grid (P, channel tiles, B): P partial blocks of a
//   (sample, tile) walk its voxel groups with a grid stride. Each writes its
//   fp32 partial sums to a scratch buffer; the last of the P to arrive (an
//   integer ticket per (b, tile), taken after __threadfence()) adds the P
//   partials in partial order, writes s and ss, and resets the ticket to 0
//   for the next call. No float atomics: two calls give the same bits. The
//   scratch stays allocated on the device between calls (ops/moments.py).
// - the grid comes from the card: P fills the SMs' resident blocks
//   (multiprocessor count x occupancy) once, at most one block a voxel
//   group, so that small shapes spread over the SMs and large ones run the
//   grid-stride loop with a finish of at most MAX_PARTIALS partials.
// - bytes in flight: a block is R rows x G columns of 16-byte vectors along
//   the contiguous C (a tile is at most 32 columns, a warp's width). Row r
//   reads voxels g0 + u * R + r, u < U = 8, of a group: it loads their U
//   mask bytes first, then issues U independent 16-byte loads of x,
//   predicated on those bytes (a hidden voxel's row is never read), before
//   any add. For one u a warp's rows are consecutive voxels, which the
//   model's masks (patches of 16^3 to 1 voxels at the levels of 32 to 512
//   channels) show or hide together: a warp skips a hidden slice's load and
//   adds whole, where a thread that owned U consecutive voxels shared its
//   warp with visible ones.
// - the block adds its R rows by a fixed tree in shared memory; the finish
//   splits the P partials over all threads of the block, then adds the
//   pieces in order.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

namespace {

constexpr int THREADS = 256;
constexpr int U = 8;             // voxels a row reads a group, R apart
constexpr int MAX_COLS = 32;     // 16-byte columns a channel tile
constexpr int MAX_VEC = 8;       // bf16 elements in 16 bytes
constexpr int MAX_PARTIALS = 256;
constexpr int MAX_DEVICES = 64;

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(bf16 v) { return __bfloat162float(v); }

// v rounded to T and widened back
template <typename T>
__device__ __forceinline__ float round_to(float v) {
  if constexpr (std::is_same<T, bf16>::value) return __bfloat162float(__float2bfloat16_rn(v));
  return v;
}

template <bool ROUND_SQ>
__device__ __forceinline__ float square(float e) {
  if constexpr (ROUND_SQ) return __bfloat162float(__float2bfloat16_rn(e * e));
  return e * e;
}

// VEC elements of T: one 16-byte vector, or one element when VEC == 1
template <typename T, int VEC>
struct Vec {
  using Raw = typename std::conditional<VEC == 1, T, uint4>::type;
  __device__ __forceinline__ static Raw load(const T* p) {
    if constexpr (VEC == 1) return __ldg(p);
    else return __ldg(reinterpret_cast<const uint4*>(p));
  }
  __device__ __forceinline__ static Raw zero() {
    if constexpr (VEC == 1) return T(0.f);
    else return make_uint4(0u, 0u, 0u, 0u);
  }
  __device__ __forceinline__ static float get(const Raw& r, int i) {
    if constexpr (VEC == 1) return to_float(r);
    else return to_float(reinterpret_cast<const T*>(&r)[i]);
  }
};

struct Plan {
  int vec;       // elements a column
  int ncols;     // columns of C
  int gt;        // columns a tile; a block is THREADS / gt rows of them
  int ntiles;    // channel tiles
  int parts;     // P: partial blocks a (sample, tile)
  long long ngroups;  // voxel groups of R * U voxels a sample
};

Plan make_plan(long long B, long long V, int C, int vec, int resident_blocks) {
  Plan p;
  p.vec = vec;
  p.ncols = C / vec;
  p.gt = p.ncols < MAX_COLS ? p.ncols : MAX_COLS;
  p.ntiles = (p.ncols + p.gt - 1) / p.gt;
  const long long per_group = (long long)(THREADS / p.gt) * U;
  p.ngroups = (V + per_group - 1) / per_group;
  long long parts = (resident_blocks + B * p.ntiles - 1) / (B * p.ntiles);
  if (parts > p.ngroups) parts = p.ngroups;
  if (parts > MAX_PARTIALS) parts = MAX_PARTIALS;
  p.parts = parts < 1 ? 1 : (int)parts;
  return p;
}

template <typename T, int VEC, bool ROUND_SQ, bool BIAS>
__global__ void __launch_bounds__(THREADS)
moments_kernel(const T* __restrict__ x, const unsigned char* __restrict__ mask,
               const float* __restrict__ bias, float* __restrict__ out,
               float* __restrict__ partials, unsigned* __restrict__ tickets, long long B,
               long long V, int C, int ncols, int gt, int parts, long long ngroups) {
  using LV = Vec<T, VEC>;
  __shared__ float red_s[THREADS * MAX_VEC];
  __shared__ float red_ss[THREADS * MAX_VEC];
  __shared__ bool last;
  const int p = blockIdx.x, tile = blockIdx.y, b = blockIdx.z;
  const int R = THREADS / gt;
  const int r = threadIdx.x / gt, g = threadIdx.x % gt;
  const int tcols = min(gt, ncols - tile * gt);  // columns of this tile
  const int rowlen = gt * VEC;                     // floats a row of red_*
  const int width = tcols * VEC;                   // channels of this tile

  float s[VEC], ss[VEC], bv[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) s[i] = ss[i] = bv[i] = 0.f;
  if (r < R && g < tcols) {
    if constexpr (BIAS) {
#pragma unroll
      for (int i = 0; i < VEC; ++i)
        bv[i] = round_to<T>(__ldg(bias + (tile * gt + g) * VEC + i));
    }
    const T* xb = x + (long long)b * V * C + (long long)(tile * gt + g) * VEC;
    const unsigned char* mb = mask == nullptr ? nullptr : mask + (long long)b * V;
    const long long full = V / ((long long)R * U);  // groups without a ragged end
    for (long long k = p; k < ngroups; k += parts) {
      // row r reads voxels g0 + u * R + r: a warp's rows are consecutive
      // voxels, so on the model's masks (runs of >= 32 / G visible voxels)
      // a warp's vis[u] is uniform and it skips a hidden slice whole
      const long long g0 = k * R * U + r;
      bool vis[U];
      if (k < full) {
#pragma unroll
        for (int u = 0; u < U; ++u) vis[u] = mb == nullptr || __ldg(mb + g0 + u * R) != 0;
      } else {
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const long long v = g0 + u * R;
          vis[u] = v < V && (mb == nullptr || __ldg(mb + v) != 0);
        }
      }
      typename LV::Raw raw[U];
#pragma unroll
      for (int u = 0; u < U; ++u)
        raw[u] = vis[u] ? LV::load(xb + (g0 + u * R) * C) : LV::zero();
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (!vis[u]) continue;
#pragma unroll
        for (int i = 0; i < VEC; ++i) {
          float e = LV::get(raw[u], i);
          if constexpr (BIAS) e = round_to<T>(__fadd_rn(e, bv[i]));
          s[i] += e;
          ss[i] += square<ROUND_SQ>(e);
        }
      }
    }
  }

  // the block's R rows, added by a fixed tree
  if (r < R) {
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      red_s[r * rowlen + g * VEC + i] = s[i];
      red_ss[r * rowlen + g * VEC + i] = ss[i];
    }
  }
  int half = 1;
  while (half < R) half <<= 1;
  for (half >>= 1; half >= 1; half >>= 1) {
    __syncthreads();
    for (int e = threadIdx.x; e < half * rowlen; e += THREADS) {
      const int rr = e / rowlen;
      if (rr + half < R) {
        red_s[e] += red_s[e + half * rowlen];
        red_ss[e] += red_ss[e + half * rowlen];
      }
    }
  }
  __syncthreads();

  const long long bt = (long long)b * gridDim.y + tile;
  float* mine = partials + (bt * parts + p) * 2 * rowlen;
  for (int j = threadIdx.x; j < width; j += THREADS) {
    mine[j] = red_s[j];
    mine[rowlen + j] = red_ss[j];
  }
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(&tickets[bt], 1u) == (unsigned)(parts - 1);
  __syncthreads();
  if (!last) return;

  // the last block of (b, tile): K threads a channel, each adding a run of
  // partials in order, then the K runs in order
  __threadfence();
  const float* all = partials + bt * parts * 2 * rowlen;
  const int K = THREADS / width;  // width <= MAX_COLS * MAX_VEC = THREADS
  const int j = threadIdx.x % width, q = threadIdx.x / width;
  if (q < K) {
    const int q0 = (int)((long long)parts * q / K), q1 = (int)((long long)parts * (q + 1) / K);
    float a = 0.f, aa = 0.f;
#pragma unroll 8
    for (int k = q0; k < q1; ++k) {
      a += __ldcg(all + (long long)k * 2 * rowlen + j);
      aa += __ldcg(all + (long long)k * 2 * rowlen + rowlen + j);
    }
    red_s[q * width + j] = a;
    red_ss[q * width + j] = aa;
  }
  __syncthreads();
  if (threadIdx.x < width) {
    float a = 0.f, aa = 0.f;
    for (int k = 0; k < K; ++k) {
      a += red_s[k * width + threadIdx.x];
      aa += red_ss[k * width + threadIdx.x];
    }
    const long long c = (long long)b * C + tile * gt * VEC + threadIdx.x;
    out[c] = a;
    out[B * C + c] = aa;
  }
  if (threadIdx.x == 0) tickets[bt] = 0u;
}

using KernelFn = const void*;

template <typename T, int VEC, bool ROUND_SQ>
KernelFn kernel_of(int bias) {
  return bias ? reinterpret_cast<const void*>(&moments_kernel<T, VEC, ROUND_SQ, true>)
              : reinterpret_cast<const void*>(&moments_kernel<T, VEC, ROUND_SQ, false>);
}

// The kernel instantiation for (dtype, vec width, rounding, bias): 0 = float32, 1 = bfloat16.
KernelFn pick(int dtype, int vec, int round_sq, int bias) {
  if (dtype == 1) {
    if (vec == 8)
      return round_sq ? kernel_of<bf16, 8, true>(bias) : kernel_of<bf16, 8, false>(bias);
    return round_sq ? kernel_of<bf16, 1, true>(bias) : kernel_of<bf16, 1, false>(bias);
  }
  return vec == 4 ? kernel_of<float, 4, false>(bias) : kernel_of<float, 1, false>(bias);
}

int vec_width(int dtype, int vec) { return vec ? (dtype == 1 ? 8 : 4) : 1; }

// Resident blocks of this instantiation on the current device: the SM count
// times the occupancy, each asked once per device.
int resident_blocks(KernelFn k, int slot) {
  static int cache[MAX_DEVICES][8];
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= MAX_DEVICES) return 0;
  if (cache[dev][slot] == 0) {
    int sms = 0, per_sm = 0;
    if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, k, THREADS, 0) != cudaSuccess)
      return 0;
    cache[dev][slot] = sms * (per_sm > 0 ? per_sm : 1);
  }
  return cache[dev][slot];
}

int slot_of(int dtype, int vec, int round_sq) {
  return dtype * 4 + (vec > 1 ? 2 : 0) + (round_sq ? 1 : 0);
}

bool plan_for(long long B, long long V, int C, int dtype, int vec, int round_sq, int bias,
              Plan* plan, KernelFn* k) {
  if (B <= 0 || V <= 0 || C <= 0 || B > 65535 || (dtype != 0 && dtype != 1)) return false;
  const int w = vec_width(dtype, vec);
  if (C % w != 0) return false;
  round_sq = dtype == 1 && round_sq;
  bias = bias != 0;
  *k = pick(dtype, w, round_sq, bias);
  // the grid of the bias-free instantiation, whatever the bias: the same
  // partials in the same order, so a bias changes no bit of a sum taken over
  // x + bias against one over that tensor written out (the blocks never wait
  // on each other, so any grid runs)
  const int resident = resident_blocks(pick(dtype, w, round_sq, 0),
                                       slot_of(dtype, w, round_sq));
  if (resident <= 0) return false;
  *plan = make_plan(B, V, C, w, resident);
  return plan->ntiles <= 65535;
}

}  // namespace

// Scratch that row_moments_forward needs for this shape on the current
// device, with or without a bias: sizes[0] fp32 partials, sizes[1] int32
// tickets (zeroed once; each call leaves them at 0). Returns 0 or a CUDA
// error code.
extern "C" int row_moments_scratch(long long B, long long V, int C, int dtype, int vec,
                                   int square_in_dtype, long long* sizes) {
  Plan p;
  KernelFn k;
  if (!plan_for(B, V, C, dtype, vec, square_in_dtype, 0, &p, &k))
    return (int)cudaErrorInvalidValue;
  sizes[0] = B * p.ntiles * (long long)p.parts * 2 * p.gt * p.vec;
  sizes[1] = B * p.ntiles;
  return 0;
}

// x: (B, V, C) contiguous, dtype 0 = float32, 1 = bfloat16; mask: (B, V) bytes
// of 0/1 or NULL; bias: (C) float32 or NULL; out: (2, B, C) float32, s then
// ss; vec: 1 when C is a multiple of 16 bytes' worth of elements and x is
// 16-byte aligned (16-byte loads), else 0 (element loads); square_in_dtype:
// round x*x to bf16 before it is added (bf16 only). One launch on `stream`;
// returns cudaGetLastError().
extern "C" int row_moments_forward(const void* x, const void* mask, const void* bias, void* out,
                                   void* partials, void* tickets, long long B, long long V,
                                   int C, int dtype, int vec, int square_in_dtype,
                                   void* stream) {
  Plan p;
  KernelFn k;
  if (!plan_for(B, V, C, dtype, vec, square_in_dtype, bias != nullptr, &p, &k))
    return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)p.parts, (unsigned)p.ntiles, (unsigned)B);
  // one pointer to each kernel parameter, in order and of its type
  void* args[] = {(void*)&x, (void*)&mask, (void*)&bias, (void*)&out, (void*)&partials,
                  (void*)&tickets, (void*)&B, (void*)&V, (void*)&C, (void*)&p.ncols, (void*)&p.gt,
                  (void*)&p.parts, (void*)&p.ngroups};
  cudaLaunchKernel(k, grid, dim3(THREADS), args, 0, static_cast<cudaStream_t>(stream));
  return (int)cudaGetLastError();
}
