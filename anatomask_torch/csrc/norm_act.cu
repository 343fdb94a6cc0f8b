// The norm epilogue in one pass over NDHWC data, for Hopper (sm_90a):
//
//   out = act(rnd(rnd(rnd(rnd(y + bias) * a) + b) + rnd(s + sbias)))
//
// y (B, V, C) is the raw output of the conv before a norm, bias its (C)
// bias, a and b the norm's (B or 1, C) affine from the fp32 statistics
// (a = weight / sqrt(var + eps), b = beta - mean * a), s an optional residual
// (B, V, C) with its optional (C) bias, act LeakyReLU(0.01) or none; rnd
// rounds to the compute dtype (bf16 or fp32). bias, a, b and sbias come in
// fp32 and are rounded to the compute dtype first. Each step rounds where the
// op sequence it replaces rounds (models/layers.py: the conv's bias add, the
// norm's x * a then + b, the residual's bias add and sum, leaky_relu), each
// in fp32 arithmetic of compute-dtype operands, so the result has the same
// bits. In fp32 every product and sum is __fmul_rn / __fadd_rn, which nvcc
// never contracts into an FMA (one rounding where the sequence has two).
//
// Replaces no TPU kernel: the JAX package leaves the norm's affine, the
// activation and the residual add to XLA, which fuses them into the ops
// around them. The port's eager PyTorch made each a full read and write of the
// activation (up to 10 passes a residual block); this kernel makes them one
// read of y (and s) and one write, on the no-grad forward (prediction, the
// teacher, validation), where no intermediate is kept for a backward.
//
// Bound on the H100: a few flops a byte, so the 3.35 TB/s of device memory:
// (2 or 3) * B*V*C * sizeof(T) bytes a call. The design: 16-byte loads and
// stores along the contiguous C; a block is R rows (voxels) x G columns of
// 16-byte vectors of one sample, each thread keeping its columns' rounded
// per-channel operands in registers for the U voxels it handles; its U loads
// of y (and of s) are all issued before any arithmetic. No shared memory, no
// atomics; grid (voxel chunks, channel tiles, B).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

namespace norm_epilogue {

constexpr int THREADS = 256;
constexpr int U = 4;  // voxels a thread handles, R apart

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(bf16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_float(float v) {
  if constexpr (std::is_same<T, bf16>::value) return __float2bfloat16_rn(v);
  else return v;
}

// v rounded to T and widened back
template <typename T>
__device__ __forceinline__ float rnd(float v) {
  return to_float(from_float<T>(v));
}

// VEC elements of T: one 16-byte vector, or one element when VEC == 1
template <typename T, int VEC>
struct Vec {
  using Raw = typename std::conditional<VEC == 1, T, uint4>::type;
  __device__ __forceinline__ static Raw load(const T* p) {
    if constexpr (VEC == 1) return __ldg(p);
    else return __ldg(reinterpret_cast<const uint4*>(p));
  }
  __device__ __forceinline__ static void store(T* p, const Raw& r) {
    if constexpr (VEC == 1) *p = r;
    else *reinterpret_cast<uint4*>(p) = r;
  }
  __device__ __forceinline__ static float get(const Raw& r, int i) {
    if constexpr (VEC == 1) return to_float(r);
    else return to_float(reinterpret_cast<const T*>(&r)[i]);
  }
  __device__ __forceinline__ static void set(Raw& r, int i, float v) {
    if constexpr (VEC == 1) r = from_float<T>(v);
    else reinterpret_cast<T*>(&r)[i] = from_float<T>(v);
  }
};

template <typename T, int VEC, bool BIAS, bool SKIP, bool SKIP_BIAS, bool ACT>
__global__ void __launch_bounds__(THREADS)
norm_act_kernel(const T* __restrict__ y, const float* __restrict__ bias,
                const float* __restrict__ a, const float* __restrict__ b,
                const T* __restrict__ s, const float* __restrict__ sbias, T* __restrict__ out,
                long long V, int C, int ncols, int gt, int per_sample) {
  using LV = Vec<T, VEC>;
  const int R = THREADS / gt;
  const int r = threadIdx.x / gt, col = blockIdx.y * gt + threadIdx.x % gt;
  if (r >= R || col >= ncols) return;
  const int c0 = col * VEC;
  const long long n = blockIdx.z;
  const long long row = per_sample ? n * C : 0;  // a and b are (B, C) or (1, C)
  float pa[VEC], pb[VEC], pc[VEC], ps[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) {
    pa[i] = rnd<T>(__ldg(a + row + c0 + i));
    pb[i] = rnd<T>(__ldg(b + row + c0 + i));
    pc[i] = ps[i] = 0.f;
    if constexpr (BIAS) pc[i] = rnd<T>(__ldg(bias + c0 + i));
    if constexpr (SKIP_BIAS) ps[i] = rnd<T>(__ldg(sbias + c0 + i));
  }
  const long long base = n * V * C + c0;
  const long long v0 = (long long)blockIdx.x * R * U + r;
  typename LV::Raw ry[U], rs[U];
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const long long v = v0 + (long long)u * R;
    if (v < V) {
      ry[u] = LV::load(y + base + v * C);
      if constexpr (SKIP) rs[u] = LV::load(s + base + v * C);
    }
  }
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const long long v = v0 + (long long)u * R;
    if (v >= V) continue;
    typename LV::Raw o;
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      float e = LV::get(ry[u], i);
      if constexpr (BIAS) e = rnd<T>(__fadd_rn(e, pc[i]));
      e = rnd<T>(__fmul_rn(e, pa[i]));
      e = rnd<T>(__fadd_rn(e, pb[i]));
      if constexpr (SKIP) {
        float w = LV::get(rs[u], i);
        if constexpr (SKIP_BIAS) w = rnd<T>(__fadd_rn(w, ps[i]));
        e = rnd<T>(__fadd_rn(e, w));
      }
      // PyTorch's leaky_relu: x > 0 ? x : x * 0.01f, in fp32, then rounded
      if constexpr (ACT) e = e > 0.f ? e : rnd<T>(__fmul_rn(e, 0.01f));
      LV::set(o, i, e);
    }
    LV::store(out + base + v * C, o);
  }
}

using KernelFn = const void*;

template <typename T, int VEC, bool BIAS, bool SKIP, bool SKIP_BIAS>
KernelFn pick_act(int act) {
  return act ? reinterpret_cast<KernelFn>(&norm_act_kernel<T, VEC, BIAS, SKIP, SKIP_BIAS, true>)
             : reinterpret_cast<KernelFn>(&norm_act_kernel<T, VEC, BIAS, SKIP, SKIP_BIAS, false>);
}

// skip: 0 none, 1 a residual, 2 a residual with its bias
template <typename T, int VEC, bool BIAS>
KernelFn pick_skip(int skip, int act) {
  if (skip == 2) return pick_act<T, VEC, BIAS, true, true>(act);
  if (skip == 1) return pick_act<T, VEC, BIAS, true, false>(act);
  return pick_act<T, VEC, BIAS, false, false>(act);
}

template <typename T, int VEC>
KernelFn pick_bias(int bias, int skip, int act) {
  return bias ? pick_skip<T, VEC, true>(skip, act) : pick_skip<T, VEC, false>(skip, act);
}

// The instantiation for (dtype 0 = float32, 1 = bfloat16; 16-byte vectors or
// elements; bias; skip; act)
KernelFn pick(int dtype, int vec, int bias, int skip, int act) {
  if (dtype == 1)
    return vec ? pick_bias<bf16, 8>(bias, skip, act) : pick_bias<bf16, 1>(bias, skip, act);
  return vec ? pick_bias<float, 4>(bias, skip, act) : pick_bias<float, 1>(bias, skip, act);
}

}  // namespace norm_epilogue

// y, s, out: (B, V, C) contiguous, dtype 0 = float32, 1 = bfloat16; s NULL for
// no residual; bias, sbias: (C) float32 or NULL (sbias only with s); a, b:
// (a_rows, C) float32, a_rows 1 (one affine for the batch) or B; vec: 1 when C
// is a multiple of 16 bytes' worth of elements and y, s, out are 16-byte
// aligned (16-byte loads and stores), else 0; act: 1 LeakyReLU(0.01), 0 none.
// One launch on `stream`; returns cudaGetLastError() or cudaErrorInvalidValue
// for a shape the grid cannot hold.
extern "C" int norm_act_forward(const void* y, const void* bias, const void* a, const void* b,
                                const void* s, const void* sbias, void* out, long long B,
                                long long V, int C, int a_rows, int dtype, int vec, int act,
                                void* stream) {
  if (B <= 0 || V <= 0 || C <= 0 || B > 65535 || (dtype != 0 && dtype != 1) ||
      (a_rows != 1 && a_rows != B) || (sbias != nullptr && s == nullptr))
    return (int)cudaErrorInvalidValue;
  using norm_epilogue::THREADS;
  const int w = vec ? (dtype == 1 ? 8 : 4) : 1;
  if (C % w != 0) return (int)cudaErrorInvalidValue;
  int ncols = C / w;
  int gt = ncols < THREADS ? ncols : THREADS;
  const long long ntiles = (ncols + gt - 1) / gt;
  const long long per_block = (long long)(THREADS / gt) * norm_epilogue::U;
  const long long chunks = (V + per_block - 1) / per_block;
  if (ntiles > 65535 || chunks > 2147483647LL) return (int)cudaErrorInvalidValue;
  const int skip = s == nullptr ? 0 : sbias == nullptr ? 1 : 2;
  norm_epilogue::KernelFn k = norm_epilogue::pick(dtype, vec, bias != nullptr, skip, act != 0);
  int per_sample = a_rows != 1;
  const dim3 grid((unsigned)chunks, (unsigned)ntiles, (unsigned)B);
  // one pointer to each kernel parameter, in order and of its type
  void* args[] = {(void*)&y, (void*)&bias, (void*)&a, (void*)&b, (void*)&s, (void*)&sbias,
                  (void*)&out, (void*)&V, (void*)&C, (void*)&ncols, (void*)&gt,
                  (void*)&per_sample};
  cudaLaunchKernel(k, grid, dim3(THREADS), args, 0, static_cast<cudaStream_t>(stream));
  return (int)cudaGetLastError();
}
