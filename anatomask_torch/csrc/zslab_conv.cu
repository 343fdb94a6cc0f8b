// Stride-1 "same" 3x3x3 convolution for Hopper (sm_90a) with the z-slab
// rounding: each first-axis tap's partial sum is rounded to the output type
// and the three taps are added in that type. NDHWC x (27*C, F).
//
// Replaces the TPU kernel anatomask_tpu/ops/pallas_zslab_conv.py `_fwd_impl`
// (the `pl.pallas_call` over the grid (B, D, 3) of `_make_kernel`: per z-tap a
// (CH*W x 9C) im2col tile times that tap's (9C x F) weight slice, accumulated in
// fp32, rounded to the output dtype and added to the output block in it).
//
//   y = round(T0) (+) round(T1) (+) round(T2),  (+) = an add in the output type,
//   Td[b, x, y, z, f] = sum_{dy, dz, c} xpad[b, x+d, y+dy, z+dz, c] * w[d, dy, dz, c, f]
//
// The TPU kernel carries the output block across the three steps of its
// sequential grid. On Hopper blocks run in no order, so nothing carries
// between them: one block owns a BM x BN output tile for all three taps. It
// is kernel #1's implicit GEMM (conv3x3_igemm.cuh, shared with csrc/conv3x3.cu)
// with PER_TAP = true: the K loop is split at the tap boundaries, K = 9*C each;
// at the end of a tap the fp32 accumulators are rounded and added to a running
// sum in the output type, and the accumulators restart at zero. The output is
// written once, at the end.
//
// Bound on the H100: at the shapes of probes/probe_pallas_v4.py (B = 4,
// 112x112x128, bf16) the conv is bound by operations. dec3 (C = F = 64) does
// 1.42 TFLOP, 1.44 ms at 989 TFLOP/s; enc0 (C = F = 32) 0.355 TFLOP, 0.36 ms,
// where its 822 MB of x and y take 0.25 ms at 3.35 TB/s. Both probe shapes run
// the hopper variant (a cp.async ring feeding wgmma), whose per-tap rounding
// stays in registers: at a tap's end the accumulators are rounded and added to
// a running bf16x2 sum, with no shared-memory round trip. The stems (C <= 8,
// F a multiple of 16 up to 96) are bound by bytes and run the stem variant
// (conv3x3_stem.cuh: the input brick in shared memory once; bf16 on wgmma
// with A from registers, each tap rounded in registers; fp32 on the FP32
// pipe, each tap summed in fp32 and the three added in fp32). fp32 with C and
// F multiples of 32 runs the tf32x3 variant (each product as three TF32 ones
// on wgmma, each tap summed in fp32 every 32 channels, the three taps added in
// fp32); every other shape the simple variant, which stages each tap through
// shared memory. PERF.md keeps the measured times.

#include "conv3x3_igemm.cuh"
#include "conv3x3_stem.cuh"

// The simple variant; see conv3x3_igemm::launch for the arguments.
extern "C" int zslab_forward(const void* x, const void* w, void* y, int B, int X, int Y,
                             int Z, int C, int F, int p, int dtype, int vec_a, int vec_b,
                             void* stream) {
  return conv3x3_igemm::launch<true>(x, w, y, B, X, Y, Z, C, F, p, dtype, vec_a, vec_b, stream);
}

// The hopper variant (bf16, wt = the (F, 27*C) K-major weight); see
// conv3x3_igemm::hopper::launch for the arguments.
extern "C" int zslab_forward_hopper(const void* x, const void* wt, void* y, int B, int X, int Y,
                                    int Z, int C, int F, int p, int bk, int bn, void* stream) {
  return conv3x3_igemm::hopper::launch<true>(x, wt, y, B, X, Y, Z, C, F, p, bk, bn, stream);
}

// The tf32x3 variant (fp32, wt = the (2, F, 27*C) hi and lo planes); see
// conv3x3_igemm::tf32x3::launch for the arguments.
extern "C" int zslab_forward_tf32x3(const void* x, const void* wt, void* y, int B, int X, int Y,
                                    int Z, int C, int F, int p, int bn, void* stream) {
  return conv3x3_igemm::tf32x3::launch<true>(x, wt, y, B, X, Y, Z, C, F, p, bn, stream);
}

// The stem variant (1 <= C <= 8, w = the (F, 3 * KT) weight of pack_weight
// "stem"; dtype 0 = float32 on the FP32 pipe, 1 = bfloat16 on wgmma, as the
// simple variant's entry takes it); see conv3x3_stem::launch for the arguments.
extern "C" int zslab_forward_stem(const void* x, const void* w, void* y, int B, int X, int Y,
                                  int Z, int C, int F, int p, int dtype, void* stream) {
  return conv3x3_stem::launch<true>(x, w, y, B, X, Y, Z, C, F, p, dtype, stream);
}
