// Stride-1 "same" 3x3x3 convolution for Hopper (sm_90a), NDHWC x (27*C, F).
//
// Replaces the TPU kernel anatomask_tpu/ops/pallas_conv.py `_pallas_conv3d_chunk`
// (im2col tile times a 27C x F weight, fp32 accumulation, one rounding).
//
//   y[b, x, y, z, f] = sum_{dx, dy, dz, c} xpad[b, x+dx, y+dy, z+dz, c] * w[dx, dy, dz, c, f]
//
// The kernel is the implicit GEMM of conv3x3_igemm.cuh with PER_TAP = false:
// every one of the 27*C terms accumulates in fp32 and the result is rounded
// once to the output type, as the TPU kernel does.
//
// Bound on the H100: at the main-path shapes (C, F >= 32) the conv does 2*27*C
// FLOP per input byte or more, far above the card's ~295 FLOP/byte ridge, so the
// floor is the bf16 tensor-core rate (989 TFLOP/s), which only wgmma reaches,
// and in fp32 three TF32 products a term at 495 TFLOP/s. Every bf16 conv with
// C and F multiples of 32 runs the hopper variant of conv3x3_igemm.cuh (a
// cp.async ring feeding wgmma, 128 x BN tiles), every fp32 one its tf32x3
// variant (the same ring, each product as three TF32 ones, summed in fp32
// every 32 channels of K); the stems (C <= 8, F a multiple of 16 up to 96),
// bound by bytes, run the stem variant of conv3x3_stem.cuh (bf16 on wgmma,
// fp32 on the FP32 pipe); every other shape the simple variant. The measured
// gap is recorded in PERF.md.

#include "conv3x3_igemm.cuh"
#include "conv3x3_stem.cuh"

// The simple variant; see conv3x3_igemm::launch for the arguments.
extern "C" int conv3x3_forward(const void* x, const void* w, void* y, int B, int X, int Y,
                               int Z, int C, int F, int p, int dtype, int vec_a, int vec_b,
                               void* stream) {
  return conv3x3_igemm::launch<false>(x, w, y, B, X, Y, Z, C, F, p, dtype, vec_a, vec_b, stream);
}

// The hopper variant (bf16, wt = the (F, 27*C) K-major weight); see
// conv3x3_igemm::hopper::launch for the arguments.
extern "C" int conv3x3_forward_hopper(const void* x, const void* wt, void* y, int B, int X,
                                      int Y, int Z, int C, int F, int p, int bk, int bn,
                                      void* stream) {
  return conv3x3_igemm::hopper::launch<false>(x, wt, y, B, X, Y, Z, C, F, p, bk, bn, stream);
}

// The tf32x3 variant (fp32, wt = the (2, F, 27*C) hi and lo planes); see
// conv3x3_igemm::tf32x3::launch for the arguments.
extern "C" int conv3x3_forward_tf32x3(const void* x, const void* wt, void* y, int B, int X,
                                      int Y, int Z, int C, int F, int p, int bn, void* stream) {
  return conv3x3_igemm::tf32x3::launch<false>(x, wt, y, B, X, Y, Z, C, F, p, bn, stream);
}

// The stem variant (1 <= C <= 8, w = the (F, 3 * KT) weight of pack_weight
// "stem"; dtype 0 = float32 on the FP32 pipe, 1 = bfloat16 on wgmma, as the
// simple variant's entry takes it); see conv3x3_stem::launch for the arguments.
extern "C" int conv3x3_forward_stem(const void* x, const void* w, void* y, int B, int X, int Y,
                                    int Z, int C, int F, int p, int dtype, void* stream) {
  return conv3x3_stem::launch<false>(x, w, y, B, X, Y, Z, C, F, p, dtype, stream);
}
