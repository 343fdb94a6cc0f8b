// The stem variant of the stride-1 3x3x3 convolution for Hopper (sm_90a):
// NDHWC x DHWIO with few input channels, in bf16 or fp32, shared by
// csrc/conv3x3.cu (one rounding) and csrc/zslab_conv.cu (each first-axis tap
// rounded to the output type).
//
// Domain: bf16 or fp32, 1 <= C <= 8, F a multiple of 16 up to 96, padding P
// in {0, 1, 2} (output voxel o reads input voxels o + t - P), any extents.
// That is every network's first conv on the paths: C = 1 (CT; STUNet,
// PlainConvUNet), 3 (the cascade: the image and a 2-label one-hot), 4 (BraTS)
// -> F = 32, and STUNet-H's 1 -> 96. ops/conv3x3.py `conv_variant` sends
// these here; `launch` picks the kernel by dtype.
//
// Function: y = the 27*C-term sum in fp32, rounded once to the output type
// (PER_TAP = false, kernel #1), or per first-axis tap dx the 9*C-term sum in
// fp32, rounded to the output type, the three added in that type in the order
// 0, +1, +2 (PER_TAP = true, kernel #2, the rounding of the TPU kernel
// anatomask_tpu/ops/pallas_zslab_conv.py `_fwd_impl`; in fp32 the rounding of
// a tap changes nothing and the three are added in fp32).
//
// Bound on the H100: bytes. At C = 4 -> 32 the conv does 2*27*4*32 FLOP per
// 72 bytes of output and input (96 FLOP/byte, under the card's ~295), and at
// C = 1 a third of that: writing the output is the floor (at B = 8, 128^3, C
// = 4: 1.07 GB out, 0.13 GB in, 0.36 ms at 3.35 TB/s). The shared implicit
// GEMM (conv3x3_igemm.cuh's simple variant) gathers every input element again
// for each K step and F tile, with a division pair an element, and so runs at
// a few percent of that bound. In fp32 the products run on the FP32 pipe (67
// TFLOP/s), exact, with no TF32 split: at C = 1 their time is below the
// bytes' (B = 4, 112x112x128, 1 -> 32: 0.166 against 0.253 ms), from C = 2 on
// above it (C = 4 at B = 8, 128^3: 1.73 against 0.72 ms), where three TF32
// products a term on wgmma would be the faster form. This design reads the
// input once into shared memory, keeps the weight there for the whole
// kernel, and writes each output byte once:
//
// - A block owns a brick of 4 x 8 x 16 output voxels (32 z-lines of 16
//   voxels, z fastest) for all F channels: one warpgroup a 32-channel slice
//   of F. Blocks are persistent: a grid of (blocks resident per SM) x SMs
//   walks the bricks. The brick's input window, 6 x 10 lines of 18 voxels,
//   is loaded into shared memory once, zero outside the volume, with no
//   padded copy in device memory.
// - bf16: the window is kept as 32-bit words of two bf16, so that a pair of
//   consecutive elements of a line is one aligned shared load: for even C
//   the line's pairs (plane 0); for odd C also the line one element on
//   (plane 1), since rows of odd parity start at odd elements.
// - Where x's pairs are aligned words (even C; odd C with Z even, where every
//   line of the volume starts at an element of one parity), the window is
//   copied with cp.async (4- or 8-byte copies, zero-filled outside the
//   volume) into one of two stages while the block multiplies the other
//   brick: the loads' latency hides behind the products. For odd C the
//   aligned words are one plane and the other is derived from them in shared
//   memory (a funnel shift a word). Elsewhere (odd C, odd Z) the threads
//   load each brick.
// - Per first-axis tap dx the K of the product runs over (dy, dz, c): the 3*C
//   elements (dz, c) of a line are contiguous in the window, so K = 3 rows of
//   R = 3*C (rounded up to even; the extra odd element has a zero weight)
//   zero-padded to KT, a multiple of 16 (16, 32, 48 at C = 1, 3, 4). The
//   weight is packed K-major by ops/conv3x3.py `pack_weight(w, "stem")`:
//   (F, 3 * KT), column dx * KT + dy * R + dz * C + c.
// - Products on the tensor cores with wgmma.m64n32k16 (bf16 -> fp32), A from
//   registers, B from shared memory: a warpgroup multiplies 4 z-lines (64
//   rows, a warp's 16 rows one z-line) by its slice at a time. Each warp
//   builds its A fragments from the window, one 32-bit load a row pair and k
//   pair at an offset fixed per thread (no division in the loop); the weight
//   sits in shared memory as (tap, k16) tiles of 32 n-rows x 32 bytes in
//   wgmma's 32-byte-swizzled K-major layout. The next tap's fragments are
//   loaded while the current tap's products run.
// - PER_TAP rounds a tap's accumulators in registers into a running bf16x2
//   sum (one packed convert and one packed bf16 add a pair: the add rounds
//   the exact sum once, which for two bf16 equals the fp32 add then rounded);
//   otherwise the fp32 sum runs through the three taps.
// - The epilogue stages a warp's 16 x 32 tile in shared memory and writes it
//   in 16-byte stores, each voxel's slice of F * 2 bytes once.
// - fp32 (namespace f32): the same bricks and persistent blocks, the window
//   copied with 4-byte cp.async (always aligned) into two stages, each line's
//   channel c as 4 runs of its z residues mod 4, so that a warp's 32 window
//   loads hit 32 banks. A warp takes items of the brick (an x-plane of 8
//   z-lines by 16, for 8 of the F channels): each lane 4 consecutive z
//   voxels of one line. Per (dx, dy, c) it loads the 6 window elements its
//   voxels' three z-taps read and, per z-tap, the 8 weights as two 16-byte
//   broadcasts (the weight in shared memory as (F / 8, 27 * C, 8)), then
//   runs 96 FMA. PER_TAP sums each first-axis tap in fresh registers and
//   adds it to the running fp32 sum. The epilogue stages a voxel's 32 lanes
//   x 32 bytes in shared memory, so that each 16-byte store is half of a
//   voxel's 32-byte piece beside its other half.
//
// A non-finite input element can reach the output one voxel further along z
// than the conv's window in bf16: the padding slot of a dy row (odd C)
// multiplies the next element by a zero weight.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "conv3x3_igemm.cuh"

namespace conv3x3_stem {

using conv3x3_igemm::hopper::cp_async_commit;
using conv3x3_igemm::hopper::cp_async_wait;
using conv3x3_igemm::hopper::fence_operand;
using conv3x3_igemm::hopper::fence_proxy_async;
using conv3x3_igemm::hopper::pack_bf16x2;
using conv3x3_igemm::hopper::smem_u32;
using conv3x3_igemm::hopper::wgmma_commit;
using conv3x3_igemm::hopper::wgmma_fence;
using conv3x3_igemm::hopper::wgmma_wait;

constexpr int TX = 4, TY = 8, TZ = 16;                // output voxels of a brick
constexpr int LX = TX + 2, LY = TY + 2, LZ = TZ + 2;  // its input window
constexpr int LINES = LX * LY;
constexpr int NS = 32;            // output channels of a warpgroup's slice (wgmma n32)
constexpr int WG = 128;           // threads of a warpgroup
constexpr int MAX_C = 8;
constexpr int MAX_F = 96;         // at most 3 slices, 384 threads
constexpr int B_TILE = NS * 32;   // bytes of one (tap, k16) weight tile
constexpr int STAGE_LD = NS / 2 + 4;  // words a row of the staging tile (no bank conflict on writes)

// the channel counts the launcher instantiates; ops/conv3x3.py STEM_MAX_C
#define CONV3X3_STEM_CHANNELS(C_) C_(1) C_(2) C_(3) C_(4) C_(5) C_(6) C_(7) C_(8)

template <int C>
struct Geo {
  static constexpr bool ODD = C % 2 == 1;
  static constexpr int R = 3 * C + (ODD ? 1 : 0);  // k of one dy row, (dz, c), even
  static constexpr int KREAL = 3 * R;
  static constexpr int KC = (KREAL + 15) / 16;     // k16 steps of a tap
  static constexpr int KT = KC * 16;               // a tap's columns in the packed weight
  static constexpr int LE = LZ * C;                // bf16 elements of the window's line
  static constexpr int INNER = (LE + 7) / 8 * 8;   // elements of a line in shared memory
  static constexpr int LINE_W = INNER / 2;         // its 32-bit words
  static constexpr int PLANES = ODD ? 2 : 1;       // odd C: the lines again, one element on
  static constexpr int PLANE_W = (LINES * LINE_W + 3) / 4 * 4;  // words a plane, 16-byte aligned
  static constexpr int STAGE_W = PLANES * PLANE_W;
  // odd C, copied: the lines as aligned words, one more a line
  static constexpr int COPY_W = (LINES * (LINE_W + 1) + 3) / 4 * 4;
  // words of the bricks: threads load one stage; copies fill two (odd C: two
  // of the aligned words and the plane derived from them)
  __host__ __device__ static constexpr int words(bool copied) {
    return !copied ? STAGE_W : ODD ? 2 * COPY_W + PLANE_W : 2 * PLANE_W;
  }
};

// descriptor of a K-major tile of 32-byte rows, 32-byte swizzle: start
// address >> 4, leading byte offset 1 (unused), stride byte offset = 8 rows
__device__ __forceinline__ uint64_t make_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) | ((uint64_t)(256 >> 4) << 32) |
         ((uint64_t)3 << 62);
}

// D (64 x 32, fp32 in registers) = A (64 x 16, bf16 in registers, a warp's 16
// rows as mma.m16n8k16's A fragment) * B (16 x 32, bf16 K-major in shared
// memory) + (scale_d ? D : 0)
__device__ __forceinline__ void wgmma_rs(float (&d)[16], const uint32_t (&a)[4], uint64_t b,
                                         int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

// keeps A fragments alive (unmoved, unreused) until the wgmma reading them retires
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

__device__ __forceinline__ uint32_t add_bf16x2(uint32_t a, uint32_t b) {
  const __nv_bfloat162 s = __hadd2(*reinterpret_cast<const __nv_bfloat162*>(&a),
                                   *reinterpret_cast<const __nv_bfloat162*>(&b));
  return *reinterpret_cast<const uint32_t*>(&s);
}

struct Shape {
  int B, X, Y, Z, F, P;   // batch, input extents, output channels, padding
  int Xo, Yo, Zo;         // output extents
  int nbx, nby, nbz;      // bricks along each axis
  int nbricks;
  int async;              // the bricks copied by cp.async into two stages (else the threads load one)
};

// 4- and 8-byte asynchronous copies to shared memory; the bytes past src_bytes are zero-filled
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async8(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes)
               : "memory");
}

// bytes of dynamic shared memory: 1024 to align the weight tiles, the tiles,
// the bricks, a staging tile a warp
template <int C>
constexpr int smem_bytes(int slices, bool copied) {
  return 1024 + slices * 3 * Geo<C>::KC * B_TILE + Geo<C>::words(copied) * 4 +
         slices * 4 * TZ * STAGE_LD * 4;
}

// x: (B, X, Y, Z, C) bf16; w: (F, 3 * KT) bf16 (pack_weight "stem"), 16-byte
// aligned; y: (B, Xo, Yo, Zo, F) bf16, 16-byte aligned. Block: one
// warpgroup a 32-channel slice of F.
template <int C, bool PER_TAP>
__global__ void __launch_bounds__(WG * (MAX_F / NS))
stem_kernel(const uint16_t* __restrict__ x, const uint4* __restrict__ w,
            __nv_bfloat16* __restrict__ y, Shape s) {
  using G = Geo<C>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t tiles = (raw + 1023u) & ~1023u;  // the weight tiles, 1024-aligned
  const int slices = (s.F + NS - 1) / NS;
  uint8_t* const btile = smem_raw + (tiles - raw);
  uint32_t* const bricks = reinterpret_cast<uint32_t*>(btile + slices * 3 * G::KC * B_TILE);
  uint32_t* const brick_w = bricks;  // the threads' brick (one stage)
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;  // the fragment's row group and column pair
  const int wgi = warp / 4, wq = warp % 4;  // this warpgroup's slice, this warp's place in it
  const int n0 = wgi * NS;
  uint32_t* const stage = bricks + G::words(s.async) + warp * (TZ * STAGE_LD);

  // the weight, once: tile (slice, dx, kc) holds rows n of the slice, columns
  // dx * KT + kc * 16 + 0..15, each row two 16-byte chunks, swizzled
  const int row16 = 3 * G::KT / 8;  // 16-byte chunks of a packed weight row
  for (int i = tid; i < slices * 3 * G::KC * NS * 2; i += blockDim.x) {
    const int c = i & 1, n = (i >> 1) % NS, tile = i / (2 * NS);
    const int sl = tile / (3 * G::KC), tk = tile % (3 * G::KC);  // tk = dx * KC + kc
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (sl * NS + n < s.F) v = w[(long long)(sl * NS + n) * row16 + tk * 2 + c];
    const uint32_t off = n * 32 + c * 16;
    *reinterpret_cast<uint4*>(btile + tile * B_TILE + (off ^ (((off >> 7) & 1u) << 4))) = v;
  }
  fence_proxy_async();  // visible to wgmma after the barrier below
  __syncthreads();
  const uint64_t desc0 = make_desc(tiles + wgi * 3 * G::KC * B_TILE);

  // A fragments: rows g and g + 8 start at elements g * C and (g + 8) * C of a
  // line, of one parity `par`, so a k pair (j, j + 1), j even, is one word
  // of the plane holding the pairs from parity par on: plane par where the
  // threads load the brick or C is even; for odd C copied, the aligned words
  // (par == q, the parity of the lines' first element in x: a line of
  // LINE_W + 1 words, the pairs from word q on) or the plane derived from
  // them (par != q). aoff: the word offset of the k pair (kc * 16 + 2t + 8h,
  // +1) within a line and its dy neighbours, or -1 past the tap's real K
  const int par = G::ODD ? (g & 1) : 0;
  // odd C copied (Z even): every line's first element, (oz0 - P) * C on from
  // an even offset, has the parity of P
  const int q = s.P & 1;
  const bool aligned_words = G::ODD && s.async && par == q;
  const int stride = aligned_words ? G::LINE_W + 1 : G::LINE_W;  // words from a line to the next
  int aoff[G::KC][2];
#pragma unroll
  for (int kc = 0; kc < G::KC; ++kc)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int k = kc * 16 + 2 * t + 8 * h;
      aoff[kc][h] = k < G::KREAL ? (k / G::R) * stride + (k % G::R) / 2 + (aligned_words ? q : 0)
                                 : -1;
    }
  const int row_lo = (g * C - par) / 2, row_hi = ((g + 8) * C - par) / 2;
  // this thread's plane of the brick in stage st
  auto plane_of = [&](int st) -> const uint32_t* {
    if (!s.async) return bricks + par * G::PLANE_W;
    if (!G::ODD) return bricks + st * G::PLANE_W;
    return aligned_words ? bricks + st * G::COPY_W : bricks + 2 * G::COPY_W;
  };

  int bb = 0, ox0 = 0, oy0 = 0, oz0 = 0;  // a brick: sample, output origin
  auto decode = [&](int id) {
    oz0 = (id % s.nbz) * TZ; id /= s.nbz;
    oy0 = (id % s.nby) * TY; id /= s.nby;
    ox0 = (id % s.nbx) * TX; bb = id / s.nbx;
  };
  // the offset in x of element e of line `line` of the brick's window, or -1
  // where it lies outside the volume or past the window
  auto offset = [&](int line, int e) -> long long {
    const int xi = ox0 + line / LY - s.P, yi = oy0 + line % LY - s.P;
    const int zi = oz0 - s.P + e / C, c = e % C;
    if (line >= LINES || e >= G::LE || (unsigned)xi >= (unsigned)s.X ||
        (unsigned)yi >= (unsigned)s.Y || (unsigned)zi >= (unsigned)s.Z)
      return -1;
    return (((long long)bb * s.X + xi) * s.Y + yi) * (long long)s.Z * C + (long long)zi * C + c;
  };
  // the brick's element e of line `line` of the window, by a thread's load
  auto element = [&](int line, int e) -> uint32_t {
    const long long o = offset(line, e);
    return o >= 0 ? (uint32_t)x[o] : 0u;
  };
  // copied bricks. Even C: words i .. i + VW - 1 of the plane are the
  // aligned elements from offset(i / LINE_W, 2 * (i % LINE_W)) on (VW = 2
  // where C % 4 == 0: a copy does not cross a voxel). Odd C: word m of a line
  // holds its elements 2m - q and 2m + 1 - q, at an even offset in x; the
  // elements outside the volume along z are not read (zero-filled): e_lo has
  // the parity of 2m - q, so only a word at the far end is cut, to its first
  // element
  constexpr int VW = C % 4 == 0 ? 2 : 1;
  auto fill_async = [&](uint32_t dst) {
    if constexpr (!G::ODD) {
      for (int i = tid * VW; i < G::PLANE_W; i += blockDim.x * VW) {
        const long long o = offset(i / G::LINE_W, 2 * (i % G::LINE_W));
        if constexpr (VW == 2)
          cp_async8(dst + 4 * i, o >= 0 ? x + o : x, o >= 0 ? 8 : 0);
        else
          cp_async4(dst + 4 * i, o >= 0 ? x + o : x, o >= 0 ? 4 : 0);
      }
    } else {
      // the line's elements inside the volume along z: [e_lo, e_hi)
      const int e_lo = (s.P - oz0) * C, e_hi = (s.Z - oz0 + s.P) * C;
      for (int i = tid; i < LINES * (G::LINE_W + 1); i += blockDim.x) {
        const int line = i / (G::LINE_W + 1), e0 = 2 * (i % (G::LINE_W + 1)) - q;
        const int xi = ox0 + line / LY - s.P, yi = oy0 + line % LY - s.P;
        const int n = (unsigned)xi < (unsigned)s.X && (unsigned)yi < (unsigned)s.Y &&
                              e0 >= e_lo && e0 < e_hi
                          ? min(2, e_hi - e0)
                          : 0;
        const long long o = (((long long)bb * s.X + xi) * s.Y + yi) * (long long)s.Z * C +
                            (long long)(oz0 - s.P) * C + e0;
        cp_async4(dst + 4 * i, n > 0 ? x + o : x, 2 * n);
      }
    }
  };

  int k = 0;  // bricks done
  if (s.async && (int)blockIdx.x < s.nbricks) {
    decode(blockIdx.x);
    fill_async(smem_u32(bricks));
  }
  cp_async_commit();
#pragma unroll 1
  for (int id = blockIdx.x; id < s.nbricks; id += gridDim.x, ++k) {
    const int st = s.async ? k & 1 : 0;
    if (s.async) {
      // the next brick into the other stage, which every warp left at the
      // barrier closing the previous brick; then this brick's copies
      if (id + (int)gridDim.x < s.nbricks) {
        decode(id + gridDim.x);
        fill_async(smem_u32(bricks + (st ^ 1) * (G::ODD ? G::COPY_W : G::PLANE_W)));
      }
      cp_async_commit();
      cp_async_wait<1>();
      decode(id);
      if constexpr (G::ODD) {
        // the other plane: pair i of a line from words i and i + 1
        __syncthreads();
        const uint32_t* words = bricks + st * G::COPY_W;
        uint32_t* const derived = bricks + 2 * G::COPY_W;
#pragma unroll 1
        for (int i = tid; i < LINES * G::LINE_W; i += blockDim.x) {
          const uint32_t* w2 = words + i + i / G::LINE_W;
          derived[i] = __funnelshift_r(w2[0], w2[1], 16);
        }
      }
    } else {
      // the threads load the brick; the barrier closing the previous brick
      // keeps its readers from seeing this one
      decode(id);
#pragma unroll 1
      for (int i = tid; i < G::STAGE_W; i += blockDim.x) {
        const int pl = i / G::PLANE_W, r = i % G::PLANE_W;
        const int line = r / G::LINE_W, e = 2 * (r % G::LINE_W) + pl;
        brick_w[i] = line < LINES ? element(line, e) | (element(line, e + 1) << 16) : 0u;
      }
    }
    __syncthreads();
    const uint32_t* const plane = plane_of(st);

    // a warpgroup step: 4 z-lines, this warp's zl = 4 * step + wq at (lx,
    // ly); the control flow is uniform over the warpgroup (wgmma), ragged
    // z-lines are computed and not stored
#pragma unroll 1
    for (int step = 0; step < TX * TY / 4; ++step) {
      const int lx = (4 * step + wq) / TY, ly = (4 * step + wq) % TY;
      auto load_a = [&](uint32_t (&a)[G::KC][4], int dx) {
        const uint32_t* line = plane + ((lx + dx) * LY + ly) * stride;
#pragma unroll
        for (int kc = 0; kc < G::KC; ++kc) {
          const int o0 = aoff[kc][0], o1 = aoff[kc][1];
          a[kc][0] = o0 >= 0 ? line[row_lo + o0] : 0u;  // row g,     k 2t, 2t + 1
          a[kc][1] = o0 >= 0 ? line[row_hi + o0] : 0u;  // row g + 8, k 2t, 2t + 1
          a[kc][2] = o1 >= 0 ? line[row_lo + o1] : 0u;  // row g,     k 2t + 8, 2t + 9
          a[kc][3] = o1 >= 0 ? line[row_hi + o1] : 0u;  // row g + 8, k 2t + 8, 2t + 9
        }
      };
      auto mma_tap = [&](float (&d)[16], uint32_t (&a)[G::KC][4], int dx, bool first) {
#pragma unroll
        for (int kc = 0; kc < G::KC; ++kc)
          wgmma_rs(d, a[kc], desc0 + (uint64_t)((dx * G::KC + kc) * (B_TILE >> 4)),
                   kc > 0 || !first);
      };
      float acc[16];
      uint32_t run[8];  // PER_TAP: the running bf16x2 sum, pair p = (row g + 8 (p % 2), 8 (p / 2) + 2t)
      uint32_t a0[G::KC][4], a1[G::KC][4];
      auto add_tap = [&](bool first) {  // a tap's retired sum, rounded, into `run`
#pragma unroll
        for (int p = 0; p < 8; ++p) {
          const uint32_t v = pack_bf16x2(acc[2 * p], acc[2 * p + 1]);
          run[p] = first ? v : add_bf16x2(run[p], v);
        }
      };
#pragma unroll
      for (int i = 0; i < 16; ++i) acc[i] = 0.f;
      load_a(a0, 0);
      fence_operand(acc);
      wgmma_fence();
      mma_tap(acc, a0, 0, true);
      wgmma_commit();
      load_a(a1, 1);  // under tap 0's products
      if constexpr (PER_TAP) {
        wgmma_wait<0>();
        fence_operand(acc);
        fence_regs(a0);
        add_tap(true);
        wgmma_fence();
        mma_tap(acc, a1, 1, true);
        wgmma_commit();
        load_a(a0, 2);  // tap 0 retired: a0 is free
        wgmma_wait<0>();
        fence_operand(acc);
        fence_regs(a1);
        add_tap(false);
        wgmma_fence();
        mma_tap(acc, a0, 2, true);
        wgmma_commit();
        wgmma_wait<0>();
        fence_operand(acc);
        fence_regs(a0);
        add_tap(false);
      } else {
        wgmma_fence();
        mma_tap(acc, a1, 1, false);
        wgmma_commit();
        wgmma_wait<1>();  // tap 0 retired: a0 is free
        fence_regs(a0);
        load_a(a0, 2);
        wgmma_fence();
        mma_tap(acc, a0, 2, false);
        wgmma_commit();
        wgmma_wait<0>();
        fence_operand(acc);
        fence_regs(a0);
        fence_regs(a1);
      }

      // pair p: row g + 8 (p % 2), channels n0 + 8 (p / 2) + 2t, +1
#pragma unroll
      for (int p = 0; p < 8; ++p) {
        uint32_t v;
        if constexpr (PER_TAP) v = run[p];
        else v = pack_bf16x2(acc[2 * p], acc[2 * p + 1]);
        stage[(g + 8 * (p % 2)) * STAGE_LD + (p / 2) * 4 + t] = v;
      }
      __syncwarp();
      const int ox = ox0 + lx, oy = oy0 + ly;
      if (ox < s.Xo && oy < s.Yo) {
        const long long vox = ((long long)bb * s.Xo + ox) * s.Yo + oy;
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int q = lane + 32 * i, row = q / 4, part = q % 4;
          const int oz = oz0 + row, n = n0 + part * 8;
          if (oz < s.Zo && n < s.F) {
            const uint4 v = *reinterpret_cast<const uint4*>(stage + row * STAGE_LD + part * 4);
            *reinterpret_cast<uint4*>(y + (vox * s.Zo + oz) * s.F + n) = v;
          }
        }
      }
      __syncwarp();  // the staging tile is rewritten by the next step
    }
    __syncthreads();  // every warp is done with this brick's stage
  }
}

template <int C, bool PER_TAP>
int launch_c(const void* x, const void* w, void* y, Shape s, cudaStream_t stream) {
  auto kernel = stem_kernel<C, PER_TAP>;
  const int slices = (s.F + NS - 1) / NS;
  const int threads = WG * slices;
  // the bricks are copied asynchronously where x's pairs of elements are
  // aligned words: even C, or odd C with every line starting at one parity
  // (Z even); otherwise the threads load them
  const uintptr_t align = reinterpret_cast<uintptr_t>(x) & (C % 4 == 0 ? 7 : 3);
  s.async = align == 0 && (C % 2 == 0 || s.Z % 2 == 0);
  const int smem = smem_bytes<C>(slices, s.async);
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         smem_bytes<C>(MAX_F / NS, true));
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorLaunchOutOfResources;
  const long long grid = s.nbricks < (long long)per_sm * sms ? s.nbricks : (long long)per_sm * sms;
  kernel<<<(unsigned)grid, threads, smem, stream>>>(static_cast<const uint16_t*>(x),
                                                    static_cast<const uint4*>(w),
                                                    static_cast<__nv_bfloat16*>(y), s);
  return (int)cudaGetLastError();
}

// The fp32 stem: the same bricks, the products on the FP32 pipe. A thread
// owns VZ consecutive z voxels of a z-line for FG output channels, and all
// 32 lanes of a warp share the channels: a weight is one broadcast read of
// shared memory that serves VZ voxels, and a window element loaded into a
// register serves its three z-taps.
namespace f32 {

constexpr int VZ = 4;                // z voxels a thread
constexpr int FG = 8;                // output channels a thread
constexpr int THREADS = 128;         // 4 warps walk the brick's (x-plane, channel group) items
constexpr int SUB = (LZ + 3) / 4;    // window elements of a line at one z residue mod 4
constexpr int PLANE = 4 * SUB;       // floats of one channel of a line

template <int C>
struct Geo {
  // a line's floats: channel c's elements z at c * PLANE + (z % 4) * SUB + z
  // / 4, so that the 32 lanes of a warp (8 lines by 4 z-groups of VZ) read 32
  // banks: the line stride is 4 times an odd number
  static constexpr int LS = PLANE * C + (C % 2 == 0 ? 4 : 0);
  static constexpr int WIN = LINES * LS;  // floats of a brick's window, a multiple of 4
};

// bytes of dynamic shared memory: the weight, two bricks, a staging tile a warp
template <int C>
constexpr int smem_bytes(int F) {
  return (27 * C * F + 2 * Geo<C>::WIN + (THREADS / 32) * 32 * FG) * 4;
}

// x: (B, X, Y, Z, C) fp32; w: (F, 3 * KT) fp32 (pack_weight "stem"); y: (B,
// Xo, Yo, Zo, F) fp32, 16-byte aligned
template <int C, bool PER_TAP>
__global__ void __launch_bounds__(THREADS, 4)
stem_fp32_kernel(const float* __restrict__ x, const float* __restrict__ w,
                 float* __restrict__ y, Shape s) {
  using G = Geo<C>;
  extern __shared__ float4 smem_f4[];
  float* const ws = reinterpret_cast<float*>(smem_f4);  // (F / FG, 27 * C, FG)
  float* const win = ws + 27 * C * s.F;                  // two stages of G::WIN
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  float* const stage = win + 2 * G::WIN + warp * 32 * FG;
  const int groups = s.F / FG;

  // the weight, once, from the packed (F, 3 * KT) rows: column dx * KT + dy *
  // R + dz * C + c of row f to ws[f / FG][(dx, dy, dz, c)][f % FG]
  constexpr int R = 3 * C + C % 2, KT = (3 * R + 15) / 16 * 16;
  for (int i = tid; i < s.F * 3 * KT; i += blockDim.x) {
    const int f = i / (3 * KT), col = i % (3 * KT), dx = col / KT, r = col % KT;
    const int dy = r / R, e = r % R;
    if (r < 3 * R && e < 3 * C)
      ws[((f / FG) * 27 * C + (dx * 3 + dy) * 3 * C + e) * FG + f % FG] = w[i];
  }

  int bb = 0, ox0 = 0, oy0 = 0, oz0 = 0;  // a brick: sample, output origin
  auto decode = [&](int id) {
    oz0 = (id % s.nbz) * TZ; id /= s.nbz;
    oy0 = (id % s.nby) * TY; id /= s.nby;
    ox0 = (id % s.nbx) * TX; bb = id / s.nbx;
  };
  // the brick's window into `dst` by 4-byte copies, zero outside the volume
  auto fill = [&](float* dst) {
    const uint32_t base = smem_u32(dst);
    for (int i = tid; i < LINES * LZ * C; i += blockDim.x) {
      const int line = i / (LZ * C), e = i % (LZ * C), zl = e / C, c = e % C;
      const int xi = ox0 + line / LY - s.P, yi = oy0 + line % LY - s.P, zi = oz0 + zl - s.P;
      const bool in = (unsigned)xi < (unsigned)s.X && (unsigned)yi < (unsigned)s.Y &&
                      (unsigned)zi < (unsigned)s.Z;
      const long long o = ((((long long)bb * s.X + xi) * s.Y + yi) * s.Z + zi) * C + c;
      cp_async4(base + 4 * (line * G::LS + c * PLANE + (zl % 4) * SUB + zl / 4), in ? x + o : x,
                in ? 4 : 0);
    }
  };

  // this lane's z-line (ly) and z-group (zg) of an item's 8 x 16 voxels
  const int ly = lane / 4, zg = lane % 4;
  int k = 0;  // bricks done
  if ((int)blockIdx.x < s.nbricks) {
    decode(blockIdx.x);
    fill(win);
  }
  cp_async_commit();
#pragma unroll 1
  for (int id = blockIdx.x; id < s.nbricks; id += gridDim.x, ++k) {
    const int st = k & 1;
    // the next brick into the other stage, which every warp left at the
    // barrier closing the previous brick; then this brick's copies
    if (id + (int)gridDim.x < s.nbricks) {
      decode(id + gridDim.x);
      fill(win + (st ^ 1) * G::WIN);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    decode(id);
    const float* const plane = win + st * G::WIN;

    // an item: x-plane lx of the brick, channels fg * FG.. of F
#pragma unroll 1
    for (int it = warp; it < TX * groups; it += THREADS / 32) {
      const int lx = it / groups, fg = it % groups;
      const float* const wg = ws + fg * 27 * C * FG;
      float acc[VZ][FG], run[PER_TAP ? VZ : 1][FG];
#pragma unroll
      for (int v = 0; v < VZ; ++v)
#pragma unroll
        for (int f = 0; f < FG; ++f) acc[v][f] = 0.f;
#pragma unroll 1
      for (int dx = 0; dx < 3; ++dx) {
        const float* const line = plane + ((lx + dx) * LY + ly) * G::LS + zg;
        const float* const wx = wg + dx * 9 * C * FG;
#pragma unroll
        for (int dy = 0; dy < 3; ++dy)
#pragma unroll
          for (int c = 0; c < C; ++c) {
            float a[VZ + 2];  // z = 4 zg + j of the line, j = 0 .. VZ + 1
#pragma unroll
            for (int j = 0; j < VZ + 2; ++j) a[j] = line[dy * G::LS + c * PLANE + (j % 4) * SUB + j / 4];
#pragma unroll
            for (int dz = 0; dz < 3; ++dz) {
              const float4* const wp =
                  reinterpret_cast<const float4*>(wx + ((dy * 3 + dz) * C + c) * FG);
              const float4 w0 = wp[0], w1 = wp[1];
              const float wv[FG] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
#pragma unroll
              for (int v = 0; v < VZ; ++v)
#pragma unroll
                for (int f = 0; f < FG; ++f) acc[v][f] = fmaf(a[v + dz], wv[f], acc[v][f]);
            }
          }
        if constexpr (PER_TAP) {  // the tap's fp32 sum into the running one, then a fresh tap
#pragma unroll
          for (int v = 0; v < VZ; ++v)
#pragma unroll
            for (int f = 0; f < FG; ++f) {
              run[v][f] = dx == 0 ? acc[v][f] : run[v][f] + acc[v][f];
              acc[v][f] = 0.f;
            }
        }
      }

      // voxel by voxel through the warp's staging tile: lane L's FG channels
      // at words L * FG (halves swapped where bit 2 of L is set: no bank
      // conflict either way), then read back so that lanes 2i, 2i + 1 store
      // voxel i's 32 bytes. Lane l stores for lanes L = l / 2 + 16 r, r = 0,
      // 1: voxel v of their z-groups, from `dst[r]` on
      const int h = lane & 1, ox = ox0 + lx;
      float* dst[2];
      int zr[2];  // the z-group's first voxel, or past Zo where the line is outside
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int L = lane / 2 + 16 * r, oy = oy0 + L / 4;
        zr[r] = ox < s.Xo && oy < s.Yo ? oz0 + (L % 4) * VZ : s.Zo;
        dst[r] = y + ((((long long)bb * s.Xo + ox) * s.Yo + oy) * s.Zo + zr[r]) * s.F +
                 fg * FG + h * 4;
      }
#pragma unroll
      for (int v = 0; v < VZ; ++v) {
        float o[FG];
#pragma unroll
        for (int f = 0; f < FG; ++f) {
          if constexpr (PER_TAP) o[f] = run[v][f];
          else o[f] = acc[v][f];
        }
        const int sw = (lane >> 2) & 1;
        reinterpret_cast<float4*>(stage + lane * FG)[sw] = make_float4(o[0], o[1], o[2], o[3]);
        reinterpret_cast<float4*>(stage + lane * FG)[sw ^ 1] = make_float4(o[4], o[5], o[6], o[7]);
        __syncwarp();
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int L = lane / 2 + 16 * r;
          const float4 val = reinterpret_cast<const float4*>(stage + L * FG)[h ^ ((L >> 2) & 1)];
          if (zr[r] + v < s.Zo) *reinterpret_cast<float4*>(dst[r] + v * s.F) = val;
        }
        __syncwarp();  // the staging tile is rewritten by the next voxel
      }
    }
    __syncthreads();  // every warp is done with this brick's stage
  }
}

template <int C, bool PER_TAP>
int launch_c(const void* x, const void* w, void* y, Shape s, cudaStream_t stream) {
  auto kernel = stem_fp32_kernel<C, PER_TAP>;
  const int smem = smem_bytes<C>(s.F);
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         smem_bytes<C>(MAX_F));
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS, smem);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorLaunchOutOfResources;
  const long long grid = s.nbricks < (long long)per_sm * sms ? s.nbricks : (long long)per_sm * sms;
  kernel<<<(unsigned)grid, THREADS, smem, stream>>>(static_cast<const float*>(x),
                                                     static_cast<const float*>(w),
                                                     static_cast<float*>(y), s);
  return (int)cudaGetLastError();
}

}  // namespace f32

// x: (B, X, Y, Z, C) contiguous; w: (F, 3 * KT), the weight as
// pack_weight(w, "stem") lays it out; y: (B, X + 2P - 2, Y + 2P - 2, Z + 2P -
// 2, F); all of `dtype` (0 = float32, 1 = bfloat16, as the simple variant's
// launcher); w and y 16-byte aligned. 1 <= C <= MAX_C, F a multiple of 16 up
// to MAX_F, P in {0, 1, 2}. Launches on `stream`; returns the CUDA error.
template <bool PER_TAP>
int launch(const void* x, const void* w, void* y, int B, int X, int Y, int Z, int C, int F,
           int P, int dtype, void* stream) {
  Shape s;
  s.B = B; s.X = X; s.Y = Y; s.Z = Z; s.F = F; s.P = P;
  s.Xo = X + 2 * P - 2; s.Yo = Y + 2 * P - 2; s.Zo = Z + 2 * P - 2;
  if (P < 0 || P > 2 || B <= 0 || s.Xo <= 0 || s.Yo <= 0 || s.Zo <= 0 || C < 1 || C > MAX_C ||
      F < 16 || F > MAX_F || F % 16 != 0 || (dtype != 0 && dtype != 1) ||
      ((reinterpret_cast<uintptr_t>(w) | reinterpret_cast<uintptr_t>(y)) & 15) != 0)
    return (int)cudaErrorInvalidValue;
  s.nbx = (s.Xo + TX - 1) / TX; s.nby = (s.Yo + TY - 1) / TY; s.nbz = (s.Zo + TZ - 1) / TZ;
  const long long nb = (long long)B * s.nbx * s.nby * s.nbz;
  if (nb > 0x7fffffffLL - 0x10000LL) return (int)cudaErrorInvalidValue;
  s.nbricks = (int)nb;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define CONV3X3_STEM_CASE(C_)                                              \
  if (C == C_) return dtype == 1 ? launch_c<C_, PER_TAP>(x, w, y, s, st) \
                                 : f32::launch_c<C_, PER_TAP>(x, w, y, s, st);
  CONV3X3_STEM_CHANNELS(CONV3X3_STEM_CASE)
#undef CONV3X3_STEM_CASE
  return (int)cudaErrorInvalidValue;
}

}  // namespace conv3x3_stem
