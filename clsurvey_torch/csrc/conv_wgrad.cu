// Kernel C: the exact float32 weight gradient of a 2-D convolution, one
// implicit GEMM straight from the NHWC input and output cotangent.
//
//   dW[co, ci, r, s] = sum over (n, oh, ow) of
//       dy[n, oh, ow, co] * x[n, oh*st + r - p, ow*st + s - p, ci]
//
// Replaces no TPU kernel: XLA computes the JAX package's conv weight
// gradient. It was added because cuDNN's float32 weight-gradient engines on
// the H100 were far less exact than float32 (ops/conv.py), and the exact
// route that replaced them wrote each conv's input patches out as a
// (pixels, C_in k k) matrix for a cuBLAS GEMM: 2.8 GB written and read
// again a step of AlexNet at batch 200, plus a padded copy of the input.
// Here the patches never reach device memory: they are gathered into
// shared memory.
//
// Bound: FFMA. AlexNet's five convs do 262 GFLOP a step at batch 200, and
// VGG-16's twelve kernel-routed convs 6.10 TFLOP, against bytes of input
// and cotangent far below the card's 67 TFLOP/s over 3.35 TB/s; at the
// float32 peak the bounds are 3.9 ms and 91.1 ms. Exactness is float32's:
// every product and sum is a float32 FFMA (one rounding a multiply-add),
// and the partial sums are added in a fixed order; no tensor core, TF32 or
// 3xTF32 instruction.
//
// The GEMM: M = C_out (rows of dW), N = k k C_in (its columns, ordered
// (r, s, ci) here so that a run of C_in is contiguous in NHWC), K = output
// pixels of the rows (n, oh, ow). Both operands are K-major as they lie in
// memory: dy's row of a pixel holds C_out contiguous floats, and a patch
// row's columns of one tap hold C_in contiguous floats of x. So a stage's
// tiles go from global to shared memory as they are, with no transpose.
//
// Two designs, chosen by ops/conv.py:wgrad_design from what it observes
// (the channels, the pointers' alignment, C_out and a group's pixels):
//
// 1. Warp-specialised (`wgrad_ws_kernel`, route "ws"): every call whose x
//    and dy are copied 16 bytes at a time (C_in and C_out multiples of 4,
//    16-byte aligned), C_out a multiple of 128 and a group of at least
//    WGRAD_WS_MIN_PIXELS pixels. 384 threads a block, one block an SM, a
//    ring of 8 stages of 16 pixels in dynamic shared memory, each with a
//    *full* and an *empty* mbarrier:
//    - a producer warpgroup (setmaxnreg.dec to 40 registers) fills the
//      ring. dy's (16 x BM) box of a whole stage is one TMA load of a 2-D
//      tensor map. The patches of a whole stage, in the 128 x 192 tile,
//      are three TMA loads in im2col mode (16 pixels x 64 channels of one
//      tap each, zeros where a window leaves the image); in the 256 x 96
//      tile three warps gather them by cp.async, each thread one 16-byte
//      column quad of rows h, h + 4, ..., its tap (r, s, ci) decoded once
//      and its pixel advanced without a division. A slice's last, partial
//      stage goes by cp.async for both, rows past the slice zero-filled,
//      so no row of the next slice or sample is ever read. TMA's bytes and
//      the cp.asyncs (cp.async.mbarrier.arrive.noinc) complete onto the
//      stage's full barrier.
//    - two consumer warpgroups (setmaxnreg.inc to 232) do nothing but
//      shared loads and FFMAs: no loader state, no block-wide barrier in
//      the loop, a wait on the full barrier and an arrival on the empty
//      one a stage. Each thread holds a 16 x 12 register tile (4 x 4 quads
//      by 3 column quads; a warp's 128-bit loads of dy are 4- or 8-address
//      broadcasts and those of patches 64- or 128-byte rows), the 12
//      patch floats of a pixel loaded once and dy's 16 streamed four at a
//      time: 28 shared floats a thread for 192 FFMAs (0.146 a FFMA),
//      against 24 for 128 (0.1875) in design 2.
//    - a block owns 128 x 192 (C_out a multiple of 128) or 256 x 96 (of
//      256) of dW: four warps, a set, cover it, and the two sets take
//      every other stage, their sums added in set order at the end
//      through the ring's memory. A warp's column quads lie 64 (32)
//      apart, interleaved with its set's other warp's, so that each run
//      of them is one im2col box. The taller tile halves the patch bytes a
//      FFMA: with the patches gathered by cp.async the 128 x 192 tile held
//      kernel C near 68% of the FFMA peak (patches read from L1-resident
//      addresses: 74-75%); im2col brought it to 67-73%; the 256 x 96 tile
//      runs 70-76% (PERF.md §6). 192 and 96 columns divide k k C_in of
//      every 3x3 conv with C_in a multiple of 64, which 128 do not (576,
//      1728).
//    - Bound: FFMA. The consumer loop alone (no copies, no barriers) ran
//      76-78% of the FFMA peak on the H100 at 1980 MHz: its 1,536 FFMAs a
//      loop are 93% of its instructions; in its SASS each pixel's shared
//      loads come right before their first FFMAs, which a 232-register
//      thread of 192 accumulators has no room to load a pixel ahead (an
//      explicit prefetch gained 2 points there and lost 1 with the
//      copies). 8 pixels of the loop
//      are unrolled; a whole stage's (16) overflowed the instruction cache
//      (5-40% slower). ptxas (-Xptxas -v): 168 registers at entry, no
//      stack, no spills.
//    - What was tried and not kept (PERF.md §6): a guard that trapped
//      a wait of many seconds (a clock read in each wait loop spilled the
//      accumulators: 7-42% of the bound), the loop's order of i and j,
//      TMA for dy alone in the 128 x 192 tile, 4-12 stages, 32-pixel
//      stages, L1-bypassing copies (all within 2 points), im2col boxes of
//      16 or 32 columns for the 256 x 96 tile (3 points slower than
//      cp.async there) and of 32 for the 128 x 192 (2 points slower than
//      64), and a 64 x 192 tile for C_out 64 and 192 (four sets of two
//      warps: 51.3% against the first design's 61.6% at C_out 192,
//      59.5-59.9% against 57.9-58.9% at C_out 64, one reading a conv).
// 2. The first design (`wgrad_kernel`, routes "vec" and "scalar"): 128
//    threads a block, each an 8 x 8 (BM 64) or 16 x 8 (BM 128) register
//    tile over 64 or 128 rows by 128 columns, the loader's cp.async
//    address and bounds arithmetic in the same threads, stages of 16 or 8
//    pixels, 3 or 4 in flight, a __syncthreads a stage. It keeps the calls
//    the warp-specialised design does not take: a tensor whose channels
//    are not a multiple of 4, or not 16-byte aligned (C_in 3: AlexNet's
//    first conv, where a patch row's contiguous run is k * 3 floats, each
//    float copied alone with its own tap), C_out 64 and 192, and
//    per-sample groups of few pixels.
//
// Split over K (both designs): the output pixels of a group (all rows, or
// one sample's rows in the per-sample form) are cut into S slices of
// `chunk` pixels (a multiple of a stage); block (x, y, g * S + s) writes its
// tile's partial sum of slice s into a workspace of its own, and a second
// kernel sums each group's S partials in a fixed order into the group's
// dW. No atomics: two calls give the same bits. With one slice and no
// padded tile the blocks write dW itself, and there is no second kernel.
// The caller (ops/conv.py:wgrad_plan) picks the tile and S.
//
// dW is laid out (C_out, k, k, C_in): the port's channels_last weight's
// own layout, so the partials' rows are dW's rows and the gradient needs
// no copy into the weight's strides.

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

struct Shape {
  int H, W, C;      // input side and channels (NHWC)
  int OH, OW, M;    // output side, C_out
  int k, st, pad;   // kernel side, stride, padding
  int N;            // k * k * C
  int mpad, npad;   // the workspace's rows and columns: whole tiles
  int Kg;           // output pixels of a group
  int S, chunk;     // slices a group, output pixels a slice
  int im2col;       // 1: x's tensor map reads whole stages' patches
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes, or zeros where !ok (nothing read); L1 kept for the patches,
// which neighbouring taps read again
template <bool L1>
__device__ __forceinline__ void copy16(float* dst, const float* src,
                                       bool ok) {
  const int n = ok ? 16 : 0;
  if (L1)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(smem_addr(dst)), "l"(src), "r"(n));
  else
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(smem_addr(dst)), "l"(src), "r"(n));
}

__device__ __forceinline__ void copy4(float* dst, const float* src,
                                      bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(ok ? 4 : 0));
}

__device__ __forceinline__ void commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wait_groups() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// ---------------------------------------------------------------------------
// Design 1: warp-specialised
// ---------------------------------------------------------------------------

namespace wsd {

constexpr int kBK = 16;           // output pixels a stage
constexpr int kRing = 8;          // stages in the ring
constexpr int kProducers = 128;   // one warpgroup
constexpr int kConsumers = 256;   // two warpgroups
constexpr int kThreads = kProducers + kConsumers;
constexpr int kProducerRegs = 40, kConsumerRegs = 232;
constexpr int kPatchThreads = 96;  // producer warps 0-2; warp 3 copies dy
constexpr int kTM = 16, kTN = 12;  // a consumer thread's register tile

// A block's tile: BM rows of C_out by BN patch columns, 128 x 192 or
// 256 x 96. A warp's lanes lie LM along C_out by 32 / LM along the
// columns, so a warp covers 16 LM rows by 12 (32 / LM) columns, and four
// warps, a set, the tile; two sets take every other stage.
template <int BM> struct Tile {
  static constexpr int BN = BM == 128 ? 192 : 96;
  static constexpr int LM = BM == 128 ? 4 : 8, LN = 32 / LM;
  static constexpr int WM = BM / (16 * LM), WN = BN / (12 * LN);
  // A warp's column quads lie CS apart, interleaved with the other
  // warp's of its set, so that the lanes' run v of both is columns
  // [CS v, CS (v + 1)).
  static constexpr int CS = WN * 4 * LN;
  // The patch tile in shared memory. BOXED (the 128 x 192 tile): BOXES
  // boxes of (16 pixels x CPP columns), run v in box v, as TMA's im2col
  // mode lays them; else (16 pixels x BN columns), for cp.async (im2col
  // ran slower there: PERF.md §6). A pixel's columns lie KK apart, a
  // column c at col(c).
  static constexpr bool BOXED = BM == 128;
  static constexpr int CPP = CS, BOXES = BN / CPP;
  static constexpr int KK = BOXED ? CPP : BN;
  static __device__ __forceinline__ int col(int c) {
    return BOXED ? c / CPP * kBK * CPP + c % CPP : c;
  }
  static constexpr int SET_WARPS = WM * WN;
  static constexpr int SETS = kConsumers / 32 / SET_WARPS;
  static constexpr int STAGE = kBK * (BM + BN);  // floats: dy, patches
  static constexpr int RING_BYTES = kRing * STAGE * 4;
  static constexpr int SMEM = RING_BYTES + 2 * kRing * 8;  // + mbarriers
  static_assert(SET_WARPS == 4 && SETS == 2, "two sets of four warps");
  static_assert((SETS - 1) * BM * BN * 4 <= RING_BYTES,
                "the second set's sums fit in the ring");
};

__device__ __forceinline__ void bar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(count) : "memory");
}

// until the phase of `parity` has completed
__device__ __forceinline__ void bar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(smem_addr(bar)), "r"(parity) : "memory");
  } while (!done);
}

__device__ __forceinline__ void bar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(smem_addr(bar)) : "memory");
}

// one arrival on `bar` once this thread's cp.asyncs so far have landed
__device__ __forceinline__ void bar_arrive_copies(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n"
               :: "r"(smem_addr(bar)) : "memory");
}

// one arrival on `bar` that also expects `bytes` more of async copies
__device__ __forceinline__ void bar_arrive_expect(uint64_t* bar,
                                                  uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
      :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
}

// the box at (col, row) of a 2-D tensor map into `dst`, its bytes
// completed onto `bar`
__device__ __forceinline__ void tma_box(float* dst, const CUtensorMap* map,
                                        int col, int row, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n"
      :: "r"(smem_addr(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(col), "r"(row), "r"(smem_addr(bar))
      : "memory");
}

// 16 output pixels' (CPP channels at c) of tap (r, s) from the NHWC tensor
// map `map` in im2col mode into `dst`, the first pixel's window at (w, h)
// of image n, its bytes completed onto `bar`
__device__ __forceinline__ void tma_patches(float* dst, const CUtensorMap* map,
                                            int c, int w, int h, int n,
                                            int r, int s, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.im2col.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%2, %3, %4, %5}], [%6], {%7, %8};\n"
      :: "r"(smem_addr(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(c), "r"(w), "r"(h), "r"(n), "r"(smem_addr(bar)),
         "h"((unsigned short)s), "h"((unsigned short)r)
      : "memory");
}

// the consumer warpgroups alone (named barrier 1)
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" :: "n"(kConsumers) : "memory");
}

// output pixel p, as (n, oh, ow) and its image's offset in x
struct Pixel {
  int p, oh, ow, img;
};

__device__ __forceinline__ Pixel pixel_at(int p, const Shape& sh) {
  const int plane = sh.OH * sh.OW;
  const int n = p / plane, rem = p - n * plane;
  const int oh = rem / sh.OW;
  return {p, oh, rem - oh * sh.OW, n * sh.H * sh.W * sh.C};
}

// The producer warpgroup: stage t of the block's slice into ring slot
// t % kRing, once the consumers have released the slot's previous stage.
template <int BM>
__device__ __forceinline__ void produce(const float* __restrict__ x,
                                        const float* __restrict__ dy,
                                        const CUtensorMap* dy_map,
                                        const CUtensorMap* x_map,
                                        float* smem, uint64_t* full,
                                        uint64_t* empty, const Shape& sh,
                                        int m0, int n0, int kb, int ke,
                                        int steps) {
  using T = Tile<BM>;
  const int tid = threadIdx.x;
  if (tid < kPatchThreads) {
    // A whole stage's patches, in a boxed tile, by TMA in im2col mode
    // where the call allows it: lane b < BOXES of warp 0 one box of one
    // tap. Otherwise (an unboxed tile, a slice's last, partial stage, a
    // call without the tensor map) by cp.async: column quad c of rows h,
    // h + H, ... of the stage, the thread's tap decoded once, a pixel's
    // window out of the image or a pixel past the slice zero-filled.
    constexpr int QUADS = T::BN / 4, H = kPatchThreads / QUADS;
    const int c = tid % QUADS, h = tid / QUADS;
    const bool boxes = T::BOXED && sh.im2col && n0 + T::BN <= sh.N;
    const int j = n0 + 4 * c;
    int tr = -(1 << 28), ts = 0, toff = 0;  // a column past N: no image
    if (j < sh.N) {
      const int t = j / sh.C, ci = j - t * sh.C;
      tr = t / sh.k;
      ts = t - tr * sh.k;
      toff = (tr * sh.W + ts) * sh.C + ci;
    }
    const int plane = sh.OH * sh.OW;
    Pixel px = pixel_at(kb + h, sh);  // the thread's next patch row
    for (int t = 0; t < steps; ++t) {
      const int slot = t % kRing;
      bar_wait(&empty[slot], ((t / kRing) & 1) ^ 1);
      float* tile = smem + slot * T::STAGE + kBK * BM;
      const int a_p = kb + t * kBK;
      if (boxes && a_p + kBK <= ke) {
        if (tid < T::BOXES) {  // its arrival carries the box's bytes
          const int jb = n0 + tid * T::CPP, tb = jb / sh.C;
          const int n = a_p / plane, rem = a_p - n * plane;
          const int oh = rem / sh.OW, ow = rem - oh * sh.OW;
          bar_arrive_expect(&full[slot], kBK * T::CPP * 4);
          tma_patches(tile + tid * kBK * T::CPP, x_map, jb - tb * sh.C,
                      ow * sh.st - sh.pad, oh * sh.st - sh.pad, n,
                      tb / sh.k, tb % sh.k, &full[slot]);
          continue;
        }
      } else {
        if (boxes) px = pixel_at(a_p + h, sh);  // the stages before: TMA
        float* dst = tile + T::col(4 * c) + h * T::KK;
#pragma unroll
        for (int i = 0; i < kBK / H; ++i) {
          const int ihb = px.oh * sh.st - sh.pad, iwb = px.ow * sh.st - sh.pad;
          const bool ok = px.p < ke &&
                          (unsigned)(ihb + tr) < (unsigned)sh.H &&
                          (unsigned)(iwb + ts) < (unsigned)sh.W;
          const float* src =
              ok ? x + (px.img + (ihb * sh.W + iwb) * sh.C + toff) : x;
          copy16<true>(dst + H * i * T::KK, src, ok);
          px.p += H;
          px.ow += H;
          while (px.ow >= sh.OW) {
            px.ow -= sh.OW;
            ++px.oh;
          }
          while (px.oh >= sh.OH) {
            px.oh -= sh.OH;
            px.img += sh.H * sh.W * sh.C;
          }
        }
      }
      bar_arrive_copies(&full[slot]);
    }
  } else {
    // dy: a whole stage's (16 x BM) box by TMA from lane 0; a slice's last,
    // partial stage by each lane's column quads lane, lane + 32, ... of
    // every row, rows past the slice zero-filled
    constexpr int QA = BM / 4 / 32;
    const int lane = tid - kPatchThreads, a_col = lane * 4;
    const float* a_src = dy + (size_t)kb * sh.M + m0 + a_col;
    for (int t = 0; t < steps; ++t) {
      const int slot = t % kRing;
      bar_wait(&empty[slot], ((t / kRing) & 1) ^ 1);
      float* dst = smem + slot * T::STAGE;
      const int a_p = kb + t * kBK;
      if (a_p + kBK <= ke) {
        if (lane == 0) {  // its arrival carries the box's bytes
          bar_arrive_expect(&full[slot], kBK * BM * 4);
          tma_box(dst, dy_map, m0, a_p, &full[slot]);
          continue;
        }
      } else {
#pragma unroll
        for (int i = 0; i < kBK; ++i) {
          const bool ok = a_p + i < ke;
          const float* src = a_src + (size_t)(t * kBK + i) * sh.M;
#pragma unroll
          for (int q = 0; q < QA; ++q)
            copy16<false>(dst + i * BM + 128 * q + a_col,
                          ok ? src + 128 * q : dy, ok);
        }
      }
      bar_arrive_copies(&full[slot]);
    }
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// The consumer warpgroups: each warp its part of the tile over the stages
// of its set, then the second set's sums added to the first's, which
// writes the tile out.
template <int BM>
__device__ __forceinline__ void consume(float* smem, uint64_t* full,
                                        uint64_t* empty,
                                        float* __restrict__ ws,
                                        const Shape& sh, int m0, int n0,
                                        int steps) {
  using T = Tile<BM>;
  constexpr int BN = T::BN, LM = T::LM, LN = T::LN;
  const int ct = threadIdx.x - kProducers;
  const int warp = ct / 32, lane = ct % 32;
  const int wn = warp % T::WN, wm = warp / T::WN % T::WM;
  const int set = warp / T::SET_WARPS;
  // rows tm + 4 LM u + (0..3), columns tn + CS v + (0..3)
  const int tm = wm * 16 * LM + lane / LN * 4;
  const int tn = wn * 4 * LN + lane % LN * 4;
  float acc[kTM][kTN];
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int j = 0; j < kTN; ++j) acc[i][j] = 0.f;

  for (int t = set; t < steps; t += T::SETS) {
    const int slot = t % kRing;
    bar_wait(&full[slot], (t / kRing) & 1);
    const float* As = smem + slot * T::STAGE + tm;
    // column tn + CS v at col(tn) + v VS (boxed: box v)
    constexpr int VS = T::BOXED ? kBK * T::CPP : T::CS;
    const float* Bs = smem + slot * T::STAGE + kBK * BM + T::col(tn);
    // 8 pixels unrolled: a whole stage's code (16) is too large for the
    // instruction cache, and ran 5-40% slower (PERF.md §6)
#pragma unroll 8
    for (int kk = 0; kk < kBK; ++kk) {
      float b[kTN];
#pragma unroll
      for (int v = 0; v < kTN / 4; ++v) {
        const float4 q =
            *reinterpret_cast<const float4*>(Bs + kk * T::KK + v * VS);
        b[4 * v] = q.x, b[4 * v + 1] = q.y, b[4 * v + 2] = q.z,
        b[4 * v + 3] = q.w;
      }
#pragma unroll
      for (int u = 0; u < kTM / 4; ++u) {
        const float4 q =
            *reinterpret_cast<const float4*>(As + kk * BM + 4 * LM * u);
        const float a[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < kTN; ++j)
            acc[4 * u + i][j] = fmaf(a[i], b[j], acc[4 * u + i][j]);
      }
    }
    __syncwarp();
    if (lane == 0) bar_arrive(&empty[slot]);
  }

  // every stage consumed: the ring's memory holds the second set's sums
  consumers_sync();
  if (set > 0) {
#pragma unroll
    for (int i = 0; i < kTM; ++i) {
      float* row = smem + (tm + i / 4 * 4 * LM + i % 4) * BN + tn;
#pragma unroll
      for (int v = 0; v < kTN / 4; ++v)
        *reinterpret_cast<float4*>(row + T::CS * v) = make_float4(
            acc[i][4 * v], acc[i][4 * v + 1], acc[i][4 * v + 2],
            acc[i][4 * v + 3]);
    }
  }
  consumers_sync();
  if (set > 0) return;
  // the partial sum of this slice: whole tiles, so no edge to mask
  float* out = ws + (size_t)blockIdx.z * sh.mpad * sh.npad +
               (size_t)m0 * sh.npad + n0;
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int r = tm + i / 4 * 4 * LM + i % 4;
    const float* part = smem + r * BN + tn;
    float* row = out + (size_t)r * sh.npad + tn;
#pragma unroll
    for (int v = 0; v < kTN / 4; ++v) {
      const float4 s = *reinterpret_cast<const float4*>(part + T::CS * v);
      *reinterpret_cast<float4*>(row + T::CS * v) = make_float4(
          acc[i][4 * v] + s.x, acc[i][4 * v + 1] + s.y,
          acc[i][4 * v + 2] + s.z, acc[i][4 * v + 3] + s.w);
    }
  }
}

}  // namespace wsd

template <int BM>
__global__ void __launch_bounds__(wsd::kThreads, 1)
wgrad_ws_kernel(const float* __restrict__ x, const float* __restrict__ dy,
                const __grid_constant__ CUtensorMap dy_map,
                const __grid_constant__ CUtensorMap x_map,
                float* __restrict__ ws, const Shape sh) {
  using T = wsd::Tile<BM>;
  extern __shared__ __align__(128) float smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(
      reinterpret_cast<char*>(smem) + T::RING_BYTES);
  uint64_t* empty = full + wsd::kRing;

  const int n0 = blockIdx.x * T::BN;
  const int m0 = blockIdx.y * BM;
  const int g = blockIdx.z / sh.S;
  const int slice = blockIdx.z - g * sh.S;
  const int kb = g * sh.Kg + slice * sh.chunk;
  const int ke = min(kb + sh.chunk, (g + 1) * sh.Kg);
  const int steps = ke > kb ? (ke - kb + wsd::kBK - 1) / wsd::kBK : 0;

  if (threadIdx.x == 0) {
    for (int s = 0; s < wsd::kRing; ++s) {
      wsd::bar_init(&full[s], wsd::kProducers);
      wsd::bar_init(&empty[s], T::SET_WARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // one branch each, never rejoined: setmaxnreg holds only so
  if (threadIdx.x < wsd::kProducers) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n"
                 :: "n"(wsd::kProducerRegs));
    wsd::produce<BM>(x, dy, &dy_map, &x_map, smem, full, empty, sh, m0, n0,
                     kb, ke, steps);
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n"
                 :: "n"(wsd::kConsumerRegs));
    wsd::consume<BM>(smem, full, empty, ws, sh, m0, n0, steps);
  }
}

// ---------------------------------------------------------------------------
// Design 2: the first design, each thread its own loader
// ---------------------------------------------------------------------------

constexpr int kBN = 128;      // patch columns a block
constexpr int kThreads = 128;

// the tile of each BM: rows of a thread's register tile, pixels a stage,
// stages in flight, blocks an SM the registers are capped for
template <int BM> struct Tile;
template <> struct Tile<64> {
  static constexpr int TM = 8, BK = 16, STAGES = 3, MIN_BLOCKS = 4;
};
template <> struct Tile<128> {
  static constexpr int TM = 16, BK = 8, STAGES = 4, MIN_BLOCKS = 2;
};

// One stage into As[buf] and Bs[buf], then the loader's next pixels. A
// macro, not a function or lambda: at both call sites the compiler keeps
// the shared arrays' address space and the loader's state in registers
// (a lambda version ran 5-10% slower, with a stack frame).
#define CLSURVEY_WGRAD_LOAD(buf)                                              \
  do {                                                                        \
    _Pragma("unroll") for (int i = 0; i < QA; ++i) {                          \
      const bool row_ok = a_p + i * RA < ke;                                  \
      const float* src = a_src + (size_t)i * RA * sh.M;                       \
      float* dst = &As[buf][a_row + i * RA][a_col];                           \
      _Pragma("unroll") for (int q = 0; q < (VA ? 1 : 4); ++q) {              \
        const bool ok = row_ok && m0 + a_col + q < sh.M;                      \
        if (VA)                                                               \
          copy16<false>(dst, ok ? src : dy, ok);                              \
        else                                                                  \
          copy4(dst + q, ok ? src + q : dy, ok);                              \
      }                                                                       \
    }                                                                         \
    a_p += BK;                                                                \
    a_src += (size_t)BK * sh.M;                                               \
    _Pragma("unroll") for (int i = 0; i < QB; ++i) {                          \
      const int ihb = oh[i] * sh.st - sh.pad, iwb = ow[i] * sh.st - sh.pad;   \
      const bool row_ok = p[i] < ke;                                          \
      const int base = img[i] + (ihb * sh.W + iwb) * sh.C;                    \
      float* dst = &Bs[buf][b_row + i * RB][b_col];                           \
      _Pragma("unroll") for (int q = 0; q < NT; ++q) {                        \
        const bool ok = row_ok && tok[q] &&                                   \
                        (unsigned)(ihb + tr[q]) < (unsigned)sh.H &&           \
                        (unsigned)(iwb + ts[q]) < (unsigned)sh.W;             \
        const float* src = ok ? x + (base + toff[q]) : x;                     \
        if (VB)                                                               \
          copy16<true>(dst, src, ok);                                         \
        else                                                                  \
          copy4(dst + q, src, ok);                                            \
      }                                                                       \
      p[i] += BK;                                                             \
      ow[i] += BK;                                                            \
      while (ow[i] >= sh.OW) {                                                \
        ow[i] -= sh.OW;                                                       \
        ++oh[i];                                                              \
      }                                                                       \
      while (oh[i] >= sh.OH) {                                                \
        oh[i] -= sh.OH;                                                       \
        img[i] += sh.H * sh.W * sh.C;                                         \
      }                                                                       \
    }                                                                         \
  } while (0)

// VA / VB: dy / x copied 16 bytes at a time (else a float at a time)
template <int BM, bool VA, bool VB>
__global__ void __launch_bounds__(kThreads, Tile<BM>::MIN_BLOCKS)
wgrad_kernel(const float* __restrict__ x, const float* __restrict__ dy,
             float* __restrict__ ws, const Shape sh) {
  constexpr int TM = Tile<BM>::TM, TN = 8;
  constexpr int BK = Tile<BM>::BK, STAGES = Tile<BM>::STAGES;
  // a thread's share of a stage: QA quads of dy (rows a_row + i RA,
  // columns a_col..+3) and QB of patches (rows b_row + i RB, columns
  // b_col..+3), the same columns every stage
  constexpr int QA = BK * BM / 4 / kThreads, RA = kThreads / (BM / 4);
  constexpr int QB = BK * kBN / 4 / kThreads, RB = kThreads / (kBN / 4);
  constexpr int NT = VB ? 1 : 4;  // taps a thread decodes
  __shared__ __align__(16) float As[STAGES][BK][BM];
  __shared__ __align__(16) float Bs[STAGES][BK][kBN];

  const int tid = threadIdx.x;
  const int n0 = blockIdx.x * kBN;
  const int m0 = blockIdx.y * BM;
  const int g = blockIdx.z / sh.S;
  const int slice = blockIdx.z - g * sh.S;
  const int kb = g * sh.Kg + slice * sh.chunk;
  const int ke = min(kb + sh.chunk, (g + 1) * sh.Kg);
  const int steps = ke > kb ? (ke - kb + BK - 1) / BK : 0;

  const int a_row = tid / (BM / 4), a_col = tid % (BM / 4) * 4;
  int a_p = kb + a_row;
  const float* a_src = dy + (size_t)a_p * sh.M + m0 + a_col;

  const int b_row = tid / (kBN / 4), b_col = tid % (kBN / 4) * 4;
  int p[QB], oh[QB], ow[QB], img[QB];  // each patch row's pixel
  const int plane = sh.OH * sh.OW;
#pragma unroll
  for (int i = 0; i < QB; ++i) {
    const int p0 = kb + b_row + i * RB;
    const int n = p0 / plane, rem = p0 - n * plane;
    p[i] = p0;
    oh[i] = rem / sh.OW;
    ow[i] = rem - oh[i] * sh.OW;
    img[i] = n * sh.H * sh.W * sh.C;
  }
  int tr[NT], ts[NT], toff[NT];  // each column's tap
  bool tok[NT];
#pragma unroll
  for (int q = 0; q < NT; ++q) {
    const int j = n0 + b_col + q;
    tok[q] = j < sh.N;
    const int t = tok[q] ? j / sh.C : 0;
    const int ci = tok[q] ? j - t * sh.C : 0;
    tr[q] = t / sh.k;
    ts[q] = t - tr[q] * sh.k;
    toff[q] = (tr[q] * sh.W + ts[q]) * sh.C + ci;
  }

  // the thread's tile: rows tm + 16 u + (0..3), columns tn + 32 v + (0..3);
  // a warp covers 4 TM rows by 64 columns, the block 2 x 2 warps
  const int warp = tid / 32, lane = tid % 32;
  const int tm = (warp >> 1) * 4 * TM + (lane >> 3) * 4;
  const int tn = (warp & 1) * 64 + (lane & 7) * 4;
  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

#pragma unroll
  for (int t = 0; t < STAGES - 1; ++t) {
    if (t < steps) CLSURVEY_WGRAD_LOAD(t);
    commit();
  }
  int rbuf = 0, wbuf = STAGES - 1;
  for (int t = 0; t < steps; ++t) {
    wait_groups<STAGES - 2>();
    __syncthreads();  // stage t landed for all; stage t - 1 is consumed
    if (t + STAGES - 1 < steps) CLSURVEY_WGRAD_LOAD(wbuf);
    commit();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[TM], b[TN];
#pragma unroll
      for (int u = 0; u < TM / 4; ++u) {
        const float4 v =
            *reinterpret_cast<const float4*>(&As[rbuf][kk][tm + 16 * u]);
        a[4 * u] = v.x, a[4 * u + 1] = v.y, a[4 * u + 2] = v.z,
        a[4 * u + 3] = v.w;
      }
#pragma unroll
      for (int u = 0; u < TN / 4; ++u) {
        const float4 v =
            *reinterpret_cast<const float4*>(&Bs[rbuf][kk][tn + 32 * u]);
        b[4 * u] = v.x, b[4 * u + 1] = v.y, b[4 * u + 2] = v.z,
        b[4 * u + 3] = v.w;
      }
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    rbuf = rbuf + 1 == STAGES ? 0 : rbuf + 1;
    wbuf = wbuf + 1 == STAGES ? 0 : wbuf + 1;
  }
  wait_groups<0>();

  // the partial sum of this slice: whole tiles, so no edge to mask
  float* out = ws + (size_t)blockIdx.z * sh.mpad * sh.npad +
               (size_t)m0 * sh.npad + n0;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    float* row = out + (size_t)(tm + i / 4 * 16 + i % 4) * sh.npad + tn;
#pragma unroll
    for (int u = 0; u < TN / 4; ++u)
      *reinterpret_cast<float4*>(row + 32 * u) = make_float4(
          acc[i][4 * u], acc[i][4 * u + 1], acc[i][4 * u + 2],
          acc[i][4 * u + 3]);
  }
}

#undef CLSURVEY_WGRAD_LOAD

// ---------------------------------------------------------------------------
// The sum of the slices (both designs)
// ---------------------------------------------------------------------------

// dW[g, co, j] = the sum of group g's S partials at (co, j), j = (r, s,
// ci): a thread an element, in slice order, neighbouring threads on
// neighbouring columns
__global__ void sum_slices(const float* __restrict__ ws,
                           float* __restrict__ out, const Shape sh,
                           long long total) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const int j = (int)(idx % sh.N);
  const long long gm = idx / sh.N;  // g * M + co
  const int co = (int)(gm % sh.M);
  const long long g = gm / sh.M;
  const size_t plane = (size_t)sh.mpad * sh.npad;
  const float* src = ws + (size_t)g * sh.S * plane + (size_t)co * sh.npad + j;
  float sum = 0.f;
  for (int s = 0; s < sh.S; ++s) sum += src[s * plane];
  out[idx] = sum;
}

// the same where S is large and dW small (AlexNet's first conv: 176 and
// more slices of 64 x 363): a block 32 columns of one row by 8 threads,
// each summing the slices s = its thread row mod 8 in slice order, then
// the 8 sums in thread-row order
constexpr int kSplitCols = 32, kSplitRows = 8, kSplitFrom = 32;

__global__ void __launch_bounds__(kSplitCols * kSplitRows)
sum_slices_split(const float* __restrict__ ws, float* __restrict__ out,
                 const Shape sh) {
  __shared__ float part[kSplitRows][kSplitCols + 1];
  const int col = threadIdx.x % kSplitCols, row = threadIdx.x / kSplitCols;
  const int j = blockIdx.x * kSplitCols + col;
  const int co = blockIdx.y, g = blockIdx.z;
  float sum = 0.f;
  if (j < sh.N) {
    const size_t plane = (size_t)sh.mpad * sh.npad;
    const float* src =
        ws + (size_t)g * sh.S * plane + (size_t)co * sh.npad + j;
    for (int s = row; s < sh.S; s += kSplitRows) sum += src[s * plane];
  }
  part[row][col] = sum;
  __syncthreads();
  if (row == 0 && j < sh.N) {
#pragma unroll
    for (int r = 1; r < kSplitRows; ++r) sum += part[r][col];
    out[((size_t)g * sh.M + co) * sh.N + j] = sum;
  }
}

bool writes_dw(const Shape& sh) {
  return sh.S == 1 && sh.mpad == sh.M && sh.npad == sh.N;
}

cudaError_t sum_pass(const float* ws, float* out, const Shape& sh,
                     int groups, cudaStream_t stream) {
  if (sh.S >= kSplitFrom) {
    const dim3 sums((sh.N + kSplitCols - 1) / kSplitCols, sh.M, groups);
    sum_slices_split<<<sums, kSplitCols * kSplitRows, 0, stream>>>(ws, out,
                                                                    sh);
  } else {
    const long long total = (long long)groups * sh.M * sh.N;
    const int threads = 256;
    sum_slices<<<(unsigned)((total + threads - 1) / threads), threads, 0,
                 stream>>>(ws, out, sh, total);
  }
  return cudaGetLastError();
}

template <int BM, bool VA, bool VB>
cudaError_t launch(const float* x, const float* dy, float* ws, float* out,
                   const Shape& sh, int groups, cudaStream_t stream) {
  const dim3 grid(sh.npad / kBN, sh.mpad / BM, groups * sh.S);
  const bool direct = writes_dw(sh);
  wgrad_kernel<BM, VA, VB><<<grid, kThreads, 0, stream>>>(
      x, dy, direct ? out : ws, sh);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || direct) return err;
  return sum_pass(ws, out, sh, groups, stream);
}

// the CUDA driver API's cuTensorMapEncodeTiled, reached through the
// runtime (no -lcuda)
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &q) != cudaSuccess ||
        q != cudaDriverEntryPointSuccess)
      p = nullptr;
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

// dy as a (pixels, C_out) matrix read in (16 x bm) boxes
bool dy_tensor_map(CUtensorMap* map, const float* dy, long long pixels,
                   int M, int bm) {
  const EncodeTiled encode = encode_tiled();
  if (!encode) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)M, (cuuint64_t)pixels};
  const cuuint64_t strides[1] = {(cuuint64_t)M * sizeof(float)};
  const cuuint32_t box[2] = {(cuuint32_t)bm, (cuuint32_t)wsd::kBK};
  const cuuint32_t elems[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2,
                const_cast<float*>(dy), dims, strides, box, elems,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// the CUDA driver API's cuTensorMapEncodeIm2col
using EncodeIm2col = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const int*, const int*,
                                  cuuint32_t, cuuint32_t, const cuuint32_t*,
                                  CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

EncodeIm2col encode_im2col() {
  static const EncodeIm2col fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeIm2col", &p,
                                cudaEnableDefault, &q) != cudaSuccess ||
        q != cudaDriverEntryPointSuccess)
      p = nullptr;
    return reinterpret_cast<EncodeIm2col>(p);
  }();
  return fn;
}

// x (rows, H, W, C) in im2col mode: 16 output pixels a request, in
// (n, oh, ow) order over the windows' top-left corners (oh st - pad,
// ow st - pad), cpp channels each, zeros outside the image; false where
// the CUDA driver API refuses the shape (the corners' range, the
// channels)
bool x_im2col_map(CUtensorMap* map, const float* x, int rows,
                  const Shape& sh, int cpp) {
  const EncodeIm2col encode = encode_im2col();
  if (!encode || sh.C % cpp) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)sh.C, (cuuint64_t)sh.W,
                              (cuuint64_t)sh.H, (cuuint64_t)rows};
  const cuuint64_t strides[3] = {(cuuint64_t)sh.C * 4,
                                 (cuuint64_t)sh.W * sh.C * 4,
                                 (cuuint64_t)sh.H * sh.W * sh.C * 4};
  // the corners' offsets from the image's first and last pixel
  const int lower[2] = {-sh.pad, -sh.pad};
  const int upper[2] = {(sh.OW - 1) * sh.st - sh.pad - (sh.W - 1),
                        (sh.OH - 1) * sh.st - sh.pad - (sh.H - 1)};
  const cuuint32_t elems[4] = {1, (cuuint32_t)sh.st, (cuuint32_t)sh.st, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4,
                const_cast<float*>(x), dims, strides, lower, upper,
                (cuuint32_t)cpp, wsd::kBK, elems,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int BM>
cudaError_t launch_ws(const float* x, const float* dy, float* ws, float* out,
                      Shape sh, int groups, cudaStream_t stream) {
  using T = wsd::Tile<BM>;
  CUtensorMap dy_map, x_map = {};
  if (!dy_tensor_map(&dy_map, dy, (long long)groups * sh.Kg, sh.M, BM))
    return cudaErrorInvalidValue;
  const int rows = groups * sh.Kg / (sh.OH * sh.OW);
  sh.im2col = T::BOXED && x_im2col_map(&x_map, x, rows, sh, T::CPP);
  cudaError_t err = cudaFuncSetAttribute(
      wgrad_ws_kernel<BM>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      T::SMEM);
  if (err != cudaSuccess) return err;
  const dim3 grid(sh.npad / T::BN, sh.mpad / BM, groups * sh.S);
  const bool direct = writes_dw(sh);
  wgrad_ws_kernel<BM><<<grid, wsd::kThreads, T::SMEM, stream>>>(
      x, dy, dy_map, x_map, direct ? out : ws, sh);
  err = cudaGetLastError();
  if (err != cudaSuccess || direct) return err;
  return sum_pass(ws, out, sh, groups, stream);
}

template <int BM, bool VA, bool VB>
int occupancy() {
  int blocks = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &blocks, wgrad_kernel<BM, VA, VB>, kThreads, 0) != cudaSuccess)
    return -1;
  return blocks;
}

template <int BM>
int occupancy_ws() {
  using T = wsd::Tile<BM>;
  int blocks = 0;
  if (cudaFuncSetAttribute(wgrad_ws_kernel<BM>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           T::SMEM) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &blocks, wgrad_ws_kernel<BM>, wsd::kThreads, T::SMEM) !=
          cudaSuccess)
    return -1;
  return blocks;
}

template <int BM>
cudaError_t launch_bm(const float* x, const float* dy, float* ws, float* out,
                      const Shape& sh, int groups, bool va, bool vb,
                      cudaStream_t stream) {
  if (va && vb) return launch<BM, true, true>(x, dy, ws, out, sh, groups,
                                              stream);
  if (va) return launch<BM, true, false>(x, dy, ws, out, sh, groups, stream);
  if (vb) return launch<BM, false, true>(x, dy, ws, out, sh, groups, stream);
  return launch<BM, false, false>(x, dy, ws, out, sh, groups, stream);
}

template <int BM>
int occupancy_bm(bool va, bool vb) {
  if (va && vb) return occupancy<BM, true, true>();
  if (va) return occupancy<BM, true, false>();
  if (vb) return occupancy<BM, false, true>();
  return occupancy<BM, false, false>();
}

// the checks and the Shape both entries share; false where refused
bool make_shape(Shape& sh, const float* x, const float* dy, const float* ws,
                int rows, int H, int W, int C, int OH, int OW, int M, int k,
                int stride, int pad, int groups, int S, int chunk, int bm,
                int bn, int bk, bool vec_x, bool vec_dy) {
  if (rows <= 0 || groups <= 0 || groups > 65535 || rows % groups ||
      S <= 0 || chunk <= 0 || M > 65535 || chunk % bk || H <= 0 ||
      W <= 0 || C <= 0 || OH <= 0 || OW <= 0 ||
      M <= 0 || k <= 0 || stride <= 0 || pad < 0)
    return false;
  if ((vec_x && (C % 4 || reinterpret_cast<uintptr_t>(x) % 16)) ||
      (vec_dy && (M % 4 || reinterpret_cast<uintptr_t>(dy) % 16)))
    return false;
  sh.H = H, sh.W = W, sh.C = C, sh.OH = OH, sh.OW = OW, sh.M = M;
  sh.k = k, sh.st = stride, sh.pad = pad, sh.N = k * k * C;
  sh.mpad = (M + bm - 1) / bm * bm;
  sh.npad = (sh.N + bn - 1) / bn * bn;
  sh.Kg = rows / groups * OH * OW;
  sh.S = S, sh.chunk = chunk;
  sh.im2col = 0;
  if ((long long)(S - 1) * chunk >= sh.Kg || (long long)groups * S > 65535)
    return false;
  return ws || writes_dw(sh);
}

}  // namespace

extern "C" {

// dW of `groups` groups of rows (1, or the samples of the per-sample form)
// into `out`, laid out (groups, M, k, k, C), by the first design; `ws` holds
// groups * S * mpad * npad floats, mpad = M rounded up to bm, npad = k k C
// rounded up to 128 (unused, and may be null, where S is 1 and both are
// unpadded). x is (rows, H, W, C) and dy (rows, OH, OW, M), both
// contiguous; a group is rows / groups whole rows; `chunk` is a multiple of
// bm's stage (16 pixels at bm 64, 8 at 128). vec_x (16-byte copies of x)
// needs C a multiple of 4 and x 16-byte aligned, vec_dy the same of M and
// dy.
int clsurvey_conv_wgrad(const float* x, const float* dy, float* ws,
                        float* out, int rows, int H, int W, int C, int OH,
                        int OW, int M, int k, int stride, int pad, int groups,
                        int S, int chunk, int bm, int vec_x, int vec_dy,
                        cudaStream_t stream) {
  Shape sh;
  const int bk = bm == 64 ? Tile<64>::BK : Tile<128>::BK;
  if ((bm != 64 && bm != 128) ||
      !make_shape(sh, x, dy, ws, rows, H, W, C, OH, OW, M, k, stride, pad,
                  groups, S, chunk, bm, kBN, bk, vec_x, vec_dy))
    return (int)cudaErrorInvalidValue;
  return (int)(bm == 64 ? launch_bm<64>(x, dy, ws, out, sh, groups, vec_dy,
                                        vec_x, stream)
                        : launch_bm<128>(x, dy, ws, out, sh, groups, vec_dy,
                                         vec_x, stream));
}

// the same by the warp-specialised design: bm 128, x and dy both copied 16
// bytes at a time (C and M multiples of 4, both pointers 16-byte aligned);
// npad = k k C rounded up to 192; `chunk` a multiple of 16 pixels
int clsurvey_conv_wgrad_ws(const float* x, const float* dy, float* ws,
                           float* out, int rows, int H, int W, int C, int OH,
                           int OW, int M, int k, int stride, int pad,
                           int groups, int S, int chunk, int bm,
                           cudaStream_t stream) {
  Shape sh;
  if ((bm != 128 && bm != 256) || M % bm ||
      !make_shape(sh, x, dy, ws, rows, H, W, C, OH, OW, M, k, stride, pad,
                  groups, S, chunk, bm, bm == 128 ? 192 : 96, wsd::kBK,
                  true, true))
    return (int)cudaErrorInvalidValue;
  return (int)(bm == 128 ? launch_ws<128>(x, dy, ws, out, sh, groups, stream)
                         : launch_ws<256>(x, dy, ws, out, sh, groups,
                                          stream));
}

// resident blocks an SM of the first design with tile rows bm and these
// copies
int clsurvey_conv_wgrad_occupancy(int bm, int vec_x, int vec_dy) {
  if (bm == 64) return occupancy_bm<64>(vec_dy, vec_x);
  if (bm == 128) return occupancy_bm<128>(vec_dy, vec_x);
  return -1;
}

// resident blocks an SM of the warp-specialised design (tile rows bm, 128)
int clsurvey_conv_wgrad_ws_occupancy(int bm) {
  if (bm == 128) return occupancy_ws<128>();
  if (bm == 256) return occupancy_ws<256>();
  return -1;
}

}  // extern "C"
