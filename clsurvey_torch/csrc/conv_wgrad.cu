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
// Here the patches never reach device memory: the kernel's loader gathers
// them into shared memory.
//
// Bound: FFMA. AlexNet's five convs do 262 GFLOP a step at batch 200
// against about 0.66 GB of input and cotangent, far above the card's
// 67 TFLOP/s over 3.35 TB/s; at the float32 peak the bound is 3.9 ms.
// Exactness is float32's: every product and sum is a float32 FFMA (one
// rounding a multiply-add); no tensor core, TF32 or 3xTF32 instruction.
//
// The GEMM: M = C_out (rows of dW), N = k k C_in (its columns, ordered
// (r, s, ci) here so that a run of C_in is contiguous in NHWC), K = output
// pixels of the rows (n, oh, ow). Both operands are K-major as they lie in
// memory: dy's row of a pixel holds C_out contiguous floats, and a patch
// row's columns of one tap hold C_in contiguous floats of x. So a stage's
// tiles go from global to shared memory as they are, with no transpose.
//
// - Tiles: 128 threads a block, each an 8 x 8 (BM 64) or 16 x 8 (BM 128)
//   register tile made of 4 x 4 quads 16 rows and 32 columns apart, so a
//   warp's 128-bit shared loads are broadcasts (dy) and whole 128-byte rows
//   (patches). A block owns BM output channels by 128 columns; BM is 128
//   where C_out is a multiple of 128 (fewer gathered patch bytes a FLOP),
//   else 64 (C_out 64 and 192 fill their tiles). Stages of 16 (BM 64) or 8
//   (BM 128) pixels, 3 or 4 in flight through cp.async. These were the
//   fastest of the tile shapes timed at AlexNet's and small_VGG9's convs
//   on the H100 (PERF.md): 53-69% of the FFMA peak. Register fragments
//   loaded a step ahead, 256-row tiles and deeper pipelines gained 1-3%.
// - The loader: each thread owns fixed columns of its quads for the whole
//   kernel, so a column's tap (r, s, ci) is decoded once; its rows'
//   (n, oh, ow) advance by a stage's pixels without a division. A tap
//   outside the image, a pixel past the slice and a column past C_out or
//   k k C_in are zero-filled by cp.async's source size 0, never read.
// - Narrow inputs: a tensor whose channels are a multiple of 4, 16-byte
//   aligned, is copied 16 bytes at a time; else (C_in 3: AlexNet's first
//   conv, where a patch row's contiguous run is k * 3 floats) each float of
//   the same quads is copied alone, with each column's own tap.
// - Split over K: the output pixels of a group (all rows, or one sample's
//   rows in the per-sample form) are cut into S slices of `chunk` pixels
//   (a multiple of a stage); block (x, y, g * S + s) writes its tile's
//   partial sum of slice s into a workspace of its own, and a second kernel
//   sums each group's S partials in a fixed order into the group's dW. No
//   atomics: two calls give the same bits. With one slice and no padded
//   tile the blocks write dW itself, and there is no second kernel. The
//   caller (ops/conv.py:wgrad_plan) picks BM and S from the shapes it sees.
// - dW is laid out (C_out, k, k, C_in): the port's channels_last weight's
//   own layout, so the partials' rows are dW's rows and the gradient needs
//   no copy into the weight's strides.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

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

struct Shape {
  int H, W, C;      // input side and channels (NHWC)
  int OH, OW, M;    // output side, C_out
  int k, st, pad;   // kernel side, stride, padding
  int N;            // k * k * C
  int mpad, npad;   // the workspace's rows and columns: whole tiles
  int Kg;           // output pixels of a group
  int S, chunk;     // slices a group, output pixels a slice
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

template <int BM, bool VA, bool VB>
cudaError_t launch(const float* x, const float* dy, float* ws, float* out,
                   const Shape& sh, int groups, cudaStream_t stream) {
  const dim3 grid(sh.npad / kBN, sh.mpad / BM, groups * sh.S);
  const bool direct = sh.S == 1 && sh.mpad == sh.M && sh.npad == sh.N;
  wgrad_kernel<BM, VA, VB><<<grid, kThreads, 0, stream>>>(
      x, dy, direct ? out : ws, sh);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || direct) return err;
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
int occupancy() {
  int blocks = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &blocks, wgrad_kernel<BM, VA, VB>, kThreads, 0) != cudaSuccess)
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

}  // namespace

extern "C" {

// dW of `groups` groups of rows (1, or the samples of the per-sample form)
// into `out`, laid out (groups, M, k, k, C); `ws` holds groups * S * mpad *
// npad floats, mpad = M rounded up to bm, npad = k k C rounded up to 128
// (unused, and may be null, where S is 1 and both are unpadded). x is
// (rows, H, W, C) and dy (rows, OH, OW, M), both contiguous; a group is
// rows / groups whole rows; `chunk` is a multiple of bm's stage (16 pixels
// at bm 64, 8 at 128). vec_x (16-byte copies of x) needs C a multiple of 4
// and x 16-byte aligned, vec_dy the same of M and dy.
int clsurvey_conv_wgrad(const float* x, const float* dy, float* ws,
                        float* out, int rows, int H, int W, int C, int OH,
                        int OW, int M, int k, int stride, int pad, int groups,
                        int S, int chunk, int bm, int vec_x, int vec_dy,
                        cudaStream_t stream) {
  const int bk = bm == 64 ? Tile<64>::BK : Tile<128>::BK;
  if (rows <= 0 || groups <= 0 || groups > 65535 || rows % groups ||
      S <= 0 || chunk <= 0 || M > 65535 || (bm != 64 && bm != 128) ||
      chunk % bk || H <= 0 || W <= 0 || C <= 0 || OH <= 0 || OW <= 0 ||
      M <= 0 || k <= 0 || stride <= 0 || pad < 0)
    return (int)cudaErrorInvalidValue;
  if ((vec_x && (C % 4 || reinterpret_cast<uintptr_t>(x) % 16)) ||
      (vec_dy && (M % 4 || reinterpret_cast<uintptr_t>(dy) % 16)))
    return (int)cudaErrorInvalidValue;
  Shape sh;
  sh.H = H, sh.W = W, sh.C = C, sh.OH = OH, sh.OW = OW, sh.M = M;
  sh.k = k, sh.st = stride, sh.pad = pad, sh.N = k * k * C;
  sh.mpad = (M + bm - 1) / bm * bm;
  sh.npad = (sh.N + kBN - 1) / kBN * kBN;
  sh.Kg = rows / groups * OH * OW;
  sh.S = S, sh.chunk = chunk;
  if ((long long)(S - 1) * chunk >= sh.Kg || (long long)groups * S > 65535)
    return (int)cudaErrorInvalidValue;
  if (!ws && !(S == 1 && sh.mpad == M && sh.npad == sh.N))
    return (int)cudaErrorInvalidValue;
  return (int)(bm == 64 ? launch_bm<64>(x, dy, ws, out, sh, groups, vec_dy,
                                        vec_x, stream)
                        : launch_bm<128>(x, dy, ws, out, sh, groups, vec_dy,
                                         vec_x, stream));
}

// resident blocks an SM of the kernel with tile rows bm and these copies
int clsurvey_conv_wgrad_occupancy(int bm, int vec_x, int vec_dy) {
  if (bm == 64) return occupancy_bm<64>(vec_dy, vec_x);
  if (bm == 128) return occupancy_bm<128>(vec_dy, vec_x);
  return -1;
}

}  // extern "C"
