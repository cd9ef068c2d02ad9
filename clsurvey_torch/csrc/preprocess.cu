// Kernel A: uint8 NHWC images -> normalized float32 or bfloat16, with the
// per-sample horizontal flip fused in.
//
// Replaces clsurvey_tpu/ops/preprocess.py:_norm_kernel (launched by
// normalize_pallas), which normalized a flat (B, H*W*3) view in VMEM and
// left the flip to an XLA `rev` outside the kernel.
//
// Bound: bytes. Each output element costs one byte read and 4 (f32) or 2
// (bf16) bytes written against one multiply and one subtract, far below
// the card's operations-per-byte balance. The design therefore touches
// every byte once: the flip is a read-side index change, not a second
// pass, and there is no scratch tensor.
//
// Two kernels, chosen by shape and alignment inside the C entry point:
//
// - vec (row width a multiple of 8, 16-byte-aligned pointers): one thread
//   writes 16-byte chunks of the output, 4 f32 or 8 bf16 values each, from
//   the 4 or 8 source bytes under them, read as one 32- or 64-bit word.
//   Neighbouring threads take neighbouring chunks, so one warp's store
//   instruction writes 512 contiguous bytes and its load 128 or 256, and
//   a thread keeps CLSURVEY_A_UNROLL chunks in flight, a block's width
//   apart (ops/tune_preprocess.py times 2, 3, 4, 6 and 8 on the card at
//   the main path's shape: on the H100 two is first in float32, and in
//   bfloat16 second to three by 0.0004 ms; from four on, the flipped
//   samples' gather costs more than the loads in flight give). Without
//   a flip the pass is flat: element e has channel e % 3, and no row or
//   pixel index is computed at all. A flipped sample (the grid's y index
//   is the sample, so the choice is uniform across a block) gathers its
//   chunk's bytes one by one from the mirrored pixels of the same row,
//   which a chunk never leaves because the row width is a multiple of 8.
//   Another form, 16 pixels per thread as three 16-byte loads and 6 or 12
//   16-byte stores a thread, is kept in preprocess_group16.cu for
//   ops/tune_preprocess.py to time beside this one: its stores lie 96 or
//   192 bytes apart from thread to thread, so no store instruction fills
//   a 32-byte sector, and it has too few threads to fill the card.
// - scalar (any width, any alignment): one thread per pixel, three 1-byte
//   loads and three scalar stores. A flipped sample reads column W-1-w;
//   the reads of a flipped row walk backwards within one row and stay
//   inside the same cache lines.
//
// Rounding: __fmul_rn then __fsub_rn keep nvcc from contracting the pair
// into one FMA, so the result is the two-rounding value that the plain
// PyTorch version (x * scale - shift) and XLA compute, in both kernels.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

template <typename T>
__device__ __forceinline__ T from_float(float v);

template <>
__device__ __forceinline__ float from_float<float>(float v) { return v; }

template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

struct Affine {
  float s0, s1, s2;  // 1 / (255 * std), per channel
  float t0, t1, t2;  // mean / std, per channel
};

// ---- scalar kernel: the general case ------------------------------------
// One thread per pixel: three channels in, three out. The index math is
// 32-bit (the wrapper refuses tensors of 2^31 elements or more) and runs
// once per pixel, not per element.
template <typename T>
__global__ void normalize_flip_kernel(const uint8_t* __restrict__ x,
                                      const uint8_t* __restrict__ flip,
                                      T* __restrict__ out, int n_pix, int h,
                                      int w, Affine a) {
  const int stride = gridDim.x * blockDim.x;
  for (int p = blockIdx.x * blockDim.x + threadIdx.x; p < n_pix;
       p += stride) {
    const int row = p / w;  // b * h + image row
    int src = p;
    if (flip != nullptr && flip[row / h]) {
      src = row * w + (w - 1 - (p - row * w));
    }
    const uint8_t* in = x + 3 * src;
    T* o = out + 3 * p;
    o[0] = from_float<T>(__fsub_rn(__fmul_rn((float)in[0], a.s0), a.t0));
    o[1] = from_float<T>(__fsub_rn(__fmul_rn((float)in[1], a.s1), a.t1));
    o[2] = from_float<T>(__fsub_rn(__fmul_rn((float)in[2], a.s2), a.t2));
  }
}

// ---- vec kernel: 16-byte output chunks -----------------------------------
constexpr int kVecThreads = 128;
#ifndef CLSURVEY_A_UNROLL
#define CLSURVEY_A_UNROLL 2
#endif
constexpr int kUnroll = CLSURVEY_A_UNROLL;  // chunks a thread keeps in flight

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  return (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(lo)) |
         ((uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(hi)) << 16);
}

// x: (b, sample_elems) bytes; out: the same elements as 16-byte chunks of
// E = 4 (f32) or 8 (bf16) values. row_elems = 3 * w is a multiple of E, and
// sample_elems = h * row_elems. Grid: x covers one sample's chunks, kUnroll
// per thread; y strides over the samples.
template <bool kBf16>
__global__ void normalize_flip_vec_kernel(const uint8_t* __restrict__ x,
                                          const uint8_t* __restrict__ flip,
                                          uint4* __restrict__ out, int b,
                                          int row_elems, int sample_elems,
                                          Affine a) {
  constexpr int E = kBf16 ? 8 : 4;  // values per chunk
  constexpr int W = E / 4;          // source words per chunk
  const int chunks = sample_elems / E;
  const int first = blockIdx.x * (kVecThreads * kUnroll) + threadIdx.x;
  for (int smp = blockIdx.y; smp < b; smp += gridDim.y) {
    const uint8_t* xs = x + (long long)smp * sample_elems;
    uint4* os = out + (long long)smp * chunks;
    const bool flipped = flip != nullptr && flip[smp] != 0;
    uint32_t words[kUnroll][W];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int c = first + u * kVecThreads;
      if (c >= chunks) continue;
      const int e0 = c * E;
      if (!flipped) {
        if (kBf16) {  // one 64-bit load
          const uint2 v = __ldg(reinterpret_cast<const uint2*>(xs + e0));
          words[u][0] = v.x;
          words[u][W - 1] = v.y;
        } else {
          words[u][0] = __ldg(reinterpret_cast<const uint32_t*>(xs + e0));
        }
      } else {
        // element o0 + k of the row is channel (c0 + k) % 3 of pixel
        // q0 + (c0 + k) / 3; its source is that channel of pixel w-1-q
        const int row0 = (e0 / row_elems) * row_elems;
        const int o0 = e0 - row0;
        const int q0 = o0 / 3, c0 = o0 - 3 * q0;
        const uint8_t* last = xs + row0 + row_elems - 3;  // pixel w-1
#pragma unroll
        for (int j = 0; j < W; ++j) {
          uint32_t word = 0;
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const int t = c0 + 4 * j + k;
            const int dq = t / 3;
            word |= (uint32_t)__ldg(last - 3 * (q0 + dq) + (t - 3 * dq))
                    << (8 * k);
          }
          words[u][j] = word;
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int c = first + u * kVecThreads;
      if (c >= chunks) continue;
      // channel of the chunk's first value; value k has (c0 + k) % 3
      const int c0 = (c * E) % 3;
      const float sr[3] = {c0 == 0 ? a.s0 : c0 == 1 ? a.s1 : a.s2,
                           c0 == 0 ? a.s1 : c0 == 1 ? a.s2 : a.s0,
                           c0 == 0 ? a.s2 : c0 == 1 ? a.s0 : a.s1};
      const float tr[3] = {c0 == 0 ? a.t0 : c0 == 1 ? a.t1 : a.t2,
                           c0 == 0 ? a.t1 : c0 == 1 ? a.t2 : a.t0,
                           c0 == 0 ? a.t2 : c0 == 1 ? a.t0 : a.t1};
      float f[E];
#pragma unroll
      for (int k = 0; k < E; ++k) {
        const uint32_t v = (words[u][k >> 2] >> (8 * (k & 3))) & 0xffu;
        f[k] = __fsub_rn(__fmul_rn((float)v, sr[k % 3]), tr[k % 3]);
      }
      if (kBf16) {
        os[c] = make_uint4(pack_bf16(f[0], f[1]), pack_bf16(f[2], f[3]),
                           pack_bf16(f[E - 4], f[E - 3]),
                           pack_bf16(f[E - 2], f[E - 1]));
      } else {
        os[c] = make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]),
                           __float_as_uint(f[2]), __float_as_uint(f[3]));
      }
    }
  }
}

// Does nothing: its device time is what any launch of that grid costs, the
// floor that kernel A's microsecond-scale bound is read against.
__global__ void empty_kernel() {}

constexpr int kThreads = 256;

int blocks_for(long long n) {
  long long b = (n + kThreads - 1) / kThreads;
  const long long cap = 1LL << 20;  // grid-stride loop covers the rest
  return (int)(b < cap ? b : cap);
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15u) == 0; }

}  // namespace

// x: (b, h, w, 3) uint8, contiguous. flip: (b,) uint8 or NULL (no flip).
// out: (b, h, w, 3) float32 (out_bf16 == 0) or bfloat16 (out_bf16 != 0).
// Returns cudaGetLastError() after the launch.
extern "C" int clsurvey_normalize_flip(const void* x, const void* flip,
                                       void* out, long long b, int h, int w,
                                       int out_bf16, float s0, float s1,
                                       float s2, float t0, float t1, float t2,
                                       void* stream) {
  const long long n_pix = b * h * w;
  if (n_pix == 0) return 0;
  if (3 * n_pix > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const Affine a{s0, s1, s2, t0, t1, t2};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint8_t* xp = static_cast<const uint8_t*>(x);
  const uint8_t* fp = static_cast<const uint8_t*>(flip);
  if (w % 8 == 0 && aligned16(x) && aligned16(out)) {
    const int row_elems = 3 * w, sample_elems = h * row_elems;
    const int per_block = kVecThreads * kUnroll * (out_bf16 ? 8 : 4);
    const dim3 grid((sample_elems + per_block - 1) / per_block,
                    (unsigned)(b < 65535 ? b : 65535));
    uint4* ov = static_cast<uint4*>(out);
    if (out_bf16) {
      normalize_flip_vec_kernel<true><<<grid, kVecThreads, 0, s>>>(
          xp, fp, ov, (int)b, row_elems, sample_elems, a);
    } else {
      normalize_flip_vec_kernel<false><<<grid, kVecThreads, 0, s>>>(
          xp, fp, ov, (int)b, row_elems, sample_elems, a);
    }
    return (int)cudaGetLastError();
  }
  if (out_bf16) {
    normalize_flip_kernel<__nv_bfloat16>
        <<<blocks_for(n_pix), kThreads, 0, s>>>(
            xp, fp, static_cast<__nv_bfloat16*>(out), (int)n_pix, h, w, a);
  } else {
    normalize_flip_kernel<float><<<blocks_for(n_pix), kThreads, 0, s>>>(
        xp, fp, static_cast<float*>(out), (int)n_pix, h, w, a);
  }
  return (int)cudaGetLastError();
}

// Launches the empty kernel on a grid of `blocks` x `threads`.
extern "C" int clsurvey_empty_launch(int blocks, int threads, void* stream) {
  empty_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>();
  return (int)cudaGetLastError();
}
