// Kernel A, the form that was designed first and not adopted: kept so that
// ops/tune_preprocess.py can time it on the card beside the adopted kernel
// (preprocess.cu). No path of the package loads this file.
//
// One thread takes 16 consecutive pixels of one image row: 48 source bytes
// as three 16-byte loads, written as 12 (f32, 192 bytes) or 6 (bf16, 96
// bytes) 16-byte stores. A flipped sample reads the mirrored group of the
// same row and reverses its pixels in registers. The loop is grid-strided
// over at most two waves of blocks. Same C entry point and rounding
// (__fmul_rn, __fsub_rn) as preprocess.cu; it takes only row widths that
// are a multiple of 16 and 16-byte-aligned pointers, and returns
// cudaErrorInvalidValue otherwise.
//
// Why it loses: a thread's stores lie 192 or 96 bytes from its
// neighbour's, so one warp's store instruction touches 32 separate
// 32-byte sectors and fills half or a quarter of each; and (200,64,64,3)
// has only 51,200 groups, 400 blocks of 128 threads, for 132 SMs.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

struct Affine {
  float s0, s1, s2;  // 1 / (255 * std), per channel
  float t0, t1, t2;  // mean / std, per channel
};

constexpr int kGroup = 16;  // pixels per thread
constexpr int kThreads = 128;

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  return (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(lo)) |
         ((uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(hi)) << 16);
}

// words: the group's 48 source bytes. f: its 48 output values in output
// order; output pixel p is source pixel 15 - p when the sample is flipped.
// Every index is a compile-time constant, so both arrays stay in registers.
template <bool kFlip>
__device__ __forceinline__ void convert(const uint32_t (&words)[12],
                                        float (&f)[3 * kGroup],
                                        const Affine& a) {
  const float sc[3] = {a.s0, a.s1, a.s2};
  const float sh[3] = {a.t0, a.t1, a.t2};
#pragma unroll
  for (int p = 0; p < kGroup; ++p) {
    const int sp = kFlip ? kGroup - 1 - p : p;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const int byte = 3 * sp + c;
      const uint32_t v = (words[byte >> 2] >> (8 * (byte & 3))) & 0xffu;
      f[3 * p + c] = __fsub_rn(__fmul_rn((float)v, sc[c]), sh[c]);
    }
  }
}

// x and out as 16-byte words: a group is 3 words of x and 12 (f32) or 6
// (bf16) words of out. groups_per_row = w / 16.
template <bool kBf16>
__global__ void normalize_flip_group16_kernel(
    const uint4* __restrict__ x, const uint8_t* __restrict__ flip,
    uint4* __restrict__ out, int n_groups, int h, int groups_per_row,
    Affine a) {
  const int stride = gridDim.x * blockDim.x;
  for (int g = blockIdx.x * blockDim.x + threadIdx.x; g < n_groups;
       g += stride) {
    const int row = g / groups_per_row;  // b * h + image row
    const int col = g - row * groups_per_row;
    const bool flipped = flip != nullptr && flip[row / h] != 0;
    const int src =
        flipped ? row * groups_per_row + (groups_per_row - 1 - col) : g;
    uint32_t words[12];
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const uint4 v = __ldg(x + 3 * (long long)src + j);
      words[4 * j] = v.x;
      words[4 * j + 1] = v.y;
      words[4 * j + 2] = v.z;
      words[4 * j + 3] = v.w;
    }
    float f[3 * kGroup];
    if (flipped) {
      convert<true>(words, f, a);
    } else {
      convert<false>(words, f, a);
    }
    if (kBf16) {
      uint4* o = out + 6 * (long long)g;
#pragma unroll
      for (int j = 0; j < 6; ++j) {
        o[j] = make_uint4(pack_bf16(f[8 * j], f[8 * j + 1]),
                          pack_bf16(f[8 * j + 2], f[8 * j + 3]),
                          pack_bf16(f[8 * j + 4], f[8 * j + 5]),
                          pack_bf16(f[8 * j + 6], f[8 * j + 7]));
      }
    } else {
      uint4* o = out + 12 * (long long)g;
#pragma unroll
      for (int j = 0; j < 12; ++j) {
        o[j] = make_uint4(__float_as_uint(f[4 * j]),
                          __float_as_uint(f[4 * j + 1]),
                          __float_as_uint(f[4 * j + 2]),
                          __float_as_uint(f[4 * j + 3]));
      }
    }
  }
}

}  // namespace

// Same arguments as preprocess.cu's entry point.
extern "C" int clsurvey_normalize_flip(const void* x, const void* flip,
                                       void* out, long long b, int h, int w,
                                       int out_bf16, float s0, float s1,
                                       float s2, float t0, float t1, float t2,
                                       void* stream) {
  const long long n_pix = b * h * w;
  if (n_pix == 0) return 0;
  if (3 * n_pix > 0x7fffffffLL || w % kGroup != 0 ||
      ((uintptr_t)x & 15u) != 0 || ((uintptr_t)out & 15u) != 0) {
    return (int)cudaErrorInvalidValue;
  }
  const Affine a{s0, s1, s2, t0, t1, t2};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n_groups = (int)(n_pix / kGroup);
  // two waves: 132 SMs x 16 resident blocks of 128 threads, twice
  const int cap = 2 * 132 * (2048 / kThreads);
  const int need = (n_groups + kThreads - 1) / kThreads;
  const int blocks = need < cap ? need : cap;
  const uint4* xv = static_cast<const uint4*>(x);
  const uint8_t* fp = static_cast<const uint8_t*>(flip);
  uint4* ov = static_cast<uint4*>(out);
  if (out_bf16) {
    normalize_flip_group16_kernel<true><<<blocks, kThreads, 0, s>>>(
        xv, fp, ov, n_groups, h, w / kGroup, a);
  } else {
    normalize_flip_group16_kernel<false><<<blocks, kThreads, 0, s>>>(
        xv, fp, ov, n_groups, h, w / kGroup, a);
  }
  return (int)cudaGetLastError();
}
