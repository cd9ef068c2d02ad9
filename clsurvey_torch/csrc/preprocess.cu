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
// every byte once: the flip is a read-side index change (a flipped sample
// reads column W-1-w), not a second pass, and there is no scratch tensor.
// Neighbouring threads handle neighbouring pixels, so a warp's loads and
// stores cover one contiguous span; the reads of a flipped row walk
// backwards within one row and stay inside the same cache lines.
//
// Rounding: __fmul_rn then __fsub_rn keep nvcc from contracting the pair
// into one FMA, so the result is the two-rounding value that the plain
// PyTorch version (x * scale - shift) and XLA compute.

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

constexpr int kThreads = 256;

int blocks_for(long long n) {
  long long b = (n + kThreads - 1) / kThreads;
  const long long cap = 1LL << 20;  // grid-stride loop covers the rest
  return (int)(b < cap ? b : cap);
}

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
