// Kernels B1 and B2: 2x2 stride-2 max-pool on NHWC with a 1-byte argmax
// code per output cell (B1), and the backward pass that routes the
// cotangent to the recorded position (B2).
//
// Replace clsurvey_tpu/ops/pool_pallas.py:_fwd_kernel and _bwd_kernel
// (the maxpool2x2 custom VJP). The TPU kernels worked on a (B*H/2, 2, Wo,
// 2C) view with lane rotates, needed C in {64, 128} and even H, W, and
// stored the code in the input dtype; none of that is a limit here.
//
// Bound: bytes. B1 reads the input once and writes a quarter-size value
// tensor plus a quarter-size uint8 code; B2 reads the cotangent and the
// code and writes the full-size dx. Each does a handful of compares per
// element. One thread owns one output cell (b, i, j, c); neighbouring
// threads take neighbouring channels, so each of the four window reads,
// the value store and the code store coalesce across the warp. Windows do
// not overlap, so B2 writes each dx element exactly once, with no atomics
// and no zero-fill pass: the thread writes g at the code's position and 0
// at the other three, and the threads of the last output row / column
// also zero the row / column that VALID pooling drops when H or W is odd.
//
// Selection is the JAX kernel's, literally: a >= b picks the top pair,
// d >= e the bottom pair, then top >= bottom (codes 0..3 in row-major
// window order). This is the first maximum in window order on ties, which
// is XLA select-and-scatter's rule, and it fixes what a NaN does. The
// compares run in float (bf16 -> float is exact); the stored value is the
// selected input element itself.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T zero();
template <>
__device__ __forceinline__ float zero<float>() { return 0.0f; }
template <>
__device__ __forceinline__ __nv_bfloat16 zero<__nv_bfloat16>() {
  return __float2bfloat16_rn(0.0f);
}

struct Dims {
  int h, w, c, ho, wo;
};

// Offset of input element (b, 2*r, 2*j, c) for output cell index i.
__device__ __forceinline__ long long window_base(long long i, const Dims& d,
                                                 int* r_out, int* j_out,
                                                 long long* b_out,
                                                 int* c_out) {
  const int c = (int)(i % d.c);
  long long t = i / d.c;
  const int j = (int)(t % d.wo);
  t /= d.wo;
  const int r = (int)(t % d.ho);
  const long long b = t / d.ho;
  *r_out = r;
  *j_out = j;
  *b_out = b;
  *c_out = c;
  return ((b * d.h + 2LL * r) * d.w + 2LL * j) * d.c + c;
}

template <typename T>
__global__ void pool_fwd_kernel(const T* __restrict__ x, T* __restrict__ val,
                                uint8_t* __restrict__ code, long long n_out,
                                Dims d) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long row = (long long)d.w * d.c;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < n_out; i += stride) {
    int r, j, c;
    long long b;
    const long long base = window_base(i, d, &r, &j, &b, &c);
    const T a = x[base];
    const T bb = x[base + d.c];
    const T dd = x[base + row];
    const T e = x[base + row + d.c];
    const float fa = to_float(a), fb = to_float(bb);
    const float fd = to_float(dd), fe = to_float(e);
    const bool t_ge = fa >= fb;
    const float vt = t_ge ? fa : fb;
    const bool b_ge = fd >= fe;
    const float vb = b_ge ? fd : fe;
    const bool f_ge = vt >= vb;
    const int k = f_ge ? (t_ge ? 0 : 1) : (b_ge ? 2 : 3);
    val[i] = k == 0 ? a : (k == 1 ? bb : (k == 2 ? dd : e));
    code[i] = (uint8_t)k;
  }
}

template <typename T>
__global__ void pool_bwd_kernel(const T* __restrict__ g,
                                const uint8_t* __restrict__ code,
                                T* __restrict__ dx, long long n_out, Dims d) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long row = (long long)d.w * d.c;
  const T z = zero<T>();
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < n_out; i += stride) {
    int r, j, c;
    long long b;
    const long long base = window_base(i, d, &r, &j, &b, &c);
    const T gv = g[i];
    const int k = code[i];
    dx[base] = k == 0 ? gv : z;
    dx[base + d.c] = k == 1 ? gv : z;
    dx[base + row] = k == 2 ? gv : z;
    dx[base + row + d.c] = k == 3 ? gv : z;
    // VALID pooling drops the last column / row of an odd-sized input;
    // its gradient is zero and the last output column / row writes it.
    const bool last_col = (d.w & 1) && j == d.wo - 1;
    const bool last_row = (d.h & 1) && r == d.ho - 1;
    if (last_col) {
      dx[base + 2 * d.c] = z;
      dx[base + row + 2 * d.c] = z;
    }
    if (last_row) {
      dx[base + 2 * row] = z;
      dx[base + 2 * row + d.c] = z;
      if (last_col) dx[base + 2 * row + 2 * d.c] = z;
    }
  }
}

constexpr int kThreads = 256;

int blocks_for(long long n) {
  long long b = (n + kThreads - 1) / kThreads;
  const long long cap = 1LL << 20;  // grid-stride loop covers the rest
  return (int)(b < cap ? b : cap);
}

}  // namespace

// x: (b, h, w, c) float32 or bfloat16 (is_bf16), contiguous, h, w >= 2.
// val: (b, h/2, w/2, c) same dtype; code: (b, h/2, w/2, c) uint8.
extern "C" int clsurvey_pool_fwd(const void* x, void* val, void* code,
                                 long long b, int h, int w, int c,
                                 int is_bf16, void* stream) {
  const Dims d{h, w, c, h / 2, w / 2};
  const long long n_out = b * d.ho * d.wo * (long long)c;
  if (n_out == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  uint8_t* cp = static_cast<uint8_t*>(code);
  if (is_bf16) {
    pool_fwd_kernel<__nv_bfloat16><<<blocks_for(n_out), kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x),
        static_cast<__nv_bfloat16*>(val), cp, n_out, d);
  } else {
    pool_fwd_kernel<float><<<blocks_for(n_out), kThreads, 0, s>>>(
        static_cast<const float*>(x), static_cast<float*>(val), cp, n_out,
        d);
  }
  return (int)cudaGetLastError();
}

// g: (b, h/2, w/2, c) cotangent, contiguous; code from clsurvey_pool_fwd.
// dx: (b, h, w, c) same dtype as g; every element is written.
extern "C" int clsurvey_pool_bwd(const void* g, const void* code, void* dx,
                                 long long b, int h, int w, int c,
                                 int is_bf16, void* stream) {
  const Dims d{h, w, c, h / 2, w / 2};
  const long long n_out = b * d.ho * d.wo * (long long)c;
  if (n_out == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint8_t* cp = static_cast<const uint8_t*>(code);
  if (is_bf16) {
    pool_bwd_kernel<__nv_bfloat16><<<blocks_for(n_out), kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(g), cp,
        static_cast<__nv_bfloat16*>(dx), n_out, d);
  } else {
    pool_bwd_kernel<float><<<blocks_for(n_out), kThreads, 0, s>>>(
        static_cast<const float*>(g), cp, static_cast<float*>(dx), n_out, d);
  }
  return (int)cudaGetLastError();
}
