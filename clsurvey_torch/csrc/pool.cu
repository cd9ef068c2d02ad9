// Kernels B1 and B2: 2x2 stride-2 max-pool on NHWC with a 1-byte argmax
// code per output cell (B1), and the backward pass that routes the
// cotangent to the recorded position (B2).
//
// Replace clsurvey_tpu/ops/pool_pallas.py:_fwd_kernel and _bwd_kernel
// (the maxpool2x2 custom VJP). The TPU kernels worked on a (B*H/2, 2, Wo,
// 2C) view with lane rotates, needed C in {64, 128} and even H, W, and
// stored the code in the input dtype; none of that is a limit here.
//
// Bound: HBM bytes. B1 reads the input once and writes a quarter-size
// value tensor plus a quarter-size uint8 code; B2 reads the cotangent and
// the code and writes the full-size dx. Each does three compares per
// output element, far below the card's operations-per-byte balance.
//
// The first design gave one thread one output element: in bfloat16 every
// load and store was a 2-byte scalar (a warp's load instruction moved 64
// bytes, its code store 32), so bfloat16 issued as many memory
// instructions as float32 for half the bytes, and every element paid three
// 64-bit div/mods to find its window. It was bound by instruction and
// transaction rate, not by DRAM: 38-43% of the byte bound in bfloat16.
//
// Two routes, chosen by the caller (ops/pool.py:pool_route) and checked
// here:
//
// - vec: C a multiple of V = 16 / sizeof(T) (8 bfloat16 or 4 float32),
//   the data pointers 16-byte aligned and the code pointer V-byte aligned.
//   One thread owns one output pixel's run of V channels: B1 issues four
//   16-byte loads (the window's four positions), one 16-byte value store
//   and one V-byte code store; B2 one 16-byte cotangent load, one V-byte
//   code load and four 16-byte dx stores. The grid is a block row per
//   output row (b * Ho + r, blockIdx.x) and threads over its Wo * C / V
//   channel vectors (blockIdx.y covers rows wider than a block), so the
//   index math is one 32-bit division per thread and one 64-bit row base;
//   neighbouring threads take neighbouring channel vectors, so each warp's
//   access covers whole 128-byte lines. At the step's shapes this gives
//   51,200 to 1.6 M threads a launch, each with 64 bytes in flight: enough
//   to fill the card without cp.async or TMA, and there is no reuse to
//   stage through shared memory. Loads and stores keep the default cache
//   policy: an evict-first hint on the loads (__ldcs) measured no faster
//   on a cold L2 and slower on a warm one, and the next layer reads B1's
//   output and B2's dx.
// - scalar: any C and alignment. One thread per output element, as in the
//   first design.
//
// Windows do not overlap, so B2 writes each dx element exactly once, with
// no atomics and no zero-fill pass: the thread writes g at the code's
// position and 0 at the other three, and the threads of the last output
// row / column also zero the row / column that VALID pooling drops when H
// or W is odd.
//
// Selection is the JAX kernel's, literally: a >= b picks the top pair,
// d >= e the bottom pair, then top >= bottom (codes 0..3 in row-major
// window order). This is the first maximum in window order on ties, which
// is XLA select-and-scatter's rule, and it fixes what a NaN does. The
// compares run in float (bf16 -> float is exact); the stored value is the
// selected input element itself, bit for bit. Both routes go through
// pick() below.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kRouteScalar = 0;
constexpr int kRouteVec = 1;

// The window rule on one element: returns the selected raw element and
// sets *k to its code.
template <typename R>
__device__ __forceinline__ R pick(float fa, float fb, float fd, float fe,
                                  R ra, R rb, R rd, R re, uint32_t* k) {
  const bool t_ge = fa >= fb;
  const bool b_ge = fd >= fe;
  const bool f_ge = (t_ge ? fa : fb) >= (b_ge ? fd : fe);
  *k = f_ge ? (t_ge ? 0u : 1u) : (b_ge ? 2u : 3u);
  return f_ge ? (t_ge ? ra : rb) : (b_ge ? rd : re);
}

// ---- scalar route: the general case --------------------------------------

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
                                                 int* r_out, int* j_out) {
  const int c = (int)(i % d.c);
  long long t = i / d.c;
  const int j = (int)(t % d.wo);
  t /= d.wo;
  const int r = (int)(t % d.ho);
  const long long b = t / d.ho;
  *r_out = r;
  *j_out = j;
  return ((b * d.h + 2LL * r) * d.w + 2LL * j) * d.c + c;
}

template <typename T>
__global__ void pool_fwd_scalar(const T* __restrict__ x, T* __restrict__ val,
                                uint8_t* __restrict__ code, long long n_out,
                                Dims d) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long row = (long long)d.w * d.c;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < n_out; i += stride) {
    int r, j;
    const long long base = window_base(i, d, &r, &j);
    const T a = x[base];
    const T b = x[base + d.c];
    const T dd = x[base + row];
    const T e = x[base + row + d.c];
    uint32_t k;
    val[i] = pick(to_float(a), to_float(b), to_float(dd), to_float(e), a, b,
                  dd, e, &k);
    code[i] = (uint8_t)k;
  }
}

template <typename T>
__global__ void pool_bwd_scalar(const T* __restrict__ g,
                                const uint8_t* __restrict__ code,
                                T* __restrict__ dx, long long n_out, Dims d) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long row = (long long)d.w * d.c;
  const T z = zero<T>();
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < n_out; i += stride) {
    int r, j;
    const long long base = window_base(i, d, &r, &j);
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

// ---- vec route: V channels a thread, 16-byte accesses ---------------------

union Vec16 {
  uint4 v;
  uint32_t w[4];
};

__device__ __forceinline__ uint4 load16(const void* p) {
  return __ldg(static_cast<const uint4*>(p));
}

// The V codes of a thread, one byte each, element 0 in the lowest byte:
// uint32_t for float32 (V = 4), uint2 for bfloat16 (V = 8).
template <typename T>
struct Codes;
template <>
struct Codes<float> {
  using type = uint32_t;
  static __device__ __forceinline__ uint32_t get(type c, int e) {
    return (c >> (8 * e)) & 0xffu;
  }
  static __device__ __forceinline__ type load(const type* p) {
    return __ldg(reinterpret_cast<const unsigned int*>(p));
  }
};
template <>
struct Codes<__nv_bfloat16> {
  using type = uint2;
  static __device__ __forceinline__ uint32_t get(type c, int e) {
    return ((e < 4 ? c.x : c.y) >> (8 * (e & 3))) & 0xffu;
  }
  static __device__ __forceinline__ type load(const type* p) {
    return __ldg(p);
  }
};

// Pool the four windows' 16-byte words: out gets the selected raw bits,
// the returned codes one byte an element.
__device__ __forceinline__ uint32_t pool_words(const Vec16& a,
                                               const Vec16& b,
                                               const Vec16& d,
                                               const Vec16& e, Vec16* out,
                                               float) {
  uint32_t codes = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    uint32_t k;
    out->w[i] = pick(__uint_as_float(a.w[i]), __uint_as_float(b.w[i]),
                     __uint_as_float(d.w[i]), __uint_as_float(e.w[i]),
                     a.w[i], b.w[i], d.w[i], e.w[i], &k);
    codes |= k << (8 * i);
  }
  return codes;
}

__device__ __forceinline__ uint2 pool_words(const Vec16& a, const Vec16& b,
                                            const Vec16& d, const Vec16& e,
                                            Vec16* out, __nv_bfloat16) {
  uint32_t codes[2] = {0u, 0u};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    // a word holds two bfloat16: element 2i in the low half, 2i+1 high;
    // as float, a bfloat16 is its bits in the upper half of a float's
    uint32_t klo, khi;
    const uint32_t lo = pick(
        __uint_as_float(a.w[i] << 16), __uint_as_float(b.w[i] << 16),
        __uint_as_float(d.w[i] << 16), __uint_as_float(e.w[i] << 16),
        a.w[i] & 0xffffu, b.w[i] & 0xffffu, d.w[i] & 0xffffu,
        e.w[i] & 0xffffu, &klo);
    const uint32_t hi = pick(
        __uint_as_float(a.w[i] & 0xffff0000u),
        __uint_as_float(b.w[i] & 0xffff0000u),
        __uint_as_float(d.w[i] & 0xffff0000u),
        __uint_as_float(e.w[i] & 0xffff0000u), a.w[i] >> 16, b.w[i] >> 16,
        d.w[i] >> 16, e.w[i] >> 16, &khi);
    out->w[i] = lo | (hi << 16);
    codes[i >> 1] |= (klo | (khi << 8)) << (16 * (i & 1));
  }
  return make_uint2(codes[0], codes[1]);
}

// The element mask of code k for one word: all ones over each element
// whose code is k.
__device__ __forceinline__ uint32_t word_mask(uint32_t codes, int i, int k,
                                              float) {
  return Codes<float>::get(codes, i) == (uint32_t)k ? 0xffffffffu : 0u;
}
__device__ __forceinline__ uint32_t word_mask(uint2 codes, int i, int k,
                                              __nv_bfloat16) {
  using C = Codes<__nv_bfloat16>;
  return (C::get(codes, 2 * i) == (uint32_t)k ? 0x0000ffffu : 0u) |
         (C::get(codes, 2 * i + 1) == (uint32_t)k ? 0xffff0000u : 0u);
}

struct VecDims {
  int h, w, c, ho, wo;
  int cv;    // C / V: channel vectors a pixel
  int nvec;  // Wo * C / V: channel vectors an output row
};

// Where a thread's window starts: the element offset of input (b, 2r,
// 2j, c0) and of output (b, r, j, c0), with r and j; false past the row.
template <typename T>
__device__ __forceinline__ bool vec_place(const VecDims& d, long long* in,
                                          long long* out, int* r, int* j) {
  constexpr int V = 16 / sizeof(T);
  const int v = blockIdx.y * blockDim.x + threadIdx.x;
  if (v >= d.nvec) return false;
  const unsigned row = blockIdx.x;  // b * Ho + r
  const unsigned b = row / (unsigned)d.ho;
  *r = (int)(row - b * (unsigned)d.ho);
  *j = v / d.cv;
  // input row of the window's top: 2 * row, plus one dropped row per
  // earlier image when H is odd
  const long long in_row = 2LL * row + (long long)b * (d.h & 1);
  *in = in_row * d.w * d.c + (long long)(v * V + *j * d.c);
  *out = (long long)row * d.wo * d.c + (long long)v * V;
  return true;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    pool_fwd_vec(const T* __restrict__ x, T* __restrict__ val,
                 uint8_t* __restrict__ code, VecDims d) {
  long long in, out;
  int r, j;
  if (!vec_place<T>(d, &in, &out, &r, &j)) return;
  const long long wc = (long long)d.w * d.c;
  Vec16 a, b, dd, e, o;
  a.v = load16(x + in);
  b.v = load16(x + in + d.c);
  dd.v = load16(x + in + wc);
  e.v = load16(x + in + wc + d.c);
  const auto codes = pool_words(a, b, dd, e, &o, T());
  *reinterpret_cast<uint4*>(val + out) = o.v;
  *reinterpret_cast<typename Codes<T>::type*>(code + out) = codes;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    pool_bwd_vec(const T* __restrict__ g, const uint8_t* __restrict__ code,
                 T* __restrict__ dx, VecDims d) {
  long long in, out;
  int r, j;
  if (!vec_place<T>(d, &in, &out, &r, &j)) return;
  const long long wc = (long long)d.w * d.c;
  Vec16 gv;
  gv.v = load16(g + out);
  const auto codes = Codes<T>::load(
      reinterpret_cast<const typename Codes<T>::type*>(code + out));
  const long long at[4] = {in, in + d.c, in + wc, in + wc + d.c};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    Vec16 o;
#pragma unroll
    for (int i = 0; i < 4; ++i) o.w[i] = gv.w[i] & word_mask(codes, i, k, T());
    *reinterpret_cast<uint4*>(dx + at[k]) = o.v;
  }
  // VALID pooling drops the last column / row of an odd-sized input; its
  // gradient is zero and the last output column / row writes it.
  const uint4 z = make_uint4(0u, 0u, 0u, 0u);
  const bool last_col = (d.w & 1) && j == d.wo - 1;
  const bool last_row = (d.h & 1) && r == d.ho - 1;
  if (last_col) {
    *reinterpret_cast<uint4*>(dx + in + 2 * d.c) = z;
    *reinterpret_cast<uint4*>(dx + in + wc + 2 * d.c) = z;
  }
  if (last_row) {
    *reinterpret_cast<uint4*>(dx + in + 2 * wc) = z;
    *reinterpret_cast<uint4*>(dx + in + 2 * wc + d.c) = z;
    if (last_col) *reinterpret_cast<uint4*>(dx + in + 2 * wc + 2 * d.c) = z;
  }
}

// Whether the vec route takes these tensors. ops/pool.py:pool_route
// chooses the route; this only refuses a vec launch it should not have
// asked for, so that a wrong route is a refused launch, never a
// misaligned access.
bool vec_ok(const void* data0, const void* data1, const void* code,
            long long b, int h, int w, int c, int is_bf16) {
  const int v = is_bf16 ? 8 : 4;
  return c % v == 0 && reinterpret_cast<uintptr_t>(data0) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(data1) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(code) % v == 0 &&
         b * (h / 2) < (1LL << 31) && (long long)w * c < (1LL << 24);
}

VecDims vec_dims(int h, int w, int c, int is_bf16) {
  const int v = is_bf16 ? 8 : 4;
  return VecDims{h, w, c, h / 2, w / 2, c / v, (w / 2) * (c / v)};
}

// Grid of the vec route: a block row per output row, threads over its
// channel vectors.
void vec_grid(long long b, const VecDims& d, dim3* grid, dim3* block) {
  const int threads = d.nvec < kThreads ? (d.nvec + 31) / 32 * 32 : kThreads;
  *block = dim3(threads);
  *grid = dim3((unsigned)(b * d.ho), (d.nvec + threads - 1) / threads);
}

template <typename T>
int launch_fwd(const void* x, void* val, void* code, long long b, int h,
               int w, int c, int route, cudaStream_t s) {
  const T* xp = static_cast<const T*>(x);
  T* vp = static_cast<T*>(val);
  uint8_t* cp = static_cast<uint8_t*>(code);
  if (route == kRouteVec) {
    const VecDims d = vec_dims(h, w, c, sizeof(T) == 2);
    dim3 grid, block;
    vec_grid(b, d, &grid, &block);
    pool_fwd_vec<T><<<grid, block, 0, s>>>(xp, vp, cp, d);
  } else {
    const Dims d{h, w, c, h / 2, w / 2};
    const long long n_out = b * d.ho * d.wo * (long long)c;
    pool_fwd_scalar<T><<<blocks_for(n_out), kThreads, 0, s>>>(xp, vp, cp,
                                                               n_out, d);
  }
  return (int)cudaGetLastError();
}

template <typename T>
int launch_bwd(const void* g, const void* code, void* dx, long long b, int h,
               int w, int c, int route, cudaStream_t s) {
  const T* gp = static_cast<const T*>(g);
  const uint8_t* cp = static_cast<const uint8_t*>(code);
  T* dp = static_cast<T*>(dx);
  if (route == kRouteVec) {
    const VecDims d = vec_dims(h, w, c, sizeof(T) == 2);
    dim3 grid, block;
    vec_grid(b, d, &grid, &block);
    pool_bwd_vec<T><<<grid, block, 0, s>>>(gp, cp, dp, d);
  } else {
    const Dims d{h, w, c, h / 2, w / 2};
    const long long n_out = b * d.ho * d.wo * (long long)c;
    pool_bwd_scalar<T><<<blocks_for(n_out), kThreads, 0, s>>>(gp, cp, dp,
                                                               n_out, d);
  }
  return (int)cudaGetLastError();
}

bool route_ok(int route, const void* data0, const void* data1,
              const void* code, long long b, int h, int w, int c,
              int is_bf16) {
  return route == kRouteScalar ||
         (route == kRouteVec &&
          vec_ok(data0, data1, code, b, h, w, c, is_bf16));
}

}  // namespace

// x: (b, h, w, c) float32 or bfloat16 (is_bf16), contiguous, h, w >= 2.
// val: (b, h/2, w/2, c) same dtype; code: (b, h/2, w/2, c) uint8.
// route: 0 scalar, 1 vec (refused with cudaErrorInvalidValue where the
// vec route does not take the tensors).
extern "C" int clsurvey_pool_fwd_route(const void* x, void* val, void* code,
                                       long long b, int h, int w, int c,
                                       int is_bf16, int route,
                                       void* stream) {
  if (!route_ok(route, x, val, code, b, h, w, c, is_bf16))
    return (int)cudaErrorInvalidValue;
  if (b * (h / 2) * (w / 2) * (long long)c == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16
             ? launch_fwd<__nv_bfloat16>(x, val, code, b, h, w, c, route, s)
             : launch_fwd<float>(x, val, code, b, h, w, c, route, s);
}

// g: (b, h/2, w/2, c) cotangent, contiguous; code from the forward.
// dx: (b, h, w, c) same dtype as g; every element is written.
extern "C" int clsurvey_pool_bwd_route(const void* g, const void* code,
                                       void* dx, long long b, int h, int w,
                                       int c, int is_bf16, int route,
                                       void* stream) {
  if (!route_ok(route, g, dx, code, b, h, w, c, is_bf16))
    return (int)cudaErrorInvalidValue;
  if (b * (h / 2) * (w / 2) * (long long)c == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16
             ? launch_bwd<__nv_bfloat16>(g, code, dx, b, h, w, c, route, s)
             : launch_bwd<float>(g, code, dx, b, h, w, c, route, s);
}

// The entry points of the first design, unchanged in signature and
// result: the scalar route, which takes any C and alignment. The port's
// wrappers call the _route entries above.
extern "C" int clsurvey_pool_fwd(const void* x, void* val, void* code,
                                 long long b, int h, int w, int c,
                                 int is_bf16, void* stream) {
  return clsurvey_pool_fwd_route(x, val, code, b, h, w, c, is_bf16,
                                 kRouteScalar, stream);
}

extern "C" int clsurvey_pool_bwd(const void* g, const void* code, void* dx,
                                 long long b, int h, int w, int c,
                                 int is_bf16, void* stream) {
  return clsurvey_pool_bwd_route(g, code, dx, b, h, w, c, is_bf16,
                                 kRouteScalar, stream);
}
