// Helpers shared by the port's kernels (included by the csrc/*.cu sources;
// _build.py rebuilds every library when this header changes): separately
// rounded arithmetic, 16-byte runs of values, a division by a divisor known
// on the host, and the one-wave grid of a grid-stride walk.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>

// x / d for x, d < 2^31 by a multiply and a shift (the round-up method of
// Granlund and Montgomery), d known on the host
struct FastDiv {
  unsigned d, m, s;
};

static inline FastDiv fast_div(unsigned d) {
  FastDiv f;
  f.d = d;
  for (f.s = 0; f.s < 31; ++f.s)
    if ((1u << f.s) >= d) break;
  const uint64_t one = 1;
  f.m = (unsigned)(((one << 32) * ((one << f.s) - d)) / d + 1);
  return f;
}

__device__ __forceinline__ unsigned divide(unsigned x, const FastDiv& f) {
  return (__umulhi(x, f.m) + x) >> f.s;
}

// products and sums rounded separately: no FMA contraction, the plain
// PyTorch versions' arithmetic
__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }

// a complex double, 16-byte aligned, so that one entry is one 16-byte load
// (V = 1 in the units of load_run and store_run)
struct __align__(16) Complex128 {
  double re, im;
  __host__ __device__ Complex128(double r = 0.0, double i = 0.0) : re(r), im(i) {}
};

// the complex product and sum in real operations, each rounded once:
// (ar br - ai bi) + i (ar bi + ai br), the order of the plain PyTorch
// version (ops/dia_spmv.py `_complex_reference`)
__device__ __forceinline__ Complex128 mul_rn(Complex128 a, Complex128 b) {
  return Complex128(__dsub_rn(__dmul_rn(a.re, b.re), __dmul_rn(a.im, b.im)),
                    __dadd_rn(__dmul_rn(a.re, b.im), __dmul_rn(a.im, b.re)));
}
__device__ __forceinline__ Complex128 add_rn(Complex128 a, Complex128 b) {
  return Complex128(__dadd_rn(a.re, b.re), __dadd_rn(a.im, b.im));
}

template <typename T> struct Vec16;
template <> struct Vec16<float> { typedef float4 type; };
template <> struct Vec16<double> { typedef double2 type; };
template <> struct Vec16<Complex128> { typedef double2 type; };

// one value at p, evict-first where STREAM
template <typename T>
__device__ __forceinline__ T load_one(const T* __restrict__ p, bool stream) {
  if constexpr (sizeof(T) == 16) {
    const double2 w = stream ? __ldcs(reinterpret_cast<const double2*>(p))
                             : *reinterpret_cast<const double2*>(p);
    return T(w.x, w.y);
  } else {
    return stream ? __ldcs(p) : *p;
  }
}

// V consecutive values at p: one 16-byte load when V values are 16 bytes
// and VEC (p aligned), else V loads; STREAM: evict-first
template <typename T, int V, bool STREAM = false, bool VEC = true>
__device__ __forceinline__ void load_run(const T* __restrict__ p, T (&v)[V]) {
  if constexpr (VEC && V * sizeof(T) == 16) {
    typedef typename Vec16<T>::type W;
    const W w = STREAM ? __ldcs(reinterpret_cast<const W*>(p))
                       : *reinterpret_cast<const W*>(p);
    const T* e = reinterpret_cast<const T*>(&w);
#pragma unroll
    for (int r = 0; r < V; ++r) v[r] = e[r];
  } else {
#pragma unroll
    for (int r = 0; r < V; ++r) v[r] = load_one(p + r, STREAM);
  }
}

template <typename T, int V>
__device__ __forceinline__ void store_run(T* __restrict__ p, const T (&v)[V]) {
  if constexpr (V * sizeof(T) == 16) {
    typedef typename Vec16<T>::type W;
    W w;
    T* e = reinterpret_cast<T*>(&w);
#pragma unroll
    for (int r = 0; r < V; ++r) e[r] = v[r];
    *reinterpret_cast<W*>(p) = w;
  } else {
#pragma unroll
    for (int r = 0; r < V; ++r) p[r] = v[r];
  }
}

// blocks of `kernel` (`threads` a block) resident on the whole card at once
// (SMs x blocks per SM), queried once per kernel
static inline int card_blocks(const void* kernel, int threads) {
  static std::mutex lock;
  static const void* keys[256];
  static int blocks[256];
  static int count = 0;
  std::lock_guard<std::mutex> guard(lock);
  for (int i = 0; i < count; ++i)
    if (keys[i] == kernel) return blocks[i];
  int dev = 0, sms = 0, per_sm = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads,
                                                    0) != cudaSuccess)
    return 0;
  const int b = sms * (per_sm > 0 ? per_sm : 1);
  if (count < 256) {
    keys[count] = kernel;
    blocks[count] = b;
    ++count;
  }
  return b;
}

// grid of a grid-stride walk over `units`: one unit per thread where the
// card holds them all at once (or where one_wave is false), else the card's
// resident blocks, trimmed so that every thread takes the same number of
// units to within one
static inline unsigned grid_for(const void* kernel, int threads,
                                unsigned units, bool one_wave) {
  const unsigned long long need = (units + threads - 1ull) / threads;
  const unsigned long long cap =
      one_wave ? (unsigned long long)card_blocks(kernel, threads) : 0;
  if (cap == 0 || need <= cap) return (unsigned)need;
  const unsigned long long per = (need + cap - 1) / cap;
  return (unsigned)((need + per - 1) / per);
}

static inline bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }
