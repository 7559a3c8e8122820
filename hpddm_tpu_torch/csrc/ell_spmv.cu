// Batched ELL SpMM for Hopper (sm_90a):
//
//     y[s, i, m] = sum_j vals[s, j, i] * x[s, cols[s, j, i], m]
//
// for a slot-major ELL batch (vals and cols of shape (S, w, n): plane j
// holds the j-th stored entry of every row) and x, y of shape (S, n, mu).
//
// Replaces the TPU kernel hpddm_tpu/ops/pallas_ell.py:133 `_windowed_spmv`
// (the band-ELL SpMV of the unstructured path). That kernel's 128-lane x
// windows, its QT/QH tiling and its per-tile select loop exist only because
// the TPU has no fast gather; Hopper gathers through L1/L2, and one
// subdomain's x (4640 f64 values = 37 KB at the card-scale cell) stays
// cache-resident while its rows are processed. So the design is plain:
//   * one thread per row, grid (ceil(n / 256), S); the slot planes are
//     read at consecutive addresses by the threads of a warp (coalesced),
//     and the gathers of x hit the caches (RCM-banded local numbering
//     keeps a warp's columns within a few hundred entries);
//   * several right-hand sides are handled inside the launch, in tiles of
//     ELL_MU_TILE accumulators held in registers, so each tile reads the
//     value and column planes once (the coarse assembly sends panels of
//     hundreds of columns through the same kernel).
//
// Bound: device-memory bandwidth. One call moves S*n*w*(itemsize + 4)
// bytes of values and columns plus S*n*mu*itemsize each for x and y, and
// does 2*w flops per row and right-hand side. At the card-scale cell
// (S=64, n=4640, w=11, f64, mu=1): 64*4640*11*(8+4) + 2*64*4640*8 =
// 43.95 MB, about 13.1 us at 3.35 TB/s.
//
// The sum runs over the slots in storage order, starting from zero, with
// separately rounded multiply and add (no FMA contraction): the arithmetic
// of the plain PyTorch version (ops/ell_spmv.py `ell_spmv_reference`), so
// the two agree to the bit on the same device. A column outside [0, n),
// which the packer never emits, reads x as 0 instead of faulting.
//
// Plain C interface (built with nvcc into a shared library, loaded with
// ctypes): launches on the given stream, allocates nothing, synchronises
// nothing, and returns the launch's cudaError_t.

#include <cuda_runtime.h>

#define ELL_BLOCK 256
#define ELL_MU_TILE 8

__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }

template <typename T>
__global__ void __launch_bounds__(ELL_BLOCK)
ell_spmv_kernel(const T* __restrict__ vals, const int* __restrict__ cols,
                const T* __restrict__ x, T* __restrict__ y, int n, int w,
                int mu) {
  const int i = blockIdx.x * ELL_BLOCK + threadIdx.x;
  if (i >= n) return;
  const long long s = blockIdx.y;
  const long long plane = (long long)w * n;
  const T* vs = vals + s * plane + i;
  const int* cs = cols + s * plane + i;
  const T* xs = x + s * (long long)n * mu;
  T* yr = y + (s * n + i) * (long long)mu;
  if (mu == 1) {
    T acc = T(0);
    for (int j = 0; j < w; ++j) {
      const int c = cs[(long long)j * n];
      const T xv = (unsigned)c < (unsigned)n ? xs[c] : T(0);
      acc = add_rn(acc, mul_rn(vs[(long long)j * n], xv));
    }
    yr[0] = acc;
    return;
  }
  for (int m0 = 0; m0 < mu; m0 += ELL_MU_TILE) {
    const int mt = min(ELL_MU_TILE, mu - m0);
    T acc[ELL_MU_TILE];
#pragma unroll
    for (int t = 0; t < ELL_MU_TILE; ++t) acc[t] = T(0);
    for (int j = 0; j < w; ++j) {
      const int c = cs[(long long)j * n];
      const T v = vs[(long long)j * n];
      const bool ok = (unsigned)c < (unsigned)n;
      const T* xr = xs + (long long)(ok ? c : 0) * mu + m0;
#pragma unroll
      for (int t = 0; t < ELL_MU_TILE; ++t)
        if (t < mt) acc[t] = add_rn(acc[t], mul_rn(v, ok ? xr[t] : T(0)));
    }
#pragma unroll
    for (int t = 0; t < ELL_MU_TILE; ++t)
      if (t < mt) yr[m0 + t] = acc[t];
  }
}

template <typename T>
static int launch(const T* vals, const int* cols, const T* x, T* y, int S,
                  int n, int w, int mu, void* stream) {
  if (S <= 0 || n <= 0 || mu <= 0) return 0;
  if (w < 0 || S > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)((n + ELL_BLOCK - 1) / ELL_BLOCK), (unsigned)S);
  ell_spmv_kernel<T><<<grid, ELL_BLOCK, 0, (cudaStream_t)stream>>>(
      vals, cols, x, y, n, w, mu);
  return (int)cudaGetLastError();
}

extern "C" {

int ell_spmv_f32(const float* vals, const int* cols, const float* x, float* y,
                 int S, int n, int w, int mu, void* stream) {
  return launch<float>(vals, cols, x, y, S, n, w, mu, stream);
}

int ell_spmv_f64(const double* vals, const int* cols, const double* x,
                 double* y, int S, int n, int w, int mu, void* stream) {
  return launch<double>(vals, cols, x, y, S, n, w, mu, stream);
}

}  // extern "C"
