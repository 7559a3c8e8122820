// Batched DIA SpMM for Hopper (sm_90a), a panel of mu right-hand sides:
//
//     y[s, i, m] = sum_k vals[s, k, i] * x[s, i + off_k, m],   x read as 0 outside [0, n)
//
// Replaces the TPU kernels hpddm_tpu/ops/pallas_spmv.py:167
// `_dia_spmv_blocked_mu` (B2, the RHS panel of the solver's products and of
// the coarse assembly) and :253 `_dia_spmv_blocked_muT` (B3, the same
// function with the RHS axis leading). x and y are read through their
// element strides along n (sn) and along mu (sm), so one kernel serves both
// layouts: (S, n, mu) has sn = mu, sm = 1 (B2); (S, mu, n) has sn = 1,
// sm = n (B3). Subdomain s starts at s * n * mu in both.
//
// Bound: device-memory bandwidth. One call moves S * n * (nd + 2 * mu) *
// itemsize bytes (every value plane once, x once, y once) and does
// 2 * nd * mu flops per row. At the card-scale cell (S=64, nd=5, n=4356,
// f64) that is 29.0 MB (8.65 us at 3.35 TB/s) at mu=4 and 2.87 GB (855 us)
// at the coarse panel mu=640, far below the card's flops-per-byte balance.
// Amortizing the value stream over mu is the kernel's whole point:
//   * one thread per row, grid (ceil(n / 256), S); the right-hand sides are
//     walked in tiles of DIA_MU_TILE accumulators held in registers, so
//     each tile reads a row's nd values once for DIA_MU_TILE right-hand
//     sides (the planes of a block, 256 * nd values, stay in L1 across the
//     tiles);
//   * the offsets are known on the host and passed by value in a small
//     struct (kernel parameter space), as in dia_spmv.cu;
//   * in the (S, n, mu) layout a thread reads DIA_MU_TILE consecutive x
//     values of its row: a warp's loads at one tile slot are strided by mu,
//     and the tile's other slots hit the same lines in L1. In the
//     (S, mu, n) layout the warp's loads are consecutive for every slot.
//
// The sum runs in the diagonal order with separately rounded multiply and
// add (no FMA contraction), the arithmetic of the plain PyTorch version
// (ops/dia_spmv.py `dia_spmv_reference`), so the two agree to the bit on
// the same device.
//
// Plain C interface (built with nvcc into a shared library, loaded with
// ctypes): launches on the given stream, allocates nothing, synchronises
// nothing, and returns the launch's cudaError_t.

#include <cuda_runtime.h>

#define DIA_MAX_DIAGS 32
#define DIA_BLOCK 256
#define DIA_MU_TILE 8

struct DiaOffsets {
  int nd;
  int off[DIA_MAX_DIAGS];
};

__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }

template <typename T>
__global__ void __launch_bounds__(DIA_BLOCK)
dia_spmm_kernel(const T* __restrict__ vals, const T* __restrict__ x,
                T* __restrict__ y, int n, int mu, int sn, int sm,
                DiaOffsets offs) {
  const int i = blockIdx.x * DIA_BLOCK + threadIdx.x;
  if (i >= n) return;
  const long long s = blockIdx.y;
  const long long panel = (long long)n * mu;
  const T* xs = x + s * panel;
  T* ys = y + s * panel + (long long)i * sn;
  const T* vs = vals + s * (long long)offs.nd * n + i;
  for (int m0 = 0; m0 < mu; m0 += DIA_MU_TILE) {
    const int mt = min(DIA_MU_TILE, mu - m0);
    T acc[DIA_MU_TILE];
#pragma unroll
    for (int t = 0; t < DIA_MU_TILE; ++t) acc[t] = T(0);
    for (int k = 0; k < offs.nd; ++k) {
      const T v = vs[(long long)k * n];
      const int j = i + offs.off[k];
      const bool ok = j >= 0 && j < n;
      const T* xr = xs + (long long)(ok ? j : 0) * sn + (long long)m0 * sm;
#pragma unroll
      for (int t = 0; t < DIA_MU_TILE; ++t)
        if (t < mt)
          acc[t] = add_rn(acc[t], mul_rn(v, ok ? xr[(long long)t * sm] : T(0)));
    }
#pragma unroll
    for (int t = 0; t < DIA_MU_TILE; ++t)
      if (t < mt) ys[(long long)(m0 + t) * sm] = acc[t];
  }
}

template <typename T>
static int launch(const T* vals, const T* x, T* y, int S, int nd, int n,
                  int mu, int sn, int sm, const int* offsets, void* stream) {
  if (S <= 0 || n <= 0 || mu <= 0) return 0;
  if (nd < 0 || nd > DIA_MAX_DIAGS || S > 65535 || sn <= 0 || sm <= 0)
    return (int)cudaErrorInvalidValue;
  DiaOffsets offs;
  offs.nd = nd;
  for (int k = 0; k < DIA_MAX_DIAGS; ++k) offs.off[k] = k < nd ? offsets[k] : 0;
  const dim3 grid((unsigned)((n + DIA_BLOCK - 1) / DIA_BLOCK), (unsigned)S);
  dia_spmm_kernel<T><<<grid, DIA_BLOCK, 0, (cudaStream_t)stream>>>(
      vals, x, y, n, mu, sn, sm, offs);
  return (int)cudaGetLastError();
}

extern "C" {

int dia_spmm_f32(const float* vals, const float* x, float* y, int S, int nd,
                 int n, int mu, int sn, int sm, const int* offsets,
                 void* stream) {
  return launch<float>(vals, x, y, S, nd, n, mu, sn, sm, offsets, stream);
}

int dia_spmm_f64(const double* vals, const double* x, double* y, int S,
                 int nd, int n, int mu, int sn, int sm, const int* offsets,
                 void* stream) {
  return launch<double>(vals, x, y, S, nd, n, mu, sn, sm, offsets, stream);
}

}  // extern "C"
