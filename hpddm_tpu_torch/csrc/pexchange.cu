// General additive exchange for Hopper (sm_90a): for every local dof (s, i)
// of a batch x of shape (S, n, mu),
//
//     p = slot[s, i]
//     y[s, i, m] = x[s, i, m]                                  if p < 0
//     y[s, i, m] = x[s, i, m] + (x[r_0, m] + x[r_1, m] + ...)  otherwise,
//
// where r_k = rows[s, p, k] is the flat row (q * n + if_idx[q, j]) of the
// k-th other copy of interface slot (s, p), and a row of -1 (no partner)
// adds +0. Every copy of a shared dof ends up holding the sum of all
// copies; interior dofs pass through.
//
// Replaces the TPU kernel hpddm_tpu/parallel/pexchange.py:149 `_pexchange`,
// three pallas_calls (k_extract: gather the interface values; k_reduce:
// gather the partner copies; k_merge: write the sums back) with an XLA sum
// between them. Their 128-lane tiles and per-tile select loops stand in for
// the gather the TPU lacks. Here one launch does all of it: one thread per
// dof, grid (ceil(n / 256), S), the right-hand sides looped inside; the
// plan (`build_plan` in parallel/pexchange.py) turns each slot's partner list into
// flat rows of x once, so no intermediate array exists.
//
// Bound: device-memory bandwidth. One call reads x and writes y once
// (S*n*mu*itemsize each), reads the slot map (S*n*4 bytes) and the partner
// rows (S*m_max*k_max*4 bytes); the partner values are rows of x that the
// caches already hold. It does k_max adds per interface dof and
// right-hand side.
//
// The partner sum runs in the order of the plain version (acc = p_0, then
// acc += p_k, then x + acc) with separately rounded adds, so the kernel
// equals both `pexchange_reference` and the port's plain `exchange`
// (parallel/ops.py) bitwise on the same device. y must not alias x.
//
// Plain C interface (built with nvcc into a shared library, loaded with
// ctypes): launches on the given stream, allocates nothing, synchronises
// nothing, and returns the launch's cudaError_t.

#include <cuda_runtime.h>

#define PEX_BLOCK 256

__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }

template <typename T>
__global__ void __launch_bounds__(PEX_BLOCK)
pexchange_kernel(const T* __restrict__ x, T* __restrict__ y,
                 const int* __restrict__ slot, const int* __restrict__ rows,
                 int n, int m_max, int k_max, int mu) {
  const int i = blockIdx.x * PEX_BLOCK + threadIdx.x;
  if (i >= n) return;
  const long long row = (long long)blockIdx.y * n + i;
  const T* xr = x + row * mu;
  T* yr = y + row * mu;
  const int p = slot[row];
  if (p < 0) {
    for (int m = 0; m < mu; ++m) yr[m] = xr[m];
    return;
  }
  const int* pr = rows + ((long long)blockIdx.y * m_max + p) * k_max;
  for (int m = 0; m < mu; ++m) {
    int r = pr[0];
    T acc = r >= 0 ? x[(long long)r * mu + m] : T(0);
    for (int k = 1; k < k_max; ++k) {
      r = pr[k];
      acc = add_rn(acc, r >= 0 ? x[(long long)r * mu + m] : T(0));
    }
    yr[m] = add_rn(xr[m], acc);
  }
}

template <typename T>
static int launch(const T* x, T* y, const int* slot, const int* rows, int S,
                  int n, int m_max, int k_max, int mu, void* stream) {
  if (S <= 0 || n <= 0 || mu <= 0) return 0;
  if (k_max < 1 || m_max < 1 || S > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)((n + PEX_BLOCK - 1) / PEX_BLOCK), (unsigned)S);
  pexchange_kernel<T><<<grid, PEX_BLOCK, 0, (cudaStream_t)stream>>>(
      x, y, slot, rows, n, m_max, k_max, mu);
  return (int)cudaGetLastError();
}

extern "C" {

int pexchange_f32(const float* x, float* y, const int* slot, const int* rows,
                  int S, int n, int m_max, int k_max, int mu, void* stream) {
  return launch<float>(x, y, slot, rows, S, n, m_max, k_max, mu, stream);
}

int pexchange_f64(const double* x, double* y, const int* slot,
                  const int* rows, int S, int n, int m_max, int k_max, int mu,
                  void* stream) {
  return launch<double>(x, y, slot, rows, S, n, m_max, k_max, mu, stream);
}

}  // extern "C"
