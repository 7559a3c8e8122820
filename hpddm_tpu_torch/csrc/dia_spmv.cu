// Batched DIA SpMV for Hopper (sm_90a):
//
//     y[s, i] = sum_k vals[s, k, i] * x[s, i + off_k],   x read as 0 outside [0, n)
//
// Replaces the TPU kernel hpddm_tpu/ops/pallas_spmv.py:98 `_dia_spmv_blocked`
// (and computes the function of its whole-row twin `_dia_spmv_1rhs`, :37).
//
// Bound: device-memory bandwidth. One call moves S * n * (nd + 2) * itemsize
// bytes (every value plane once, x once, y once) and does 2 * nd flops per
// row, far below the card's flops-per-byte balance point. The design
// therefore only has to keep the streams coalesced:
//   * one thread per row, grid (ceil(n / 256), S): thread i of a warp reads
//     vals[s, k, i] and x[s, i + off_k] at consecutive addresses for every
//     diagonal k, so each plane and each shifted window of x is read in full
//     transactions; the nd shifted reads of x overlap and hit L1/L2;
//   * the offsets are known on the host and passed by value in a small
//     struct (kernel parameter space), so the diagonal loop reads no
//     offset array from device memory;
//   * no shared-memory staging: the TPU kernel's (rows, 128) lane roll and
//     select exist only for the TPU's vector-register layout.
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
dia_spmv_kernel(const T* __restrict__ vals, const T* __restrict__ x,
                T* __restrict__ y, int n, DiaOffsets offs) {
  const long long i = (long long)blockIdx.x * DIA_BLOCK + threadIdx.x;
  if (i >= n) return;
  const long long s = blockIdx.y;
  const T* xs = x + s * n;
  const T* vs = vals + s * (long long)offs.nd * n;
  T acc = T(0);
#pragma unroll 4
  for (int k = 0; k < offs.nd; ++k) {
    const long long j = i + offs.off[k];
    const T xv = (j >= 0 && j < n) ? xs[j] : T(0);
    acc = add_rn(acc, mul_rn(vs[(long long)k * n + i], xv));
  }
  y[s * n + i] = acc;
}

template <typename T>
static int launch(const T* vals, const T* x, T* y, int S, int nd, int n,
                  const int* offsets, void* stream) {
  if (S <= 0 || n <= 0) return 0;
  if (nd < 0 || nd > DIA_MAX_DIAGS || S > 65535) return (int)cudaErrorInvalidValue;
  DiaOffsets offs;
  offs.nd = nd;
  for (int k = 0; k < DIA_MAX_DIAGS; ++k) offs.off[k] = k < nd ? offsets[k] : 0;
  const dim3 grid((unsigned)((n + DIA_BLOCK - 1) / DIA_BLOCK), (unsigned)S);
  dia_spmv_kernel<T><<<grid, DIA_BLOCK, 0, (cudaStream_t)stream>>>(vals, x, y, n, offs);
  return (int)cudaGetLastError();
}

extern "C" {

int dia_spmv_f32(const float* vals, const float* x, float* y, int S, int nd,
                 int n, const int* offsets, void* stream) {
  return launch<float>(vals, x, y, S, nd, n, offsets, stream);
}

int dia_spmv_f64(const double* vals, const double* x, double* y, int S,
                 int nd, int n, const int* offsets, void* stream) {
  return launch<double>(vals, x, y, S, nd, n, offsets, stream);
}

}  // extern "C"
