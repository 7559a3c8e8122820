// Batched DIA SpMV and SpMM for Hopper (sm_90a):
//
//     y[s, i, m] = sum_k vals[s, k, i] * x[s, i + off_k, m],   x read as 0 outside [0, n)
//
// for vals (S, nd, n) in f32 or f64 and a panel x of mu right-hand sides.
// Replaces three TPU kernels of hpddm_tpu/ops/pallas_spmv.py:
//   * B1 :98  `_dia_spmv_blocked` (and its whole-row twin `_dia_spmv_1rhs`,
//     :37): one right-hand side, x (S, n); entry points dia_spmv_*;
//   * B2 :167 `_dia_spmv_blocked_mu`: the port's panel x (S, n, mu), the
//     right-hand sides contiguous; entry points dia_spmm_* (mu_leading 0);
//   * B3 :253 `_dia_spmv_blocked_muT`: x (S, mu, n), the rows contiguous;
//     dia_spmm_* (mu_leading 1). B1 is this layout at mu = 1.
//
// Bound: device-memory bandwidth. A call moves S * n * (nd + 2 * mu) *
// itemsize bytes (every value plane, x and y once) and does 2 * nd * mu
// flops per row, far below the card's flops-per-byte balance. At the grid
// card cell (S=64, nd=5, n=4356, f64) that is 15.6 MB (4.66 us at 3.35
// TB/s) for B1, 29.0 MB (8.65 us) at mu=4 and 2.87 GB (855 us) at the
// coarse panel mu=640.
//
// The first design ran one thread per row on a grid of
// (ceil(n / 256), S) blocks, B2/B3 walking the right-hand sides in register
// tiles of 8 with x and y read through run-time strides. On an H100 80GB
// HBM3 at 700 W, f64, L2 flushed, it took 13.47 us for B1 (34.6% of the
// bound), 25.44 us for B2 at mu=4 (34.0%), 7028 us for B2 at mu=640 (12.2%,
// 3.0x slower than torch.sparse.mm) and 2323 us for B3 at mu=640 (36.8%).
// What held it back: 1,152 blocks are 1.1-1.5 waves of the card, so the
// last blocks ran alone, and at mu=640 each block walked all 80 tiles; in
// the (S, n, mu) layout a warp's loads and stores touched 32 rows mu * 8
// bytes apart (408 GB/s at mu=640); B1 had one 8-byte load per diagonal in
// flight per thread, a run-time diagonal loop and a bounds check on every
// load.
//
// This design:
//   * units ordered so that consecutive threads take consecutive addresses
//     in the contiguous axis: in the (S, mu, n) layout a unit is V rows of
//     CH = 2 right-hand sides (rows fastest), in the (S, n, mu) layout V
//     right-hand sides of one row (right-hand sides fastest: a warp covers
//     16 rows x 4 right-hand sides at mu=4, 64 right-hand sides of one row
//     at mu=640, 512 contiguous bytes per load or store in f64). A row's
//     value is read there by the threads that share the row, as a
//     broadcast. The units in flight cover a window of consecutive rows, so
//     the rows of x that the outer diagonals read again are still in L2;
//   * B1 and B2 walk their units grid-stride on at most one wave of the
//     card (the SM count times the kernel's resident blocks per SM, queried
//     once per kernel), each thread taking the same number of units to
//     within one; B3 launches one short block per 512 units, which measured
//     faster for it (1215 against 1669 us at mu=640 for one wave of 256);
//   * V = 16 bytes / itemsize elements per unit where the contiguous axis's
//     length and the pointers allow 16-byte loads and stores (double2,
//     float4), one element per unit otherwise;
//   * the layout is a template parameter (two kernels, one source), and so
//     is the diagonal count the port meets (5, the 2D 5-point stencil): its
//     loop is unrolled and every load of a unit is issued before its sums;
//     other counts take a run-time loop;
//   * a unit whose window [i0 + min_off, i0 + V - 1 + max_off] lies inside
//     [0, n) reads x without bounds checks; only units at the edges check;
//   * values that a call reads once (B1's planes, B2's for mu <= 64 in f64)
//     are loaded evict-first (ld.global.cs), so that they do not push x out
//     of L2; x itself is not (its reuse by the outer diagonals is in L2:
//     evict-first x made B2 at mu=640 2.5x slower).
//   x is not staged in shared memory: the diagonals' reads of x overlap in
//   L1 and L2.
//
// Measured (chip_smoke.py and examples/bench_dia.py, same card, f64, L2
// flushed by a write): B1 11.92-12.91 us, B2 17.38-18.11 us at mu=4 and
// 1115-1176 us at mu=640 (73-77% of the bound, 0.47-0.50 of
// torch.sparse.mm's time), B3 1120-1132 us at mu=640 (1189-1249 us with
// 256-thread blocks). In the same bracket a kernel that writes one element
// takes 4.9-5.2 us and a copy moving B1's 15.6 MB 13.6-14.5 us: B1 and B2
// at mu=4 are at the floor of the measurement, not of the bandwidth.
//
// Every output's sum runs in the diagonal order from zero with separately
// rounded multiply and add (no FMA contraction), the arithmetic of the plain
// PyTorch version (ops/dia_spmv.py `dia_spmv_reference`): the two agree to
// the bit on the same device. No sum over k is split across threads.
//
// Complex128 (B1 and B2; B3 has no complex form): T is a 16-byte-aligned
// pair of doubles, so a unit is one entry, one 16-byte load (V = 1), and
// the 5-diagonal unrolled loop applies to the native Helmholtz operator.
// mul_rn and add_rn (kernel_util.cuh) write the complex product and sum in
// real operations, each rounded once: the plain version's explicit form
// (ops/dia_spmv.py `_complex_reference`), so the two agree to the bit too.
// Bound: S * n * (nd + 2 * mu) * 16 bytes and 8 * nd * mu real flops a row.
//
// Plain C interface (built with nvcc into a shared library, loaded with
// ctypes): launches on the given stream, allocates nothing, synchronises
// nothing, and returns the launch's cudaError_t. Limits: nd <= 32 and
// n * mu < 2^31 (one subdomain's x); a call with S * n * mu >= 2^31 launches
// once per batch of subdomains.

#include "kernel_util.cuh"

#define DIA_MAX_DIAGS 32
#define DIA_FIXED_ND 5   // the diagonal count with an unrolled loop

// threads per block: 256, and 512 for the (S, mu, n) kernel's chunks of
// right-hand sides (B3), which measured faster there (1120-1122 against
// 1189-1192 us at mu=640) and the same elsewhere
__host__ __device__ constexpr int block_threads(int ch) {
  return ch == 1 ? 256 : 512;
}
constexpr int kRhsBlock = 256;
constexpr int kRhsChunk = 2;   // right-hand sides per unit, (S, mu, n) layout

struct DiaOffsets {
  int nd, lo, hi;            // count, least and largest offset
  int off[DIA_MAX_DIAGS];
};

// Rows contiguous, x and y (S, mu, n) (B1 at mu = 1, B3): a unit is rows
// [i0, i0 + V) of right-hand sides [m0, m0 + CH) of subdomain s, units
// numbered row group fastest, then right-hand-side chunk, then subdomain.
// V > 1 only where n % V == 0 and the pointers are 16-byte aligned, so a
// value plane's run and y's run are one aligned vector, and x's run is one
// where the offset is a multiple of V. B1 (CH = 1) reads each value once:
// evict-first.
template <typename T, int ND, int V, int CH>
__global__ void __launch_bounds__(block_threads(CH))
dia_rows_kernel(const T* __restrict__ vals, const T* __restrict__ x,
                T* __restrict__ y, int n, int mu, unsigned units,
                FastDiv groups, FastDiv chunks, DiaOffsets offs) {
  constexpr unsigned B = block_threads(CH);
  const int nd = ND > 0 ? ND : offs.nd;
  for (unsigned q = blockIdx.x * B + threadIdx.x; q < units;
       q += gridDim.x * B) {
    const unsigned t = divide(q, groups);
    const int i0 = (int)(q - t * groups.d) * V;
    unsigned s = t;
    int m0 = 0;
    if constexpr (CH > 1) {
      s = divide(t, chunks);
      m0 = (int)(t - s * chunks.d) * CH;
    }
    const int mt = min(CH, mu - m0);
    const T* vs = vals + (size_t)s * nd * n + i0;
    const T* xs = x + ((size_t)s * mu + m0) * n;
    // i0 + lo >= 0 and i0 + V - 1 + hi < n, without overflow (n - i0 >= V)
    const bool inside = offs.lo >= -i0 && offs.hi < n - i0 - (V - 1);
    T acc[CH][V];
#pragma unroll
    for (int c = 0; c < CH; ++c)
#pragma unroll
      for (int r = 0; r < V; ++r) acc[c][r] = T(0);
#pragma unroll
    for (int k = 0; k < nd; ++k) {
      T v[V];
      load_run<T, V, CH == 1>(vs + (size_t)k * n, v);
      // x's row index; below 0 it wraps to 2^32 + j >= n
      const unsigned j = (unsigned)i0 + (unsigned)offs.off[k];
#pragma unroll
      for (int c = 0; c < CH; ++c) {
        if (c >= mt) break;
        const T* xr = xs + (size_t)c * n;
        T xv[V];
        if (inside) {
          if ((j & (V - 1)) == 0)
            load_run<T, V>(xr + j, xv);
          else
            load_run<T, V, false, false>(xr + j, xv);
        } else {
#pragma unroll
          for (int r = 0; r < V; ++r)
            xv[r] = j + r < (unsigned)n ? xr[j + r] : T(0);
        }
#pragma unroll
        for (int r = 0; r < V; ++r)
          acc[c][r] = add_rn(acc[c][r], mul_rn(v[r], xv[r]));
      }
    }
    T* ys = y + ((size_t)s * mu + m0) * n + i0;
#pragma unroll
    for (int c = 0; c < CH; ++c)
      if (c < mt) store_run<T, V>(ys + (size_t)c * n, acc[c]);
  }
}

// Right-hand sides contiguous, x and y (S, n, mu) (B2): a unit is the V
// right-hand sides [m, m + V) of row i of subdomain s, units numbered in
// memory order. V > 1 only where mu % V == 0 and the pointers are 16-byte
// aligned.
template <typename T, int ND, int V>
__global__ void __launch_bounds__(kRhsBlock)
dia_rhs_kernel(const T* __restrict__ vals, const T* __restrict__ x,
               T* __restrict__ y, int n, int mu, unsigned units,
               FastDiv panel, FastDiv row, bool stream_vals, DiaOffsets offs) {
  const int nd = ND > 0 ? ND : offs.nd;
  for (unsigned q = blockIdx.x * kRhsBlock + threadIdx.x; q < units;
       q += gridDim.x * kRhsBlock) {
    const unsigned s = divide(q, panel);
    const unsigned r = q - s * panel.d;
    const unsigned iu = divide(r, row);
    const int i = (int)iu;
    const int m = (int)(r - iu * row.d) * V;
    const T* vs = vals + (size_t)s * nd * n + i;
    const T* xs = x + (size_t)s * n * mu + m;
    const bool inside = offs.lo >= -i && offs.hi < n - i;
    T acc[V];
#pragma unroll
    for (int e = 0; e < V; ++e) acc[e] = T(0);
#pragma unroll
    for (int k = 0; k < nd; ++k) {
      const T v = load_one(vs + (size_t)k * n, stream_vals);
      const unsigned j = (unsigned)i + (unsigned)offs.off[k];
      T xv[V];
      if (inside || j < (unsigned)n) {
        load_run<T, V>(xs + (size_t)j * mu, xv);
      } else {
#pragma unroll
        for (int e = 0; e < V; ++e) xv[e] = T(0);
      }
#pragma unroll
      for (int e = 0; e < V; ++e) acc[e] = add_rn(acc[e], mul_rn(v, xv[e]));
    }
    store_run<T, V>(y + ((size_t)s * n + i) * mu + m, acc);
  }
}

// the offsets clamped to [-n, n] (a diagonal at |offset| >= n reads only
// zeros either way)
static bool pack_offsets(int nd, const int* offsets, int n, DiaOffsets* offs) {
  if (nd < 0 || nd > DIA_MAX_DIAGS) return false;
  offs->nd = nd;
  offs->lo = offs->hi = 0;
  for (int k = 0; k < DIA_MAX_DIAGS; ++k) {
    const int o = k < nd ? offsets[k] : 0;
    offs->off[k] = o < -n ? -n : (o > n ? n : o);
  }
  for (int k = 0; k < nd; ++k) {
    if (k == 0 || offs->off[k] < offs->lo) offs->lo = offs->off[k];
    if (k == 0 || offs->off[k] > offs->hi) offs->hi = offs->off[k];
  }
  return true;
}

// A unit's index is 32-bit, so a launch takes fewer than 2^31 elements of x:
// the subdomains go in batches of `batch` (all of them in one launch unless
// S * n * mu >= 2^31). Offsetting by whole subdomains keeps the alignment
// that chose V.
template <typename T, int ND, int V, int CH>
static int launch_rows(const T* vals, const T* x, T* y, int S, int nd, int n,
                       int mu, int batch, const DiaOffsets& offs,
                       cudaStream_t stream) {
  constexpr int B = block_threads(CH);
  const unsigned groups = (unsigned)(n / V), chunks = (unsigned)((mu + CH - 1) / CH);
  const void* kernel = (const void*)dia_rows_kernel<T, ND, V, CH>;
  for (int s0 = 0; s0 < S; s0 += batch) {
    const int sb = S - s0 < batch ? S - s0 : batch;
    const unsigned units = (unsigned)((unsigned long long)sb * chunks * groups);
    // B1 walks on at most one wave; B3 runs one short block per B units
    dia_rows_kernel<T, ND, V, CH><<<grid_for(kernel, B, units, CH == 1), B, 0, stream>>>(
        vals + (size_t)s0 * nd * n, x + (size_t)s0 * mu * n,
        y + (size_t)s0 * mu * n, n, mu, units, fast_div(groups),
        fast_div(chunks), offs);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

template <typename T, int ND, int V>
static int launch_rhs(const T* vals, const T* x, T* y, int S, int nd, int n,
                      int mu, int batch, const DiaOffsets& offs,
                      cudaStream_t stream) {
  const unsigned row = (unsigned)(mu / V), panel = (unsigned)n * row;
  const void* kernel = (const void*)dia_rhs_kernel<T, ND, V>;
  // a row's value is read by its mu / V units: streamed where they share a warp
  const bool stream_vals = row <= 32;
  for (int s0 = 0; s0 < S; s0 += batch) {
    const int sb = S - s0 < batch ? S - s0 : batch;
    const unsigned units = (unsigned)((unsigned long long)sb * panel);
    dia_rhs_kernel<T, ND, V><<<grid_for(kernel, kRhsBlock, units, true), kRhsBlock, 0, stream>>>(
        vals + (size_t)s0 * nd * n, x + (size_t)s0 * n * mu,
        y + (size_t)s0 * n * mu, n, mu, units, fast_div(panel), fast_div(row),
        stream_vals, offs);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

// picks the kernel for the layout, the diagonal count and the alignment
template <typename T>
static int launch(const T* vals, const T* x, T* y, int S, int nd, int n,
                  int mu, bool mu_leading, const int* offsets, void* stream) {
  DiaOffsets offs;
  if (S < 0 || n < 0 || mu < 0 || !pack_offsets(nd, offsets, n, &offs))
    return (int)cudaErrorInvalidValue;
  if ((long long)n * mu >= (1ll << 31)) return (int)cudaErrorInvalidValue;
  if (S == 0 || n == 0 || mu == 0) return 0;
  const long long fit = ((1ll << 31) - 1) / ((long long)n * mu);
  const int batch = fit < S ? (int)fit : S;
  constexpr int W = 16 / sizeof(T);
  const bool fixed = nd == DIA_FIXED_ND;
  const cudaStream_t st = (cudaStream_t)stream;
#define DIA_ARGS vals, x, y, S, nd, n, mu, batch, offs, st
  if (mu_leading) {       // (S, mu, n): rows contiguous
    const bool vec = n % W == 0 && aligned16(vals) && aligned16(x) && aligned16(y);
    if (mu == 1) {
      if (vec) return fixed ? launch_rows<T, DIA_FIXED_ND, W, 1>(DIA_ARGS)
                            : launch_rows<T, 0, W, 1>(DIA_ARGS);
      return fixed ? launch_rows<T, DIA_FIXED_ND, 1, 1>(DIA_ARGS)
                   : launch_rows<T, 0, 1, 1>(DIA_ARGS);
    }
    if constexpr (sizeof(T) == 16) {
      return (int)cudaErrorInvalidValue;   // B3 has no complex form
    } else {
      if (vec) return fixed ? launch_rows<T, DIA_FIXED_ND, W, kRhsChunk>(DIA_ARGS)
                            : launch_rows<T, 0, W, kRhsChunk>(DIA_ARGS);
      return fixed ? launch_rows<T, DIA_FIXED_ND, 1, kRhsChunk>(DIA_ARGS)
                   : launch_rows<T, 0, 1, kRhsChunk>(DIA_ARGS);
    }
  }
  // (S, n, mu): right-hand sides contiguous
  const bool vec = mu % W == 0 && aligned16(x) && aligned16(y);
  if (vec) return fixed ? launch_rhs<T, DIA_FIXED_ND, W>(DIA_ARGS)
                        : launch_rhs<T, 0, W>(DIA_ARGS);
  return fixed ? launch_rhs<T, DIA_FIXED_ND, 1>(DIA_ARGS)
               : launch_rhs<T, 0, 1>(DIA_ARGS);
#undef DIA_ARGS
}

extern "C" {

// B1: y (S, n) = vals (S, nd, n) applied to x (S, n)
int dia_spmv_f32(const float* vals, const float* x, float* y, int S, int nd,
                 int n, const int* offsets, void* stream) {
  return launch<float>(vals, x, y, S, nd, n, 1, true, offsets, stream);
}

int dia_spmv_f64(const double* vals, const double* x, double* y, int S,
                 int nd, int n, const int* offsets, void* stream) {
  return launch<double>(vals, x, y, S, nd, n, 1, true, offsets, stream);
}

// B2 (mu_leading 0): x, y (S, n, mu); B3 (mu_leading 1): x, y (S, mu, n)
int dia_spmm_f32(const float* vals, const float* x, float* y, int S, int nd,
                 int n, int mu, int mu_leading, const int* offsets,
                 void* stream) {
  return launch<float>(vals, x, y, S, nd, n, mu, mu_leading != 0, offsets,
                       stream);
}

int dia_spmm_f64(const double* vals, const double* x, double* y, int S,
                 int nd, int n, int mu, int mu_leading, const int* offsets,
                 void* stream) {
  return launch<double>(vals, x, y, S, nd, n, mu, mu_leading != 0, offsets,
                        stream);
}

// complex128 (interleaved re, im; 16-byte aligned): B1, and B2 (mu_leading
// 0 only: B3 on complex is not instantiated)
int dia_spmv_c128(const Complex128* vals, const Complex128* x, Complex128* y,
                  int S, int nd, int n, const int* offsets, void* stream) {
  return launch<Complex128>(vals, x, y, S, nd, n, 1, true, offsets, stream);
}

int dia_spmm_c128(const Complex128* vals, const Complex128* x, Complex128* y,
                  int S, int nd, int n, int mu, int mu_leading,
                  const int* offsets, void* stream) {
  if (mu_leading != 0) return (int)cudaErrorInvalidValue;
  return launch<Complex128>(vals, x, y, S, nd, n, mu, false, offsets, stream);
}

}  // extern "C"
