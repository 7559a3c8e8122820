// Batched ELL SpMM for Hopper (sm_90a):
//
//     y[s, i, m] = sum_{j < cnt[s, i]} vals[s, j, i] * x[s, cols[s, j, i], m]
//
// for a slot-major ELL batch (vals and cols of shape (S, w, n): plane j
// holds the j-th stored entry of every row), each row's count of stored
// slots cnt (S, n) (all w where no counts are given), and x, y of shape
// (S, n, mu).
//
// Replaces the TPU kernel hpddm_tpu/ops/pallas_ell.py:133 `_windowed_spmv`
// (the band-ELL SpMV of the unstructured path). That kernel's 128-lane x
// windows, its QT/QH tiling and its per-tile select loop exist only because
// the TPU has no fast gather; Hopper gathers through L1/L2, and one
// subdomain's x (4640 f64 values = 37 KB at the card cell) stays in the
// caches while its rows are processed. Its payload (`annotate_windowed`,
// pallas_ell.py:70) has a counterpart here: ops/ell_spmv.py `build_payload`
// narrows the columns and counts each row's stored slots, once per batch.
//
// Bound: device-memory bandwidth (2 flops a nonzero and right-hand side).
// At the unstructured card cell (S=64, n=4640, w=11, 2,001,748 nonzeros,
// f64) the matrix's nonzeros with their columns at the width the payload
// stores (2 bytes) plus x and y are 24.77 MB at mu=1 (7.39 us at 3.35
// TB/s) and 3.06 GB at the coarse panel mu=640 (0.91 ms, x and y 1.52 GB
// each). The padded arrays that an ELL kernel reads are larger: 26.1 MB of
// values (61% filled) and 6.5 MB of uint16 columns.
//
// The first design (one thread per row on a grid of (ceil(n / 256), S)
// blocks, int32 columns, a run-time slot loop, right-hand sides in register
// tiles of 8) took 26.26 us at mu=1 on an H100 80GB HBM3 at 700 W, f64, L2
// flushed by a write (28.2% of the bound; it read 4-byte columns). What held it back: each thread
// ran a chain of 2w dependent loads (column, then x[column]) that the
// compiler could not issue ahead across the ordered sum; 1,216 blocks were
// 1.15 waves; it read every padding slot and 4-byte columns; at mu > 1
// each thread walked its row's value and column planes once per tile of 8
// right-hand sides, and a warp's loads and stores of x and y touched 32
// rows mu elements apart.
//
// This design:
//   * columns are uint16 where n <= 65,535 (int32 otherwise, a second
//     instantiation), and a row stops at its count: the sectors of value
//     and column planes past every row's count in them are not read, nor
//     the x rows of padding slots (at mu=640 the counts halve the time);
//   * mu == 1: a unit is one row; it loads the values and columns of up to
//     6 slots, then issues their 6 gathers of x, then sums them in slot
//     order, pass after pass (the pass width a template parameter): 6 loads
//     in flight per thread instead of one, at 64 registers, so 4 blocks of
//     256 threads stay resident on an SM. The first pass loads up to w,
//     not up to the count, so that its loads need not wait for the count.
//     A pass of 12 (w=11 in one pass) fits 3 blocks per SM at 80
//     registers and measured 1.4-1.6 us slower. Two rows a unit (16-byte
//     value loads) measured 1.5 us slower than one: the registers it takes
//     cost more resident threads than the wider loads save. The value and
//     column planes are read once, evict-first, so that they do not push x
//     out of L2;
//   * mu > 1: a unit is V right-hand sides of one row (16 bytes where mu
//     and the pointers allow), right-hand sides fastest, as B2's (S, n, mu)
//     kernel (csrc/dia_spmv.cu): a warp reads each gathered x row and
//     writes each y row whole, and the row's values and columns are the
//     same address for the units of the row (a broadcast), read once per
//     panel. The slots are walked in order at 34-40 registers: the units
//     in flight hide the latency. Where a row holds a multiple of 32 units
//     (mu=640), a warp takes 32 units of one row and consecutive warps
//     consecutive rows, so that neighbouring rows' gathers of the same x
//     rows meet in L1 (14% faster at mu=640 than memory order);
//   * every kernel walks its units grid-stride on at most one wave of the
//     card (the SM count times its resident blocks per SM).
//
// Measured (examples/bench_ell.py, NVIDIA H100 80GB HBM3 at 700 W, f64, the
// card cell, L2 flushed by a write / by a read): mu=1 18.72-19.06 / 16.27-
// 16.43 us (39-39.5% / 45-45.4% of the bound; the first design 26.22-26.29
// / 19.70-19.89 us), mu=4 29.79-30.11 us (39% of 11.65 us; first design
// 36.37-36.43), mu=640 1780-1829 us (50-51%; first design 7865-7920 us,
// torch.sparse.mm 2653-2674 us). In the same bracket a one-element kernel
// takes 4.9-5.2 us and a device copy of the bound's 24.77 MB 17.50 / 14.34
// us: at mu=1 the kernel takes 1.6-2.1 us longer than a copy of the bytes
// it must move. Without the row counts: 20.42-21.26 us at mu=1, 3029-3080
// us at mu=640. ptxas: 64 registers (mu == 1), 40 (mu > 1), no spills.
//
// Every output's sum runs over the row's slots in storage order from zero
// with separately rounded multiply and add (no FMA contraction): the
// arithmetic of the plain PyTorch version (ops/ell_spmv.py
// `ell_spmv_payload_reference`), so the two agree to the bit on the same
// device. No sum over the slots is split across threads. Stopping at the
// count skips only padding slots (value 0, column 0); a row whose count is
// below w adds one term for all of them after its last stored slot,
// 0 * x[s, 0, m]. That term is +-0 for finite x, and a sum that starts at
// +0 is never -0, so the result equals the full sum (`ell_spmv_reference`)
// bitwise; for a non-finite x[s, 0] both give NaN there, as the JAX
// package's full slot sum does. Where the term is added:
//   * mu == 1: after the row's passes, from x[s, 0] (an L1 hit);
//   * mu > 1 without a flag buffer: the loop runs one slot past the count,
//     over the first padding slot (value 0, column 0);
//   * mu > 1 with a flag buffer (the wrapper passes one where mu is a
//     multiple of 32): a first launch flags each subdomain whose x[s, 0, :]
//     holds a non-finite value, and only the rows of a flagged subdomain add
//     the term.
// Against the kernels without the term, in the same calls (bench_ell.py
// --parent, the card cell, f64, write flush): mu=1 18.18-18.48 us against
// 18.78-19.20; mu=4 30.24-30.59 against 29.81-30.30 (the extra slot);
// mu=640 1736.72-1803.66 against 1777.25-1795.82 (the flags). Tried, as
// edits of this source timed by bench_ell.py: the term after the loop
// from x[s, 0, m] in every unit at mu > 1, 36.37 us at mu=4 and 2242.82 us
// at mu=640 (parent 30.11 and 1777.94); one more padding slot in every
// count of the payload, 1937.28 us at mu=640 against 1781.10 with the
// stored slots only; the extra slot and the flags in one kernel, 32.93 us
// at mu=4 against 29.97.
// The columns must lie in [0, n) (`build_payload` checks them); they are
// not checked here.
//
// Plain C interface (built with nvcc into a shared library, loaded with
// ctypes): launches on the given stream, allocates nothing, synchronises
// nothing, and returns the launch's cudaError_t. Limits: n * mu < 2^31 (one
// subdomain's x); a call with S * n * mu >= 2^31 launches once per batch of
// subdomains.

#include "kernel_util.cuh"

constexpr int kEllBlock = 256;
// mu == 1: slots loaded ahead per pass, and the resident blocks per SM that
// the kernel's registers must allow (64 registers, no spills)
constexpr int kRowsPass = 6;
constexpr int kRowsMinBlocks = 4;

// Slots [j0, j0 + P) of one row (mu == 1): every value and column of the
// pass below `loaded`, then every gather of x below the row's count, then
// the sums in slot order.
template <typename T, typename IDX, int P>
__device__ __forceinline__ T rows_pass(const T* __restrict__ vs,
                                       const IDX* __restrict__ cs,
                                       const T* __restrict__ xs, int n,
                                       int j0, int loaded, int cnt, T acc) {
  T v[P], xv[P];
  IDX c[P];
#pragma unroll
  for (int j = 0; j < P; ++j)
    if (j0 + j < loaded) {
      v[j] = __ldcs(vs + (size_t)(j0 + j) * n);
      c[j] = __ldcs(cs + (size_t)(j0 + j) * n);
    }
#pragma unroll
  for (int j = 0; j < P; ++j)
    if (j0 + j < cnt) xv[j] = xs[c[j]];
#pragma unroll
  for (int j = 0; j < P; ++j)
    if (j0 + j < cnt) acc = add_rn(acc, mul_rn(v[j], xv[j]));
  return acc;
}

// mu == 1, x and y (S, n): a unit is row i of subdomain s, units numbered
// in memory order; the row's slots in passes of P. The value and column
// planes are read once: evict-first.
template <typename T, typename IDX, int P>
__global__ void __launch_bounds__(kEllBlock, kRowsMinBlocks)
ell_rows_kernel(const T* __restrict__ vals, const IDX* __restrict__ cols,
                const unsigned char* __restrict__ counts,
                const T* __restrict__ x, T* __restrict__ y, int n, int w,
                unsigned units, FastDiv rows) {
  for (unsigned q = blockIdx.x * kEllBlock + threadIdx.x; q < units;
       q += gridDim.x * kEllBlock) {
    const unsigned s = divide(q, rows);
    const size_t plane0 = (size_t)s * w * n + (q - s * rows.d);
    const int cnt = counts != nullptr ? (int)__ldcs(counts + q) : w;
    const T* xs = x + (size_t)s * n;
    // the first pass loads its values and columns up to w, so that they do
    // not wait for the count; the gathers and sums stop at the count
    T acc = rows_pass<T, IDX, P>(vals + plane0, cols + plane0, xs, n, 0, w,
                                 cnt, T(0));
    for (int j0 = P; j0 < cnt; j0 += P)
      acc = rows_pass<T, IDX, P>(vals + plane0, cols + plane0, xs, n, j0, cnt,
                                 cnt, acc);
    if (cnt < w) acc = add_rn(acc, mul_rn(T(0), xs[0]));   // padding's term
    y[q] = acc;
  }
}

// mu > 1, x and y (S, n, mu): a unit is right-hand sides [m, m + V) of row
// i of subdomain s. FLAGS: the padding's term comes from the flags x0_bad
// (its own instantiation: one kernel for both paths cost 3 us at mu=4). The
// flag is read after the loop: read before it, it held a register that
// ptxas spilled. V > 1 only where mu % V == 0 and the pointers are
// 16-byte aligned. Units are numbered in memory order, except where a row
// holds a multiple of 32 units (chunk.d = 32 n): then a warp is 32 units
// of one row, and consecutive warps take consecutive rows at the same
// right-hand sides, so that the x rows a row gathers are still in L1 for
// its neighbours (RCM numbering: neighbouring rows share columns). The
// slots are walked in order; the units in flight, not loads ahead, hide
// the latency.
template <typename T, typename IDX, int V, bool FLAGS>
__global__ void __launch_bounds__(kEllBlock)
ell_rhs_kernel(const T* __restrict__ vals, const IDX* __restrict__ cols,
               const unsigned char* __restrict__ counts,
               const unsigned char* __restrict__ x0_bad,
               const T* __restrict__ x, T* __restrict__ y, int n, int w,
               int mu, unsigned units, FastDiv panel, FastDiv row,
               FastDiv chunk, bool stream_vals) {
  for (unsigned q = blockIdx.x * kEllBlock + threadIdx.x; q < units;
       q += gridDim.x * kEllBlock) {
    const unsigned s = divide(q, panel);
    const unsigned r = q - s * panel.d;
    unsigned i, mv;
    if (chunk.d > 1) {
      const unsigned c = divide(r, chunk);
      const unsigned rc = r - c * chunk.d;
      i = rc >> 5;
      mv = c * 32 + (rc & 31);
    } else {
      i = divide(r, row);
      mv = r - i * row.d;
    }
    const int m = (int)mv * V;
    const size_t plane0 = (size_t)s * w * n + i;
    const T* vs = vals + plane0;
    const IDX* cs = cols + plane0;
    const int cnt = counts != nullptr ? (int)counts[(size_t)s * n + i] : w;
    // the padding's term: after the loop where the subdomain is flagged,
    // else through the first padding slot
    const int end = !FLAGS && cnt < w ? cnt + 1 : cnt;
    const T* xs = x + (size_t)s * n * mu + m;
    T acc[V];
#pragma unroll
    for (int e = 0; e < V; ++e) acc[e] = T(0);
#pragma unroll 4
    for (int j = 0; j < end; ++j) {
      const size_t o = (size_t)j * n;
      const T v = stream_vals ? __ldcs(vs + o) : vs[o];
      const IDX c = stream_vals ? __ldcs(cs + o) : cs[o];
      T xv[V];
      load_run<T, V>(xs + (size_t)c * mu, xv);
#pragma unroll
      for (int e = 0; e < V; ++e) acc[e] = add_rn(acc[e], mul_rn(v, xv[e]));
    }
    if (FLAGS && cnt < w && x0_bad[s]) {
      T xv[V];
      load_run<T, V>(xs, xv);
#pragma unroll
      for (int e = 0; e < V; ++e) acc[e] = add_rn(acc[e], mul_rn(T(0), xv[e]));
    }
    store_run<T, V>(y + ((size_t)s * n + i) * mu + m, acc);
  }
}

// bad[s] = 1 where x[s, 0, :] (mu values) holds a non-finite value, else 0:
// a block per subdomain, grid-stride over the subdomains.
template <typename T>
__global__ void __launch_bounds__(kEllBlock)
x0_flags_kernel(const T* __restrict__ x, unsigned char* __restrict__ bad,
                int S, int n, int mu) {
  for (int s = blockIdx.x; s < S; s += gridDim.x) {
    const T* x0 = x + (size_t)s * n * mu;
    int any = 0;
    for (int m = threadIdx.x; m < mu; m += kEllBlock) any |= !isfinite(x0[m]);
    any = __syncthreads_or(any);
    if (threadIdx.x == 0) bad[s] = (unsigned char)(any != 0);
    __syncthreads();
  }
}

// A unit's index is 32-bit, so a launch takes fewer than 2^31 elements of x:
// the subdomains go in batches of `batch` (all of them in one launch unless
// S * n * mu >= 2^31). Offsetting by whole subdomains keeps the alignment
// that chose V.
template <typename T, typename IDX>
static int launch_rows(const T* vals, const IDX* cols,
                       const unsigned char* counts, const T* x, T* y, int S,
                       int n, int w, int batch, cudaStream_t stream) {
  const void* kernel = (const void*)ell_rows_kernel<T, IDX, kRowsPass>;
  for (int s0 = 0; s0 < S; s0 += batch) {
    const int sb = S - s0 < batch ? S - s0 : batch;
    const unsigned units = (unsigned)((unsigned long long)sb * n);
    const size_t plane = (size_t)s0 * w * n;
    ell_rows_kernel<T, IDX, kRowsPass>
        <<<grid_for(kernel, kEllBlock, units, true), kEllBlock, 0, stream>>>(
            vals + plane, cols + plane,
            counts != nullptr ? counts + (size_t)s0 * n : nullptr,
            x + (size_t)s0 * n, y + (size_t)s0 * n, n, w, units,
            fast_div((unsigned)n));
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

template <typename T, typename IDX, int V, bool FLAGS>
static int launch_rhs(const T* vals, const IDX* cols,
                      const unsigned char* counts, unsigned char* x0_bad,
                      const T* x, T* y, int S, int n, int w, int mu, int batch,
                      cudaStream_t stream) {
  const unsigned row = (unsigned)(mu / V), panel = (unsigned)n * row;
  const void* kernel = (const void*)ell_rhs_kernel<T, IDX, V, FLAGS>;
  // a row's values are read by its mu / V units: streamed where they share
  // a warp
  const bool stream_vals = row <= 32;
  // rows of whole warps: a warp per row and 32 units of right-hand sides
  const FastDiv chunk = fast_div(row % 32 == 0 ? 32u * (unsigned)n : 1u);
  if (FLAGS) {
    x0_flags_kernel<T><<<S < 65535 ? S : 65535, kEllBlock, 0, stream>>>(
        x, x0_bad, S, n, mu);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  for (int s0 = 0; s0 < S; s0 += batch) {
    const int sb = S - s0 < batch ? S - s0 : batch;
    const unsigned units = (unsigned)((unsigned long long)sb * panel);
    const size_t plane = (size_t)s0 * w * n;
    ell_rhs_kernel<T, IDX, V, FLAGS>
        <<<grid_for(kernel, kEllBlock, units, true), kEllBlock, 0, stream>>>(
            vals + plane, cols + plane,
            counts != nullptr ? counts + (size_t)s0 * n : nullptr,
            FLAGS ? x0_bad + s0 : nullptr,
            x + (size_t)s0 * n * mu, y + (size_t)s0 * n * mu, n, w, mu, units,
            fast_div(panel), fast_div(row), chunk, stream_vals);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

// picks the kernel: one for mu == 1, at mu > 1 by the unit's vector width
template <typename T, typename IDX>
static int launch_idx(const T* vals, const IDX* cols,
                      const unsigned char* counts, unsigned char* x0_bad,
                      const T* x, T* y, int S, int n, int w, int mu, int batch,
                      cudaStream_t st) {
  if (mu == 1)
    return launch_rows<T, IDX>(vals, cols, counts, x, y, S, n, w, batch, st);
  constexpr int V = 16 / sizeof(T);
  const bool vec = mu % V == 0 && aligned16(x) && aligned16(y);
  // the flags matter only where rows stop at a count
  if (x0_bad != nullptr && counts != nullptr)
    return vec ? launch_rhs<T, IDX, V, true>(vals, cols, counts, x0_bad, x, y,
                                             S, n, w, mu, batch, st)
               : launch_rhs<T, IDX, 1, true>(vals, cols, counts, x0_bad, x, y,
                                             S, n, w, mu, batch, st);
  return vec ? launch_rhs<T, IDX, V, false>(vals, cols, counts, nullptr, x, y,
                                            S, n, w, mu, batch, st)
             : launch_rhs<T, IDX, 1, false>(vals, cols, counts, nullptr, x, y,
                                            S, n, w, mu, batch, st);
}

template <typename T>
static int launch(const T* vals, const void* cols, int narrow,
                  const unsigned char* counts, unsigned char* x0_bad,
                  const T* x, T* y, int S, int n, int w, int mu,
                  void* stream) {
  if (S < 0 || n < 0 || w < 0 || mu < 0) return (int)cudaErrorInvalidValue;
  if ((long long)n * mu >= (1ll << 31)) return (int)cudaErrorInvalidValue;
  if (S == 0 || n == 0 || mu == 0) return 0;
  const long long fit = ((1ll << 31) - 1) / ((long long)n * mu);
  const int batch = fit < S ? (int)fit : S;
  const cudaStream_t st = (cudaStream_t)stream;
  if (narrow)
    return launch_idx<T, unsigned short>(
        vals, (const unsigned short*)cols, counts, x0_bad, x, y, S, n, w, mu,
        batch, st);
  return launch_idx<T, int>(vals, (const int*)cols, counts, x0_bad, x, y, S, n,
                            w, mu, batch, st);
}

extern "C" {

// y (S, n, mu) = the batch vals (S, w, n) with columns cols (S, w, n; uint16
// where narrow, else int32) and row counts counts (S, n; null: w slots
// every row) applied to x (S, n, mu); x0_bad: S bytes of scratch for the
// flags of wide panels, or null (header)
int ell_spmv_f32(const float* vals, const void* cols, int narrow,
                 const unsigned char* counts, unsigned char* x0_bad,
                 const float* x, float* y, int S, int n, int w, int mu,
                 void* stream) {
  return launch<float>(vals, cols, narrow, counts, x0_bad, x, y, S, n, w, mu,
                       stream);
}

int ell_spmv_f64(const double* vals, const void* cols, int narrow,
                 const unsigned char* counts, unsigned char* x0_bad,
                 const double* x, double* y, int S, int n, int w, int mu,
                 void* stream) {
  return launch<double>(vals, cols, narrow, counts, x0_bad, x, y, S, n, w, mu,
                        stream);
}

}  // extern "C"
