// General additive exchange for Hopper (sm_90a): for a batch x of shape
// (S, n, mu),
//
//     y[s, i, m] = x[s, i, m]                                   interior dof
//     y[d, m]    = x[d, m] + (x[r_0, m] + x[r_1, m] + ...)      d = dst[s, p]
//
// for every interface slot (s, p) with flat row d = s * n + if_idx[s, p],
// where r_k = rows[s, k, p] is the flat row (q * n + if_idx[q, j]) of the
// k-th other copy of the slot, and a row of -1 (no partner) adds +0. Every
// copy of a shared dof ends up holding the sum of all copies; interior and
// padding dofs pass through.
//
// Replaces the TPU kernel hpddm_tpu/parallel/pexchange.py:149 `_pexchange`,
// three pallas_calls (k_extract: gather the interface values; k_reduce:
// gather the partner copies; k_merge: write the sums back) with an XLA sum
// between them. Their 128-lane tiles and per-tile select loops stand in for
// the gather the TPU lacks. Here one launch does all of it; the plan
// (`build_plan` in parallel/pexchange.py) turns each slot's partner list
// into flat rows of x once, so no intermediate array exists.
//
// Bound: device-memory bandwidth. One call reads x and writes y once
// (S*n*mu*itemsize each) and reads the plan: a byte per dof (`interior`),
// the flat row of each interface slot and its valid partner rows (4 bytes
// each); the partner values are rows of x. At the unstructured card cell
// (S=64, n=4640, f64, 58,114 interface slots, 63,216 partner rows) that is
// 5.53 MB at mu=1 (1.65 us at 3.35 TB/s) and 3.04 GB at the coarse panel
// mu=640 (0.91 ms), x and y 2.38 MB and 1.52 GB each. It does k_max adds
// per interface dof and right-hand side.
//
// The first design (one thread per dof over all S*n dofs on a grid of
// (ceil(n / 256), S) blocks, reading an int32 slot per dof, then the slot's
// partner rows at a stride of k_max and their values one after the other)
// took 10.46 us at mu=1 on an H100 80GB HBM3 at 700 W, f64, L2 flushed by a
// write. In the same bracket a one-element kernel takes 4.9-5.2 us and the
// flush's write-back about 2 us more, so the kernel's own work was about
// 3.5 us against a 1.85 us bound. What held it back: the few interface
// threads of a warp ran a chain of dependent loads that the interior
// threads waited for; the partner rows of neighbouring slots were k_max * 4
// bytes apart; x and y moved in 8-byte accesses; at mu > 1 a thread looped
// over the right-hand sides with a warp's addresses mu elements apart.
//
// This design: one launch, two roles with disjoint writes, told apart by
// the block index (no divergence inside a block):
//   * copy role: a grid-stride 16-byte stream over the flat (S, n, mu) array
//     (2 f64 or 4 f32 elements a unit where the sizes and pointers allow, one
//     element otherwise) that writes y = x where `interior` (a byte per dof)
//     is set, and nothing on interface dofs (at mu > 1, where a unit lies in
//     one dof, it reads the flag first and skips the dof's x);
//   * slot role: a unit is one interface slot and V right-hand sides of it
//     (16 bytes where mu and the pointers allow), right-hand sides fastest;
//     the partner rows are stored slot-major, (S, k_max, m_max), so
//     consecutive slots read their k-th partner row coalesced; each slot
//     carries its flat row `dst`; up to 4 partner rows of a unit, then
//     their values, are loaded before the ordered sum;
//   * the two roles share at most one wave of the card (the SM count times
//     the kernel's resident blocks per SM), split by the bytes of each.
// A warp per interface slot (its lanes over the partners, the ordered sum
// by lane 0 through shuffles) measured 17.3-17.5 us at mu=1, twice this
// design's time; 8 partner rows ahead instead of 4 took more registers
// (47-70) and measured the same at mu=1 and 8-13% slower at mu=4 and 640.
//
// Measured (examples/bench_ell.py, NVIDIA H100 80GB HBM3 at 700 W, f64, the
// card cell, L2 flushed by a write / by a read): mu=1 9.02-9.09 / 7.84-8.13
// us (the first design 10.54-10.75 / 9.55-9.63 us; a one-element kernel
// takes 4.9-5.1 us in either bracket and a device copy of the bound's
// 5.53 MB 10.4-10.8 us), mu=4 15.46-15.57 us (first design 16.59-16.69),
// mu=640 1247-1300 us (70-73% of the bound; first design 5933-5977 us,
// torch.sparse.mm on I + P 2146-2169 us). ptxas: 32-48 registers, no
// spills.
//
// The partner sum runs in the order of the plain version (acc = p_0, then
// acc += p_k, then x + acc) with separately rounded adds, so the kernel
// equals both `pexchange_reference` and the port's plain `exchange`
// (parallel/ops.py) bitwise on the same device. y must not alias x.
//
// Plain C interface (built with nvcc into a shared library, loaded with
// ctypes): launches on the given stream, allocates nothing, synchronises
// nothing, and returns the launch's cudaError_t. Limit: S * n * mu < 2^31.

#include "kernel_util.cuh"

constexpr int kPexBlock = 256;
constexpr int kPexAhead = 4;   // partner rows loaded ahead of the sum

// V interior flags at p (V consecutive dofs), aligned to V bytes
template <int V>
__device__ __forceinline__ void load_flags(const unsigned char* __restrict__ p,
                                           unsigned char (&f)[V]) {
  if constexpr (V == 4) {
    const uchar4 w = *reinterpret_cast<const uchar4*>(p);
    f[0] = w.x; f[1] = w.y; f[2] = w.z; f[3] = w.w;
  } else if constexpr (V == 2) {
    const uchar2 w = *reinterpret_cast<const uchar2*>(p);
    f[0] = w.x; f[1] = w.y;
  } else {
    f[0] = *p;
  }
}

// VC: elements per copy unit; PER_DOF: mu == 1, so each element of a unit is
// its own dof (else the VC elements of a unit belong to one dof, which
// divide(q, per_dof) gives); VS: right-hand sides per slot unit.
template <typename T, int VC, bool PER_DOF, int VS>
__global__ void __launch_bounds__(kPexBlock)
pexchange_kernel(const T* __restrict__ x, T* __restrict__ y,
                 const unsigned char* __restrict__ interior,
                 const int* __restrict__ dst, const int* __restrict__ rows,
                 int mu, int m_max, int k_max, unsigned copy_units,
                 unsigned copy_blocks, FastDiv per_dof, unsigned slot_units,
                 FastDiv per_slot, FastDiv slots) {
  if (blockIdx.x < copy_blocks) {
    for (unsigned q = blockIdx.x * kPexBlock + threadIdx.x; q < copy_units;
         q += copy_blocks * kPexBlock) {
      const size_t e = (size_t)q * VC;
      // a unit of one dof reads x only where it copies it
      if (!PER_DOF && !interior[divide(q, per_dof)]) continue;
      T v[VC];
      load_run<T, VC>(x + e, v);
      if constexpr (PER_DOF) {
        unsigned char keep[VC];
        load_flags<VC>(interior + e, keep);
        bool all = true;
#pragma unroll
        for (int r = 0; r < VC; ++r) all = all && keep[r];
        if (all) {
          store_run<T, VC>(y + e, v);
        } else {
#pragma unroll
          for (int r = 0; r < VC; ++r)
            if (keep[r]) y[e + r] = v[r];
        }
      } else {
        store_run<T, VC>(y + e, v);
      }
    }
    return;
  }
  const unsigned nb = gridDim.x - copy_blocks;
  for (unsigned q = (blockIdx.x - copy_blocks) * kPexBlock + threadIdx.x;
       q < slot_units; q += nb * kPexBlock) {
    const unsigned t = divide(q, per_slot);     // the slot, s * m_max + p
    const int m = (int)(q - t * per_slot.d) * VS;
    const int d = dst[t];
    if (d < 0) continue;
    const unsigned s = divide(t, slots);
    const int* pr = rows + (size_t)s * k_max * m_max + (t - s * slots.d);
    T own[VS], acc[VS];
    load_run<T, VS>(x + (size_t)d * mu + m, own);
    for (int k0 = 0; k0 < k_max; k0 += kPexAhead) {
      int r[kPexAhead];
#pragma unroll
      for (int a = 0; a < kPexAhead; ++a)
        if (k0 + a < k_max) r[a] = pr[(size_t)(k0 + a) * m_max];
      T pv[kPexAhead][VS];
#pragma unroll
      for (int a = 0; a < kPexAhead; ++a) {
        if (k0 + a >= k_max) break;
        if (r[a] >= 0) {
          load_run<T, VS>(x + (size_t)r[a] * mu + m, pv[a]);
        } else {
#pragma unroll
          for (int e = 0; e < VS; ++e) pv[a][e] = T(0);
        }
      }
#pragma unroll
      for (int a = 0; a < kPexAhead; ++a) {
        if (k0 + a >= k_max) break;
#pragma unroll
        for (int e = 0; e < VS; ++e)
          acc[e] = k0 + a == 0 ? pv[a][e] : add_rn(acc[e], pv[a][e]);
      }
    }
#pragma unroll
    for (int e = 0; e < VS; ++e) own[e] = add_rn(own[e], acc[e]);
    store_run<T, VS>(y + (size_t)d * mu + m, own);
  }
}

template <typename T, int VC, bool PER_DOF, int VS>
static int launch_roles(const T* x, T* y, const unsigned char* interior,
                        const int* dst, const int* rows, int S, int n,
                        int m_max, int k_max, int mu, cudaStream_t stream) {
  const unsigned copy_units = (unsigned)((size_t)S * n * mu / VC);
  const unsigned slot_units = (unsigned)((size_t)S * m_max * (mu / VS));
  const void* kernel = (const void*)pexchange_kernel<T, VC, PER_DOF, VS>;
  const unsigned long long copy_need =
      (copy_units + kPexBlock - 1ull) / kPexBlock;
  const unsigned long long slot_need =
      (slot_units + kPexBlock - 1ull) / kPexBlock;
  unsigned long long copy_blocks = copy_need, slot_blocks = slot_need;
  const unsigned long long card = card_blocks(kernel, kPexBlock);
  if (card > 0 && copy_need + slot_need > card) {
    // one wave, shared by bytes: a copy unit moves 2 runs, a slot unit
    // about k_max + 2
    const unsigned long long wc = copy_need * 2,
                             ws = slot_need * (unsigned long long)(k_max + 2);
    slot_blocks = slot_need == 0 ? 0 : card * ws / (wc + ws);
    if (slot_need > 0 && slot_blocks == 0) slot_blocks = 1;
    if (slot_blocks > slot_need) slot_blocks = slot_need;
    copy_blocks = card > slot_blocks + 1 ? card - slot_blocks : 1;
    if (copy_blocks > copy_need) copy_blocks = copy_need;
  }
  pexchange_kernel<T, VC, PER_DOF, VS>
      <<<(unsigned)(copy_blocks + slot_blocks), kPexBlock, 0, stream>>>(
          x, y, interior, dst, rows, mu, m_max, k_max, copy_units,
          (unsigned)copy_blocks, fast_div((unsigned)(mu / (PER_DOF ? 1 : VC))),
          slot_units, fast_div((unsigned)(mu / VS)),
          fast_div((unsigned)(m_max > 0 ? m_max : 1)));
  return (int)cudaGetLastError();
}

template <typename T>
static int launch(const T* x, T* y, const unsigned char* interior,
                  const int* dst, const int* rows, int S, int n, int m_max,
                  int k_max, int mu, void* stream) {
  if (S < 0 || n < 0 || mu < 0 || m_max < 0 || k_max < 1)
    return (int)cudaErrorInvalidValue;
  if ((long long)S * n * mu >= (1ll << 31) ||
      (long long)S * m_max >= (1ll << 31))
    return (int)cudaErrorInvalidValue;
  if (S == 0 || n == 0 || mu == 0) return 0;
  constexpr int W = 16 / sizeof(T);
  const cudaStream_t st = (cudaStream_t)stream;
  const bool vec = aligned16(x) && aligned16(y) && ((uintptr_t)interior % W) == 0;
  if (vec && mu == 1 && ((long long)S * n) % W == 0)
    return launch_roles<T, W, true, 1>(x, y, interior, dst, rows, S, n, m_max,
                                       k_max, mu, st);
  if (vec && mu % W == 0)
    return launch_roles<T, W, false, W>(x, y, interior, dst, rows, S, n,
                                        m_max, k_max, mu, st);
  return launch_roles<T, 1, false, 1>(x, y, interior, dst, rows, S, n, m_max,
                                      k_max, mu, st);
}

extern "C" {

int pexchange_f32(const float* x, float* y, const unsigned char* interior,
                  const int* dst, const int* rows, int S, int n, int m_max,
                  int k_max, int mu, void* stream) {
  return launch<float>(x, y, interior, dst, rows, S, n, m_max, k_max, mu,
                       stream);
}

int pexchange_f64(const double* x, double* y, const unsigned char* interior,
                  const int* dst, const int* rows, int S, int n, int m_max,
                  int k_max, int mu, void* stream) {
  return launch<double>(x, y, interior, dst, rows, S, n, m_max, k_max, mu,
                        stream);
}

}  // extern "C"
