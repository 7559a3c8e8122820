"""Batched block-tridiagonal LU for grid subdomains (counterpart of
``hpddm_tpu/ops/banded_solve.py``).

A 5-point (or any width-1-coupled) local matrix in row-major grid order
is block-tridiagonal in grid rows with *diagonal* coupling blocks, so its
block LU keeps only the wy dense Schur-complement factors

    D_1 = A_11,   D_j = A_jj - diag(cl_j) D_{j-1}^{-1} diag(cu_j)

(O(n * wx) memory where the ``inv`` solver's dense inverses take O(n^2)),
and a solve is a forward and a backward sweep over the block rows.
Non-diagonal coupling between adjacent rows (9-point corners, node
blocks, an RCM-banded unstructured matrix) is detected and kept as dense
(wx, wx) coupling blocks: the same recursion with matmul couplings.

``rows_per_block=r`` eliminates r grid rows per block: the coupling
between blocks stays in one row of lanes (the corner), the sweeps take
wy/r steps of (r*wx)-wide matmuls, and the factors take r times the
memory, (nbk, S, r*wx, r*wx) with nbk = ceil(wy / r).

Factorization:

* ``method="host"``: the blocks are extracted on the host in f64, the
  Schur recursion runs there in f64 (``_schur_host``, LAPACK inversions
  batched over the subdomains) and the factors are rounded once to the
  solver's dtype and copied to its device;
* ``method="device"``: the Schur recursion runs on the solver's device
  in its dtype (``_schur_device``), one batched ``torch.linalg.inv`` per
  block row, each polished by ``newton`` steps of X <- X + X (I - A X);
* ``method="auto"``: the JAX package's rule, device for f32 on an
  accelerator, host otherwise (``hpddm_tpu/ops/banded_solve.py:445-447``).

The JAX package's content-keyed disk cache of the host factors, its
LU-free Newton chain and its ``HPDDM_TPU_BANDED_*`` environment overrides
are not ported (ROADMAP.md, slice 3a's leftovers).

A solve is one batched product with every block's inverse factor, then a
forward and a backward sweep over the block rows of one ``baddbmm_`` a
step, with the products of the inverse factors and the coupling blocks
built once with the solver (2 nbk + 3 launches a solve, about twice the
memory of the factors: on the host-bound card the launches set the
time). The steps write work buffers in place through views built on the
first solve of a panel width and dtype, with no host read inside a
sweep. The gathers into and out of the block-row layout are one
``index_select`` each, on flat indices built once with the solver.
"""

from __future__ import annotations

import dataclasses
from types import SimpleNamespace
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from hpddm_tpu_torch.device import DEFAULT, as_device
from hpddm_tpu_torch.dtypes import as_torch_dtype


@dataclasses.dataclass(frozen=True)
class BandedSolver:
    """Per-subdomain block-tridiagonal LU in padded grid layout, on one
    device. The fields are the JAX package's ``BandedSolver``'s, index
    maps as int64."""
    Dinv: torch.Tensor      # (nbk, S, L, L) inverse block factors
    cl: torch.Tensor        # (nbk, S, cw) lower corner coupling diagonal,
    #                         or (nbk, S, cw, cw) dense coupling blocks
    cu: torch.Tensor        # like cl (upper)
    idx_fwd: torch.Tensor   # (S, nbk*L) local flat row per grid slot
    msk_fwd: torch.Tensor   # (S, nbk*L, 1) 0/1
    idx_inv: torch.Tensor   # (S, n_max) grid slot per local flat row
    msk_inv: torch.Tensor   # (S, n_max, 1) 0/1
    wy_max: int             # = nbk
    wx_max: int             # = L
    n_max: int
    S: int
    cw: int = 0
    # built once: flat rows of the block-row layout (nbk, S, L) into b
    # viewed as (S * n_max, mu), and back; the forward mask in that layout;
    # the coupling products of the sweeps (``solve``); the work buffers and
    # per-step views of each (mu, dtype) solved so far
    fwd_rows: torch.Tensor = dataclasses.field(init=False, repr=False)
    inv_rows: torch.Tensor = dataclasses.field(init=False, repr=False)
    fwd_mask: torch.Tensor = dataclasses.field(init=False, repr=False)
    DC: torch.Tensor = dataclasses.field(init=False, repr=False)
    DU: torch.Tensor = dataclasses.field(init=False, repr=False)
    _work: dict = dataclasses.field(init=False, repr=False, compare=False)

    def __post_init__(self):
        S, nbk, L = self.S, self.wy_max, self.wx_max
        cw = self.cw or L
        dev = self.idx_fwd.device
        s = torch.arange(S, device=dev)
        fwd = (self.idx_fwd.view(S, nbk, L).long()
               + (s * self.n_max)[:, None, None])
        slot = self.idx_inv.long()
        inv = (slot // L) * (S * L) + s[:, None] * L + slot % L
        # DC[j - 1] = D_j^-1[:, :cw] C_j and DU[j] = D_j^-1[:, L-cw:] U_{j+1}
        # with C and U the coupling blocks (diagonal or dense)
        Dl, Dr = self.Dinv[1:, :, :, :cw], self.Dinv[:-1, :, :, L - cw:]
        if self.cl.dim() == 4:
            DC, DU = Dl @ self.cl[1:], Dr @ self.cu[1:]
        else:
            DC = Dl * self.cl[1:, :, None, :]
            DU = Dr * self.cu[1:, :, None, :]
        for name, value in (
                ("fwd_rows", fwd.permute(1, 0, 2).reshape(-1).contiguous()),
                ("inv_rows", inv.reshape(-1).contiguous()),
                ("fwd_mask", self.msk_fwd.view(S, nbk, L, 1)
                 .permute(1, 0, 2, 3).contiguous()),
                ("DC", DC.contiguous()), ("DU", DU.contiguous()),
                ("_work", {})):
            object.__setattr__(self, name, value)

    @property
    def nbytes(self) -> int:
        """Bytes of the factors, the coupling blocks and their products."""
        return sum(t.numel() * t.element_size()
                   for t in (self.Dinv, self.cl, self.cu, self.DC, self.DU))

    def _workspace(self, mu: int, dtype: torch.dtype) -> SimpleNamespace:
        """The work buffers of a solve of mu right-hand sides in dtype and
        the views each step of the sweeps reads and writes, built on the
        first such solve: a step then costs one launch and no view
        construction. The factors are promoted to dtype here, once."""
        ws = self._work.get((mu, dtype))
        if ws is not None:
            return ws
        if len(self._work) >= 4:
            self._work.clear()
        nbk, L, S = self.wy_max, self.wx_max, self.S
        cw = self.cw or L
        Dinv = self.Dinv.to(dtype)
        DC, DU = self.DC.to(dtype), self.DU.to(dtype)
        g = Dinv.new_empty((nbk, S, L, mu))
        U = torch.empty_like(g)
        ws = SimpleNamespace(
            g=g, g2=g.view(-1, mu), g3=g.view(nbk * S, L, mu), U=U,
            U2=U.view(-1, mu), U3=U.view(nbk * S, L, mu),
            D3=Dinv.view(nbk * S, L, L),
            # forward step j >= 1: U_j -= DC[j - 1] U_{j-1}[last cw lanes]
            fwd=[(U[j], DC[j - 1], U[j - 1, :, L - cw:])
                 for j in range(1, nbk)],
            # backward step j <= nbk - 2: U_j -= DU[j] U_{j+1}[first cw lanes]
            bwd=[(U[j], DU[j], U[j + 1, :, :cw])
                 for j in range(nbk - 2, -1, -1)],
            mask=self.fwd_mask.to(dtype), msk_inv=self.msk_inv.to(dtype))
        self._work[(mu, dtype)] = ws
        return ws

    def solve(self, b: torch.Tensor) -> torch.Tensor:
        """b: (S, n_max, mu) -> A^-1 b (exact block-tridiagonal solve).

        With U_j = D_j^-1 g_j for every block row at once (one batched
        product), the forward sweep is u_j = U_j - D_j^-1 C_j u_{j-1} and the
        backward one x_j = u_j - D_j^-1 U_{j+1} x_{j+1}, each step one
        ``baddbmm_`` with the products built with the solver (the JAX
        package applies C_j to u_{j-1} first: the same sweeps, associated
        otherwise). A factor in another dtype than b is promoted with b, as
        ``LocalSolver`` promotes it; the result has the promoted dtype."""
        S, n, mu = b.shape
        dtype = torch.promote_types(self.Dinv.dtype, b.dtype)
        ws = self._workspace(mu, dtype)
        # gather into the block-row layout (nbk, S, L, mu); zero the
        # inactive lanes (box padding, holes)
        torch.index_select(b.to(dtype).reshape(S * n, mu), 0, self.fwd_rows,
                           out=ws.g2)
        ws.g.mul_(ws.mask)
        torch.bmm(ws.D3, ws.g3, out=ws.U3)
        for Uj, P, prev in ws.fwd:
            Uj.baddbmm_(P, prev, alpha=-1)
        for Uj, P, nxt in ws.bwd:
            Uj.baddbmm_(P, nxt, alpha=-1)
        out = ws.U2.index_select(0, self.inv_rows)
        return out.view(S, self.n_max, mu).mul_(ws.msk_inv)


def _extract_blocks(mats, boxes, n_max, slot_maps, r, out_dtype=np.float64):
    """Vectorized raw-block extraction (host, f64 by default; the device
    factor path extracts straight into f32 — halves the host allocation
    and astype traffic of the ~2 GB flagship block tensors).

    One fancy-index scatter per subdomain replaces the old per-block
    scipy ``todense`` loops (O(nbk) scipy slices each) — the extraction
    is O(nnz) numpy.  Returns ``(D, cl, cu, idx_fwd, msk_fwd, idx_inv,
    msk_inv, dense_mode, nbk, L, wx_max)`` with D the *raw* (uninverted)
    elimination blocks, identity on padded/hole lanes."""
    S = len(boxes)
    wy_hi = max(j1 - j0 for (_, _, j0, j1) in boxes)
    wx_max = max(i1 - i0 for (i0, i1, _, _) in boxes)
    nbk = -(-wy_hi // r)                 # ceil: block rows
    L = r * wx_max                       # lanes per block

    entries = []
    dense_mode = False
    for s_, (i0, i1, j0, j1) in enumerate(boxes):
        wx, wy = i1 - i0, j1 - j0
        K = mats[s_].scipy(expand=True) if hasattr(mats[s_], "scipy") \
            else mats[s_].tocsr()
        coo = K.tocoo()
        slots = None if slot_maps is None else np.asarray(slot_maps[s_],
                                                          dtype=np.int64)
        if slots is not None and slots.shape[0] == wy * wx and \
                np.array_equal(slots, np.arange(wy * wx)):
            slots = None                      # identity map: no embedding
        rr = coo.row if slots is None else slots[coo.row]
        cc = coo.col if slots is None else slots[coo.col]
        data = np.asarray(coo.data, dtype=np.float64)
        if K.shape[0] < (wy * wx if slots is None else 0):
            raise ValueError(f"subdomain {s_}: matrix smaller than its box")
        rj, cj = rr // wx, cc // wx
        if np.abs(rj - cj).max(initial=0) > 1:
            raise ValueError("matrix is not block-tridiagonal in grid rows")
        # diagonal inter-row coupling (5/7-point stencils) keeps the O(cw)
        # coupling storage; anything else (elasticity node blocks, 9-point
        # corners) switches to dense (cw, cw) coupling blocks
        off = rj != cj
        if np.any(off & (rr % wx != cc % wx) & (data != 0)):
            dense_mode = True
        entries.append((rr, cc, data, wx, wy, slots))

    D = np.zeros((nbk, S, L, L), dtype=out_dtype)
    cshape = (nbk, S, wx_max, wx_max) if dense_mode else (nbk, S, wx_max)
    cl = np.zeros(cshape, dtype=out_dtype)
    cu = np.zeros(cshape, dtype=out_dtype)
    idx_fwd = np.zeros((S, nbk * L), dtype=np.int32)
    msk_fwd = np.zeros((S, nbk * L, 1))
    idx_inv = np.zeros((S, n_max), dtype=np.int32)
    msk_inv = np.zeros((S, n_max, 1))

    for s, (rr, cc, data, wx, wy, slots) in enumerate(entries):
        gy, gx = rr // wx, rr % wx
        hy, hx = cc // wx, cc % wx
        jr, jc = gy // r, hy // r
        inb = jr == jc                             # in-block entries
        pr = (gy % r) * wx_max + gx
        pc = (hy % r) * wx_max + hx
        np.add.at(D[:, s], (jr[inb], pr[inb], pc[inb]), data[inb])
        ml = jr == jc + 1      # lower coupling K[row gy0, row gy0-1] @ jr
        mu_ = jc == jr + 1     # upper coupling K[row gy0-1, row gy0] @ jc
        if dense_mode:
            np.add.at(cl[:, s], (jr[ml], gx[ml], hx[ml]), data[ml])
            np.add.at(cu[:, s], (jc[mu_], gx[mu_], hx[mu_]), data[mu_])
        else:
            kl = ml & (gx == hx)
            ku = mu_ & (gx == hx)
            np.add.at(cl[:, s], (jr[kl], gx[kl]), data[kl])
            np.add.at(cu[:, s], (jc[ku], gx[ku]), data[ku])
        # identity diagonal on inactive lanes (box padding + hole slots)
        n = wy * wx
        eff = np.arange(n) if slots is None else slots
        canvas = (eff // wx) * wx_max + (eff % wx)   # block-lane flat index
        active = np.zeros(nbk * L, dtype=bool)
        active[canvas] = True
        inact = np.nonzero(~active)[0]
        D[inact // L, s, inact % L, inact % L] = 1.0
        idx_fwd[s, canvas] = np.arange(len(eff))
        msk_fwd[s, canvas, 0] = 1.0
        idx_inv[s, : len(eff)] = canvas
        msk_inv[s, : len(eff), 0] = 1.0
    return (D, cl, cu, idx_fwd, msk_fwd, idx_inv, msk_inv, dense_mode,
            nbk, L, wx_max)


def _schur_host(D, cl, cu, dense_mode, wx_max):
    """Host-f64 Schur recursion, in place: D <- per-block inverse factors.

    Inversions *batched over subdomains* (threaded LAPACK: ~4x faster
    than per-subdomain loops); cl/cu are zero beyond each subdomain's
    true wx, so the batched corner correction is a no-op on padded
    lanes."""
    L = D.shape[-1]
    lo = L - wx_max
    prev = np.linalg.inv(D[0])
    D[0] = prev
    for jb in range(1, D.shape[0]):
        corner = prev[:, lo:, lo:]
        if dense_mode:
            D[jb, :, :wx_max, :wx_max] -= cl[jb] @ corner @ cu[jb]
        else:
            D[jb, :, :wx_max, :wx_max] -= \
                cl[jb][:, :, None] * corner * cu[jb][:, None, :]
        prev = np.linalg.inv(D[jb])
        D[jb] = prev
    return D




def _schur_device(D: torch.Tensor, cl: torch.Tensor, cu: torch.Tensor, *,
                  dense_mode: bool, newton: int, wx_max: int) -> torch.Tensor:
    """The Schur recursion on D's device in D's dtype, in place: D <- the
    per-block inverse factors. One batched ``torch.linalg.inv`` per block
    row, each polished by ``newton`` steps of X <- X + X (I - A X) (the
    JAX package's ``_schur_device``, ``hpddm_tpu/ops/banded_solve.py:370``).
    The product of the stored factors reconstructs the blocks for any
    stored corner, so a step's rounding does not compound."""
    L = D.shape[-1]
    lo = L - wx_max
    eye = torch.eye(L, dtype=D.dtype, device=D.device)
    for jb in range(D.shape[0]):
        A = D[jb]
        if jb:                       # cl[0] is zero: block 0 has no corner
            corner = D[jb - 1][:, lo:, lo:]
            if dense_mode:
                corr = cl[jb] @ (corner @ cu[jb])
            else:
                corr = cl[jb][:, :, None] * corner * cu[jb][:, None, :]
            A[:, :wx_max, :wx_max] -= corr
        X = torch.linalg.inv(A)
        for _ in range(newton):
            X = X + X @ (eye - A @ X)
        D[jb] = X
    return D


def build_banded_solver(mats: Sequence,
                        boxes: Sequence[Tuple[int, int, int, int]],
                        n_max: int, dtype=torch.float32,
                        slot_maps: Optional[Sequence] = None,
                        rows_per_block: int = 1, method: str = "auto",
                        newton: int = 1, device=DEFAULT) -> BandedSolver:
    """Factor local matrices given in row-major grid order.

    mats: MatrixCSR (or scipy) local matrices, local index = iy*wx + ix;
    boxes: (i0, i1, j0, j1) per subdomain. Raises ValueError if a matrix
    couples grid rows more than one apart (not block-tridiagonal).

    slot_maps (optional): per-subdomain int array mapping local row ->
    grid slot iy*wx + ix, for node sets that do not fill their bounding
    box: the matrix is embedded into the full box with identity rows on
    the holes.

    rows_per_block: grid rows eliminated per block (module doc).
    method: "host", "device" or "auto" (module doc); newton: the polish
    steps of the device recursion. The solver's tensors are in ``dtype``
    on ``device``.
    """
    S = len(boxes)
    r = max(int(rows_per_block), 1)
    device = as_device(device)
    dtype = as_torch_dtype(dtype)
    npdt = torch.empty(0, dtype=dtype).numpy().dtype
    if method not in ("auto", "host", "device"):
        raise ValueError(f"unknown banded factor method {method!r}")
    if method == "auto":
        method = "device" if (device.type != "cpu"
                              and dtype == torch.float32) else "host"

    def dev(a):
        return torch.as_tensor(np.ascontiguousarray(a), device=device)

    if method == "device":
        real_dt = np.float64 if npdt.itemsize >= 8 else npdt
        (D, cl, cu, idx_fwd, msk_fwd, idx_inv, msk_inv, dense_mode,
         nbk, L, wx_max) = _extract_blocks(mats, boxes, n_max, slot_maps, r,
                                           out_dtype=real_dt)
        cl, cu = dev(cl.astype(npdt, copy=False)), dev(cu.astype(npdt,
                                                                 copy=False))
        Dinv = _schur_device(dev(D.astype(npdt, copy=False)), cl, cu,
                             dense_mode=dense_mode, newton=int(newton),
                             wx_max=wx_max)
    else:
        (Dinv, cl, cu, idx_fwd, msk_fwd, idx_inv, msk_inv, dense_mode,
         nbk, L, wx_max) = _extract_blocks(mats, boxes, n_max, slot_maps, r)
        Dinv = dev(_schur_host(Dinv, cl, cu, dense_mode, wx_max)
                   .astype(npdt, copy=False))
        cl, cu = dev(cl.astype(npdt, copy=False)), dev(cu.astype(npdt,
                                                                 copy=False))
    return BandedSolver(
        Dinv=Dinv, cl=cl, cu=cu,
        idx_fwd=dev(idx_fwd.astype(np.int64)),
        msk_fwd=dev(msk_fwd.astype(npdt, copy=False)),
        idx_inv=dev(idx_inv.astype(np.int64)),
        msk_inv=dev(msk_inv.astype(npdt, copy=False)),
        wy_max=nbk, wx_max=L, n_max=n_max, S=S, cw=wx_max)


def build_banded_solver_rcm(mats: Sequence, n_max: int, dtype=torch.float32,
                            rows_per_block: int = 1, method: str = "auto",
                            wx: Optional[int] = None, newton: int = 1,
                            device=DEFAULT):
    """Banded exact local solves for unstructured matrices.

    Reverse Cuthill-McKee gives each local matrix a numbering of bandwidth
    b ~ O(sqrt(n)); a matrix of bandwidth <= wx is block-tridiagonal in
    blocks of wx rows, so the same recursion applies, with dense (wx, wx)
    coupling blocks (detected by ``_extract_blocks``). The permutation
    rides the solver's gathers (``idx_fwd``/``idx_inv``), so ``solve``
    takes and returns vectors in the caller's local numbering.

    wx: optional bandwidth override (>= the largest RCM bandwidth; the
    default rounds that up to a multiple of 8).
    Returns (solver, bandwidths): the RCM bandwidth of each subdomain.
    """
    from scipy.sparse.csgraph import reverse_cuthill_mckee

    csrs, slot_maps, boxes, bws = [], [], [], []
    for m in mats:
        K = m.scipy(expand=True) if hasattr(m, "scipy") else m.tocsr()
        perm = np.asarray(reverse_cuthill_mckee(K, symmetric_mode=True))
        iperm = np.empty_like(perm)
        iperm[perm] = np.arange(len(perm))
        coo = K.tocoo()
        b = int(np.abs(iperm[coo.row].astype(np.int64)
                       - iperm[coo.col]).max(initial=1))
        bws.append(b)
        csrs.append(K)
        slot_maps.append(iperm.astype(np.int64))
    wx_eff = int(-(-max(max(bws), 8) // 8) * 8) if wx is None else int(wx)
    if wx_eff < max(bws):
        raise ValueError(f"wx={wx_eff} below max RCM bandwidth {max(bws)}")
    for K in csrs:
        n = K.shape[0]
        boxes.append((0, wx_eff, 0, -(-n // wx_eff)))
    solver = build_banded_solver(csrs, boxes, n_max, dtype=dtype,
                                 slot_maps=slot_maps,
                                 rows_per_block=rows_per_block,
                                 method=method, newton=newton, device=device)
    return solver, bws
