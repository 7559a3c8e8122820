"""DST-I fast local solver for grid subdomains (counterpart of
``hpddm_tpu/ops/fft_solve.py``).

The local 5-point operator with Dirichlet-type artificial boundaries
diagonalizes in the 2-D DST-I basis, so a local solve is a DST along both
grid axes, a divide by the eigenvalues and the DST back: O(n log n), no
factor memory. It is exact when the local matrix is the constant-
coefficient 5-point stencil of the box, and a spectrally close
approximation otherwise (the Schwarz smoother, or the inner
preconditioner of the Chebyshev local solves, ops/cheby_solve.py).

Two forms, as in the JAX package:

* ``FFTLocalSolver``: subdomains grouped by box shape (wy, wx), each group
  batched through ``dst1`` (the imaginary part of a ``torch.fft.rfft`` of
  the odd extension, length 2(m+1));
* ``DSTMatmulSolver``: the DST-I of length w as a product with the
  symmetric sine matrix, so a solve is four batched matmuls, a gather in
  and a gather out, with uniform padded shapes for every subdomain.

``build_fft_solver``'s "auto" takes the matmul form for boxes up to 128 a
side and the FFT form beyond. Both are plain torch ops (``torch.fft`` and
``torch.matmul``): the JAX package writes them in jnp, no Pallas kernel.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

import numpy as np
import torch

from hpddm_tpu_torch.device import DEFAULT, as_device
from hpddm_tpu_torch.dtypes import as_torch_dtype
from hpddm_tpu_torch.ops.local_solve import promoted


def dst1(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Unnormalized DST-I along ``dim``:
    X_k = sum_i x_i sin(pi (i+1)(k+1)/(m+1)), in x's dtype (the rFFT runs
    in the matching complex type). dst1(dst1(x)) = (m+1)/2 x."""
    x = torch.movedim(x, dim, -1)
    m = x.shape[-1]
    z = x.new_zeros(x.shape[:-1] + (1,))
    ext = torch.cat([z, x, z, -torch.flip(x, dims=(-1,))], dim=-1)
    X = -torch.fft.rfft(ext, dim=-1).imag[..., 1: m + 1] / 2.0
    return torch.movedim(X.to(x.dtype), -1, dim)


def _eigs(wy: int, wx: int, dx: float, dy: float) -> np.ndarray:
    """The eigenvalues of the Dirichlet 5-point Laplacian on a wy x wx
    box."""
    ky = np.arange(1, wy + 1)
    kx = np.arange(1, wx + 1)
    lam_y = (2.0 - 2.0 * np.cos(np.pi * ky / (wy + 1))) / (dy * dy)
    lam_x = (2.0 - 2.0 * np.cos(np.pi * kx / (wx + 1))) / (dx * dx)
    return lam_y[:, None] + lam_x[None, :]


@dataclasses.dataclass(frozen=True)
class FFTLocalSolver:
    """Per-group DST solver: ``inv_eigs[g]`` (len(members[g]), wy, wx) for
    the subdomains ``members[g]`` (an int64 index tensor) whose boxes are
    ``shapes[g]`` = (wy, wx)."""
    inv_eigs: Tuple[torch.Tensor, ...]
    members: Tuple[torch.Tensor, ...]
    shapes: Tuple[Tuple[int, int], ...]
    n_max: int
    S: int

    def solve(self, b: torch.Tensor) -> torch.Tensor:
        """b: (S, n_max, mu) -> A^-1 b (approximate for a non-separable A).
        Rows past a box (the pads) stay 0."""
        out = torch.zeros_like(b)
        mu = b.shape[-1]
        for inv, idx, (wy, wx) in zip(self.inv_eigs, self.members,
                                      self.shapes):
            sub = b[idx, : wy * wx, :].reshape(len(idx), wy, wx, mu)
            t = dst1(dst1(sub, dim=1), dim=2)
            t = t * promoted(inv, t)[:, :, :, None]
            u = dst1(dst1(t, dim=1), dim=2)
            # DST-I is its own inverse up to 2/(m+1) per axis
            u = u * (4.0 / ((wy + 1) * (wx + 1)))
            out[idx, : wy * wx, :] = u.reshape(len(idx), wy * wx, mu) \
                .to(out.dtype)
        return out


@dataclasses.dataclass(frozen=True)
class DSTMatmulSolver:
    """Per-subdomain DST-I solver as batched masked sine matmuls: uniform
    padded shapes for every subdomain whatever its box."""
    Uy: torch.Tensor          # (S, wy_max, wy_max) masked sine matrices
    Ux: torch.Tensor          # (S, wx_max, wx_max)
    inv_eigs: torch.Tensor    # (S, wy_max, wx_max), self-inverse scale in
    idx_fwd: torch.Tensor     # (S, wy_max*wx_max) flat row per grid slot
    msk_fwd: torch.Tensor     # (S, wy_max*wx_max, 1) 0/1
    idx_inv: torch.Tensor     # (S, n_max) grid slot per flat row
    msk_inv: torch.Tensor     # (S, n_max, 1) 0/1
    wy_max: int
    wx_max: int
    n_max: int
    S: int

    def solve(self, b: torch.Tensor) -> torch.Tensor:
        """b: (S, n_max, mu) -> A^-1 b."""
        S, _, mu = b.shape
        Uy, Ux = promoted(self.Uy, b), promoted(self.Ux, b)
        g = torch.gather(b, 1, self.idx_fwd[:, :, None].expand(-1, -1, mu))
        g = (g * self.msk_fwd).reshape(S, self.wy_max, self.wx_max, mu)
        t = torch.einsum("syi,sixm->syxm", Uy, g)
        t = torch.einsum("sxj,syjm->syxm", Ux, t)
        t = t * promoted(self.inv_eigs, t)[:, :, :, None]
        u = torch.einsum("syi,sixm->syxm", Uy, t)
        u = torch.einsum("sxj,syjm->syxm", Ux, u)
        u = u.reshape(S, self.wy_max * self.wx_max, mu)
        out = torch.gather(u, 1, self.idx_inv[:, :, None].expand(-1, -1, mu))
        return out * self.msk_inv


def _build_matmul(boxes, Nx: int, Ny: int, n_max: int, dtype,
                  device) -> DSTMatmulSolver:
    dx, dy = 10.0 / Nx, 10.0 / Ny
    S = len(boxes)
    wy_max = max(j1 - j0 for (_, _, j0, j1) in boxes)
    wx_max = max(i1 - i0 for (i0, i1, _, _) in boxes)
    Uy = np.zeros((S, wy_max, wy_max))
    Ux = np.zeros((S, wx_max, wx_max))
    inv = np.zeros((S, wy_max, wx_max))
    idx_fwd = np.zeros((S, wy_max * wx_max), dtype=np.int64)
    msk_fwd = np.zeros((S, wy_max * wx_max, 1))
    idx_inv = np.zeros((S, n_max), dtype=np.int64)
    msk_inv = np.zeros((S, n_max, 1))
    for s, (i0, i1, j0, j1) in enumerate(boxes):
        wy, wx = j1 - j0, i1 - i0
        ky = np.arange(1, wy + 1)
        kx = np.arange(1, wx + 1)
        Uy[s, :wy, :wy] = np.sin(np.pi * np.outer(ky, ky) / (wy + 1))
        Ux[s, :wx, :wx] = np.sin(np.pi * np.outer(kx, kx) / (wx + 1))
        inv[s, :wy, :wx] = (4.0 / ((wy + 1) * (wx + 1))) / \
            _eigs(wy, wx, dx, dy)
        iy, ix = np.meshgrid(np.arange(wy), np.arange(wx), indexing="ij")
        slot = (iy * wx_max + ix).ravel()          # padded-grid positions
        flat = (iy * wx + ix).ravel()              # local flat rows
        idx_fwd[s, slot] = flat
        msk_fwd[s, slot, 0] = 1.0
        idx_inv[s, flat] = slot
        msk_inv[s, flat, 0] = 1.0

    def f(a):
        return torch.as_tensor(a, device=device).to(dtype)

    def i(a):
        return torch.as_tensor(a, device=device)
    return DSTMatmulSolver(
        Uy=f(Uy), Ux=f(Ux), inv_eigs=f(inv), idx_fwd=i(idx_fwd),
        msk_fwd=f(msk_fwd), idx_inv=i(idx_inv), msk_inv=f(msk_inv),
        wy_max=wy_max, wx_max=wx_max, n_max=int(n_max), S=S)


def build_fft_solver(boxes: Sequence[Tuple[int, int, int, int]],
                     Nx: int, Ny: int, n_max: int, dtype=torch.float32,
                     mode: str = "auto", device=DEFAULT):
    """The DST solver of the generator's subdomain boxes (i0, i1, j0, j1)
    on an Nx x Ny grid of [0,10]^2 (models/diffusion2d geometry).

    mode: "fft" (grouped rFFT), "matmul" (uniform masked sine matmuls) or
    "auto" (matmul for boxes up to 128 a side, fft beyond), as in the JAX
    package (``hpddm_tpu/ops/fft_solve.py:152``)."""
    device = as_device(device)
    dtype = as_torch_dtype(dtype)
    if mode == "auto":
        wmax = max(max(j1 - j0, i1 - i0) for (i0, i1, j0, j1) in boxes)
        mode = "matmul" if wmax <= 128 else "fft"
    if mode == "matmul":
        return _build_matmul(boxes, Nx, Ny, n_max, dtype, device)
    if mode != "fft":
        raise ValueError(f"unknown DST solver mode {mode!r}")
    dx, dy = 10.0 / Nx, 10.0 / Ny
    groups = {}
    for s, (i0, i1, j0, j1) in enumerate(boxes):
        groups.setdefault((j1 - j0, i1 - i0), []).append(s)
    members, shapes, inv_eigs = [], [], []
    for (wy, wx), mem in sorted(groups.items()):
        inv = np.broadcast_to(1.0 / _eigs(wy, wx, dx, dy),
                              (len(mem), wy, wx))
        members.append(torch.as_tensor(mem, dtype=torch.int64,
                                       device=device))
        shapes.append((wy, wx))
        inv_eigs.append(torch.as_tensor(np.array(inv),
                                        device=device).to(dtype))
    return FFTLocalSolver(inv_eigs=tuple(inv_eigs), members=tuple(members),
                          shapes=tuple(shapes), n_max=int(n_max),
                          S=len(boxes))
