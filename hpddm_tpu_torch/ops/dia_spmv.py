"""Batched DIA SpMV and SpMM: CUDA kernels and their plain PyTorch versions.

Counterpart of ``hpddm_tpu/ops/pallas_spmv.py``. ``dia_spmv``
(``_dia_spmv_blocked``, :98) computes

    y[s, i] = sum_k vals[s, k, i] * x[s, i + offsets[k]]

with x read as 0 outside [0, n), for vals (S, nd, n) and x (S, n) in f32,
f64 or c128. ``dia_spmm`` (``_dia_spmv_blocked_mu``, :167) computes the same
product for a panel x (S, n, mu), and ``dia_spmm_muT``
(``_dia_spmv_blocked_muT``, :253) for a panel with the RHS axis leading,
xT (S, mu, n). All three launch kernels of one source,
``csrc/dia_spmv.cu``, which takes the layout as a template parameter. On
CUDA tensors each wrapper launches its hand-written kernel; on CPU tensors
it runs the plain PyTorch version of the same function. A CUDA tensor that
the kernel does not take raises; nothing falls back.

Complex (c128, B1 and B2 only): the product of a value and an entry of x
is written out in real operations, each rounded once,
(vr xr - vi xi) + i (vr xi + vi xr), and the diagonals are summed in
order, componentwise. The plain version computes exactly these operations
on ``torch.view_as_real``, so kernel and plain version agree to the bit.
B3 (``dia_spmm_muT``) and c64 raise ``TypeError``: B3 on complex is
ROADMAP queue B, and native c64 has no parity target (queue C, C11).
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import torch
import torch.nn.functional as F

# launches of the CUDA kernels since the last reset (plain-version calls on
# CPU tensors are not counted): ``launches`` by ``dia_spmv`` (B1),
# ``spmm_launches`` by ``dia_spmm`` and ``dia_spmm_muT`` (B2/B3), and of
# those ``muT_launches`` by ``dia_spmm_muT`` (B3)
launches = 0
spmm_launches = 0
muT_launches = 0

MAX_DIAGS = 32                # DIA_MAX_DIAGS of csrc/dia_spmv.cu
MAX_PANEL = 2 ** 31           # one subdomain's x, n * mu, holds fewer elements


def dia_spmv_reference(vals: torch.Tensor, x: torch.Tensor,
                       offsets: Sequence[int]) -> torch.Tensor:
    """Plain version: y = sum_k vals[:, k] * shift(x, offsets[k]), summed in
    diagonal order from zero. x: (S, n) or (S, n, mu); vals: (S, nd, n).
    Complex operands take ``_complex_reference``'s explicit form."""
    if vals.is_complex() or x.is_complex():
        return _complex_reference(vals, x, offsets)
    S, nd, n = vals.shape
    extra = x.dim() - 2
    w = max((abs(int(o)) for o in offsets), default=0)
    xp = F.pad(x, (0, 0) * extra + (w, w))          # zero halo on axis 1
    out = x.new_zeros(x.shape, dtype=torch.result_type(vals, x))
    for k, off in enumerate(offsets):
        shifted = xp[:, w + off: w + off + n]
        out = out + vals[:, k].reshape(S, n, *([1] * extra)) * shifted
    return out


def _complex_reference(vals: torch.Tensor, x: torch.Tensor,
                       offsets: Sequence[int]) -> torch.Tensor:
    """The complex product in real operations, each rounded once: for
    diagonal k, p = v * x_shifted as (vr xr - vi xi, vr xi + vi xr), then
    acc = acc + p componentwise, the diagonals in order from zero. This
    defines the complex kernels' function (csrc/dia_spmv.cu ``mul_rn`` and
    ``add_rn`` of ``Complex128``)."""
    dt = torch.promote_types(torch.result_type(vals, x), torch.complex64)
    S, nd, n = vals.shape
    extra = x.dim() - 2
    v = torch.view_as_real(vals.to(dt).resolve_conj())      # (S, nd, n, 2)
    xr = torch.view_as_real(x.to(dt).resolve_conj())        # (S, n, ..., 2)
    w = max((abs(int(o)) for o in offsets), default=0)
    xp = F.pad(xr, (0, 0) + (0, 0) * extra + (w, w))
    re = xr.new_zeros(x.shape)
    im = xr.new_zeros(x.shape)
    for k, off in enumerate(offsets):
        sh = xp[:, w + off: w + off + n]
        vr = v[:, k, :, 0].reshape(S, n, *([1] * extra))
        vi = v[:, k, :, 1].reshape(S, n, *([1] * extra))
        re = re + (vr * sh[..., 0] - vi * sh[..., 1])
        im = im + (vr * sh[..., 1] + vi * sh[..., 0])
    return torch.complex(re, im)


def dia_spmm_muT_reference(vals: torch.Tensor, xT: torch.Tensor,
                           offsets: Sequence[int]) -> torch.Tensor:
    """Plain version of the RHS-leading layout: xT (S, mu, n) -> (S, mu, n),
    the same sums as ``dia_spmv_reference`` on the transposed panel."""
    return dia_spmv_reference(vals, xT.transpose(1, 2), offsets) \
        .transpose(1, 2).contiguous()


def check_limits(name: str, S: int, nd: int, n: int, mu: int) -> None:
    """Raise unless the kernels take S subdomains of n rows, nd diagonals
    and mu right-hand sides: nd <= 32 and n * mu < 2^31 (a launch takes
    whole subdomains, fewer than 2^31 elements of x; a larger S takes more
    launches); S fits a C int."""
    if nd > MAX_DIAGS or n * max(mu, 1) >= MAX_PANEL or S >= 2 ** 31:
        raise ValueError(f"{name}: S={S}, nd={nd}, n={n}, mu={mu} exceed "
                         f"the kernel's limits (nd <= {MAX_DIAGS}, n * mu < "
                         "2^31, S < 2^31)")


# the dtypes of each kernel's instantiations, by entry-point suffix
_SUFFIX = {torch.float32: "f32", torch.float64: "f64",
           torch.complex128: "c128"}


def _checked(name: str, vals: torch.Tensor, x: torch.Tensor,
             offsets: Sequence[int], shape: tuple,
             complex_ok: bool = True) -> None:
    """Raise unless the kernel takes vals (S, nd, n) and x of ``shape``:
    one CUDA device (the current one), float32, float64 or (where
    ``complex_ok``) complex128 for both, contiguous, 16-byte aligned if
    complex, and within the launch's limits."""
    if not (vals.is_cuda and x.is_cuda and vals.device == x.device):
        raise ValueError(f"{name}: vals on {vals.device}, x on {x.device}; "
                         "both must be on the same CUDA device")
    if x.is_complex() and not (complex_ok and x.dtype == torch.complex128):
        raise TypeError(
            f"{name}: dtype {x.dtype}; " + (
                "complex128 is the kernel's only complex type (native "
                "complex64 has no parity target: ROADMAP queue C, C11)"
                if complex_ok else "the kernel takes float32 or float64; "
                "its complex form is ROADMAP queue B, item B3c"))
    if vals.dtype != x.dtype or x.dtype not in _SUFFIX:
        raise TypeError(f"{name}: dtypes {vals.dtype}/{x.dtype}; the kernel "
                        "takes float32, float64 or complex128, the same for "
                        "both")
    if x.is_complex() and (vals.data_ptr() % 16 or x.data_ptr() % 16):
        raise ValueError(f"{name}: complex128 tensors must start on a "
                         "16-byte boundary (one load per entry)")
    if vals.dim() != 3 or x.dim() != len(shape):
        raise ValueError(f"{name}: shapes {tuple(vals.shape)} and "
                         f"{tuple(x.shape)}; expected (S, nd, n) and "
                         f"{len(shape)} axes")
    S, nd, n = vals.shape
    if tuple(x.shape) != shape or len(offsets) != nd:
        raise ValueError(f"{name}: vals {tuple(vals.shape)}, x "
                         f"{tuple(x.shape)}, {len(offsets)} offsets disagree")
    if not (vals.is_contiguous() and x.is_contiguous()):
        raise ValueError(f"{name}: vals and x must be contiguous")
    check_limits(name, S, nd, n, x.numel() // max(S * n, 1))
    if x.device.index != torch.cuda.current_device():
        raise ValueError(f"{name}: x on {x.device}, current device is "
                         f"cuda:{torch.cuda.current_device()}")


def _offsets(offsets: Sequence[int]):
    return (ctypes.c_int * max(len(offsets), 1))(*[int(o) for o in offsets])


def dia_spmv(vals: torch.Tensor, x: torch.Tensor,
             offsets: Sequence[int]) -> torch.Tensor:
    """y (S, n) = DIA product of vals (S, nd, n) with x (S, n)."""
    global launches
    if vals.device.type == "cpu" and x.device.type == "cpu":
        return dia_spmv_reference(vals, x, offsets)
    S, nd, n = vals.shape if vals.dim() == 3 else (0, 0, 0)
    vals, x = vals.resolve_conj(), x.resolve_conj()
    _checked("dia_spmv", vals, x, offsets, (S, n))
    from hpddm_tpu_torch import _build

    fn = getattr(_build.load(), f"dia_spmv_{_SUFFIX[x.dtype]}")
    y = torch.empty_like(x)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = fn(vals.data_ptr(), x.data_ptr(), y.data_ptr(), S, nd, n,
             _offsets(offsets), stream)
    if err != 0:
        raise RuntimeError(f"dia_spmv: kernel launch failed, cudaError {err}")
    launches += 1
    return y


def _dia_spmm(name: str, vals: torch.Tensor, x: torch.Tensor,
              offsets: Sequence[int], mu_leading: bool) -> torch.Tensor:
    """Launch the SpMM kernel on x (S, n, mu), or (S, mu, n) when
    mu_leading."""
    global spmm_launches, muT_launches
    S, nd, n = vals.shape if vals.dim() == 3 else (0, 0, 0)
    mu = x.shape[1 if mu_leading else -1] if x.dim() == 3 else 0
    vals, x = vals.resolve_conj(), x.resolve_conj()
    _checked(name, vals, x, offsets, (S, mu, n) if mu_leading else (S, n, mu),
             complex_ok=not mu_leading)
    from hpddm_tpu_torch import _build

    fn = getattr(_build.load(), f"dia_spmm_{_SUFFIX[x.dtype]}")
    y = torch.empty_like(x)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = fn(vals.data_ptr(), x.data_ptr(), y.data_ptr(), S, nd, n, mu,
             int(mu_leading), _offsets(offsets), stream)
    if err != 0:
        raise RuntimeError(f"{name}: kernel launch failed, cudaError {err}")
    spmm_launches += 1
    muT_launches += int(mu_leading)
    return y


def dia_spmm(vals: torch.Tensor, x: torch.Tensor,
             offsets: Sequence[int]) -> torch.Tensor:
    """y (S, n, mu) = DIA product of vals (S, nd, n) with the panel x
    (S, n, mu): B2's layout, the port's (S, n_max, mu) batch."""
    if vals.device.type == "cpu" and x.device.type == "cpu":
        return dia_spmv_reference(vals, x, offsets)
    return _dia_spmm("dia_spmm", vals, x, offsets, mu_leading=False)


def dia_spmm_muT(vals: torch.Tensor, xT: torch.Tensor,
                 offsets: Sequence[int]) -> torch.Tensor:
    """yT (S, mu, n) = DIA product of vals (S, nd, n) with the panel xT
    (S, mu, n): B3's layout, the right-hand-side axis leading."""
    if vals.device.type == "cpu" and xT.device.type == "cpu":
        return dia_spmm_muT_reference(vals, xT, offsets)
    return _dia_spmm("dia_spmm_muT", vals, xT, offsets, mu_leading=True)
