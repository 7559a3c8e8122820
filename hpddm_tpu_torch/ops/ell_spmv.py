"""Batched ELL SpMM: the CUDA kernel and its plain PyTorch versions.

Counterpart of ``hpddm_tpu/ops/pallas_ell.py`` (``_windowed_spmv``, :133).
``ell_spmv`` computes

    y[s, i, m] = sum_j vals[s, j, i] * x[s, cols[s, j, i], m]

for a slot-major ELL batch, vals (S, w, n) and int32 cols (S, w, n)
(``BatchedELL``), and x (S, n, mu) in f32 or f64. The kernel
``csrc/ell_spmv.cu`` reads the batch's values and an ``EllPayload`` built
once per batch by ``build_payload`` (the counterpart of the JAX package's
``annotate_windowed`` payload): the columns narrowed to uint16 where
n <= 65,535, and each row's count of stored slots, so that a row stops at
its last real slot. On CUDA tensors ``ell_spmv`` launches the kernel, all
mu right-hand sides in one launch; on CPU tensors it runs the kernel's
plain version ``ell_spmv_payload_reference`` (``ell_spmv_reference`` for a
batch without a payload). A CUDA call without a payload, or with tensors
the kernel does not take, raises; nothing falls back.

A row whose count is below w skips its trailing padding slots (value 0,
column 0) and adds one term in their place, 0 * x[s, 0, m], after its last
stored slot. For finite x every skipped product and that term are +-0, and
a sum that starts at +0 is never -0, so the result equals the full sum
(``ell_spmv_reference``) bitwise; for a non-finite x[s, 0] both give NaN
there, as the JAX package's ``spmm_ell`` does. Where mu is a multiple of
32, the wrapper hands the kernel S bytes of scratch in which it first flags
the subdomains whose x[s, 0, :] is not finite (``csrc/ell_spmv.cu``).
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Optional

import torch

# launches of the CUDA kernel since the last reset (plain-version calls on
# CPU tensors are not counted), in all and by the panel width mu
launches = 0
launches_by_mu: collections.Counter = collections.Counter()

NARROW_MAX_N = 65535          # columns as uint16 up to this n_max
COUNT_MAX_W = 255             # row counts as uint8 up to this width
MAX_PANEL = 2 ** 31           # one subdomain's x, n * mu, holds fewer elements


@dataclasses.dataclass(frozen=True)
class EllPayload:
    """The maps the kernel reads beside a slot-major ELL batch.

    cols : (S, w, n) the batch's columns, uint16 where n <= 65,535, else
        int32; every column lies in [0, n).
    counts : (S, n) uint8, 1 + the last slot of each row that is not
        padding (value 0 and column 0), 0 for an all-padding row; or None
        (``build_payload`` where w > 255): every slot is summed.
    """
    cols: torch.Tensor
    counts: Optional[torch.Tensor]


def build_payload(vals: torch.Tensor, cols: torch.Tensor) -> EllPayload:
    """The payload of the slot-major batch vals, cols (S, w, n), built on
    their device. Raises where a column lies outside [0, n)."""
    S, w, n = cols.shape
    if cols.numel() and (int(cols.min()) < 0 or int(cols.max()) >= n):
        raise ValueError(f"build_payload: columns outside [0, {n})")
    narrow = cols.to(torch.uint16 if n <= NARROW_MAX_N else torch.int32)
    counts = None
    if w <= COUNT_MAX_W:
        stored = (vals != 0) | (cols != 0)                     # (S, w, n)
        slot = torch.arange(1, w + 1, device=cols.device)[None, :, None]
        counts = (stored * slot).amax(dim=1).to(torch.uint8)
    return EllPayload(cols=narrow.contiguous(),
                      counts=None if counts is None else counts.contiguous())


def ell_spmv_reference(vals: torch.Tensor, cols: torch.Tensor,
                       x: torch.Tensor) -> torch.Tensor:
    """Plain version of the full product: every slot summed in storage
    order from zero, one product and one sum per slot. vals, cols:
    (S, w, n); x: (S, n, mu)."""
    return _slot_sum(vals, cols, None, x)


def ell_spmv_payload_reference(vals: torch.Tensor, payload: EllPayload,
                               x: torch.Tensor) -> torch.Tensor:
    """Plain version of the kernel: each row's slots below its count
    summed in storage order from zero, then, where the count is below w,
    the padding's one term 0 * x[s, 0]."""
    return _slot_sum(vals, payload.cols, payload.counts, x)


def _slot_sum(vals, cols, counts, x):
    S, w, n = vals.shape
    mu = x.shape[-1]
    idx = cols.long()
    out = x.new_zeros((S, n, mu), dtype=torch.result_type(vals, x))
    for j in range(w):
        xj = torch.gather(x, 1, idx[:, j, :, None].expand(S, n, mu))
        term = out + vals[:, j, :, None] * xj
        out = term if counts is None else \
            torch.where((counts > j)[:, :, None], term, out)
    if counts is not None:
        out = torch.where((counts < w)[:, :, None],
                          out + vals.new_zeros(()) * x[:, :1, :], out)
    return out


def ell_spmv(vals: torch.Tensor, cols: torch.Tensor, x: torch.Tensor,
             payload: Optional[EllPayload] = None) -> torch.Tensor:
    """y (S, n, mu) = slot-major ELL product of vals, cols (S, w, n) with x
    (S, n, mu); on the card through the kernel, which reads ``payload``."""
    global launches
    tensors = [vals, cols, x]
    if payload is not None:
        tensors += [t for t in (payload.cols, payload.counts) if t is not None]
    if all(t.device.type == "cpu" for t in tensors):
        if payload is None:
            return ell_spmv_reference(vals, cols, x)
        return ell_spmv_payload_reference(vals, payload, x)
    if payload is None:
        raise ValueError("ell_spmv: the batch carries no kernel payload "
                         "(ops/ell_spmv.build_payload); the CUDA kernel reads "
                         "its narrowed columns and row counts")
    if not all(t.is_cuda and t.device == x.device for t in tensors):
        raise ValueError(f"ell_spmv: vals on {vals.device}, payload on "
                         f"{payload.cols.device}, x on {x.device}; all must "
                         "be on the same CUDA device")
    if vals.dtype != x.dtype or x.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"ell_spmv: dtypes {vals.dtype}/{x.dtype}; the kernel "
                        "takes float32 or float64, the same for both (its "
                        "complex form is ROADMAP queue B, item B4c)")
    if vals.dim() != 3 or x.dim() != 3 or cols.shape != vals.shape or \
            payload.cols.shape != vals.shape:
        raise ValueError(f"ell_spmv: shapes {tuple(vals.shape)}, "
                         f"{tuple(payload.cols.shape)} and {tuple(x.shape)}; "
                         "expected (S, w, n), (S, w, n) and (S, n, mu)")
    S, w, n = vals.shape
    mu = x.shape[2]
    narrow = payload.cols.dtype == torch.uint16
    if payload.cols.dtype != (torch.uint16 if n <= NARROW_MAX_N
                              else torch.int32):
        raise TypeError(f"ell_spmv: payload columns of dtype "
                        f"{payload.cols.dtype} at n={n}; the kernel takes "
                        f"uint16 for n <= {NARROW_MAX_N}, else int32")
    counts = payload.counts
    if counts is not None and (counts.dtype != torch.uint8 or
                               tuple(counts.shape) != (S, n)):
        raise ValueError(f"ell_spmv: payload counts {counts.dtype} "
                         f"{tuple(counts.shape)}; expected uint8 ({S}, {n})")
    if tuple(x.shape[:2]) != (S, n):
        raise ValueError(f"ell_spmv: vals {tuple(vals.shape)} and x "
                         f"{tuple(x.shape)} disagree")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("ell_spmv: vals, the payload and x must be "
                         "contiguous")
    if n * max(mu, 1) >= MAX_PANEL or S >= 2 ** 31 or w >= 2 ** 31:
        raise ValueError(f"ell_spmv: S={S}, w={w}, n={n}, mu={mu} exceed "
                         "the kernel's limits (n * mu < 2^31)")
    if x.device.index != torch.cuda.current_device():
        raise ValueError(f"ell_spmv: x on {x.device}, current device is "
                         f"cuda:{torch.cuda.current_device()}")
    from hpddm_tpu_torch import _build

    lib = _build.load()
    fn = lib.ell_spmv_f64 if x.dtype == torch.float64 else lib.ell_spmv_f32
    y = torch.empty_like(x)
    # wide panels: scratch for the kernel's flags of non-finite x[s, 0, :]
    x0_bad = torch.empty(S, dtype=torch.uint8, device=x.device) \
        if counts is not None and mu > 1 and mu % 32 == 0 else None
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = fn(vals.data_ptr(), payload.cols.data_ptr(), int(narrow),
             None if counts is None else counts.data_ptr(),
             None if x0_bad is None else x0_bad.data_ptr(), x.data_ptr(),
             y.data_ptr(), S, n, w, mu, stream)
    if err != 0:
        raise RuntimeError(f"ell_spmv: kernel launch failed, cudaError {err}")
    launches += 1
    launches_by_mu[mu] += 1
    return y
