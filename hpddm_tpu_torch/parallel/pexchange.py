"""General additive exchange in one kernel (counterpart of ``hpddm_tpu/parallel/pexchange.py``).

The exchange of the general path (parallel/ops.py ``exchange``) is a
dozen PyTorch operations: interface gather, partner gathers and adds, one
scatter back. ``pexchange`` computes the same function in one launch of
the hand-written kernel ``csrc/pexchange.cu``, which replaces the JAX
package's three Pallas passes (``_pexchange``, :149). For every local dof
(s, i) with interface slot p:

    y[s, i] = x[s, i] + (x[r_0] + x[r_1] + ...)

over the flat rows r_k of the other copies of slot (s, p); interior dofs
pass through. ``build_plan`` derives the two index maps the kernel reads
from a ``Decomposition``, once and on its device. On CPU tensors
``pexchange`` runs ``pexchange_reference``, the same function in plain
PyTorch; a CUDA tensor that the kernel does not take raises.

Both sum each slot's partners in the plain exchange's order (the first
partner, then each next one added, then the dof's own value added), so
the kernel, ``pexchange_reference`` and ``exchange`` agree bitwise.
"""

from __future__ import annotations

import dataclasses

import torch

# launches of the CUDA kernel since the last reset (plain-version calls on
# CPU tensors are not counted)
launches = 0

_MAX_S = 65535                # grid.y limit of the launch


@dataclasses.dataclass(frozen=True)
class ExchangePlan:
    """Index maps of the one-pass exchange, on the decomposition's device.

    slot : (S, n_max) int32, interface slot of each local dof, -1 for an
        interior or padding dof.
    rows : (S, m_max, k_max) int32, flat row q * n_max + if_idx[q, j] of
        each partner slot q * m_max + j of ``Decomposition.partners``, -1
        where the partner list has ended.
    """
    slot: torch.Tensor
    rows: torch.Tensor
    n_max: int
    m_max: int
    k_max: int


def build_plan(dec) -> ExchangePlan:
    """The plan of a ``Decomposition`` (general path), built on its device."""
    S, n, m = dec.S, dec.n_max, dec.m_max
    if S * n >= 2 ** 31:
        raise ValueError(f"build_plan: S * n_max = {S * n} rows do not fit "
                         "the kernel's int32 row index")
    p = dec.partners
    valid = p != S * m
    q = torch.div(p, m, rounding_mode="floor")
    partner_dof = dec.if_idx.reshape(-1)[torch.where(valid, p, 0)]
    rows = torch.where(valid, q * n + partner_dof, -1)
    slot = torch.where(dec.is_if, dec.inv_map, -1)
    return ExchangePlan(slot=slot.to(torch.int32).contiguous(),
                        rows=rows.to(torch.int32).contiguous(),
                        n_max=n, m_max=m, k_max=int(p.shape[2]))


def pexchange_reference(plan: ExchangePlan, x: torch.Tensor) -> torch.Tensor:
    """Plain version of the kernel. x: (S, n_max, mu) -> a new contiguous
    tensor of the same shape."""
    S, n, mu = x.shape
    flat = torch.cat([x.reshape(S * n, mu), x.new_zeros((1, mu))])
    rows = plan.rows.long()
    pvals = flat[torch.where(rows < 0, S * n, rows)]      # (S, m, k, mu)
    acc = pvals[:, :, 0]
    for k in range(1, pvals.shape[2]):
        acc = acc + pvals[:, :, k]
    slot = plan.slot.long()
    partner_sum = torch.gather(acc, 1,
                               slot.clamp(min=0)[:, :, None].expand(S, n, mu))
    return torch.where((slot >= 0)[:, :, None], x + partner_sum, x)


def pexchange(plan: ExchangePlan, x: torch.Tensor) -> torch.Tensor:
    """Sum-reduce duplicated unknowns of x (S, n_max, mu) in one pass."""
    global launches
    tensors = (plan.slot, plan.rows, x)
    if all(t.device.type == "cpu" for t in tensors):
        return pexchange_reference(plan, x)
    if not all(t.is_cuda and t.device == x.device for t in tensors):
        raise ValueError(f"pexchange: plan on {plan.slot.device}, x on "
                         f"{x.device}; both must be on the same CUDA device")
    if x.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"pexchange: dtype {x.dtype}; the kernel takes "
                        "float32 or float64")
    if x.dim() != 3 or tuple(x.shape[:2]) != tuple(plan.slot.shape):
        raise ValueError(f"pexchange: x {tuple(x.shape)} does not match the "
                         f"plan's (S, n_max) = {tuple(plan.slot.shape)}")
    if not x.is_contiguous():
        raise ValueError("pexchange: x must be contiguous")
    S, n, mu = x.shape
    if S > _MAX_S:
        raise ValueError(f"pexchange: S={S} exceeds the kernel's limit "
                         f"(S <= {_MAX_S})")
    if x.device.index != torch.cuda.current_device():
        raise ValueError(f"pexchange: x on {x.device}, current device is "
                         f"cuda:{torch.cuda.current_device()}")
    from hpddm_tpu_torch import _build

    lib = _build.load()
    fn = lib.pexchange_f64 if x.dtype == torch.float64 else lib.pexchange_f32
    y = torch.empty_like(x)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = fn(x.data_ptr(), y.data_ptr(), plan.slot.data_ptr(),
             plan.rows.data_ptr(), S, n, plan.m_max, plan.k_max, mu, stream)
    if err != 0:
        raise RuntimeError(f"pexchange: kernel launch failed, cudaError {err}")
    launches += 1
    return y
