"""General additive exchange in one kernel (counterpart of ``hpddm_tpu/parallel/pexchange.py``).

The exchange of the general path (parallel/ops.py ``exchange``) is a
dozen PyTorch operations: interface gather, partner gathers and adds, one
scatter back. ``pexchange`` computes the same function in one launch of
the hand-written kernel ``csrc/pexchange.cu``, which replaces the JAX
package's three Pallas passes (``_pexchange``, :149). For every local dof
(s, i):

    y[s, i] = x[s, i] + (x[r_0] + x[r_1] + ...)

over the flat rows r_k of the other copies of the dof's interface slot;
interior and padding dofs pass through. The launch has two roles with
disjoint writes: a copy of x to y over the dofs that ``interior`` marks,
and one unit per interface slot that writes its dof's sum. ``build_plan``
derives the maps both read from a ``Decomposition``, once and on its
device. On CPU tensors ``pexchange`` runs ``pexchange_reference``, the
same function in plain PyTorch on the same plan; a CUDA tensor that the
kernel does not take raises.

Both sum each slot's partners in the plain exchange's order (the first
partner, then each next one added, a missing partner as +0, then the
dof's own value added), so the kernel, ``pexchange_reference`` and
``exchange`` agree bitwise.
"""

from __future__ import annotations

import collections
import dataclasses

import torch

# launches of the CUDA kernel since the last reset (plain-version calls on
# CPU tensors are not counted), in all and by the panel width mu
launches = 0
launches_by_mu: collections.Counter = collections.Counter()


@dataclasses.dataclass(frozen=True)
class ExchangePlan:
    """Index maps of the one-pass exchange, on the decomposition's device.

    interior : (S, n_max) bool, True where the dof passes through (interior
        or padding), False on an interface dof.
    dst : (S, m_max) int32, flat row s * n_max + if_idx[s, p] of each
        interface slot (s, p), -1 on a padding slot.
    rows : (S, k_max, m_max) int32, slot-major: the flat row
        q * n_max + if_idx[q, j] of the k-th partner slot q * m_max + j of
        ``Decomposition.partners[s, p]``, -1 where the partner list has
        ended.
    """
    interior: torch.Tensor
    dst: torch.Tensor
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
    sub = torch.arange(S, device=p.device)[:, None]
    dst = torch.where(dec.if_mask, sub * n + dec.if_idx, -1)
    return ExchangePlan(interior=(~dec.is_if).contiguous(),
                        dst=dst.to(torch.int32).contiguous(),
                        rows=rows.transpose(1, 2).to(torch.int32)
                        .contiguous(),
                        n_max=n, m_max=m, k_max=int(p.shape[2]))


def pexchange_reference(plan: ExchangePlan, x: torch.Tensor) -> torch.Tensor:
    """Plain version of the kernel. x: (S, n_max, mu) -> a new contiguous
    tensor of the same shape."""
    S, n, mu = x.shape
    flat = torch.cat([x.reshape(S * n, mu), x.new_zeros((1, mu))])
    rows = plan.rows.long()
    pvals = flat[torch.where(rows < 0, S * n, rows)]      # (S, k, m, mu)
    acc = pvals[:, 0]
    for k in range(1, pvals.shape[1]):
        acc = acc + pvals[:, k]
    dst = plan.dst.long()
    on = dst >= 0
    sums = flat[dst[on]] + acc[on]
    out = flat[: S * n]                   # a view of the fresh copy
    out.index_copy_(0, dst[on], sums)
    return out.view(S, n, mu)


def pexchange(plan: ExchangePlan, x: torch.Tensor) -> torch.Tensor:
    """Sum-reduce duplicated unknowns of x (S, n_max, mu) in one pass."""
    global launches
    tensors = (plan.interior, plan.dst, plan.rows, x)
    if all(t.device.type == "cpu" for t in tensors):
        return pexchange_reference(plan, x)
    if not all(t.is_cuda and t.device == x.device for t in tensors):
        raise ValueError(f"pexchange: plan on {plan.dst.device}, x on "
                         f"{x.device}; both must be on the same CUDA device")
    if x.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"pexchange: dtype {x.dtype}; the kernel takes "
                        "float32 or float64 (its complex form is ROADMAP "
                        "queue B, item B5c)")
    if x.dim() != 3 or tuple(x.shape[:2]) != tuple(plan.interior.shape):
        raise ValueError(f"pexchange: x {tuple(x.shape)} does not match the "
                         f"plan's (S, n_max) = {tuple(plan.interior.shape)}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("pexchange: x and the plan must be contiguous")
    S, n, mu = x.shape
    if S * n * mu >= 2 ** 31:            # the kernel's 32-bit unit index
        raise ValueError(f"pexchange: S * n * mu = {S * n * mu} elements "
                         "exceed the kernel's limit (< 2^31)")
    if x.device.index != torch.cuda.current_device():
        raise ValueError(f"pexchange: x on {x.device}, current device is "
                         f"cuda:{torch.cuda.current_device()}")
    from hpddm_tpu_torch import _build

    lib = _build.load()
    fn = lib.pexchange_f64 if x.dtype == torch.float64 else lib.pexchange_f32
    y = torch.empty_like(x)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = fn(x.data_ptr(), y.data_ptr(), plan.interior.data_ptr(),
             plan.dst.data_ptr(), plan.rows.data_ptr(), S, n, plan.m_max,
             plan.k_max, mu, stream)
    if err != 0:
        raise RuntimeError(f"pexchange: kernel launch failed, cudaError {err}")
    launches += 1
    launches_by_mu[mu] += 1
    return y
