"""Carry a JAX-built preconditioner state into the port.

``state_from_numpy`` builds the port's ``SchwarzState`` from the arrays of
a ``hpddm_tpu`` ``SchwarzState`` that the caller has flattened to numpy, so
that the port's runtime (``gmv``, ``apply``, GMRES) can be held against the
JAX runtime on identical operators, independently of the port's own setup.
This module imports no JAX: the caller does the extraction.

Keys of ``arrays`` (numpy arrays unless stated):

* decomposition: ``n_loc``, ``d``, ``if_idx``, ``if_gid``, ``if_mask``,
  ``ov_mask``, ``mult``, ``partners``, ``inv_map``, ``is_if``; ints
  ``S``, ``n_max``, ``m_max``, ``n_if``, ``n_global``, ``k_max``; tuple
  ``sub_shifts`` (optional); ``grid`` (optional): the fields of the JAX
  package's ``GridPlan`` as a dict (``nbr``, ``sxw``, ``syw``, ``onehot``
  arrays, ints ``H``, ``W``, ``t``, ``S``, ``gx``, ``gy``, bool
  ``regular``, tuples ``sxw_s``, ``syw_s``), which routes the exchange
  through the slab plan; ``perm``, ``iperm`` (arrays or None) and bool
  ``renumbered`` (optional, False where absent) for the interface-first
  layout, which gets no one-pass exchange plan;
* local matrices: DIA as ``A_values`` (S, nd, n_max) and ``A_offsets``
  (tuple) with ``A_canvas_hw`` (optional, the canvas (H, W)) and
  ``A_values_lp`` (optional, the bf16 mirror of ``-hpddm_gmv_dtype``:
  numpy has no bfloat16, so the caller passes its values in float32; they
  are stored as bfloat16, exactly), or ELL as ``A_values`` (S, n_max, w) and ``A_cols`` (S, n_max,
  w), the JAX package's row-major layout; an ELL operator is stored
  slot-major with its kernel payload and gets the one-pass exchange plan,
  as ``Schwarz`` gives them;
* local solver (absent for an ``operator_state``): ``factor`` (S, n_max,
  n_max) with str ``local_kind`` (``inv`` where absent; ``lu``, ``chol``
  or ``qr``) and ``aux`` (lu: the JAX package's 0-based pivots, carried
  as torch's 1-based ones; qr: R), the factor of the optimized matrices
  for an ORAS/SORAS state, or banded as
  ``Dinv``, ``cl``, ``cu``, ``idx_fwd``, ``msk_fwd``, ``idx_inv``,
  ``msk_inv`` (the JAX package's ``BandedSolver`` arrays) and ints
  ``wy_max``, ``wx_max``, ``cw``, or a DST solver as the dict ``dst``
  (``dst_solver_from_numpy``), or a Chebyshev solver as the dict
  ``cheby`` (``cheby_solver_from_numpy``);
* coarse space (optional; absent for one level): ``Z``, ``E_inv`` (None
  in ``bsr`` mode), ``nu_loc``; int ``nu_max``; str ``correction``; and,
  for the nested modes of the level-2 options, str ``mode`` (``direct``
  where absent), the scalars ``inner_tol``, ``inner_max_it``, ``method``,
  ``restart``, ``prec``, ``lvl3``, ``l3_tol``, ``l3_max_it``, the arrays
  (each optional) ``E``, ``E2_inv``, ``Z2``, ``E2``, ``Eloc_inv``,
  ``loc_idx``, ``agg_oh``, ``Eb_diag``, ``Eb_nbr``, ``Eb_diag_inv`` and
  ``nbr_oh`` (the JAX package's (S, K, S+1) one-hot of the neighbour
  blocks, carried as the port's gather index ``nbr_idx``), and the
  levels-4+ tuples ``chain_Z``, ``chain_E``, ``chain_inv`` (arrays),
  ``chain_modes``, ``chain_tols``, ``chain_max_its``;
* ``variant`` (str) and ``bc`` (array or None).

``substructure_state_from_numpy`` does the same for a ``hpddm_tpu``
``SubstructureState`` (FETI/BDD in every local and coarse mode), with its
interface decomposition ``dec_b`` given by the decomposition keys above
(``decomposition_from_numpy``), its banded factors by the keys of
``banded_solver_from_numpy`` and its packed local matrices by the layout
keys above, so that the port's FETI and BDD runtimes run on the JAX
package's factors and Chebyshev bounds, independently of how each
package's eigh picks its kernel bases and of the start vectors of its
bounds.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

import numpy as np
import torch

from hpddm_tpu_torch.core.formats import BatchedDIA, BatchedELL
from hpddm_tpu_torch.device import DEFAULT, as_device
from hpddm_tpu_torch.dtypes import as_torch_dtype, underlying
from hpddm_tpu_torch.ops.banded_solve import BandedSolver
from hpddm_tpu_torch.ops.cheby_solve import ChebyLocalSolver
from hpddm_tpu_torch.ops.fft_solve import DSTMatmulSolver, FFTLocalSolver
from hpddm_tpu_torch.ops.local_solve import LocalSolver
from hpddm_tpu_torch.parallel.decomposition import Decomposition
from hpddm_tpu_torch.parallel.grid import GridPlan
from hpddm_tpu_torch.parallel.pexchange import build_plan
from hpddm_tpu_torch.precond.schwarz import CoarseState, SchwarzState

DEC_INT_KEYS = ("S", "n_max", "m_max", "n_if", "n_global", "k_max")
# CoarseState fields beyond the direct solve's
COARSE_ARRAYS = ("E", "E2_inv", "Z2", "E2", "Eloc_inv", "agg_oh", "Eb_diag",
                 "Eb_nbr", "Eb_diag_inv")
COARSE_SCALARS = ("mode", "inner_tol", "inner_max_it", "method", "restart",
                  "prec", "lvl3", "l3_tol", "l3_max_it")
COARSE_CHAIN = ("chain_Z", "chain_E", "chain_inv")


def state_from_numpy(arrays: Dict[str, Any], device=DEFAULT,
                     dtype=None) -> SchwarzState:
    """A port ``SchwarzState`` on ``device`` whose floating tensors are in
    ``dtype`` (default f64, c128 for a complex operator ``A_values``),
    the decomposition's POU and multiplicities in its real type, and whose
    index tensors are int64 (int32 for ELL columns)."""
    device = as_device(device)
    if dtype is None:
        dtype = torch.complex128 if np.iscomplexobj(arrays["A_values"]) \
            else torch.float64
    dtype = as_torch_dtype(dtype)

    def t(key, dt):
        # a copy: the arrays of a JAX state are read-only views
        return torch.as_tensor(np.array(arrays[key]), device=device).to(dt)

    def f(key):
        return t(key, dtype)

    def i(key):
        return t(key, torch.int64)

    def kept_array(a):
        # local factors and coarse arrays held in a lower precision than
        # the operator (the JAX package's mixed precision) keep it
        low = as_torch_dtype(np.asarray(a).dtype)
        return torch.as_tensor(np.array(a), device=device).to(
            low if low.itemsize < dtype.itemsize else dtype)

    def kept(key):
        return kept_array(arrays[key])

    dec = decomposition_from_numpy(arrays, device, underlying(dtype))
    grid = arrays.get("grid")
    if grid is not None:
        dec = dataclasses.replace(dec, grid=GridPlan(
            **{k: torch.as_tensor(np.array(grid[k]), device=device)
               for k in ("nbr", "sxw", "syw", "onehot")},
            **{k: int(grid[k]) for k in ("H", "W", "t", "S", "gx", "gy")},
            regular=bool(grid["regular"]),
            sxw_s=tuple(map(tuple, grid["sxw_s"])),
            syw_s=tuple(map(tuple, grid["syw_s"]))))
    A = _matrix(arrays, int(arrays["n_max"]), device, dtype)
    if isinstance(A, BatchedELL) and not dec.renumbered:
        dec = dataclasses.replace(dec, pexch=build_plan(dec))
    coarse = None
    if arrays.get("Z") is not None:
        def opt(key, conv):
            return None if arrays.get(key) is None else conv(key)
        extra = {k: opt(k, kept) for k in COARSE_ARRAYS}
        extra.update({k: arrays[k] for k in COARSE_SCALARS if k in arrays})
        extra.update({k: tuple(kept_array(a) for a in arrays[k])
                      for k in COARSE_CHAIN if k in arrays})
        extra.update({k: tuple(arrays[k]) for k in (
            "chain_modes", "chain_tols", "chain_max_its") if k in arrays})
        if arrays.get("nbr_oh") is not None:
            extra["nbr_idx"] = torch.as_tensor(
                np.argmax(np.asarray(arrays["nbr_oh"]), axis=-1),
                device=device)
        coarse = CoarseState(
            Z=kept("Z"), E_inv=opt("E_inv", kept),
            nu_loc=t("nu_loc", torch.int32), loc_idx=opt("loc_idx", i),
            nu_max=int(arrays["nu_max"]), correction=str(arrays["correction"]),
            **extra)
    if arrays.get("Dinv") is not None:
        solver = banded_solver_from_numpy(arrays, device, dtype)
    elif arrays.get("dst") is not None:
        solver = dst_solver_from_numpy(arrays["dst"], device, dtype)
    elif arrays.get("cheby") is not None:
        solver = cheby_solver_from_numpy(arrays["cheby"], device, dtype)
    elif arrays.get("factor") is not None:
        kind = str(arrays.get("local_kind", "inv"))
        aux = arrays.get("aux")
        if kind == "lu":
            aux = torch.as_tensor(np.asarray(aux) + 1, dtype=torch.int32,
                                  device=device)
        elif aux is not None:
            aux = kept("aux")
        solver = LocalSolver(kind=kind, factor=kept("factor"), aux=aux)
    else:
        solver = None                                 # operator_state
    bc = arrays.get("bc")
    return SchwarzState(
        dec=dec, A=A, solver=solver, coarse=coarse,
        variant=str(arrays["variant"]), bc=None if bc is None else f("bc"))


def banded_solver_from_numpy(d: Dict[str, Any], device=DEFAULT,
                             dtype=torch.float64) -> BandedSolver:
    """The port's ``BandedSolver`` from the arrays of the JAX package's:
    ``Dinv``, ``cl``, ``cu``, ``idx_fwd``, ``msk_fwd``, ``idx_inv``,
    ``msk_inv`` and ints ``wy_max``, ``wx_max``, ``n_max``, ``S``, ``cw``.
    Factors held in a lower precision than dtype keep it; indices are
    int64."""
    device = as_device(device)
    dtype = as_torch_dtype(dtype)

    def kept(key):
        low = as_torch_dtype(np.asarray(d[key]).dtype)
        return torch.as_tensor(np.array(d[key]), device=device).to(
            low if low.itemsize < dtype.itemsize else dtype)

    def i(key):
        return torch.as_tensor(np.array(d[key]), device=device).to(
            torch.int64)
    return BandedSolver(
        Dinv=kept("Dinv"), cl=kept("cl"), cu=kept("cu"),
        idx_fwd=i("idx_fwd"), msk_fwd=kept("msk_fwd"),
        idx_inv=i("idx_inv"), msk_inv=kept("msk_inv"),
        wy_max=int(d["wy_max"]), wx_max=int(d["wx_max"]),
        n_max=int(d["n_max"]), S=int(d["S"]), cw=int(d["cw"]))


def decomposition_from_numpy(arrays: Dict[str, Any], device,
                             rdtype) -> Decomposition:
    """The port's ``Decomposition`` from the decomposition keys of
    ``state_from_numpy`` (its POU and multiplicities in rdtype)."""
    def t(key, dt):
        return torch.as_tensor(np.array(arrays[key]), device=device).to(dt)

    def i(key):
        return t(key, torch.int64)

    def b(key):
        return t(key, torch.bool)

    return Decomposition(
        n_loc=t("n_loc", torch.int32),
        d=t("d", rdtype), if_idx=i("if_idx"), if_gid=i("if_gid"),
        if_mask=b("if_mask"), ov_mask=b("ov_mask"), mult=t("mult", rdtype),
        partners=i("partners"), inv_map=i("inv_map"), is_if=b("is_if"),
        sub_shifts=tuple(arrays.get("sub_shifts", ())),
        perm=None if arrays.get("perm") is None else i("perm"),
        iperm=None if arrays.get("iperm") is None else i("iperm"),
        renumbered=bool(arrays.get("renumbered", False)),
        **{k: int(arrays[k]) for k in DEC_INT_KEYS})


# SubstructureState fields carried as floating tensors, index tensors and
# boolean masks; G, GtG_inv, G_def, FG_def and GFG_inv are optional
SUB_FLOAT = ("K_pinv", "kernels", "S_b", "S_b_pinv", "Sb_kernels", "K_bi",
             "K_bb", "scaling", "Kii_inv", "lam_sign")
SUB_INDEX = ("r_loc", "sb_r_loc", "bidx", "iidx", "lam_id", "lam_loc",
             "kern_off", "sub_gid")
SUB_MASK = ("b_mask", "i_mask")
SUB_OPTIONAL = ("G", "GtG_inv", "G_def", "FG_def", "GFG_inv")
# the Chebyshev bounds (floats, optional) and the degrees and refinements
# (ints, 0 or the default where absent) of the cheby and banded modes
SUB_BOUNDS = ("gtg_lo", "gtg_hi", "wsw_lo", "wsw_hi", "sb_lo", "sb_hi")
SUB_COUNTS = ("coarse_degree", "bdd_coarse_degree", "sb_degree", "k_refine")


def substructure_state_from_numpy(arrays: Dict[str, Any], device=DEFAULT,
                                  dtype=torch.float64):
    """A port ``SubstructureState`` from the arrays of a JAX package
    ``SubstructureState`` flattened to numpy: the fields of ``SUB_FLOAT``,
    ``SUB_INDEX``, ``SUB_MASK`` and (each optional, None where absent)
    ``SUB_OPTIONAL``; ints ``N_l``, ``nc``, ``n_max``, ``S_total``; strs
    ``coarse_mode`` (``dense``, ``mfree`` or ``cheby``) and ``local_mode``
    (``dense`` or ``banded``; dense where absent); the floats of
    ``SUB_BOUNDS`` and ints of ``SUB_COUNTS`` where the modes set them;
    in the banded mode ``Kb`` and ``Kiib`` (dicts for
    ``banded_solver_from_numpy``) and ``A_loc`` (a dict of the local
    matrices' layout keys as ``state_from_numpy`` takes them); and
    ``dec_b``, a dict of the interface decomposition's keys. The gather
    lists of B and B^T are derived from the slot arrays, so the port's
    runtime runs on the JAX package's factors."""
    from hpddm_tpu_torch.precond.substructure import (SubstructureState,
                                                      plan_of)
    device = as_device(device)
    dtype = as_torch_dtype(dtype)
    mode = str(arrays.get("coarse_mode", "dense"))
    local = str(arrays.get("local_mode", "dense"))
    if mode not in ("dense", "mfree", "cheby") or \
            local not in ("dense", "banded"):
        raise ValueError(f"unknown substructuring modes: coarse {mode!r}, "
                         f"local {local!r}")

    def t(a, dt):
        return torch.as_tensor(np.array(a), device=device).to(dt)

    fields = {k: t(arrays[k], dtype) for k in SUB_FLOAT}
    fields.update({k: t(arrays[k], torch.int64) for k in SUB_INDEX})
    fields.update({k: t(arrays[k], torch.bool) for k in SUB_MASK})
    fields.update({k: None if arrays.get(k) is None else t(arrays[k], dtype)
                   for k in SUB_OPTIONAL})
    ints = {k: int(arrays[k]) for k in ("N_l", "nc", "n_max", "S_total")}
    plan = plan_of(arrays["lam_id"], arrays["lam_loc"], arrays["lam_sign"],
                   arrays["bidx"], arrays["b_mask"], arrays["iidx"],
                   arrays["i_mask"], arrays["r_loc"], arrays["kern_off"],
                   int(np.shape(arrays["kernels"])[2]), ints["N_l"],
                   ints["nc"], ints["n_max"], device)
    dec_b = decomposition_from_numpy(arrays["dec_b"], device,
                                     underlying(dtype))
    fields.update({k: float(arrays[k]) for k in SUB_BOUNDS
                   if arrays.get(k) is not None})
    fields.update({k: int(arrays[k]) for k in SUB_COUNTS if k in arrays})
    if local == "banded":
        fields.update(
            Kb=banded_solver_from_numpy(arrays["Kb"], device, dtype),
            Kiib=banded_solver_from_numpy(arrays["Kiib"], device, dtype),
            A_loc=_matrix(arrays["A_loc"], ints["n_max"], device, dtype))
    return SubstructureState(dec_b=dec_b, plan=plan, coarse_mode=mode,
                             local_mode=local, **fields, **ints)


def _matrix(arrays: Dict[str, Any], n_max: int, device, dtype):
    """The local matrices of ``arrays`` (``A_values`` with ``A_offsets``,
    ``A_canvas_hw`` and ``A_values_lp`` for DIA, with ``A_cols`` for ELL,
    the JAX package's layouts) as a port batch in dtype."""
    vals = torch.as_tensor(np.array(arrays["A_values"]), device=device) \
        .to(dtype)
    if arrays.get("A_cols") is not None:
        cols = torch.as_tensor(np.array(arrays["A_cols"]), device=device) \
            .to(torch.int32)
        return BatchedELL.from_slot_major(
            vals.transpose(1, 2).contiguous(),
            cols.transpose(1, 2).contiguous(), n_max)
    hw = arrays.get("A_canvas_hw")
    lp = arrays.get("A_values_lp")
    return BatchedDIA(values=vals.contiguous(),
                      offsets=tuple(int(o) for o in arrays["A_offsets"]),
                      n_max=n_max,
                      canvas_hw=None if hw is None else tuple(map(int, hw)),
                      values_lp=None if lp is None else torch.as_tensor(
                          np.array(lp), device=device)
                      .to(torch.bfloat16).contiguous())


def dst_solver_from_numpy(d: Dict[str, Any], device=DEFAULT, dtype=None):
    """The port's DST solver from the leaves of the JAX package's: a
    ``DSTMatmulSolver`` (keys ``Uy``, ``Ux``, ``inv_eigs``, ``idx_fwd``,
    ``msk_fwd``, ``idx_inv``, ``msk_inv``, ints ``wy_max``, ``wx_max``,
    ``n_max``, ``S``) or an ``FFTLocalSolver`` (``inv_eigs`` a tuple of
    arrays, ``members`` a tuple of index tuples, ``shapes``, ``n_max``,
    ``S``). Values in dtype (default the arrays' own), indices int64."""
    device = as_device(device)

    def f(a):
        t = torch.as_tensor(np.array(a), device=device)
        return t if dtype is None else t.to(as_torch_dtype(dtype))

    def i(a):
        return torch.as_tensor(np.array(a), device=device).to(torch.int64)
    if "Uy" in d:
        return DSTMatmulSolver(
            Uy=f(d["Uy"]), Ux=f(d["Ux"]), inv_eigs=f(d["inv_eigs"]),
            idx_fwd=i(d["idx_fwd"]), msk_fwd=f(d["msk_fwd"]),
            idx_inv=i(d["idx_inv"]), msk_inv=f(d["msk_inv"]),
            wy_max=int(d["wy_max"]), wx_max=int(d["wx_max"]),
            n_max=int(d["n_max"]), S=int(d["S"]))
    return FFTLocalSolver(
        inv_eigs=tuple(f(a) for a in d["inv_eigs"]),
        members=tuple(i(m) for m in d["members"]),
        shapes=tuple(tuple(map(int, sh)) for sh in d["shapes"]),
        n_max=int(d["n_max"]), S=int(d["S"]))


def cheby_solver_from_numpy(d: Dict[str, Any], device=DEFAULT,
                            dtype=torch.float64) -> ChebyLocalSolver:
    """The port's ``ChebyLocalSolver`` from the JAX package's: its
    matrices (``A_values`` and the layout keys of ``state_from_numpy``),
    ``inner`` (a dict for ``dst_solver_from_numpy``, or None), ``dinv``,
    ``scale`` (arrays or None), ``lo``, ``hi`` and int ``k``."""
    device = as_device(device)
    dtype = as_torch_dtype(dtype)

    def f(key):
        a = d.get(key)
        return None if a is None else \
            torch.as_tensor(np.array(a), device=device).to(dtype)
    A = _matrix(d, int(np.asarray(d["A_values"]).shape[-1]
                       if d.get("A_cols") is None else
                       np.asarray(d["A_values"]).shape[1]), device, dtype)
    inner = None if d.get("inner") is None else \
        dst_solver_from_numpy(d["inner"], device, dtype)
    return ChebyLocalSolver(A=A, inner=inner, dinv=f("dinv"),
                            scale=f("scale"), lo=f("lo"), hi=f("hi"),
                            k=int(d["k"]))
