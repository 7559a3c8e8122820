"""Subdomain decomposition (counterpart of ``hpddm_tpu/parallel/decomposition.py``).

All subdomains are one batch: a leading axis ``S`` of device tensors.
Host-side setup (numpy) resolves the pairwise neighbor lists into one
global *interface numbering* by union-find, so that the runtime exchange
(parallel/ops.py) is a fixed-shape program of gathers and one scatter:
mathematically the reference's sum-reduce of duplicated unknowns
(HPDDM_subdomain.hpp:115-130), with a fixed reduction order.

Two layouts: the caller's local numbering (``renumber=False``), or the
interface-first layout (``renumber=True``, the JAX package's production
unstructured configuration), where each subdomain's interface dofs come
first, in slot order, then its interior, then its pads, so that the
exchange reads and writes the contiguous block x[:, :m_max] only;
``permute``/``unpermute`` move a batch between the two numberings. Two
optional plans route the exchange of the caller's numbering
(parallel/ops.py): ``grid``, the uniform-grid slab plan (parallel/grid.py)
that ``Schwarz.set_grid_geometry`` attaches, and ``pexch``, which sends
the exchange of CUDA tensors through the one-pass kernel
(parallel/pexchange.py); ``Schwarz`` attaches it for ELL operators.

Host helpers of the reference's ``Subdomain`` and ``Schwarz``:
``restrict_pou`` (boolean rounding of a partition of unity),
``Decomposition.global_mapping`` and ``Decomposition.distributed_csr``.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Sequence, Tuple

import numpy as np
import scipy.sparse as sp
import torch

from hpddm_tpu_torch.device import DEFAULT, as_device
from hpddm_tpu_torch.dtypes import as_torch_dtype


def uf_resolve(n: int, pairs_a: np.ndarray, pairs_b: np.ndarray) -> np.ndarray:
    """Resolved union-find roots for n slots linked pairwise.

    The root of a class is its smallest slot id, whatever the link order,
    so the result is canonical. (The numpy fallback of
    ``hpddm_tpu/native/__init__.py`` ``uf_resolve``; the port builds no
    host library.)"""
    parent = np.arange(n, dtype=np.int64)
    pa = np.ascontiguousarray(pairs_a, dtype=np.int64)
    pb = np.ascontiguousarray(pairs_b, dtype=np.int64)

    def find(x):
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x
    for a, b in zip(pa.tolist(), pb.tolist()):
        ra, rb = find(a), find(b)
        if ra != rb:
            parent[max(ra, rb)] = min(ra, rb)
    for i in range(n):
        parent[i] = find(i)
    return parent


def _pair_links(neighbors, mappings, offsets) -> Tuple[np.ndarray, np.ndarray]:
    """The flat slot pairs (offsets[s] + i, offsets[q] + j) that the
    aligned neighbour lists link, each pair of subdomains once, from its
    lower side."""
    pa, pb = [], []
    for s in range(len(neighbors)):
        for q, idx in zip(neighbors[s], mappings[s]):
            if q < s:
                continue
            pos = list(neighbors[q]).index(s)
            pa.append(offsets[s] + np.asarray(idx, dtype=np.int64))
            pb.append(offsets[q] + np.asarray(mappings[q][pos],
                                              dtype=np.int64))
    return (np.concatenate(pa) if pa else np.zeros(0, np.int64),
            np.concatenate(pb) if pb else np.zeros(0, np.int64))


def restrict_pou(neighbors, mappings, d_list) -> bool:
    """Round a partition of unity to boolean ownership in place
    (``Schwarz::restriction``, HPDDM_schwarz.hpp:277-333; the JAX
    package's ``restrict_pou``, ``hpddm_tpu/parallel/decomposition.py:33``).

    Every shared dof whose value is fractional, or whose copies do not
    sum to 1, goes to the sharer with the strictly largest value (ties to
    the higher subdomain id): that copy becomes 1, the others 0. The
    classes are grouped by root with ``reduceat``, no loop over dofs.
    Returns whether anything changed. d_list: per-subdomain (n_s,) arrays
    in the caller's numbering, modified in place."""
    S = len(neighbors)
    n_loc = np.array([len(d) for d in d_list], dtype=np.int64)
    offsets = np.concatenate([[0], np.cumsum(n_loc)])
    roots = uf_resolve(int(offsets[-1]),
                       *_pair_links(neighbors, mappings, offsets))
    flat = np.concatenate([np.asarray(dd, dtype=np.float64)
                           for dd in d_list])
    eps = 1.0e-12
    order = np.argsort(roots, kind="stable")      # ascending slot in a root
    rs = roots[order]
    starts = np.flatnonzero(np.concatenate([[True], rs[1:] != rs[:-1]]))
    counts = np.diff(np.concatenate([starts, [len(rs)]]))
    vals = flat[order]
    gmax = np.maximum.reduceat(vals, starts)
    gsum = np.add.reduceat(vals, starts)
    frac = np.add.reduceat(
        ((np.abs(vals - 1.0) > eps) & (np.abs(vals) > eps)).astype(np.int64),
        starts) > 0
    needs = (counts > 1) & (frac | (np.abs(gsum - 1.0) > eps))
    if not np.any(needs):
        return False
    gid = np.repeat(np.arange(len(starts)), counts)
    # the winner is the last member attaining the max: members ascend by
    # flat slot, so by subdomain id
    ismax = vals >= gmax[gid]
    win = np.maximum.reduceat(np.where(ismax, np.arange(len(vals)), -1),
                              starts)
    new_vals = np.where(needs[gid], 0.0, vals)
    new_vals[win[needs]] = 1.0
    changed = bool(np.any(np.abs(new_vals - vals) > eps))
    if changed:
        flat[order] = new_vals
        for s in range(S):
            d_list[s][:] = flat[offsets[s]: offsets[s + 1]]
    return changed


@dataclasses.dataclass(frozen=True)
class Decomposition:
    """Device-side decomposition state (leading axis = subdomains).

    n_loc : (S,) int32, actual local size of each subdomain (<= n_max).
    d : (S, n_max), partition of unity (``Schwarz::d_``); zero on padding.
    if_idx : (S, m_max) int64, local indices of interface (duplicated) dofs.
    if_gid : (S, m_max) int64, global interface id of each, padded to n_if.
    if_mask : (S, m_max) bool, validity of each slot.
    ov_mask : (S, n_max) bool, union of the neighbor lists (the geometric
        overlap region; used by ``scale_into_overlap`` for GenEO).
    mult : (S, n_max), multiplicity of each dof.
    partners : (S, m_max, k_max) int64, flattened slot ids (q * m_max + j)
        of the other copies of slot (s, k); sentinel S * m_max (a zero pad).
    inv_map : (S, n_max) int64, interface slot of each local dof, or m_max.
    is_if : (S, n_max) bool.
    pexch : the one-pass exchange plan (parallel/pexchange.ExchangePlan),
        or None.
    grid : the uniform-grid slab plan (parallel/grid.GridPlan), or None.
    perm, iperm : (S, n_max) int64 of the interface-first layout:
        perm[s, p] = caller index now at position p, iperm its inverse;
        None in the caller's numbering (``renumbered`` False). There
        if_idx is arange(m_max) on every subdomain: slot k lives at
        position k, and slots past a subdomain's own interface count hold
        interior dofs whose partner lists are empty.

    Index tensors are int64 (torch's index type); their values equal the
    JAX package's int32 arrays.
    """
    n_loc: torch.Tensor
    d: torch.Tensor
    if_idx: torch.Tensor
    if_gid: torch.Tensor
    if_mask: torch.Tensor
    ov_mask: torch.Tensor
    mult: torch.Tensor
    partners: torch.Tensor
    inv_map: torch.Tensor
    is_if: torch.Tensor
    S: int
    n_max: int
    m_max: int
    n_if: int
    n_global: int
    k_max: int
    sub_shifts: Tuple[int, ...] = ()
    pexch: Optional[object] = None
    grid: Optional[object] = None
    perm: Optional[torch.Tensor] = None
    iperm: Optional[torch.Tensor] = None
    renumbered: bool = False

    @property
    def device(self) -> torch.device:
        return self.d.device

    # ------------------------------------------------------------------
    @staticmethod
    def from_subdomains(neighbors: Sequence[Sequence[int]],
                        mappings: Sequence[Sequence[np.ndarray]],
                        n_loc: Sequence[int],
                        d: Optional[Sequence[np.ndarray]] = None,
                        n_max: Optional[int] = None,
                        scaling: str = "normalized",
                        renumber: bool = False,
                        dtype=np.float64,
                        device=DEFAULT) -> "Decomposition":
        """Build from HPDDM-style neighbor lists (general path).

        neighbors[s] = neighbor subdomain ids; mappings[s][j] = local
        indices of the dofs shared with neighbors[s][j], aligned
        elementwise with the other side's list; d[s] = partition of unity
        (None: 1/multiplicity). scaling as in the JAX package:
        "normalized" (d_i / sum over sharers), "given" or "multiplicity".
        renumber: the interface-first layout
        (``hpddm_tpu/parallel/decomposition.py:291-325``).
        """
        device = as_device(device)
        S = len(neighbors)
        n_loc = np.asarray(n_loc, dtype=np.int64)
        if n_max is None:
            n_max = int(n_loc.max()) if S else 0

        offsets = np.concatenate([[0], np.cumsum(n_loc)])
        total = int(offsets[-1])
        pairs_a, pairs_b = [], []
        for s in range(S):
            for q, idx in zip(neighbors[s], mappings[s]):
                if q < s:
                    continue  # handle each pair once, from the lower side
                try:
                    pos = list(neighbors[q]).index(s)
                except ValueError as e:
                    raise ValueError(f"neighbor lists inconsistent: {s}<->{q}") from e
                idx_q = mappings[q][pos]
                if len(idx) != len(idx_q):
                    raise ValueError(
                        f"mapping length mismatch between {s} and {q}: "
                        f"{len(idx)} vs {len(idx_q)}")
                pairs_a.append(offsets[s] + np.asarray(idx, dtype=np.int64))
                pairs_b.append(offsets[q] + np.asarray(idx_q, dtype=np.int64))

        roots = uf_resolve(
            total,
            np.concatenate(pairs_a) if pairs_a else np.zeros(0, np.int64),
            np.concatenate(pairs_b) if pairs_b else np.zeros(0, np.int64))
        # interface dofs: classes with more than one member
        unique_roots, inverse, counts = np.unique(
            roots, return_inverse=True, return_counts=True)
        size_of = counts[inverse]                  # class size of each slot
        shared = size_of > 1
        if_roots = np.unique(roots[shared])
        gid_of = np.searchsorted(if_roots, roots)  # valid where shared
        n_if = len(if_roots)
        n_global = len(unique_roots)

        m_count = np.array([int(shared[offsets[s]:offsets[s + 1]].sum())
                            for s in range(S)], dtype=np.int64)
        m_max = int(m_count.max(initial=1))

        if_idx = np.zeros((S, m_max), dtype=np.int64)
        if_gid = np.full((S, m_max), n_if, dtype=np.int64)
        if_mask = np.zeros((S, m_max), dtype=bool)
        mult = np.zeros((S, n_max), dtype=dtype)
        ov_mask = np.zeros((S, n_max), dtype=bool)
        inv_map = np.full((S, n_max), m_max, dtype=np.int64)
        class_slots: dict = {}
        for s in range(S):
            lo, hi = offsets[s], offsets[s + 1]
            loc = np.nonzero(shared[lo:hi])[0]
            if_idx[s, : len(loc)] = loc
            if_gid[s, : len(loc)] = gid_of[lo + loc]
            if_mask[s, : len(loc)] = True
            inv_map[s, loc] = np.arange(len(loc))
            for k, i in enumerate(loc.tolist()):
                class_slots.setdefault(int(roots[lo + i]), []).append(
                    s * m_max + k)
            mult[s, : n_loc[s]] = size_of[lo:hi]
            for idx in mappings[s]:
                ov_mask[s, np.asarray(idx, dtype=np.int64)] = True

        # partner tables: each slot lists the other copies of its class
        k_max = max((len(v) - 1 for v in class_slots.values()), default=1)
        k_max = max(k_max, 1)
        sentinel = S * m_max
        partners = np.full((S, m_max, k_max), sentinel, dtype=np.int64)
        for members in class_slots.values():
            for me in members:
                others = [p for p in members if p != me]
                s_i, k_i = divmod(me, m_max)
                partners[s_i, k_i, : len(others)] = others
        valid = partners != sentinel
        src = np.broadcast_to(np.arange(S)[:, None, None], partners.shape)
        sub_shifts = tuple(
            int(v) for v in np.unique(partners[valid] // m_max
                                      - src[valid])) if valid.any() else ()

        d_arr = np.zeros((S, n_max), dtype=dtype)
        if d is None or scaling == "multiplicity":
            for s in range(S):
                d_arr[s, : n_loc[s]] = 1.0 / mult[s, : n_loc[s]]
        else:
            for s in range(S):
                d_arr[s, : n_loc[s]] = np.asarray(d[s], dtype=dtype)
            if scaling == "normalized":
                # class-wise normalization d_i <- d_i / sum_{sharers} d_q
                # (the fixed point of multiplicityScaling). np.add.at adds
                # in slot order, the order of the JAX package's loop, so
                # the sums and d are bitwise the same.
                flat = np.concatenate([d_arr[s, : n_loc[s]]
                                       for s in range(S)])
                class_sum = np.zeros(n_global, dtype=dtype)
                np.add.at(class_sum, inverse, flat)
                with np.errstate(divide="ignore", invalid="ignore"):
                    flat = np.where(np.abs(flat) < 1.0e-12, 0.0,
                                    flat / class_sum[inverse])
                for s in range(S):
                    d_arr[s, : n_loc[s]] = flat[offsets[s]: offsets[s + 1]]

        perm = iperm = None
        is_if = inv_map < m_max
        if renumber:
            # interface-first: slot k at position k, the interior next,
            # the pads last; the per-dof arrays follow the permutation
            perm = np.zeros((S, n_max), dtype=np.int64)
            iperm = np.zeros((S, n_max), dtype=np.int64)
            for s in range(S):
                iface = if_idx[s, : m_count[s]]
                interior = np.ones(n_loc[s], dtype=bool)
                interior[iface] = False
                order = np.concatenate([iface, np.nonzero(interior)[0],
                                        np.arange(n_loc[s], n_max)])
                perm[s] = order
                iperm[s, order] = np.arange(n_max)
                d_arr[s] = d_arr[s][order]
                mult[s] = mult[s][order]
                ov_mask[s] = ov_mask[s][order]
            if_idx = np.broadcast_to(np.arange(m_max), (S, m_max)).copy()
            inv_map = np.broadcast_to(
                np.where(np.arange(n_max) < m_max, np.arange(n_max), m_max),
                (S, n_max)).copy()
            is_if = np.arange(n_max)[None, :] < m_count[:, None]

        def dev(a, dt=None):
            return None if a is None else \
                torch.as_tensor(a, dtype=dt, device=device)

        fdt = as_torch_dtype(dtype)
        return Decomposition(
            n_loc=dev(n_loc, torch.int32), d=dev(d_arr, fdt),
            if_idx=dev(if_idx), if_gid=dev(if_gid), if_mask=dev(if_mask),
            ov_mask=dev(ov_mask), mult=dev(mult, fdt),
            partners=dev(partners), inv_map=dev(inv_map),
            is_if=dev(is_if),
            S=S, n_max=int(n_max), m_max=m_max, n_if=n_if,
            n_global=n_global, k_max=int(k_max), sub_shifts=sub_shifts,
            perm=dev(perm), iperm=dev(iperm), renumbered=bool(renumber))

    # ------------------------------------------------------------------
    @functools.cached_property
    def scatter_index(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """(flat row positions s * n_max + if_idx, flat slot ids
        s * m_max + k) of the valid interface slots: the write-back of the
        exchange as one index_copy_ with unique targets. Derived from
        if_idx and if_mask once, on first use."""
        s_idx = torch.arange(self.S, device=self.device)[:, None]
        pos = (s_idx * self.n_max + self.if_idx)[self.if_mask]
        k = torch.arange(self.m_max, device=self.device)[None, :]
        slot = (s_idx * self.m_max + k)[self.if_mask]
        return pos, slot

    def _gather(self, x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
        if x.dim() == 3:
            idx = idx[:, :, None].expand(-1, -1, x.shape[2])
        return torch.gather(x, 1, idx)

    def permute(self, x: torch.Tensor) -> torch.Tensor:
        """Caller -> internal (interface-first) numbering of x (S, n_max)
        or (S, n_max, mu): one gather; the identity when not renumbered."""
        return self._gather(x, self.perm) if self.renumbered else x

    def unpermute(self, x: torch.Tensor) -> torch.Tensor:
        """Internal -> caller numbering; the identity when not renumbered."""
        return self._gather(x, self.iperm) if self.renumbered else x

    def permute_host(self, v: np.ndarray, s: int) -> np.ndarray:
        """Subdomain s's host vector (or (n_s, k) block) of length n_loc[s]
        in the internal numbering."""
        if not self.renumbered:
            return v
        order = self.perm[s].cpu().numpy()
        return np.asarray(v)[order[order < len(v)]]

    @staticmethod
    def global_mapping(neighbors, mappings, n_loc):
        """Owner-based contiguous global numbering (``Subdomain::
        globalMapping``, HPDDM_subdomain.hpp:471-544): every dof class gets
        the rank of its root (its smallest flat slot, so its lowest-id
        sharer) among the sorted roots. Returns (list of (n_loc[s],) int64
        arrays, n_global). A method of the JAX package's Decomposition that
        reads none of its fields; a static method here."""
        n_loc = np.asarray(n_loc, dtype=np.int64)
        offsets = np.concatenate([[0], np.cumsum(n_loc)])
        roots = uf_resolve(int(offsets[-1]),
                           *_pair_links(neighbors, mappings, offsets))
        uniq, inverse = np.unique(roots, return_inverse=True)
        return ([inverse[offsets[s]: offsets[s + 1]].astype(np.int64)
                 for s in range(len(neighbors))], len(uniq))

    @staticmethod
    def distributed_csr(mats, gids, d_list, n_global):
        """The global CSR matrix sum_s R_s^T D_s A_s R_s of overlapping
        local matrices (``Subdomain::distributedCSR``,
        HPDDM_subdomain.hpp:549-656), d_list in the caller's numbering."""
        acc = sp.csr_matrix((n_global, n_global))
        for s, m in enumerate(mats):
            n = m.n
            R = sp.csr_matrix((np.ones(n), (np.asarray(gids[s]),
                                            np.arange(n))),
                              shape=(n_global, n))
            D = sp.diags(np.asarray(d_list[s])[:n])
            acc = acc + R @ D @ m.scipy(expand=True) @ R.T
        return sp.csr_matrix(acc)

    @property
    def row_mask(self) -> torch.Tensor:
        """(S, n_max) bool, valid (non-padded) rows."""
        return (torch.arange(self.n_max, device=self.device)[None, :]
                < self.n_loc[:, None])

    def zero_pad(self, x: torch.Tensor) -> torch.Tensor:
        """x (S, n_max, ...) with its padded rows set to zero."""
        mask = self.row_mask
        return torch.where(mask.reshape(mask.shape + (1,) * (x.dim() - 2)),
                           x, x.new_zeros(()))
