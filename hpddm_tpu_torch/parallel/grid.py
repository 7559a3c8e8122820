"""Structured-grid halo exchange (counterpart of ``hpddm_tpu/parallel/grid.py``).

For 2D grid decompositions with uniform boxes
(``models/diffusion2d.generate_uniform``) the duplicated unknowns are the
box-boundary strips, so the JAX package writes the additive exchange as
static slices, eight neighbour strip takes, static realignment shifts and
adds, with no index gather or scatter (a TPU runs gathers element by
element). Neighbour strips are padded to width ``t = 3*overlap``
(edge boxes are extended inward to stay uniform, which widens their shared
region to 3*overlap; interior pairs share 2*overlap) and realigned per
subdomain with 2-3 static shifts under static masks.

The takes and selects only move values and fill zeros. On the card each
of them is a launch, so the plan composes them once, by running them on a
canvas of flat positions, into one index map: a call is one gather of the
eight contributions and the adds of the composition, in the JAX package's
default order ("hybrid", ``grid.py:342-355``). A panel of right-hand sides
runs as a leading batch axis of the single-RHS canvas, the arithmetic of
the JAX package's ``vmap`` (``grid.py:258-269``); ``grid_exchange_muT``
takes a panel with the right-hand-side axis leading through the same map
laid out for it, without the permutes. The result equals the
JAX package's value for value (only the sign of a zero may differ where
the JAX package adds a zero to -0.0) and the general exchange's to about
1e-13 (``tests/test_grid_exchange.py:37-45``).

The port runs on one device, so every plan covers the whole batch: the
JAX package's sharded helpers (``_global_row_shift``,
``_sharded_neighbor_take``) and traced selects (``_shift_select``,
``_shift_select_mu``) have no caller here.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from hpddm_tpu_torch.device import DEFAULT, as_device

# direction order: E, W, N, S, NE, NW, SE, SW as (dy, dx)
_DIRS = ((0, 1), (0, -1), (-1, 0), (1, 0), (-1, 1), (-1, -1), (1, 1), (1, -1))


@dataclasses.dataclass(frozen=True)
class GridPlan:
    """Static halo-exchange plan for a uniform-box 2D grid decomposition.

    nbr, sxw, syw: (S, 8) int32 neighbour subdomain id (sentinel S) and
    the extent shared with it along x and y; onehot: (S, 8, S+1) one-hot
    of nbr, the neighbour take of an irregular grid. ``regular``: the
    subdomains are numbered row-major on the process grid (s == iy*gx +
    ix), and a neighbour take is a static shift of the (gy, gx) grid of
    strips. sxw_s / syw_s: host copies of sxw / syw, tuple[dir][s]."""
    nbr: torch.Tensor
    sxw: torch.Tensor
    syw: torch.Tensor
    onehot: torch.Tensor
    H: int
    W: int
    t: int
    S: int
    gx: int
    gy: int
    regular: bool
    sxw_s: Tuple[Tuple[int, ...], ...]
    syw_s: Tuple[Tuple[int, ...], ...]

    @functools.cached_property
    def index(self):
        """The neighbour contributions' gather map (``_gather_map``), built
        on the first exchange."""
        return _gather_map(self)

    @functools.cached_property
    def muT_index(self):
        """The maps of ``_muT_map`` by panel width."""
        return {}


def build_grid_plan(boxes, device=DEFAULT) -> Optional[GridPlan]:
    """A plan from the subdomain boxes (i0, i1, j0, j1), or None where the
    decomposition is not a uniform-box aligned grid (the general exchange
    takes it then): boxes of one size, one box per grid cell, overlaps
    only between adjacent cells, and a strip narrower than a box. The
    strip width t is the widest pair overlap."""
    S = len(boxes)
    ws = {(i1 - i0, j1 - j0) for (i0, i1, j0, j1) in boxes}
    if len(ws) != 1:
        return None
    (W, H), = ws
    xs = sorted({b[0] for b in boxes})
    ys = sorted({b[2] for b in boxes})
    if len(xs) * len(ys) != S:
        return None
    if any(xs[i + 2] < xs[i] + W for i in range(len(xs) - 2)):
        return None
    if any(ys[i + 2] < ys[i] + H for i in range(len(ys) - 2)):
        return None
    pos = {(b[2], b[0]): s for s, b in enumerate(boxes)}
    gx = {x: ix for ix, x in enumerate(xs)}
    gy = {y: iy for iy, y in enumerate(ys)}
    t = 0
    for i in range(len(xs) - 1):
        t = max(t, xs[i] + W - xs[i + 1])
    for i in range(len(ys) - 1):
        t = max(t, ys[i] + H - ys[i + 1])
    if t <= 0 or W <= t or H <= t:
        return None
    nbr = np.full((S, 8), S, dtype=np.int32)
    sxw = np.zeros((S, 8), dtype=np.int32)
    syw = np.zeros((S, 8), dtype=np.int32)
    for s, (i0, i1, j0, j1) in enumerate(boxes):
        ix, iy = gx[i0], gy[j0]
        for dir_, (dy, dx) in enumerate(_DIRS):
            jx, jy = ix + dx, iy + dy
            if not (0 <= jx < len(xs) and 0 <= jy < len(ys)):
                continue
            q = pos[(ys[jy], xs[jx])]
            qi0, qi1, qj0, qj1 = boxes[q]
            ox = min(i1, qi1) - max(i0, qi0)
            oy = min(j1, qj1) - max(j0, qj0)
            if ox <= 0 or oy <= 0:
                continue
            nbr[s, dir_] = q
            sxw[s, dir_] = ox if dx else W
            syw[s, dir_] = oy if dy else H
    onehot = np.zeros((S, 8, S + 1), dtype=np.float32)
    for dir_ in range(8):
        onehot[np.arange(S), dir_, nbr[:, dir_]] = 1.0
    gx_n, gy_n = len(xs), len(ys)
    regular = all(pos.get((ys[iy], xs[ix])) == iy * gx_n + ix
                  for iy in range(gy_n) for ix in range(gx_n))
    device = as_device(device)
    return GridPlan(nbr=torch.as_tensor(nbr, device=device),
                    sxw=torch.as_tensor(sxw, device=device),
                    syw=torch.as_tensor(syw, device=device),
                    onehot=torch.as_tensor(onehot, device=device),
                    H=H, W=W, t=t, S=S, gx=gx_n, gy=gy_n, regular=regular,
                    sxw_s=tuple(map(tuple, sxw.T.tolist())),
                    syw_s=tuple(map(tuple, syw.T.tolist())))


def _static_shift(vals: torch.Tensor, v: int, axis: int) -> torch.Tensor:
    """out[..., i, ...] = vals[..., i + v, ...], zero-filled (static v)."""
    if v == 0:
        return vals
    ext = vals.shape[axis]
    k = min(abs(v), ext)
    kept = vals.narrow(axis, k, ext - k) if v > 0 else \
        vals.narrow(axis, 0, ext - k)
    pad = [0, 0] * (vals.dim() - axis)
    pad[-2 if v < 0 else -1] = k               # (before, after) of `axis`
    return F.pad(kept, pad)


def _shift_select_static(vals: torch.Tensor, k: tuple,
                         axis: int) -> torch.Tensor:
    """out[:, s] = shift of vals[:, s] by k[s] along ``axis``, zero-filled:
    one static shift per distinct value of k, under a static mask of the
    subdomains that take it where several values coexist, summed in
    increasing order of the value (``_shift_select_static``)."""
    distinct = sorted(set(k))
    if len(distinct) == 1:
        return _static_shift(vals, distinct[0], axis)
    out = None
    for v in distinct:
        mask = torch.as_tensor(np.asarray(k) == v,
                               device=vals.device).reshape(1, -1, 1, 1)
        term = torch.where(mask, _static_shift(vals, v, axis),
                           vals.new_zeros(()))
        out = term if out is None else out + term
    return out


def _neighbor_strips(plan: GridPlan, c: torch.Tensor):
    """The eight realigned neighbour contributions (e, w, n, s, ne, nw, se,
    sw) of the canvas c (mu, S, H, W), as the JAX package's
    ``grid_exchange`` forms them: the strips of width t, the neighbour
    take (a static shift of the (gy, gx) grid of strips on a regular grid,
    the one-hot product otherwise) and the realignment selects."""
    mu, S = c.shape[:2]
    H, W, t = plan.H, plan.W, plan.t
    Est = c[:, :, :, W - t:]
    Wst = c[:, :, :, :t]
    Nst = c[:, :, :t, :]
    Sst = c[:, :, H - t:, :]
    if plan.regular:
        def take(strips, dir_):
            dy, dx = _DIRS[dir_]
            g = strips.reshape((mu, plan.gy, plan.gx) + strips.shape[2:])
            g = _static_shift(_static_shift(g, dy, 1), dx, 2)
            return g.reshape(strips.shape)
        Ep, Wp, Np, Sp = Est, Wst, Nst, Sst
    else:
        def pad(strip):
            return F.pad(strip, [0, 0, 0, 0, 0, 1])    # a zero subdomain S
        Ep, Wp, Np, Sp = pad(Est), pad(Wst), pad(Nst), pad(Sst)
        oh = plan.onehot.to(device=c.device, dtype=c.dtype)     # exact

        def take(strips_p, dir_):
            return torch.einsum("sq,kqab->ksab", oh[:, dir_, :], strips_p)

    def selx(vals, k):
        return _shift_select_static(vals, k, 3)

    def sely(vals, k):
        return _shift_select_static(vals, k, 2)

    def lo(d, shared):             # my strip [0, t): shift by t - shared
        return tuple(t - w for w in shared[d])

    def hi(d, shared):
        return tuple(w - t for w in shared[d])

    sx, sy = plan.sxw_s, plan.syw_s
    return (selx(take(Wp, 0), hi(0, sx)),
            selx(take(Ep, 1), lo(1, sx)),
            sely(take(Sp, 2), lo(2, sy)),
            sely(take(Np, 3), hi(3, sy)),
            selx(sely(take(Sp, 4)[..., :t], lo(4, sy)), hi(4, sx)),
            selx(sely(take(Sp, 5)[..., W - t:], lo(5, sy)), lo(5, sx)),
            selx(sely(take(Np, 6)[..., :t], hi(6, sy)), hi(6, sx)),
            selx(sely(take(Np, 7)[..., W - t:], hi(7, sy)), lo(7, sx)))


def _gather_map(plan: GridPlan):
    """(index, valid, shapes): the eight contributions as one gather from
    the flat canvas. The takes and realignment selects only move values
    and fill zeros, so running them once on a canvas of flat positions (1
    + the position, exact in f64; 0 where a zero is filled in) composes
    them into one index map."""
    S, H, W = plan.S, plan.H, plan.W
    pos = torch.arange(1, S * H * W + 1, dtype=torch.float64)
    parts = _neighbor_strips(plan, pos.reshape(1, S, H, W))
    flat = torch.cat([p.reshape(-1) for p in parts]).to(torch.int64)
    return ((flat - 1).clamp(min=0).to(plan.nbr.device),
            (flat > 0).to(plan.nbr.device),
            tuple(tuple(p.shape[1:]) for p in parts))


def _muT_map(plan: GridPlan, mu: int):
    """(index, valid, sizes): the gather map of ``_gather_map`` for a panel
    (S, mu, H*W) with the right-hand-side axis leading, each of the eight
    contributions laid out (S, mu, h, w). Built once per mu."""
    cache = plan.muT_index
    if mu not in cache:
        S, HW = plan.S, plan.H * plan.W
        idx, valid, shapes = plan.index
        m = torch.arange(mu, device=idx.device)[None, :, None]
        parts_i, parts_v, sizes, o = [], [], [], 0
        for shp in shapes:
            size = S * shp[1] * shp[2]
            ip = idx[o: o + size].view(S, 1, -1)
            parts_i.append(((ip // HW) * mu + m) * HW + ip % HW)
            parts_v.append(valid[o: o + size].view(S, 1, -1)
                           .expand(-1, mu, -1))
            sizes.append(size * mu)
            o += size
        cache[mu] = (torch.cat([p.reshape(-1) for p in parts_i]),
                     torch.cat([p.reshape(-1) for p in parts_v]),
                     tuple(sizes))
    return cache[mu]


def _add_contributions(c: torch.Tensor, parts, t: int) -> torch.Tensor:
    """c plus the eight neighbour contributions in the JAX package's
    "hybrid" order: corners and the E/W strips' end rows into the
    full-width N/S strips, then c + n on the top band, (c + w) + e on the
    middle rows and c + s on the bottom band. c: a canvas (B1, B2, H, W)
    whose two leading axes are batch axes (right-hand sides and
    subdomains, in either order); parts (B1, B2, h, w), updated in place.
    Returns a new contiguous tensor."""
    H, W = c.shape[-2:]
    e, w, n, s, ne, nw, se, sw = parts
    n[..., W - t:] += ne + e[..., :t, :]
    n[..., :t] += nw + w[..., :t, :]
    s[..., W - t:] += se + e[..., H - t:, :]
    s[..., :t] += sw + w[..., H - t:, :]
    out = c.clone(memory_format=torch.contiguous_format)
    out[..., :t, :] += n
    out[..., t:H - t, :t] += w[..., t:H - t, :]
    out[..., t:H - t, W - t:] += e[..., t:H - t, :]
    out[..., H - t:, :] += s
    return out


def grid_exchange(plan: GridPlan, x: torch.Tensor) -> torch.Tensor:
    """Sum-reduce duplicated unknowns on a uniform grid decomposition.

    x: (S, n_max, mu) with n_max >= H*W. Each right-hand side is an
    (S, H, W) canvas; the panel is a leading axis (mu, S, H, W). The eight
    neighbour contributions come from one gather (the plan's index map),
    then ``_add_contributions`` adds them in the JAX package's order.
    Returns a new contiguous (S, n_max, mu) tensor."""
    S, n_max, mu = x.shape
    H, W, t = plan.H, plan.W, plan.t
    idx, valid, shapes = plan.index
    xb = x.permute(2, 0, 1)
    c = xb[:, :, : H * W].reshape(mu, S, H, W)
    g = torch.where(valid, c.reshape(mu, -1).index_select(1, idx),
                    c.new_zeros(()))
    parts, o = [], 0
    for shp in shapes:
        size = S * shp[1] * shp[2]
        parts.append(g[:, o: o + size].view(mu, *shp))
        o += size
    out = _add_contributions(c, parts, t).reshape(mu, S, H * W)
    if n_max > H * W:
        out = torch.cat([out, xb[:, :, H * W:]], dim=2)
    if mu == 1:
        return out.reshape(S, n_max, 1)
    return out.permute(1, 2, 0).contiguous()


def grid_exchange_muT(plan: GridPlan, xT: torch.Tensor) -> torch.Tensor:
    """The exchange of a panel with the right-hand-side axis leading:
    xT (S, mu, n_max) -> (S, mu, n_max) (``hpddm_tpu/parallel/grid.py:381``,
    a ``vmap`` of the single-RHS exchange over the right-hand sides).
    ``grid_exchange``'s body on an (S, mu, H, W) canvas, without its two
    permutes: one gather through the plan's map laid out for this panel
    (``_muT_map``), then the same adds, so each right-hand side gets the
    single-RHS exchange's values. Returns a new contiguous tensor."""
    S, mu, n_max = xT.shape
    H, W, t = plan.H, plan.W, plan.t
    idx, valid, sizes = _muT_map(plan, mu)
    c = xT[:, :, : H * W].reshape(S, mu, H, W)
    g = torch.where(valid, c.reshape(-1).index_select(0, idx),
                    c.new_zeros(()))
    _, _, shapes = plan.index
    parts, o = [], 0
    for shp, size in zip(shapes, sizes):
        parts.append(g[o: o + size].view(S, mu, shp[1], shp[2]))
        o += size
    out = _add_contributions(c, parts, t).reshape(S, mu, H * W)
    if n_max > H * W:
        out = torch.cat([out, xT[:, :, H * W:]], dim=2)
    return out


def grid_exchange_muT_scan(plan: GridPlan, xT: torch.Tensor) -> torch.Tensor:
    """The RHS-leading exchange one right-hand side at a time: the JAX
    package's ``lax.scan`` form (``hpddm_tpu/parallel/grid.py:391``), which
    it takes where its batched form re-tiles on the TPU. The same values
    as ``grid_exchange_muT``; ``gmv`` takes the batched form, and the smoke
    times both."""
    S, mu, n = xT.shape
    if mu == 1:
        return grid_exchange_muT(plan, xT)
    y = torch.empty_like(xT)
    for m in range(mu):
        y[:, m] = grid_exchange(plan, xT[:, m].reshape(S, n, 1))[:, :, 0]
    return y
