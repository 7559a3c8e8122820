"""The operands of the library calls that time a kernel's function.

``chip_smoke.py`` and the benches time one ``torch.sparse.mm`` beside each
kernel, on a CSR matrix of the same linear map: the block-diagonal matrix
of the S local matrices (B1-B4) or the exchange's matrix I + P (B5). The
port never calls them.
"""

import torch


def block_csr(rows, cols, vals, N):
    """The (N, N) CSR matrix of global (row, col, value) triplets, zeros
    dropped."""
    keep = vals != 0
    coo = torch.sparse_coo_tensor(torch.stack([rows[keep], cols[keep]]),
                                  vals[keep], (N, N)).coalesce()
    return coo.to_sparse_csr()


def dia_csr(vals, offs):
    """The block-diagonal CSR matrix of a DIA batch vals (S, nd, n)."""
    S, nd, n = vals.shape
    i = torch.arange(n, device=vals.device)
    base = (torch.arange(S, device=vals.device) * n)[:, None]
    trip = [[], [], []]
    for k, off in enumerate(offs):
        ok = (i + off >= 0) & (i + off < n)
        trip[0].append((base + i[ok]).reshape(-1))
        trip[1].append((base + i[ok] + off).reshape(-1))
        trip[2].append(vals[:, k, ok].reshape(-1))
    return block_csr(*(torch.cat(t) for t in trip), S * n)


def ell_csr(vals, cols):
    """The block-diagonal CSR matrix of a slot-major ELL batch vals, cols
    (S, w, n)."""
    S, w, n = vals.shape
    base = (torch.arange(S, device=vals.device) * n)[:, None, None]
    rows = (base + torch.arange(n, device=vals.device)[None, None, :]) \
        .expand(S, w, n)
    return block_csr(rows.reshape(-1), (base + cols.long()).reshape(-1),
                     vals.reshape(-1), S * n)


def exchange_csr(plan, dtype):
    """The (S n, S n) CSR matrix I + P of the exchange, a linear map: row
    (s, i) holds 1 on its diagonal and, for an interface dof, 1 at each
    partner copy's flat row."""
    S, n = plan.interior.shape
    dev = plan.dst.device
    flat = torch.arange(S * n, device=dev)
    dst = plan.dst.long()
    on = dst >= 0
    prow = plan.rows.long().transpose(1, 2)[on]               # (M, k_max)
    valid = prow >= 0
    rows = torch.cat([flat, dst[on][:, None].expand_as(prow)[valid]])
    cols = torch.cat([flat, prow[valid]])
    return block_csr(rows, cols, torch.ones(rows.numel(), dtype=dtype,
                                            device=dev), S * n)
