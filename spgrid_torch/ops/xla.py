"""The JAX package's XLA compositions as torch ops: COO, SELL-C-sigma, ELL,
CSC, LDU and compressed-value SpMM and SpMV (``spmm_coo``, ``spmv_coo``,
``spmm_sell``, ``spmv_sell``, ``spmm_ell``, ``spmv_ell``, ``spmm_csc``,
``spmv_csc``, ``spmm_ldu``, ``spmv_ldu``, ``spmm_cv``, ``spmv_cv``), the
BSR baseline ``spmm_bsr`` (the ``bsr`` format, the ``--xla-only``
pipeline's SpMM) and the SDDMM baselines ``sddmm_coo`` and ``sddmm_dense``
(``--sddmm --xla-only``) — the counterparts of the functions of the same
names in ``spgrid/ops/xla.py``.

The JAX package leaves these to XLA (a gather, a weighted sum and a segment
sum), outside any Pallas kernel, so the port leaves them to torch ops:
``index_select`` for ``take`` (the JAX ``take``s fill with zeros past
the operand's rows, so an operand shorter than the layout's column count
is first padded with zero rows, ``zero_rows``, decided from shapes
alone); for COO's and BSR's ``segment_sum``,
``segment_sum`` below over the row-sorted products at the layout's
``row_ptr``; the pad entries take no part. The products and sums run in
f32 (f64 for an f64 X), the matrix products with TF32 off. Every size is
known on the host, so a call can be captured in a CUDA graph.

``sddmm_coo`` runs chunk by chunk so that its gathered Q and K rows stay
under ``SDDMM_CHUNK_BYTES``: unchunked, a 4096^2 mask at sparsity 0.5 (16.8M
nnz) at d = 512 would gather 34 GB of each.

CSC and LDU scatter into rows in the JAX package (an unsorted segment
sum); here their products, formed in the JAX op's order (CSC's column by
column, LDU's face by face), are taken to row order by the layout's fixed
permutation and summed by ``segment_sum``. ELL sums a row's slots with
``torch.sum`` over a chunk of rows at a time (``ELL_CHUNK_BYTES``), and CV
dequantizes its values each call, as the JAX op does.

Bits: COO, SELL and ELL write each row once and add no element twice in a
launch, CSC, LDU and CV sum each row in one fixed order, BSR sums a block
row's products in block order, and SDDMM forms each value as one dot
product, so every op gives the same bits on every call.
"""

from __future__ import annotations

import torch

from spgrid_torch.ops.dense import at_high, full_f32
from spgrid_torch.ops.layouts import (
    DeviceBSR, DeviceCOO, DeviceCSC, DeviceCV, DeviceELL, DeviceLDU,
    DeviceSELL,
)

SDDMM_CHUNK_BYTES = 1 << 30   # gathered Q and K rows of a sddmm_coo chunk
ELL_CHUNK_BYTES = 1 << 30     # gathered X rows of a spmm_ell chunk


def acc_dtype(x: torch.Tensor) -> torch.dtype:
    """f32 sums, except for an f64 X (as the JAX package's ``_acc_dtype``)."""
    return torch.float64 if x.dtype == torch.float64 else torch.float32


def zero_rows(x: torch.Tensor, rows: int) -> torch.Tensor:
    """``x`` with zero rows appended up to ``rows``, so that a gather of
    any index below ``rows`` reads zeros past ``x``'s own rows, as the JAX
    ops' ``take(..., fill_value=0)`` does; ``x`` itself, with no copy, when
    it has ``rows`` rows or more. Decided from shapes alone: no sync, so a
    call can be captured in a CUDA graph."""
    if x.shape[0] >= rows:
        return x
    xp = x.new_zeros((rows,) + tuple(x.shape[1:]))
    xp[:x.shape[0]] = x
    return xp


def segment_sum(data: torch.Tensor, offsets: torch.Tensor) -> torch.Tensor:
    """(len(offsets) - 1, ...) sums of the runs ``data[offsets[i]:
    offsets[i + 1]]`` along dim 0, an empty run 0. ``torch.segment_reduce``
    adds each run in index order, one thread an output element, on the card
    as on the CPU, so a call gives the same bits every time (an
    ``index_add_`` on the card adds with atomics in any order);
    ``unsafe=True`` skips its host-synchronising checks of ``offsets``, so
    a call can be captured in a CUDA graph."""
    return torch.segment_reduce(data, "sum", offsets=offsets, axis=0,
                                unsafe=True)


def spmm_coo(coo: DeviceCOO, x: torch.Tensor) -> torch.Tensor:
    """Y (m, n) = A @ X: each nnz's row of X, weighted by its value, added
    into its row."""
    acc = acc_dtype(x)
    nnz = coo.nnz
    g = zero_rows(x, coo.shape[1]).index_select(0, coo.cols[:nnz])
    prods = g.to(acc).mul_(coo.values[:nnz, None].to(acc))
    return segment_sum(prods, coo.row_ptr).to(x.dtype)


def spmv_coo(coo: DeviceCOO, x: torch.Tensor) -> torch.Tensor:
    """y (m,) = A @ x for x (k,)."""
    return spmm_coo(coo, x[:, None])[:, 0]


def spmm_sell(sell: DeviceSELL, x: torch.Tensor) -> torch.Tensor:
    """Y (m, n) = A @ X from the SELL-C-sigma buckets: per width bucket the
    gathered X rows of its (s, C, w) slots, weighted and summed over w, into
    the buckets' slots; then the slots back to their rows through
    ``perm``."""
    m = sell.shape[0]
    n = x.shape[1]
    m_pad = sell.perm.shape[0]
    acc = acc_dtype(x)
    # the buckets' slices cover every slot once, and perm every row once
    y_perm = torch.empty((m_pad, n), dtype=acc, device=x.device)
    lane = torch.arange(sell.C, device=x.device)
    xz = zero_rows(x, sell.shape[1])
    for cols, vals, srows in zip(sell.bucket_cols, sell.bucket_vals,
                                 sell.bucket_slice_rows):
        s, C, w = cols.shape
        g = xz.index_select(0, cols.reshape(-1)).reshape(s, C, w, n).to(acc)
        part = g.mul_(vals[..., None].to(acc)).sum(dim=2)   # (s, C, n)
        slots = (srows[:, None] + lane[None, :]).reshape(-1)
        y_perm.index_copy_(0, slots, part.reshape(s * C, n))
    y = torch.empty((m_pad, n), dtype=acc, device=x.device)
    y.index_copy_(0, sell.perm.long(), y_perm)
    return y[:m].to(x.dtype)


def spmv_sell(sell: DeviceSELL, x: torch.Tensor) -> torch.Tensor:
    """y (m,) = A @ x for x (k,)."""
    return spmm_sell(sell, x[:, None])[:, 0]


def spmm_bsr(bsr: DeviceBSR, x: torch.Tensor,
             precision=None) -> torch.Tensor:
    """Y (m, n) = A @ X from the BSR blocks: each block's tile of X
    gathered, one batched product (at matmul ``precision`` 'high' by
    ``dense.at_high``), the products summed a block row (``segment_sum`` at
    ``row_ptr``; the pad blocks lie past it)."""
    full_f32()
    nb = bsr.num_blocks
    bk, mb = bsr.bk, bsr.mb
    n = x.shape[1]
    acc = acc_dtype(x)
    kb = -(-max(x.shape[0], bsr.shape[1]) // bk)
    xp = torch.zeros((kb * bk, n), dtype=acc, device=x.device)
    xp[:x.shape[0]] = x
    tiles = xp.view(kb, bk, n).index_select(0, bsr.block_cols[:nb])
    blocks = bsr.blocks[:nb].to(acc)
    prods = (at_high(torch.bmm, blocks, tiles) if precision == "high"
             else torch.bmm(blocks, tiles))                 # (nb, bm, n)
    out = segment_sum(prods, bsr.row_ptr.long())             # (mb, bm, n)
    return out.reshape(mb * bsr.bm, n)[:bsr.shape[0]].to(x.dtype)


def sddmm_chunk(d: int) -> int:
    """nnz a ``sddmm_coo`` chunk takes: its gathered f32 Q and K rows, 8d
    bytes a nnz (the product is formed in place), within
    ``SDDMM_CHUNK_BYTES``; at least 1."""
    return max(1, SDDMM_CHUNK_BYTES // (8 * max(d, 1)))


def sddmm_coo(mask: DeviceCOO, q: torch.Tensor,
              k: torch.Tensor) -> torch.Tensor:
    """values[p] = mask_val[p] * sum_d Q[row_p, d] * K[col_p, d] for each
    of the mask's (padded) entries, pads 0: the taco-naive semantics, the
    dot over the dense width scaled by the mask value. The rows of a chunk
    (``sddmm_chunk``) come from ``row_ptr``."""
    acc = acc_dtype(q)
    out = torch.zeros(mask.values.shape[0], dtype=acc, device=q.device)
    step = sddmm_chunk(q.shape[1])
    q = zero_rows(q, mask.shape[0])
    k = zero_rows(k, mask.shape[1])
    for s in range(0, mask.nnz, step):
        e = min(s + step, mask.nnz)
        rows = torch.searchsorted(
            mask.row_ptr, torch.arange(s, e, device=q.device),
            right=True) - 1
        g = q.index_select(0, rows).to(acc)
        g.mul_(k.index_select(0, mask.cols[s:e]).to(acc))
        torch.sum(g, dim=1, out=out[s:e])
        out[s:e].mul_(mask.values[s:e].to(acc))
    return out.to(q.dtype)


def sddmm_dense(mask_dense: torch.Tensor, q: torch.Tensor,
                k: torch.Tensor) -> torch.Tensor:
    """mask ⊙ (Q @ K^T) as one dense product: the dense masked score
    matrix."""
    full_f32()
    acc = acc_dtype(q)
    scores = q.to(acc) @ k.to(acc).T
    return (mask_dense.to(acc) * scores).to(q.dtype)


def ell_chunk_rows(width: int, n: int) -> int:
    """Rows a ``spmm_ell`` chunk takes: its gathered f32 X rows, 4 n bytes a
    slot, within ``ELL_CHUNK_BYTES``; a multiple of 8, at least 8."""
    rows = max(ELL_CHUNK_BYTES // max(4 * width * n, 1), 8)
    return rows // 8 * 8


def _ell_rows(vals: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """(rows, n): each row's slots' values (rows, w) times their gathered
    X rows (rows, w, n), summed over w: the JAX op's einsum."""
    return torch.einsum("rw,rwn->rn", vals, g)


def spmm_ell(ell: DeviceELL, x: torch.Tensor,
             precision=None) -> torch.Tensor:
    """Y (m, n) = A @ X from ELL, a chunk of rows at a time: the X rows of
    the chunk's slots gathered, weighted by the slots' values and summed
    over the width (pad slots add 0 x X[0]); at matmul ``precision`` 'high'
    the JAX op's einsum by ``dense.at_high``."""
    m = ell.shape[0]
    m_pad, w = ell.cols.shape
    n = x.shape[1]
    acc = acc_dtype(x)
    y = torch.empty((m, n), dtype=acc, device=x.device)
    step = ell_chunk_rows(w, n)
    x = zero_rows(x, ell.shape[1])
    for r0 in range(0, m, step):
        r1 = min(r0 + step, m)
        g = x.index_select(0, ell.cols[r0:r1].reshape(-1)).view(
            r1 - r0, w, n).to(acc)
        if precision == "high":
            y[r0:r1] = at_high(_ell_rows, ell.values[r0:r1].to(acc), g)
            continue
        g.mul_(ell.values[r0:r1, :, None].to(acc))
        torch.sum(g, dim=1, out=y[r0:r1])
    return y.to(x.dtype)


def spmv_ell(ell: DeviceELL, x: torch.Tensor) -> torch.Tensor:
    """y (m,) = A @ x for x (k,)."""
    return spmm_ell(ell, x[:, None])[:, 0]


def spmm_csc(csc: DeviceCSC, x: torch.Tensor) -> torch.Tensor:
    """Y (m, n) = A @ X walking A column-major: each entry's X row, weighted
    by its value, in column order; then each row's products summed, in the
    layout's row order (columns ascending)."""
    acc = acc_dtype(x)
    nnz = csc.nnz
    g = zero_rows(x, csc.shape[1]).index_select(0, csc.cols[:nnz])
    prods = g.to(acc).mul_(csc.values[:nnz, None].to(acc))
    return segment_sum(prods.index_select(0, csc.row_order),
                       csc.row_ptr).to(x.dtype)


def spmv_csc(csc: DeviceCSC, x: torch.Tensor) -> torch.Tensor:
    """y (m,) = A @ x for x (k,)."""
    return spmm_csc(csc, x[:, None])[:, 0]


def spmm_ldu(ldu: DeviceLDU, x: torch.Tensor) -> torch.Tensor:
    """Y = A @ X from the LDU face lists: Y = diag X; then for each face f,
    upper[f] X[neigh[f]] added into row owner[f], and lower[f] X[owner[f]]
    into row neigh[f], each row's faces in face order."""
    acc = acc_dtype(x)
    nf = ldu.n_faces
    xa = x.to(acc)
    y = ldu.diag[:, None].to(acc) * xa
    xa = zero_rows(xa, ldu.shape[1])
    up = xa.index_select(0, ldu.neigh[:nf]).mul_(ldu.upper[:nf, None].to(acc))
    y = y + segment_sum(up.index_select(0, ldu.owner_order), ldu.owner_ptr)
    lo = xa.index_select(0, ldu.owner[:nf]).mul_(ldu.lower[:nf, None].to(acc))
    y = y + segment_sum(lo.index_select(0, ldu.neigh_order), ldu.neigh_ptr)
    return y.to(x.dtype)


def spmv_ldu(ldu: DeviceLDU, x: torch.Tensor) -> torch.Tensor:
    """y (n_cells,) = A @ x for x (n_cells,)."""
    return spmm_ldu(ldu, x[:, None])[:, 0]


def spmm_cv(cv: DeviceCV, x: torch.Tensor) -> torch.Tensor:
    """Y (m, n) = A @ X with A's values dequantized on each call (int8
    times its row's scale, or bf16 widened), in f32."""
    nnz = cv.nnz
    vals = cv.qvalues[:nnz].to(torch.float32)
    if cv.mode == "int8":
        vals = vals * cv.scales.index_select(0, cv.rows[:nnz])
    g = zero_rows(x, cv.shape[1]).index_select(0, cv.cols[:nnz])
    prods = g.to(torch.float32).mul_(vals[:, None])
    return segment_sum(prods, cv.row_ptr).to(x.dtype)


def spmv_cv(cv: DeviceCV, x: torch.Tensor) -> torch.Tensor:
    """y (m,) = A @ x for x (k,)."""
    return spmm_cv(cv, x[:, None])[:, 0]
