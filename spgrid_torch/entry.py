"""The flagship step: the sparse-attention pipeline on DLMC-style pruned
weights, the counterpart of ``__graft_entry__.entry``.

``entry(device)`` returns ``(fn, (attn, x))``; ``fn(attn, x)`` runs one
pipeline step (three weight SpMMs, the masked SDDMM, the final SpMM) and
returns Y.
"""

from __future__ import annotations

import numpy as np
import torch

from spgrid_torch.ops.attention import SparseAttention, attention_pipeline


def flagship_csrs(m=512, k=512, density=0.5, mask_sparsity=0.9, seed=14):
    """W_K, W_Q, W_V and the mask, made by the same generator calls as
    ``__graft_entry__._flagship_csrs``."""
    from spgrid_torch.gen import artificial_matrix_generation, create_mask

    def weight(s):
        return artificial_matrix_generation(
            m, k, density * k, density * k / 8, "normal", seed=s,
            placement="random", bw=1.0, name=f"dlmc_twin_{s}")

    wk, wq, wv = weight(seed), weight(seed + 1), weight(seed + 2)
    mask = create_mask("band_and_random", m, sparsity=mask_sparsity,
                       band_size=16, seed=seed)
    return wk, wq, wv, mask


def hypersparse_edge(m=700, k=1100, density=0.005, empty=slice(256, 512),
                     heavy_row=3, heavy_nnz=200, seed=5):
    """The slot kernels' edge matrix: scattered nnz at ``density``, the rows
    ``empty`` empty (whole row blocks and 128-row blocks when they are
    aligned so), and row ``heavy_row`` full in the last ``heavy_nnz``
    columns, so that it collides in each of the last windows. Neither m nor
    k need be a multiple of 128."""
    from spgrid_torch.formats.csr import dense_to_csr
    rng = np.random.default_rng(seed)
    d = np.where(rng.random((m, k)) < density, rng.random((m, k)) + 0.5, 0.0)
    d[empty] = 0.0
    d[heavy_row, k - heavy_nnz:] = rng.random(heavy_nnz) + 0.5
    return dense_to_csr(d.astype(np.float32), name="hypersparse_edge")


def flagship_x(k: int, n: int = 512) -> np.ndarray:
    """The step's activation X (k, n), f32, as ``__graft_entry__.entry``
    makes it."""
    return (np.random.default_rng(0).random((k, n), dtype=np.float64)
            .astype(np.float32))


def entry(device):
    """The single-device forward step and its arguments on ``device``."""
    wk, wq, wv, mask = flagship_csrs()
    attn = SparseAttention.from_csr(wk, wq, wv, mask, device=device)
    x = torch.from_numpy(flagship_x(wk.k)).to(device)

    def fn(attn, x):
        y, _ = attention_pipeline(attn, x)
        return y

    return fn, (attn, x)
