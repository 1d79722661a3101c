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
    from spgrid.gen import artificial_matrix_generation, create_mask

    def weight(s):
        return artificial_matrix_generation(
            m, k, density * k, density * k / 8, "normal", seed=s,
            placement="random", bw=1.0, name=f"dlmc_twin_{s}")

    wk, wq, wv = weight(seed), weight(seed + 1), weight(seed + 2)
    mask = create_mask("band_and_random", m, sparsity=mask_sparsity,
                       band_size=16, seed=seed)
    return wk, wq, wv, mask


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
