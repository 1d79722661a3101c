"""The 3-pass bf16 forms' shared split (``csrc/bf16x3.cuh``), in plain torch.

Matmul precision 'high' on the TPU computes an f32 dot as three bf16
passes: each f32 operand split into bf16 parts, v = v_hi + v_lo with v_hi =
bf16(v) and v_lo = bf16(v - v_hi), and a b = a_hi b_hi + a_hi b_lo + a_lo
b_hi summed in f32 (the a_lo b_lo term is dropped). The kernels' forms at
'high' (3c ``bsr_sddmm_bf16x3``, 1c ``bsr_spmm_bf16x3``, 2c
``panel_spmm_bf16x3``, 4c ``bsr_spmm_cstat_bf16x3``) first split their f32
operands into bf16 hi and lo planes with one pass (``split_pair`` of the
header): plane_rows(m) rows of ``plane_cols(d)`` columns (d rounded up to
whole 64-deep steps, zeros past d). ``split_planes_plain`` is that pass in
plain torch, ``split_launch`` the pass alone on the card, ``bmm_bf16x3``
the plain versions' product of each block.
"""

from __future__ import annotations

import torch

from spgrid_torch.ops.kernels import _build

STEP = 64   # BF_TK of csrc/bf16_mma.cuh: a plane row is whole steps


def split_bf16(t: torch.Tensor):
    """(hi, lo): the bf16 parts of f32 ``t``, hi = t rounded to bf16 and lo
    = (t - hi) rounded (to nearest, ties to even; t - hi is exact in f32),
    as f32 tensors."""
    hi = t.to(torch.bfloat16).float()
    return hi, (t - hi).to(torch.bfloat16).float()


def plane_rows(m: int) -> int:
    """Rows of an operand's planes: its rows, at least one."""
    return max(m, 1)


def plane_cols(d: int) -> int:
    """Columns of an operand's planes: d rounded up to whole steps, at
    least one."""
    return max(1, -(-d // STEP)) * STEP


def plane_shape(mq: int, mk: int, d: int):
    """(Q's plane rows, K's plane rows, plane columns) of the 3-pass SDDMM's
    split planes, as ``csrc/sddmm.cu`` lays them."""
    return plane_rows(mq), plane_rows(mk), plane_cols(d)


def split_planes_plain(a: torch.Tensor, b: torch.Tensor):
    """(A_hi, A_lo, B_hi, B_lo) in plain torch, bf16: the split pass's
    planes of two f32 operands, each ``plane_rows`` by ``plane_cols`` of its
    own width, each value's parts by ``split_bf16`` and zeros past its
    width and past its rows."""
    planes = []
    for t in (a, b):
        padded = torch.zeros((plane_rows(t.shape[0]), plane_cols(t.shape[1])),
                             dtype=torch.float32, device=t.device)
        padded[:t.shape[0], :t.shape[1]] = t
        planes += [p.to(torch.bfloat16) for p in split_bf16(padded)]
    return tuple(planes)


def split_launch(a: torch.Tensor, b, scratch: torch.Tensor) -> None:
    """The split pass alone on the card (``spgrid_bf16x3_split``, as 1c
    and 4c run it on their blocks and X): f32 ``a`` and ``b`` (2-D, rows
    contiguous; b may be None) into their planes, A_hi, A_lo, B_hi, B_lo,
    at ``scratch`` (on 16 bytes), uncounted: for tests and timing."""
    mb, db = (b.shape[0], b.shape[1]) if b is not None else (-1, 0)
    with torch.cuda.device(a.device):
        _build.check(_build.library().spgrid_bf16x3_split(
            a.data_ptr(), b.data_ptr() if b is not None else None,
            scratch.data_ptr(), a.shape[0], a.shape[1], mb, db,
            torch.cuda.current_stream().cuda_stream), "bf16x3_split")


def bmm_bf16x3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The 3-pass product of each of a batch of f32 blocks, f32: a and b
    split (``split_bf16``), each pass's sum formed in f64 and rounded once
    to f32 (a bf16 x bf16 product is exact in f64, and so is the sum of a
    contraction's products whose magnitudes lie within 2^37 of each other,
    so the order of the sum does not matter), then in f32 the cross passes
    a_hi b_lo + a_lo b_hi, then that plus a_hi b_hi. The dropped a_lo b_lo
    term is what sets it apart from the f32 product."""
    ah, al = split_bf16(a.float())
    bh, bl = split_bf16(b.float())

    def dot(u, v):
        return torch.bmm(u.double(), v.double()).float()

    return (dot(ah, bl) + dot(al, bh)) + dot(ah, bh)
