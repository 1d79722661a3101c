"""Block-sparse SDDMM: the block values of mask ⊙ (Q @ Kᵀ) on a DeviceBSR
mask.

Counterpart of ``spgrid/ops/pallas/sddmm.py``; the CUDA kernel is
``spgrid_torch/csrc/sddmm.cu``, in three forms: f32, bf16
(``bsr_sddmm_bf16``: bf16 mask, Q and K, the f32 sum times the mask value
in f32, rounded once to bf16, as the Pallas kernel runs at dtype bf16) and
the 3-pass bf16 form of f32 operands (``bsr_sddmm_bf16x3``: the Pallas
kernel's dot at matmul precision 'high', Q and K split into bf16 hi and lo
parts, Q_hi K_hi + Q_hi K_lo + Q_lo K_hi summed in f32).
``bsr_sddmm(..., precision=)`` launches the form of Q's dtype and the
precision for CUDA tensors and takes its plain version
(``bsr_sddmm_plain``, ``bsr_sddmm_bf16x3_plain``) only for CPU tensors; an
f64 Q, or a precision without a form, raises.

The f32 form runs the tensor-core tile of ``csrc/block_mma.cuh``: one
tile a (mask block, 128-row slice of it, 64 of its columns), its
contraction (d, 32 a step) split across a cluster where the tiles alone
would leave the card idle (``launch_grid`` reports the launch); the mask
multiplies the summed tile once. The bf16 form runs a persistent tile of
128 x 128 fed by TMA (one CTA an SM walking tiles where the grid is long,
a cluster a tile where it is short; ``bf16_shape`` reports the launch and
the bytes of the copy pass that pads Q and K where TMA cannot read them as
they lie). The 3-pass form first splits Q and
K once into bf16 hi and lo planes (the split pass of ``csrc/bf16x3.cuh``
that the SpMMs' 3-pass forms share; ``bf16x3.split_planes_plain`` is that
pass in plain torch) in scratch the wrapper allocates (``x3_shape``
reports its bytes), then runs tiles of 128 columns fed from the planes by
TMA.
"""

from __future__ import annotations

import ctypes

import torch

from spgrid_torch.ops.kernels import (
    OTHER_PRECISIONS, _build, check_form, check_operands, runs_plain)
from spgrid_torch.ops.kernels.bf16x3 import (  # noqa: F401 (3c's names)
    bmm_bf16x3, plane_shape, split_launch, split_planes_plain)
from spgrid_torch.ops.kernels.block_mma import LaunchShape, query
from spgrid_torch.ops.layouts import DeviceBSR
from spgrid_torch.ops.xla import acc_dtype


def _check(mask: DeviceBSR, q: torch.Tensor, k: torch.Tensor,
           dtype: torch.dtype) -> None:
    if q.dim() != 2 or k.dim() != 2 or q.shape[1] != k.shape[1]:
        raise ValueError(f"q (mq, d) and k (mk, d) must share d, got "
                         f"{tuple(q.shape)} and {tuple(k.shape)}")
    check_operands("bsr_sddmm", q.device, q=(q, dtype), k=(k, dtype),
                   mask_blocks=(mask.blocks, dtype),
                   block_rows=(mask.block_rows, torch.int32),
                   block_cols=(mask.block_cols, torch.int32))


def launch_grid(mask: DeviceBSR, precision: str = "highest",
                q: torch.Tensor = None, k: torch.Tensor = None
                ) -> LaunchShape:
    """The launch of the form ``mask``'s blocks take for its stored blocks
    (pad blocks included) on the card ``mask`` lies on, as
    ``spgrid_bsr_sddmm``, ``spgrid_bsr_sddmm_bf16`` (for Q ``q`` and K
    ``k``) or, for f32 blocks at ``precision`` 'high',
    ``spgrid_bsr_sddmm_bf16x3`` makes it (its tiles, for Q ``q`` and K
    ``k``; the cluster depends on the card's SM count)."""
    nb, bm, bk = mask.blocks.shape
    if mask.blocks.dtype == torch.bfloat16:
        return bf16_shape(mask, q, k)[0]
    if precision == "high":
        return x3_shape(mask, q.shape[0], k.shape[0], q.shape[1])[0]
    with torch.cuda.device(mask.blocks.device):
        return query("spgrid_bsr_sddmm_shape", "bsr_sddmm", nb, bm, bk)


def bf16_shape(mask: DeviceBSR, q: torch.Tensor, k: torch.Tensor):
    """(the bf16 form's launch, the bytes of its copy pass's planes: 0 where
    TMA reads Q and K as they lie) for Q ``q`` and K ``k`` on the card
    ``mask`` lies on, as ``spgrid_bsr_sddmm_bf16_shape`` reports them; its
    ``grid`` is the CTAs of the persistent walk where the cluster is 1."""
    nb, bm, bk = mask.blocks.shape
    shape = (ctypes.c_int * 7)()
    scratch = ctypes.c_longlong()
    with torch.cuda.device(mask.blocks.device):
        _build.check(_build.library().spgrid_bsr_sddmm_bf16_shape(
            nb, bm, bk, q.shape[0], k.shape[0], q.shape[1], q.data_ptr(),
            k.data_ptr(), ctypes.addressof(shape),
            ctypes.addressof(scratch)), "bsr_sddmm_bf16")
    return LaunchShape(*shape), scratch.value


def x3_shape(mask: DeviceBSR, mq: int, mk: int, d: int):
    """(the 3-pass form's tile launch, the bytes of its split planes) for
    Q (mq, d) and K (mk, d) on the card ``mask`` lies on, as
    ``spgrid_bsr_sddmm_bf16x3_shape`` reports them."""
    nb, bm, bk = mask.blocks.shape
    shape = (ctypes.c_int * 6)()
    scratch = ctypes.c_longlong()
    with torch.cuda.device(mask.blocks.device):
        _build.check(_build.library().spgrid_bsr_sddmm_bf16x3_shape(
            nb, bm, bk, mq, mk, d, ctypes.addressof(shape),
            ctypes.addressof(scratch)), "bsr_sddmm_bf16x3")
    return LaunchShape(*shape), scratch.value


def _launch(wrapper, mask: DeviceBSR, q: torch.Tensor, k: torch.Tensor,
            out: torch.Tensor = None, cluster: int = 0) -> torch.Tensor:
    """The block values by the form of Q's dtype into ``out`` (a new
    output where None; the 3-pass form's split planes and the bf16 form's
    copied planes in new scratch) at ``cluster`` (0: the launch rule)."""
    nb, bm, bk = mask.blocks.shape
    if out is None:
        out = torch.empty((nb, bm, bk), dtype=q.dtype, device=q.device)
    if nb == 0:
        return out
    mq, mk, d = q.shape[0], k.shape[0], q.shape[1]
    entry = getattr(_build.library(), "spgrid_" + wrapper.__name__)
    args = ()
    nbytes = 0
    if wrapper is bsr_sddmm_bf16x3:
        nbytes = x3_shape(mask, mq, mk, d)[1]
    elif wrapper is bsr_sddmm_bf16:
        nbytes = bf16_shape(mask, q, k)[1]
        args = (None,)
    if nbytes:
        scratch = torch.empty(nbytes, dtype=torch.uint8, device=q.device)
        args = (scratch.data_ptr(),)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = entry(mask.block_rows.data_ptr(), mask.block_cols.data_ptr(),
                     mask.blocks.data_ptr(), q.data_ptr(), k.data_ptr(),
                     out.data_ptr(), *args, nb, bm, bk, mq, mk, d, cluster,
                     stream)
    _build.check(code, wrapper.__name__)
    return out


def launch(mask: DeviceBSR, q: torch.Tensor, k: torch.Tensor,
           out: torch.Tensor, cluster: int = 0) -> torch.Tensor:
    """The form of Q's dtype into ``out`` at ``cluster`` (0 the launch
    rule; 1, 2, 4 or 8), uncounted: for tests and sweeps."""
    wrapper = {torch.bfloat16: bsr_sddmm_bf16}.get(q.dtype, bsr_sddmm)
    _check(mask, q, k, q.dtype)
    return _launch(wrapper, mask, q, k, out, cluster)


def _run(wrapper, mask: DeviceBSR, q: torch.Tensor, k: torch.Tensor,
         dtype: torch.dtype, plain=None) -> torch.Tensor:
    _check(mask, q, k, dtype)
    if runs_plain(wrapper.__name__, q.device):
        return (plain or bsr_sddmm_plain)(mask, q, k)
    out = _launch(wrapper, mask, q, k)
    wrapper.launches += 1
    return out


def bsr_sddmm(mask: DeviceBSR, q: torch.Tensor, k: torch.Tensor,
              precision=None) -> torch.Tensor:
    """(nb, bm, bk) block values aligned with ``mask.blocks``, in Q's dtype
    (f32, or bf16: ``bsr_sddmm_bf16``) at matmul ``precision`` (None: the
    dtype's own; 'high' for f32 operands: ``bsr_sddmm_bf16x3``); pad
    blocks (block_row = mb) give zero blocks."""
    check_form("bsr_sddmm", q.dtype, precision=precision,
               other_precisions=OTHER_PRECISIONS)
    if q.dtype == torch.bfloat16:
        return bsr_sddmm_bf16(mask, q, k)
    if precision == "high":
        return bsr_sddmm_bf16x3(mask, q, k)
    return _run(bsr_sddmm, mask, q, k, torch.float32)


bsr_sddmm.launches = 0


def bsr_sddmm_bf16(mask: DeviceBSR, q: torch.Tensor,
                   k: torch.Tensor) -> torch.Tensor:
    """(nb, bm, bk) bf16 block values for a bf16 mask, Q and K: each the
    f32 dot product times the mask value in f32, rounded once."""
    return _run(bsr_sddmm_bf16, mask, q, k, torch.bfloat16)


bsr_sddmm_bf16.launches = 0


def bsr_sddmm_bf16x3(mask: DeviceBSR, q: torch.Tensor,
                     k: torch.Tensor) -> torch.Tensor:
    """(nb, bm, bk) f32 block values for an f32 mask, Q and K at matmul
    precision 'high': three bf16 passes summed in f32, times the mask
    value (``bsr_sddmm_bf16x3_plain`` says in what order)."""
    return _run(bsr_sddmm_bf16x3, mask, q, k, torch.float32,
                bsr_sddmm_bf16x3_plain)


bsr_sddmm_bf16x3.launches = 0


def gather_panels(mask: DeviceBSR, q: torch.Tensor, k: torch.Tensor,
            dtype: torch.dtype):
    """(Q panels (nb, bm, d), K panels (nb, bk, d)) of every block in
    ``dtype``: the gather of ``spgrid.ops.attention._sddmm_bsr_xla`` (Q
    and K row panels by block coordinates, a zero Q panel for the pad row
    mb), zeros past Q's and K's rows as that gather's ``take(...,
    fill_value=0)`` reads them: each operand padded to the block count the
    mask's shape reaches where it is shorter."""
    nb, bm, bk = mask.blocks.shape
    mbq = max(-(-q.shape[0] // bm), mask.mb) + 1
    mbk = max(-(-k.shape[0] // bk), -(-mask.shape[1] // bk))
    d = q.shape[1]
    qp = torch.zeros((mbq * bm, d), dtype=dtype, device=q.device)
    qp[:q.shape[0]] = q
    kp = torch.zeros((mbk * bk, d), dtype=dtype, device=q.device)
    kp[:k.shape[0]] = k
    return (qp.view(mbq, bm, d)[mask.block_rows.long()],
            kp.view(mbk, bk, d)[mask.block_cols.long()])


def split_planes(scratch: torch.Tensor, mq: int, mk: int, d: int):
    """(Q_hi, Q_lo, K_hi, K_lo): the split planes in the 3-pass form's
    scratch (bytes), as bf16 views."""
    rq, rk, dp = plane_shape(mq, mk, d)
    flat = scratch.view(torch.bfloat16)
    q_planes = flat[:2 * rq * dp].view(2, rq, dp)
    k_planes = flat[2 * rq * dp:2 * (rq + rk) * dp].view(2, rk, dp)
    return q_planes[0], q_planes[1], k_planes[0], k_planes[1]


def copy_launch(q: torch.Tensor, k: torch.Tensor,
                scratch: torch.Tensor) -> None:
    """The bf16 form's copy pass alone on the card (Q and K, zero-padded to
    whole 64-deep steps, into ``scratch`` of the bytes ``bf16_shape``
    reports), uncounted: for timing."""
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = _build.library().spgrid_bsr_sddmm_bf16_copy(
            q.data_ptr(), k.data_ptr(), scratch.data_ptr(), q.shape[0],
            k.shape[0], q.shape[1], stream)
    _build.check(code, "bsr_sddmm_bf16")


def bsr_sddmm_bf16x3_plain(mask: DeviceBSR, q: torch.Tensor,
                           k: torch.Tensor) -> torch.Tensor:
    """The 3-pass form's block values in plain torch, f32: each block's Q
    and K panels' 3-pass product (``bmm_bf16x3``: each pass's sum over d in
    f64, rounded once to f32, the cross passes Q_hi K_lo + Q_lo K_hi, then
    that plus Q_hi K_hi), times the mask value."""
    qg, kg = gather_panels(mask, q.float(), k.float(), torch.float32)
    return bmm_bf16x3(qg, kg.transpose(1, 2)) * mask.blocks.float()


def bsr_sddmm_plain(mask: DeviceBSR, q: torch.Tensor,
                    k: torch.Tensor) -> torch.Tensor:
    """The same block values in plain torch, in q's dtype (bf16: widened to
    f32, the product and the mask in f32, rounded once at the end): the
    gather of ``spgrid.ops.attention._sddmm_bsr_xla`` (Q and K row panels by
    block coordinates, a zero Q panel for the pad row mb) and one batched
    product."""
    acc = acc_dtype(q)
    qg, kg = gather_panels(mask, q, k, acc)
    return (torch.bmm(qg, kg.transpose(1, 2))
            * mask.blocks.to(acc)).to(q.dtype)
