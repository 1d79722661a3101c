"""The live-slot stream that the packed SpMV kernels read
(``spgrid_torch/csrc/slot_stream.cuh``): its host build, its checks, its
launch and its product in plain torch.

A layout's padded pieces (P, 128) hold many empty slots: pad lanes, pad
pieces, slots whose x index lies past k. The stream keeps, piece by piece
and in lane order, only the live slots (value not 0, x index inside x):
their values, their x indices (the piece's window · 128 + the column in
it, int32) and their rows within the target block (uint8, ``PIECE_START``
set on each piece's first slot), with ``slot_ptr`` (P + 1) and
``block_slot`` (blocks + 1) pointing at each piece's and each block's
slots. WROW v2 (``wrow_spmv.wrow_spmv_v2``) and the default WPACK product
(``wpack_spmv.wpack_spmv``) read the values, x indices, rows and
``block_slot``; layouts build the stream in ``from_arrays``.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from spgrid_torch.ops.kernels import _build, check_operands

LANE = 128
GROUP_PIECES = 8
PIECE_START = 0x80   # row byte's flag on a piece's first live slot


def live_slot_stream(values, xoff, piece_w, block_ptr, k: int,
                     group_pieces: int = GROUP_PIECES):
    """The live-slot stream of padded pieces (P, 128): the slots whose value
    is not 0 and whose x index, 128 ``piece_w`` + ``xoff``, lies inside x,
    in piece and then lane order. Returns (piece, lane, x index) of each
    live slot, ``slot_ptr`` (P + 1,) int32 (piece p's slots are
    ``slot_ptr[p]:slot_ptr[p + 1]``) and ``block_slot`` (blocks + 1,) int32
    (target block b's, from ``block_ptr`` over groups of ``group_pieces``
    pieces)."""
    values = np.asarray(values)
    piece, lane = np.nonzero(values != 0)
    x_index = (np.asarray(piece_w, np.int64)[piece] * LANE
               + np.asarray(xoff)[piece, lane].astype(np.int64))
    keep = x_index < k
    piece, lane, x_index = piece[keep], lane[keep], x_index[keep]
    counts = np.bincount(piece, minlength=values.shape[0])
    slot_ptr = np.concatenate([[0], np.cumsum(counts)])
    if slot_ptr[-1] >= 2 ** 31 - 1024:
        raise ValueError("live-slot stream: too many slots for int32")
    slot_ptr = slot_ptr.astype(np.int32)
    block_slot = slot_ptr[np.asarray(block_ptr, np.int64) * group_pieces]
    return piece, lane, x_index, slot_ptr, block_slot


def row_bytes(rows, slot_ptr) -> np.ndarray:
    """Each live slot's row byte: its row in the target block, with
    ``PIECE_START`` set on the first slot of each piece."""
    out = np.asarray(rows, np.uint8).copy()
    firsts = slot_ptr[:-1][np.diff(slot_ptr) > 0]
    out[firsts] |= PIECE_START
    return out


# CTAs an SM that the default range aims at: 256 threads of 32 registers
# let 8 CTAs share an SM, so the grid is one wave
CTAS_PER_SM = 8
MIN_SLOTS_PER_CTA = 1024


def default_slots_per_cta(num_slots: int, sms: int) -> int:
    """The default range of live slots a CTA: one wave of ``CTAS_PER_SM``
    CTAs on each of ``sms`` SMs, in whole tiles of 512, at least 1,024 (on
    the H100's 132 SMs: 2,048 at the 2.1M slots of a 100000^2 scattered
    matrix, 1,024 at the 392K of the 65535^2 hypersparse one)."""
    want = -(-num_slots // (CTAS_PER_SM * max(sms, 1)))
    return max(MIN_SLOTS_PER_CTA, -(-want // 512) * 512)


@functools.lru_cache(maxsize=None)
def _sms(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def check_stream(kernel: str, a, x: torch.Tensor,
                 slots_per_cta: int | None) -> None:
    """Raise unless the live-slot stream of ``a`` (DeviceWROW or
    DeviceWPACK) is what the stream kernels take."""
    if slots_per_cta is not None and slots_per_cta < 1:
        raise ValueError(f"slots_per_cta must be >= 1, got {slots_per_cta}")
    check_operands(kernel, x.device, slot_ptr=(a.slot_ptr, torch.int32),
                   block_slot=(a.block_slot, torch.int32),
                   slot_vals=(a.slot_vals, torch.float32),
                   slot_cols=(a.slot_cols, torch.int32),
                   slot_rows=(a.slot_rows, torch.uint8))


def launch_stream(wrapper, a, x: torch.Tensor,
                  slots_per_cta: int | None) -> torch.Tensor:
    """Launch ``spgrid_<wrapper's name>``, the live-slot stream walk and its
    carry combine, into a new y and count the launch on ``wrapper``;
    ``slots_per_cta`` None takes ``default_slots_per_cta`` for x's card."""
    m = a.shape[0]
    y = torch.empty((m,), dtype=torch.float32, device=x.device)
    if m == 0:
        return y
    if slots_per_cta is None:
        slots_per_cta = default_slots_per_cta(a.num_slots, _sms(x.device))
    ctas = -(-a.num_slots // slots_per_cta)
    carry = torch.empty((max(ctas, 1), 2, LANE), dtype=torch.float32,
                        device=x.device)
    name = wrapper.__name__
    lib = _build.library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = getattr(lib, f"spgrid_{name}")(
            a.block_slot.data_ptr(), a.slot_vals.data_ptr(),
            a.slot_cols.data_ptr(), a.slot_rows.data_ptr(), x.data_ptr(),
            y.data_ptr(), carry.data_ptr(), a.num_slots, slots_per_cta,
            a.blocks, m, stream)
    _build.check(code, name)
    wrapper.launches += 1
    return y


def stream_product(a, x: torch.Tensor) -> torch.Tensor:
    """y = A @ x over the live-slot stream of ``a`` (DeviceWROW or
    DeviceWPACK), in x's dtype: live slot s of target block b adds value ·
    x[slot_cols[s]] to row 128 b + its row (``index_add_``)."""
    block = torch.repeat_interleave(
        torch.arange(a.blocks, device=x.device),
        torch.diff(a.block_slot.long()))
    row = a.slot_rows.long() & (LANE - 1)
    y = torch.zeros((a.shape[0],), dtype=x.dtype, device=x.device)
    y.index_add_(0, block * LANE + row,
                 a.slot_vals.to(x.dtype) * x[a.slot_cols.long()])
    return y
