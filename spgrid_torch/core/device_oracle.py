"""The f64 gate on the device: the gold Y = A @ X and the error vector's
partial sums formed where the result lies, so a gate fetches ten numbers
instead of an (m, n) result.

The counterpart of ``spgrid/core/device_oracle.py``. Only its idea carries
over: the JAX package builds its gold in double-float arithmetic from f32
pieces because the TPU has no f64, caps it at an ELL slot budget and sends
the heavier rows to a host pass; the H100 has native f64, so here the gold
is formed in f64 for every row, however long, with no slot budget and no
host pass.

The host gate (``core.metrics.gold_spmm_fast`` and ``error_metrics``) stays
the definition. This one is built to give its numbers:

- the gold is the host gold bit for bit. Each product is an f32 value
  times an f32 value, exact in f64, and each row is summed in the order
  ``np.add.reduceat`` sums it there: the row's first product, plus numpy's
  pairwise sum of the rest (eight running sums over blocks of eight
  products up to 128, the remainder added after; longer runs halved at a
  multiple of eight, ``pairwise_plan``). Rows are formed a chunk at a
  time, at most ``GOLD_BYTES`` of f64 products a chunk;
- the metrics' terms are ``error_metrics``'s, in f64, summed over the rows
  a chunk at a time (at most ``METRIC_BYTES`` of f64 terms), then
  finished on the host as ``error_metrics`` finishes them (``finish``).
  Their sums run in another order than numpy's, so a metric may differ in
  its last bits: within ``METRIC_RTOL`` relative. lnQ_error is the mean of
  log10|f| - log10|a|, and log10 on the card differs from numpy's on the
  host by a unit in the last place on about a quarter of its inputs
  (measured on an H100 host), while the mean of an f32 result's terms may
  be as small as 1e-12: the two gates' lnQ_error then differ far more than
  1e-12 relative, by at most ``LNQ_ABS_TOL`` absolute (two units in the
  last place of two log10 values below 8 a term), and gmare = |10^lnQ - 1|
  (mlare its log10) by at most ``GMARE_ABS_TOL``. On the CPU torch's log10
  is numpy's, and every metric agrees within ``METRIC_RTOL``
  (``disagreements`` holds two gates to these bounds).

A gate that runs out of device memory raises; nothing falls back to the
host.
"""

from __future__ import annotations

import functools
import math
from typing import Optional

import numpy as np
import torch

from spgrid_torch.core.metrics import ErrorMetrics

GOLD_BYTES = 1 << 30     # f64 products of a gold chunk
METRIC_BYTES = 1 << 28   # f64 values of a metric chunk (several live)
METRIC_RTOL = 1e-12      # two gates' metrics, relative
LNQ_ABS_TOL = 4 * 2.0 ** -50    # lnQ_error: 2 ulp of two log10 below 8
GMARE_ABS_TOL = 3 * LNQ_ABS_TOL  # |10^lnQ - 1|: ln 10 LNQ_ABS_TOL + 2 ulp
BLOCK = 128              # numpy's pairwise block (PW_BLOCKSIZE)
UNROLL = 8               # numpy's pairwise running sums
# the partial sums, in the order ``DeviceOracle.partials`` keeps them
PARTIALS = ("sum_ad", "sum_d2", "sum_ape", "cnt_nz", "sum_sape", "cnt_dz",
            "sum_lnq", "max_ad", "max_rel")


@functools.lru_cache(maxsize=None)
def pairwise_plan(n: int):
    """numpy's pairwise sum of a run of n > ``BLOCK`` values as a tree:
    (leaves, adds, root). ``leaves`` are (offset, length) runs of at most
    ``BLOCK``, summed as numpy sums a block; ``adds`` are (left, right,
    height) node pairs, node i < len(leaves) a leaf and node len(leaves) +
    j the j-th add; ``root`` is the last node."""
    leaves, adds = [], []

    def walk(off, length):
        if length <= BLOCK:
            leaves.append((off, length))
            return ("leaf", len(leaves) - 1), 0
        half = length // 2
        half -= half % UNROLL
        left, hl = walk(off, half)
        right, hr = walk(off + half, length - half)
        adds.append((left, right, max(hl, hr) + 1))
        return ("add", len(adds) - 1), max(hl, hr) + 1

    walk(0, n)
    nl = len(leaves)

    def node(ref):
        return ref[1] if ref[0] == "leaf" else nl + ref[1]

    return (tuple(leaves), tuple((node(l), node(r), h) for l, r, h in adds),
            nl + len(adds) - 1)


def block_sums(prods: torch.Tensor, lens: torch.Tensor) -> torch.Tensor:
    """numpy's pairwise sum of each run ``prods[i, :lens[i]]`` (lens at most
    ``BLOCK``; entries past a run's length are 0), in f64: below 8 values
    one running sum from 0; else eight running sums over whole blocks of
    eight, combined ((r0 + r1) + (r2 + r3)) + ((r4 + r5) + (r6 + r7)),
    then the rest added one at a time. Adding a 0 changes no sum, so runs
    of different lengths share the loop."""
    b, width, n = prods.shape
    short = torch.zeros((b, n), dtype=prods.dtype, device=prods.device)
    for t in range(min(width, UNROLL - 1)):
        short += prods[:, t]
    if width < UNROLL:
        return short
    lens = lens.to(prods.device)
    whole = lens - lens % UNROLL              # the blocks' end
    r = prods[:, :UNROLL].clone()
    for i in range(UNROLL, width - UNROLL + 1, UNROLL):
        keep = (i < whole).to(prods.dtype)[:, None, None]
        r += prods[:, i:i + UNROLL] * keep
    long = ((r[:, 0] + r[:, 1]) + (r[:, 2] + r[:, 3])) + \
        ((r[:, 4] + r[:, 5]) + (r[:, 6] + r[:, 7]))
    for t in range(UNROLL - 1):
        at = (whole + t).clamp(max=width - 1)
        keep = ((whole + t) < lens).to(prods.dtype)[:, None]
        long += prods.gather(1, at[:, None, None].expand(b, 1, n))[:, 0] * keep
    return torch.where((lens < UNROLL)[:, None], short, long)


class DeviceOracle:
    """One matrix's f64 gate on a device, reused across the rows of a gate
    class: the f64 CSR is uploaded once, the gold of the last X asked is
    kept (``gold``), and ``check`` gates a result against it.

    Host side, at build: every row's run of products after its first is
    cut into leaves of at most ``BLOCK`` (one leaf for a row of up to 129
    nnz, ``pairwise_plan``'s for a longer one), each leaf holding a node of
    the row's sum tree; node r is row r's run, nodes past m the long rows'
    leaves and inner adds."""

    def __init__(self, row_ptr: np.ndarray, col_idx: np.ndarray,
                 values: np.ndarray, m: int, k: int, *, device):
        self.m, self.k = m, k
        self.device = torch.device(device)
        ptr = np.asarray(row_ptr, np.int64)
        deg = np.diff(ptr)
        rest = np.maximum(deg - 1, 0)
        leaf_start = [ptr[:-1] + 1]
        leaf_len = [np.where(rest <= BLOCK, rest, 0)]
        leaf_node = [np.arange(m, dtype=np.int64)]
        adds = []                         # (node, left, right, height)
        nodes = m
        for length in np.unique(rest[rest > BLOCK]):
            rows = np.flatnonzero(rest == length)
            leaves, tree, root = pairwise_plan(int(length))
            size = len(leaves) + len(tree)
            # node ids: the root is the row's own node, the rest new
            ids = nodes + np.arange(len(rows) * (size - 1),
                                    dtype=np.int64).reshape(len(rows), -1)
            nodes += ids.size
            ids = np.insert(ids, root, rows, axis=1)
            for j, (off, ln) in enumerate(leaves):
                leaf_start.append(ptr[rows] + 1 + off)
                leaf_len.append(np.full(len(rows), ln, np.int64))
                leaf_node.append(ids[:, j])
            for j, (left, right, height) in enumerate(tree):
                node = len(leaves) + j
                adds.append((ids[:, node], ids[:, left], ids[:, right],
                             np.full(len(rows), height)))
        self.nodes = nodes
        self._leaves = (np.concatenate(leaf_start),
                        np.concatenate(leaf_len),
                        np.concatenate(leaf_node))
        self._adds = []
        if adds:
            node, left, right, height = (np.concatenate(a)
                                         for a in zip(*adds))
            for h in np.unique(height):
                at = height == h
                self._adds.append(tuple(
                    torch.from_numpy(v[at]).to(self.device)
                    for v in (node, left, right)))
        self._first = torch.from_numpy(
            np.where(deg > 0, ptr[:-1], -1)).to(self.device)
        self._cols = torch.from_numpy(
            np.asarray(col_idx, np.int64)).to(self.device)
        self._vals = torch.from_numpy(
            np.asarray(values, np.float64)).to(self.device)
        self._gold: Optional[torch.Tensor] = None
        self._gold_key = None

    @classmethod
    def from_csr(cls, csr, *, device) -> "DeviceOracle":
        return cls(csr.row_ptr, csr.col_idx, csr.values, csr.m, csr.k,
                   device=device)

    def _products(self, at: torch.Tensor, x64: torch.Tensor) -> torch.Tensor:
        """The f64 products of the nnz ``at`` (any shape) with their X rows:
        (*at.shape, n)."""
        flat = at.reshape(-1)
        p = x64.index_select(0, self._cols.index_select(0, flat))
        p *= self._vals.index_select(0, flat)[:, None]
        return p.view(*at.shape, x64.shape[1])

    def gold(self, x: torch.Tensor, key=None) -> torch.Tensor:
        """The (m, n) f64 gold A @ X on the device, the host gold bit for bit
        (``gold_spmm_fast``); kept for the next call with the same ``key``
        (None: formed anew)."""
        if key is not None and key == self._gold_key:
            return self._gold
        self._gold, self._gold_key = None, None     # its memory first
        x64 = x.to(device=self.device, dtype=torch.float64)
        n = x64.shape[1]
        sums = torch.zeros((self.nodes, n), dtype=torch.float64,
                           device=self.device)
        start, length, node = self._leaves
        by_len = np.argsort(length, kind="stable")
        bounds = np.searchsorted(length[by_len], [0, 1, 2, 4, 8, 16, 32, 64,
                                                  BLOCK + 1], side="right")
        for lo, hi in zip(bounds[:-1], bounds[1:]):
            if lo == hi:
                continue
            width = int(length[by_len[hi - 1]])
            step = max(1, GOLD_BYTES // (8 * width * max(n, 1)))
            for c0 in range(lo, hi, step):
                sel = by_len[c0:min(c0 + step, hi)]
                lens = torch.from_numpy(length[sel])
                at = torch.from_numpy(start[sel])[:, None] + torch.arange(
                    width)
                live = (torch.arange(width)[None, :] < lens[:, None])
                at = torch.where(live, at, 0).to(self.device)
                prods = self._products(at, x64)
                prods *= live.to(self.device, torch.float64)[:, :, None]
                sums.index_copy_(0, torch.from_numpy(node[sel]).to(
                    self.device), block_sums(prods, lens))
                del prods
        for node_, left, right in self._adds:
            sums.index_copy_(0, node_, sums.index_select(0, left)
                             + sums.index_select(0, right))
        gold = sums[:self.m]
        del sums
        has = self._first >= 0
        step = max(1, GOLD_BYTES // (8 * max(n, 1)))
        for r0 in range(0, self.m if self._vals.numel() else 0, step):
            r1 = min(r0 + step, self.m)
            first = self._products(self._first[r0:r1].clamp(min=0), x64)
            first *= has[r0:r1, None].to(torch.float64)
            gold[r0:r1] = first + gold[r0:r1]
        gold = gold.contiguous()
        if key is not None:
            self._gold, self._gold_key = gold, key
        return gold

    def partials(self, gold: torch.Tensor, test: torch.Tensor,
                 eps: float) -> dict:
        """``error_metrics``'s partial sums of ``test`` against ``gold``, in
        f64 on the device, a chunk of rows at a time; fetched once."""
        m, n = gold.shape
        acc = torch.zeros(len(PARTIALS), dtype=torch.float64,
                          device=self.device)
        tiny = max(eps, np.finfo(np.float64).tiny)
        step = max(1, METRIC_BYTES // (8 * max(n, 1)))
        for r0 in range(0, m, step):
            a = gold[r0:r0 + step]
            f = test[r0:r0 + step].to(torch.float64)
            diff = (a - f).abs()
            aa, af = a.abs(), f.abs()
            nz = aa > 0
            denom = aa + af
            dz = denom > 0
            lnq = (torch.log10(af.clamp(min=tiny))
                   - torch.log10(aa.clamp(min=tiny)))
            sig = aa > eps
            rel = torch.where(sig, diff / torch.where(sig, aa, 1.0), diff)
            zero = torch.zeros((), dtype=torch.float64, device=self.device)
            chunk = torch.stack([
                diff.sum(), (diff * diff).sum(),
                torch.where(nz, diff / torch.where(nz, aa, 1.0), zero).sum(),
                nz.sum().to(torch.float64),
                torch.where(dz, 2.0 * diff / torch.where(dz, denom, 1.0),
                            zero).sum(),
                dz.sum().to(torch.float64), lnq.sum(),
                diff.max() if diff.numel() else zero,
                rel.max() if rel.numel() else zero])
            acc[:7] += chunk[:7]
            acc[7:] = torch.maximum(acc[7:], chunk[7:])
        out = dict(zip(PARTIALS, acc.tolist()))
        out["cnt"] = m * n
        return out

    def check(self, test: torch.Tensor, x: torch.Tensor, eps: float,
              key=None) -> ErrorMetrics:
        """Gate ``test`` (an (m, n) result on the device) against the f64
        gold of the X the class multiplies, ``x``; ``key`` names that X for
        the gold's reuse."""
        if tuple(test.shape) != (self.m, x.shape[1]):
            raise ValueError(f"shape mismatch: gold ({self.m}, {x.shape[1]}) "
                             f"vs test {tuple(test.shape)}")
        return finish(self.partials(self.gold(x, key), test, eps), eps)


def finish(p: dict, eps: float) -> ErrorMetrics:
    """The error vector from its partial sums, as ``error_metrics`` forms it
    from the same sums."""
    cnt = p["cnt"]
    lnq = p["sum_lnq"] / cnt if cnt else 0.0
    mlare = float(np.log10(abs(10.0 ** lnq - 1.0))) if lnq != 0.0 \
        else -math.inf
    return ErrorMetrics(
        mae=p["sum_ad"] / cnt if cnt else 0.0,
        max_ae=p["max_ad"] if cnt else 0.0,
        mse=p["sum_d2"] / cnt if cnt else 0.0,
        mape=p["sum_ape"] / p["cnt_nz"] if p["cnt_nz"] else 0.0,
        smape=p["sum_sape"] / p["cnt_dz"] if p["cnt_dz"] else 0.0,
        lnQ_error=lnq,
        mlare=mlare,
        gmare=float(10.0 ** mlare),
        max_rel_diff=p["max_rel"] if cnt else 0.0,
        passed=bool((p["max_rel"] if cnt else 0.0) <= eps),
    )


# the metrics held to METRIC_RTOL, relative, by ``disagreements``
LINEAR_METRICS = ("mae", "max_ae", "mse", "mape", "smape", "max_rel_diff")


def disagreements(host: ErrorMetrics, dev: ErrorMetrics) -> list:
    """The names of the metrics in which two gates' error vectors differ
    by more than their bounds (module doc): ``METRIC_RTOL`` relative for
    the sums and maxima, ``LNQ_ABS_TOL`` for lnQ_error, ``GMARE_ABS_TOL``
    for gmare and for 10^mlare; and ``passed`` where the verdicts
    differ."""
    out = []
    for f in LINEAR_METRICS:
        h, d = getattr(host, f), getattr(dev, f)
        if h != d and not abs(h - d) <= METRIC_RTOL * abs(h):
            out.append(f)
    if not abs(host.lnQ_error - dev.lnQ_error) <= LNQ_ABS_TOL:
        out.append("lnQ_error")
    if not abs(host.gmare - dev.gmare) <= GMARE_ABS_TOL:
        out.append("gmare")
    if not abs(10.0 ** host.mlare - 10.0 ** dev.mlare) <= GMARE_ABS_TOL:
        out.append("mlare")
    if host.passed != dev.passed:
        out.append("passed")
    return out
