"""The core pass's sequential first-fit of vertex colouring (kernel V1) —
counterpart of the XLA fori_loop `step` of gardenia_tpu/solvers/vc.py:
268-286, which has no Pallas kernel behind it.

    chosen = vc_core_firstfit(forb, rowptr, col)

colours K core vertices one after another: in order i = 0 .. K-1, c_i is
the first zero of row i of `forb` (K, C) int8 (1 = forbidden); a row with
no zero gives chosen[i] = -1 (saturated) and changes nothing, else
chosen[i] = c_i and column c_i of every core neighbour j > i of i becomes
forbidden.  The core-core adjacency is a CSR of its upper part (rowptr
int64[K+1], col int32 with col > its row; `core_csr` builds it): only
the later rows are read after step i.  `forb` is not modified.

`vc_core_firstfit` launches V1 (csrc/vc_core_firstfit.cu, one CTA walking
the K dependent steps) on CUDA tensors, or raises; on CPU tensors, and
only there, it takes `vc_core_firstfit_plain`, the same loop in torch ops
(some eight launches a step on a card, which is why V1 exists: 65,536
steps a solve at R-MAT-20).  LAUNCHES counts V1's launches, never the
plain version's, so a run can show that its main path went through V1.
"""

from __future__ import annotations

import torch

LAUNCHES = 0


def core_csr(rows: torch.Tensor, cols: torch.Tensor, K: int):
    """(rowptr i64[K+1], col i32) of the upper part of the core-core
    adjacency given as position pairs (rows, cols) in [0, K): the pairs
    with cols > rows, ordered by (row, col).  Each undirected edge of a
    symmetric graph appears twice among the pairs and once in the CSR."""
    keep = cols > rows
    a, b = rows[keep].long(), cols[keep].long()
    order = torch.argsort(a * K + b)
    rowptr = torch.zeros(K + 1, dtype=torch.int64, device=rows.device)
    rowptr[1:] = torch.cumsum(torch.bincount(a, minlength=K), 0)
    return rowptr, b[order].int()


def vc_core_firstfit_plain(forb: torch.Tensor, rowptr: torch.Tensor,
                           col: torch.Tensor) -> torch.Tensor:
    """int32[K] in torch ops, step by step: the first minimum of the row
    (torch.argmin returns the first, as jnp.argmin does), saturated when
    it is not 0."""
    forb = forb.clone()
    K = forb.shape[0]
    chosen = torch.full((K,), -1, dtype=torch.int32, device=forb.device)
    rp = rowptr.tolist()
    col = col.long()
    for i in range(K):
        row = forb[i]
        c = torch.argmin(row)
        free = row[c] == 0
        chosen[i] = torch.where(free, c.int(), -1)
        nb = col[rp[i]:rp[i + 1]]
        if nb.numel():
            forb[nb, c] = torch.maximum(forb[nb, c], free.to(torch.int8))
    return chosen


def _check(forb, rowptr, col):
    if forb.dtype != torch.int8 or forb.dim() != 2:
        raise TypeError(f"forb must be a 2-D int8 tensor, got {forb.dtype} "
                        f"{tuple(forb.shape)}")
    if rowptr.dtype != torch.int64 or rowptr.dim() != 1:
        raise TypeError(f"rowptr must be a 1-D int64 tensor, got "
                        f"{rowptr.dtype} {tuple(rowptr.shape)}")
    if col.dtype != torch.int32 or col.dim() != 1:
        raise TypeError(f"col must be a 1-D int32 tensor, got {col.dtype} "
                        f"{tuple(col.shape)}")
    K, C = forb.shape
    if rowptr.shape[0] != K + 1:
        raise ValueError(f"rowptr has {rowptr.shape[0]} entries for {K} rows")
    if C < 1 and K:
        raise ValueError("forb has no colour column")
    devs = {forb.device, rowptr.device, col.device}
    if len(devs) != 1:
        raise ValueError(f"tensors on different devices: {devs}")


def vc_core_firstfit(forb: torch.Tensor, rowptr: torch.Tensor,
                     col: torch.Tensor) -> torch.Tensor:
    """int32[K]: each core row's first-fit colour, -1 where saturated.

    forb:   (K, C) int8, 0 = free, 1 = forbidden (by non-core neighbours).
    rowptr: int64[K+1], col: int32 — the adjacency's upper part (core_csr).
    """
    global LAUNCHES
    _check(forb, rowptr, col)
    if forb.device.type == "cpu":
        return vc_core_firstfit_plain(forb, rowptr, col)
    if forb.device.type != "cuda":
        raise ValueError(f"unsupported device {forb.device}")
    for name, t in (("rowptr", rowptr), ("col", col)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    K, C = forb.shape
    if K >= 2 ** 31 or C >= 2 ** 31:
        raise ValueError(f"forb shape {tuple(forb.shape)} exceeds int32")
    from gardenia_tpu_torch.ops import _build

    chosen = torch.empty(K, dtype=torch.int32, device=forb.device)
    if K == 0:
        return chosen
    work = forb.contiguous().clone()     # the kernel updates its copy
    with torch.cuda.device(forb.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = _build.lib().gdn_vc_core_firstfit(
            work.data_ptr(), rowptr.data_ptr(), col.data_ptr(),
            chosen.data_ptr(), K, C, stream)
    _build.check(code, "vc_core_firstfit")
    LAUNCHES += 1
    return chosen


def empty_steps(K: int, device) -> None:
    """Launch V1's loop of K steps with no search and no stores: the floor
    that its dependent steps' barriers set.  Not counted in LAUNCHES."""
    from gardenia_tpu_torch.ops import _build
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError("empty_steps runs V1's loop on a CUDA device")
    sink = torch.zeros(1, dtype=torch.int32, device=device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        code = _build.lib().gdn_vc_core_steps(K, sink.data_ptr(), stream)
    _build.check(code, "vc_core_steps")
