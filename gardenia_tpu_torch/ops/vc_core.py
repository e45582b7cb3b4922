"""The core pass's sequential first-fit of vertex colouring (kernel V1) —
counterpart of the XLA fori_loop `step` of gardenia_tpu/solvers/vc.py:
268-286, which has no Pallas kernel behind it.

    chosen = vc_core_firstfit(forb, rowptr, col)

colours K core vertices one after another: in order j = 0 .. K-1, row j
of `forb` (K, C) int8 (0 = free, 1 = forbidden) with the colours of j's
earlier core neighbours set, and chosen[j] its first zero, or -1
(saturated) where it has none; a saturated neighbour forbids nothing.
The reference pushes each step's colour into the later neighbours' rows;
pulling it from the earlier ones gives the same rows.  The core-core
adjacency is a CSR of its lower part (rowptr int64[K+1], col int32 with
col < its row; `core_csr` builds it).  `forb` is not modified.

`vc_core_firstfit` launches V1 (csrc/vc_core_firstfit.cu) on CUDA
tensors, or raises: a persistent grid of warps claims positions in order
and colours each as soon as its earlier neighbours are done, so it costs
about `core_depth` hand-overs (the longest chain of the order's DAG), not
K steps.  On CPU tensors, and only there, it takes
`vc_core_firstfit_plain`, the same loop in torch ops (some seven launches
a position on a card).  LAUNCHES counts V1's launches, never the plain
version's, so a run can show that its main path went through V1.
"""

from __future__ import annotations

import numpy as np
import torch

LAUNCHES = 0
PENDING = -2              # chosen[j] until the kernel colours j
MAX_C = 16384             # the kernel's palette limit, the solver's cap


def core_csr(rows: torch.Tensor, cols: torch.Tensor, K: int):
    """(rowptr i64[K+1], col i32) of the lower part of the core-core
    adjacency given as position pairs (rows, cols) in [0, K): the pairs
    with cols < rows, ordered by (row, col).  Each undirected edge of a
    symmetric graph appears twice among the pairs and once in the CSR."""
    keep = cols < rows
    a, b = rows[keep].long(), cols[keep].long()
    order = torch.argsort(a * K + b)
    rowptr = torch.zeros(K + 1, dtype=torch.int64, device=rows.device)
    rowptr[1:] = torch.cumsum(torch.bincount(a, minlength=K), 0)
    return rowptr, b[order].int()


def core_levels(rowptr: torch.Tensor, col: torch.Tensor) -> np.ndarray:
    """int64[K]: each position's level in the order's dependency DAG given
    by the lower CSR, 1 + the deepest earlier neighbour's (1 with none).
    On the host."""
    rp = rowptr.cpu().numpy()
    cl = col.cpu().numpy()
    level = np.zeros(len(rp) - 1, np.int64)
    for j in range(len(level)):
        nb = cl[rp[j]:rp[j + 1]]
        level[j] = 1 + (int(level[nb].max()) if nb.size else 0)
    return level


def core_depth(rowptr: torch.Tensor, col: torch.Tensor) -> int:
    """D, the DAG's levels: the most positions on a chain j_1 < j_2 < ...
    of neighbours (K with a chain or a clique, 1 with no edge, 0 when
    K = 0).  What V1's time goes with."""
    level = core_levels(rowptr, col)
    return int(level.max()) if level.size else 0


def vc_core_firstfit_plain(forb: torch.Tensor, rowptr: torch.Tensor,
                           col: torch.Tensor) -> torch.Tensor:
    """int32[K] in torch ops, position by position: the row with its
    earlier neighbours' colours set (a saturated -1 goes to a spare
    column), then its first minimum (torch.argmin returns the first, as
    jnp.argmin does), saturated when that is not 0."""
    K, C = forb.shape
    chosen = torch.full((K,), -1, dtype=torch.int32, device=forb.device)
    row = torch.empty(C + 1, dtype=torch.int8, device=forb.device)
    rp = rowptr.tolist()
    col = col.long()
    for j in range(K):
        row[:C] = forb[j]
        if rp[j + 1] > rp[j]:
            c = chosen[col[rp[j]:rp[j + 1]]].long()
            row[torch.where(c >= 0, c, C)] = 1
        c = torch.argmin(row[:C])
        chosen[j] = torch.where(row[c] == 0, c.int(), -1)
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
    rowptr: int64[K+1], col: int32 — the adjacency's lower part (core_csr).
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
    if K >= 2 ** 31 or C > MAX_C:
        raise ValueError(f"forb shape {tuple(forb.shape)}: V1 takes K < "
                         f"2^31 and C <= {MAX_C}")
    from gardenia_tpu_torch.ops import _build

    chosen = torch.full((K,), PENDING, dtype=torch.int32, device=forb.device)
    if K == 0:
        return chosen
    forb = forb.contiguous()             # read only: no copy when it is
    counter = torch.zeros(1, dtype=torch.int32, device=forb.device)
    with torch.cuda.device(forb.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = _build.lib().gdn_vc_core_firstfit(
            forb.data_ptr(), rowptr.data_ptr(), col.data_ptr(),
            chosen.data_ptr(), counter.data_ptr(), K, C, stream)
    _build.check(code, "vc_core_firstfit")
    LAUNCHES += 1
    return chosen
