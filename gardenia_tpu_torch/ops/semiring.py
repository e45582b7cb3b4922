"""Semirings for generalized SpMV (torch counterpart of
gardenia_tpu/ops/semiring.py).

JAX's scatters drop out-of-range indices (`mode="drop"`), and the ELL
layout relies on it: its pad rows carry the row sentinel m.  A CUDA
`index_add_` faults on such an index instead, so `scatter_into` routes
every out-of-range index to an extra pad slot and slices it off.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np
import torch

from gardenia_tpu_torch.core import types as T


@dataclasses.dataclass(frozen=True)
class Semiring:
    """(add, mul) with identity `zero`.

    pad_x: value stored in the padded slot of the gathered operand so that
           mul(0, pad_x) == zero (ELL pads values with 0).
    scatter: how partial row results combine ('add'/'min'/'max') — must
             match `add`.
    """

    name: str
    add: Callable[[Any, Any], Any]
    mul: Callable[[Any, Any], Any]
    zero: Any
    pad_x: Any
    scatter: str
    dtype: torch.dtype

    def reduce(self, arr: torch.Tensor, dim: int) -> torch.Tensor:
        if self.scatter == "add":
            return arr.sum(dim=dim, dtype=arr.dtype)   # int32 stays int32
        if self.scatter == "min":
            return arr.amin(dim=dim)
        if self.scatter == "max":
            return arr.amax(dim=dim)
        raise ValueError(self.scatter)

    def scatter_(self, y: torch.Tensor, idx: torch.Tensor,
                 vals: torch.Tensor) -> torch.Tensor:
        """Combine vals into y at idx, in place; every idx must be in
        range."""
        if self.scatter == "add":
            return y.index_add_(0, idx, vals)
        if self.scatter in ("min", "max"):
            return y.scatter_reduce_(0, idx.long(), vals, "a" + self.scatter)
        raise ValueError(self.scatter)

    def scatter_into(self, y: torch.Tensor, idx: torch.Tensor,
                     vals: torch.Tensor) -> torch.Tensor:
        """y with vals combined at idx; indices outside [0, len(y)) are
        dropped, as JAX's mode="drop" does."""
        n = y.shape[0]
        ext = torch.cat([y, y.new_full((1,), self.zero)])
        self.scatter_(ext, drop_index(idx, n), vals)
        return ext[:n]


def drop_index(idx: torch.Tensor, n: int) -> torch.Tensor:
    """idx with every entry outside [0, n) sent to the pad slot n."""
    return torch.where((idx >= 0) & (idx < n), idx, n)


_INF_F32 = np.float32(np.inf)

# y[i] = sum_j A[i,j] * x[j]   — SpMV, PageRank pull, BC accumulation
F32_PLUS_TIMES = Semiring("f32_plus_times", torch.add, torch.mul,
                          0.0, 0.0, "add", torch.float32)

# y[i] = min_j (A[i,j] + x[j]) — SSSP relaxation (float weights)
F32_MIN_PLUS = Semiring("f32_min_plus", torch.minimum, torch.add,
                        float(_INF_F32), float(_INF_F32), "min",
                        torch.float32)

# integer distances with MYINFINITY sentinel (reference common.h:66)
I32_MIN_PLUS = Semiring("i32_min_plus", torch.minimum, torch.add,
                        T.MYINFINITY, T.MYINFINITY, "min", torch.int32)

# y[i] = sum_j x[j] over neighbors — frontier-overlap counts (BFS, TC rows)
I32_PLUS_TIMES = Semiring("i32_plus_times", torch.add, torch.mul,
                          0, 0, "add", torch.int32)

# y[i] = min_j x[j] — min-label propagation (CC / SV hooking, BFS parent);
# mul ignores the matrix value ("select second")
I32_MIN_SELECT2 = Semiring("i32_min_select2", torch.minimum,
                           lambda a, x: x,
                           int(np.iinfo(np.int32).max),
                           int(np.iinfo(np.int32).max), "min", torch.int32)
