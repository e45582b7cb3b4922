"""Pointer jumping — torch counterpart of gardenia_tpu/ops/pointer_jump.py,
the replacement for the reference's lock-free union-find compression
(include/component.h, src/cc/omp_afforest.cc:12-35).

A parent forest is an i32 vector; full path compression is comp =
comp[comp] until a fixpoint.  The JAX version runs that under
lax.while_loop; here the loop runs on the host and reads one `.any()`
back per level.  The reference's TPU row-select gather (rowsel.take) is
plain indexing.
"""

from __future__ import annotations

import torch


def pointer_jump(comp: torch.Tensor) -> torch.Tensor:
    """Fully compress a parent forest: comp[v] -> root of v."""
    while True:
        c2 = comp[comp]
        if not bool((c2 != comp).any()):
            return c2
        comp = c2


def pointer_jump_n(comp: torch.Tensor, n: int) -> torch.Tensor:
    """Fixed-count jumping (cheaper when the depth bound is known)."""
    for _ in range(n):
        comp = comp[comp]
    return comp
