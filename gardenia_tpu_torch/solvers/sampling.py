"""Graph sampling — batched uniform random walks; torch counterpart of
gardenia_tpu/solvers/sampling.py (the reference's src/sampling is an
empty skeleton).

W walkers advance in lockstep: each step picks, per walker, one slot of
its vertex's CSR row by a uniform draw.  The draws come from a
torch.Generator on the solve's device seeded with `seed`, so a seed gives
the same walks on one device; jax.random's stream has no bit-for-bit
torch counterpart, so the walks differ from the JAX solver's.
"""

from __future__ import annotations

import numpy as np
import torch

from gardenia_tpu_torch import resolve_device
from gardenia_tpu_torch.core import views


def random_walks(g, starts, length: int, seed: int = 0, *,
                 device="cuda") -> torch.Tensor:
    """walks[w, t] (i32[W, length + 1]): the vertex of walker w at step t
    (t = 0 is its start).  Walkers at sinks (no out-edges) stay put."""
    dev = resolve_device(device)
    rowptr, colidx = views.csr(g, dev)
    pos = torch.from_numpy(np.asarray(starts, np.int32)).to(dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    trail = [pos]
    for _ in range(length):
        p = pos.long()
        lo = rowptr[p]
        deg = rowptr[p + 1] - lo
        r = torch.rand(pos.shape, generator=gen, device=dev)
        # the slot floor(r * deg) of the row; the clamp keeps it in the
        # row where f32 rounds r * deg up to deg
        off = torch.minimum((r * deg.clamp(min=1)).long(),
                            (deg - 1).clamp(min=0))
        nxt = colidx[(lo + off).clamp(max=max(g.nnz - 1, 0))]
        pos = torch.where(deg > 0, nxt, pos)
        trail.append(pos)
    return torch.stack(trail, dim=1)
