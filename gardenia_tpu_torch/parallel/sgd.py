"""Multi-device SGD matrix factorization: full-batch data parallelism over
the rating edges — the torch counterpart of gardenia_tpu/parallel/sgd.py.

Each rank owns a contiguous shard of (src, dst, rating), padded to a
common length with invalid edges; the latent factor tables are
replicated.  A step computes the rank's gradient of the full-batch loss
over its edges, all-reduces the two gradient tables (sum) and the squared
error once, and every rank applies the same update.  (The JAX step has no
explicit gradient psum: shard_map's transpose of a replicated input
inserts it.  Here the sum is explicit, and taken exactly once.)  The
reference's SGD is single-node Hogwild (src/sgd/omp_base.cc); this is
the scale-out axis it lacks.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from gardenia_tpu_torch.core import types as T
from gardenia_tpu_torch.solvers.sgd import (DEFAULT_LAMBDA, DEFAULT_STEP,
                                            _edges, init_latent, num_items)


class SGDDistResult(NamedTuple):
    user_lv: torch.Tensor    # f32[m, K]
    item_lv: torch.Tensor    # f32[n, K]
    rmse: torch.Tensor       # f32 scalar: the last step's RMSE


def make_dist_sgd_step(mesh, m: int, n: int, nnz_total: int,
                       lam: float = DEFAULT_LAMBDA,
                       step: float = DEFAULT_STEP):
    """The data-parallel training step of mesh's rank:
    (ulv, ilv, src, dst, r, valid) -> (ulv', ilv', rmse), where src, dst,
    r, valid are the rank's edge shard (valid 0 on padding) and the
    factor tables are replicated.  m and n (users, items) are kept for
    the JAX signature."""
    lam = float(np.float32(lam))
    step = float(np.float32(step))

    def train_step(ulv, ilv, src, dst, r, valid):
        s, d = src.long(), dst.long()
        us, it = ulv[s], ilv[d]
        delta = (r - (us * it).sum(1)) * valid
        v = valid[:, None]
        # d/d(ulv, ilv) of 0.5 sum delta^2 + 0.5 lam sum (|u_s|^2 + |i_d|^2)
        # over the valid edges
        gu = torch.zeros_like(ulv).index_add_(
            0, s, (lam * us - delta[:, None] * it) * v)
        gi = torch.zeros_like(ilv).index_add_(
            0, d, (lam * it - delta[:, None] * us) * v)
        gu = mesh.all_reduce(gu)
        gi = mesh.all_reduce(gi)
        sqerr = mesh.all_reduce((delta * delta).sum())
        return (ulv - step * gu, ilv - step * gi,
                torch.sqrt(sqerr / nnz_total))

    return train_step


def sgd_train_dist(g, *, mesh, iters: int = 3,
                   lam: float = DEFAULT_LAMBDA, step: float = DEFAULT_STEP,
                   seed: int = 0) -> SGDDistResult:
    """`iters` distributed full-batch epochs of the rating graph g on
    every rank of mesh, from init_latent(m, seed), (n, seed + 1)."""
    dev, ndev = mesh.device, mesh.size
    m, n = g.m, num_items(g)
    src_h, dst_h, r_h = _edges(g)
    per = T.round_up(max(1, -(-g.nnz // ndev)), 8)
    lo = min(g.nnz, mesh.rank * per)
    hi = min(g.nnz, lo + per)

    def shard(a, dtype):
        out = np.zeros(per, dtype)
        out[:hi - lo] = a[lo:hi]
        return torch.from_numpy(out).to(dev)
    data = (shard(src_h, np.int32), shard(dst_h, np.int32),
            shard(r_h, np.float32),
            shard(np.ones(g.nnz, np.float32), np.float32))
    train = make_dist_sgd_step(mesh, m, n, g.nnz, lam, step)
    ulv = torch.from_numpy(init_latent(m, seed)).to(dev)
    ilv = torch.from_numpy(init_latent(n, seed + 1)).to(dev)
    rmse = torch.zeros((), dtype=torch.float32, device=dev)
    for _ in range(iters):
        ulv, ilv, rmse = train(ulv, ilv, *data)
    return SGDDistResult(ulv, ilv, rmse)
