"""SGD — matrix-factorisation stochastic gradient descent (Koren); torch
counterpart of gardenia_tpu/solvers/sgd.py (reference src/sgd/{sgd.h,
omp_base.cc,main.cc}).

The rating graph is bipartite: rows are users, columns items, weights
ratings; K = 20 latent dimensions.  Two steps, as in the JAX solver:

  make_sgd_epoch — mini-batched epochs: a static shuffle of the edges
      (default_rng(17)) into equal batches, padded with zero-valid edges;
      per batch the squared errors at the pre-update factors, and each
      touched vertex's MEAN gradient over its batch edges (the per-edge
      inverse batch counts nu / ni are fixed, so counted once on the
      host); the -lambda regularisation once an epoch.
  make_sgd_step — batches = 0: the exact full-batch gradient of
      0.5 sum_e (r_e - u_src . i_dst)^2 + 0.5 lambda sum_e (|u_src|^2 +
      |i_dst|^2), written out (no autograd).

The per-vertex sums are `index_add_`s straight into the factor tables
(the gathered rows are taken first, so every edge of a batch sees the
pre-update factors, as in the JAX epoch); on a card their float atomics
add in no fixed order, so results repeat only to f32 rounding.  The JAX
package's packed 128-lane epoch (a TPU row-gather workaround) and its
device segments are not ported: `sgd_solver` loops over epochs on the
host and reads the RMSE only when epsilon > 0 asks it to stop early.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from gardenia_tpu_torch import resolve_device

K = 20                 # latent dims (sgd.h:25)
DEFAULT_LAMBDA = 0.05  # driver default (src/sgd/main.cc:35)
DEFAULT_STEP = 0.003
DEFAULT_EPSILON = 0.1
DEFAULT_MAX_ITERS = 3


class SGDResult(NamedTuple):
    user_lv: torch.Tensor   # f32[m, K]
    item_lv: torch.Tensor   # f32[n, K]
    rmse: torch.Tensor      # f32[max_iters] (inf tail), rmse[i] after i+1
    iterations: int


def init_latent(count: int, seed: int = 0) -> np.ndarray:
    """uniform(0, 0.1) init (src/sgd/main.cc:6-13)."""
    return (np.random.default_rng(seed).random((count, K)) * 0.1
            ).astype(np.float32)


def make_sgd_step(src, dst, ratings, lam, step, num_users, num_items, *,
                  device="cuda"):
    """(step, data): step(u, i, data) -> (u', i', rmse), the exact
    full-batch gradient step, and its edge tensors on `device`; the edge
    arrays are numpy (the users and items counts stay for the JAX
    signature)."""
    dev = resolve_device(device)
    data = tuple(torch.from_numpy(np.asarray(a)).to(dev) for a in
                 (src, dst, np.asarray(ratings, np.float32)))
    nnz = data[2].shape[0]

    def sgd_step(ulv, ilv, data_):
        s, d, r = data_
        s, d = s.long(), d.long()
        us, it_ = ulv[s], ilv[d]
        delta = r - (us * it_).sum(1)
        sqerr = (delta * delta).sum()
        gu = torch.zeros_like(ulv).index_add_(
            0, s, lam * us - delta[:, None] * it_)
        gi = torch.zeros_like(ilv).index_add_(
            0, d, lam * it_ - delta[:, None] * us)
        return ulv - step * gu, ilv - step * gi, torch.sqrt(sqerr / nnz)

    return sgd_step, data


def make_sgd_epoch(src, dst, ratings, lam, step, num_users, num_items,
                   batches: int, seed: int = 17, *, device="cuda"):
    """(epoch, data): epoch(u, i, data) -> (u', i', rmse), one mini-batched
    epoch over the static shuffle (gardenia_tpu/solvers/sgd.py:134-159),
    and its batched edge tensors on `device`.  epoch updates u and i in
    place and returns them."""
    dev = resolve_device(device)
    src, dst = np.asarray(src), np.asarray(dst)
    ratings = np.asarray(ratings, np.float32)
    nnz = int(ratings.shape[0])
    per = -(-nnz // batches)
    rng = np.random.default_rng(seed)
    order = rng.permutation(nnz).astype(np.int32)
    pad = batches * per - nnz
    order = np.concatenate([order, np.zeros(pad, np.int32)])
    valid = np.concatenate([np.ones(nnz, np.float32),
                            np.zeros(pad, np.float32)])
    src_b = src[order].reshape(batches, per)
    dst_b = dst[order].reshape(batches, per)
    v_b = valid.reshape(batches, per)
    # the batches are static, so each edge's inverse count of its
    # vertex's edges in the batch is fixed (small integers: the counts
    # are exact in f32, as the JAX solver's np.add.at sums are)
    nu_b = np.empty((batches, per), np.float32)
    ni_b = np.empty((batches, per), np.float32)
    for b in range(batches):
        cu = np.bincount(src_b[b], v_b[b], num_users).astype(np.float32)
        ci = np.bincount(dst_b[b], v_b[b], num_items).astype(np.float32)
        nu_b[b] = 1.0 / np.maximum(cu[src_b[b]], 1.0)
        ni_b[b] = 1.0 / np.maximum(ci[dst_b[b]], 1.0)
    data = tuple(torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in (
        src_b.astype(np.int64), dst_b.astype(np.int64),
        ratings[order].reshape(batches, per), v_b, nu_b, ni_b))

    def epoch(ulv, ilv, data_):
        sq = torch.zeros((), dtype=torch.float32, device=ulv.device)
        for b in range(batches):
            s, d, r, v, nu, ni = (a[b] for a in data_)
            us, it_ = ulv[s], ilv[d]                       # (per, K)
            delta = (r - (us * it_).sum(1)) * v
            sq += (delta * delta).sum()
            ulv.index_add_(0, s, it_ * (delta * nu)[:, None], alpha=step)
            ilv.index_add_(0, d, us * (delta * ni)[:, None], alpha=step)
        # the regularisation, once an epoch (the reference: once an
        # iteration over all vertices)
        ulv -= (step * lam) * ulv
        ilv -= (step * lam) * ilv
        return ulv, ilv, torch.sqrt(sq / nnz)

    return epoch, data


def num_items(g) -> int:
    """Item count: the graph's columns, or past its largest column id."""
    return max(g.n, int(g.colidx.max()) + 1 if g.nnz else 1)


def _edges(g):
    """(src, dst, ratings f32) of the rating graph, on the host."""
    src = np.repeat(np.arange(g.m, dtype=np.int32), np.diff(g.rowptr))
    ratings = (g.weights if g.weights is not None else np.ones(g.nnz))
    return src, np.asarray(g.colidx), np.asarray(ratings, np.float32)


def sgd_solver(g, lam: float = DEFAULT_LAMBDA, step: float = DEFAULT_STEP,
               max_iters: int = DEFAULT_MAX_ITERS,
               epsilon: float = DEFAULT_EPSILON, seed: int = 0,
               batches: int = None, init=None, *,
               device="cuda") -> SGDResult:
    """Reference entry SGDSolver(m, n, nnz, row_offsets, column_indices,
    rating, user_lv, item_lv, ordering) (src/sgd/sgd.h:31).

    batches: mini-batches an epoch (None: one a 64K edges, at most 64;
    0: the exact full-gradient step).  Epochs run while it < max_iters
    and the last RMSE >= epsilon.  init: optional (user_lv, item_lv)
    starting tables ((m, K) and (n, K) f32, numpy or tensors; they are
    copied, never updated), so that a benchmark hoists their making out
    of its timed region; default init_latent(m, seed), (n, seed + 1)."""
    dev = resolve_device(device)
    m, n = g.m, num_items(g)
    if batches is None:
        batches = min(64, g.nnz // 65536)

    def build():
        src, dst, ratings = _edges(g)
        if batches:
            return make_sgd_epoch(src, dst, ratings, lam, step, m, n,
                                  batches, device=dev)
        return make_sgd_step(src, dst, ratings, lam, step, m, n,
                             device=dev)

    sgd_step, data = g._dev(("torch", "sgd_run", str(dev), lam, step,
                             batches), build)
    if init is None:
        init = (init_latent(m, seed), init_latent(n, seed + 1))
    ulv, ilv = (torch.as_tensor(a).to(dev, torch.float32).clone()
                for a in init)
    hist = torch.full((max_iters,), float("inf"), dtype=torch.float32,
                      device=dev)
    it, last = 0, float("inf")
    while it < max_iters and last >= epsilon:
        ulv, ilv, rmse = sgd_step(ulv, ilv, data)
        hist[it] = rmse
        it += 1
        if epsilon > 0:          # the stop rule reads; epsilon 0 never stops
            last = float(rmse)
    return SGDResult(ulv, ilv, hist, it)


def sgd_train_checkpointed(g, checkpointer, total_iters: int,
                           checkpoint_every: int = 1,
                           lam: float = DEFAULT_LAMBDA,
                           step: float = DEFAULT_STEP, seed: int = 0, *,
                           device="cuda") -> SGDResult:
    """Restartable full-gradient training: resumes from the
    checkpointer's last saved (user_lv, item_lv) and epoch, and saves
    every `checkpoint_every` epochs and after the last
    (utils/checkpoint.py; the reference has no app-level checkpointing)."""
    dev = resolve_device(device)
    m, n = g.m, num_items(g)
    sgd_step, data = g._dev(
        ("torch", "sgd_step", str(dev), lam, step),
        lambda: make_sgd_step(*_edges(g), lam, step, m, n, device=dev))
    template = (init_latent(m, seed), init_latent(n, seed + 1))
    restored = checkpointer.restore(like=template)
    start = 0
    if restored is not None:
        template, start = restored
    ulv, ilv = (torch.from_numpy(np.asarray(a, np.float32)).to(dev)
                for a in template)
    hist = torch.full((max(total_iters, 1),), float("inf"),
                      dtype=torch.float32, device=dev)
    for it in range(start, total_iters):
        ulv, ilv, rmse = sgd_step(ulv, ilv, data)
        hist[it] = rmse
        if (it + 1) % checkpoint_every == 0 or it + 1 == total_iters:
            checkpointer.save((ulv, ilv), step=it + 1)
    return SGDResult(ulv, ilv, hist, total_iters)
