"""The sparse relax of SSSP's bucket rounds (kernel F1) — counterpart of
the `sparse` branch of gardenia_tpu/solvers/sssp.py:77-84, which is XLA
and has no Pallas kernel behind it.

    new = sparse_relax(dist, active, n_active, scout, rowptr, colidx, w,
                       deg)

new[v] = min(dist[v], min over the out-edges (u -> v, w) of every active
u of dist[u] + w), with dist as it stood before the round (Jacobi), int32
throughout.  n_active is the number of active vertices and scout their
out-degree sum, both already read by the caller's round; a round with
scout 0 returns dist itself.

`sparse_relax` launches F1 (csrc/frontier_relax.cu) on CUDA tensors, or
raises: three launches (tile totals with the copy of dist, the compaction
with the degrees' prefix, the relax balanced by edge slots), nothing read
back.  On CPU tensors, and only there, it takes `sparse_relax_plain`,
the route the port took before F1: `ops/frontier.compact_mask`,
`expand_frontier_edges`, the candidate gathers and a scatter-min (about
forty launches on a card, a torch.cummax over the edge slots among them).
A min of integers is the same in any order, so the two agree bit for bit.
LAUNCHES counts F1's calls (three kernels each), never the plain
version's, so a run can show that its sparse rounds went through F1.
"""

from __future__ import annotations

import torch

from gardenia_tpu_torch.ops.frontier import (compact_mask,
                                             expand_frontier_edges)

LAUNCHES = 0
F1_THREADS = 256        # threads a CTA of F1's relax (THREADS in the .cu)
F1_SLOTS = 8            # edge slots a thread of it (SLOTS)
F1_CHUNK = F1_THREADS * F1_SLOTS      # edge slots a CTA


def sparse_relax_plain(dist, active, n_active: int, scout: int, rowptr,
                       colidx, w, deg) -> torch.Tensor:
    """sparse_relax in torch ops, on any device: the active ids compacted,
    their out-edges expanded in CSR order, the candidates scatter-min'd
    into dist.  deg is not read (the expansion takes rowptr's)."""
    if scout == 0:
        return dist
    ids = compact_mask(active, n_active, dist.shape[0])
    src, dst, _, eid = expand_frontier_edges(rowptr, colidx, ids, scout)
    nd = dist[src.long()] + w[eid]
    return dist.scatter_reduce(0, dst.long(), nd, "amin")


def _check(dist, active, rowptr, colidx, w, deg) -> None:
    want = (("dist", dist, torch.int32), ("active", active, torch.bool),
            ("rowptr", rowptr, torch.int64), ("colidx", colidx, torch.int32),
            ("w", w, torch.int32), ("deg", deg, torch.int32))
    for name, t, dtype in want:
        if t.dtype != dtype or t.dim() != 1 or not t.is_contiguous():
            raise ValueError(f"F1 takes {name} as a contiguous 1-D {dtype} "
                             f"tensor; got {t.dtype} {tuple(t.shape)}")
    m = dist.shape[0]
    if active.shape[0] != m or deg.shape[0] != m \
            or rowptr.shape[0] != m + 1 or w.shape != colidx.shape:
        raise ValueError(f"F1 takes active and deg of dist's {m} entries, "
                         f"rowptr of {m + 1} and w of colidx's shape; got "
                         f"active {tuple(active.shape)}, deg "
                         f"{tuple(deg.shape)}, rowptr {tuple(rowptr.shape)}, "
                         f"colidx {tuple(colidx.shape)}, w {tuple(w.shape)}")
    devs = {t.device for _, t, _ in want}
    if len(devs) != 1:
        raise ValueError(f"F1's tensors lie on different devices: {devs}")
    if m >= 2 ** 31:
        raise ValueError(f"F1 takes fewer than 2^31 vertices; got {m}")


def takes_f1(device: torch.device) -> bool:
    """Whether sparse_relax launches F1: on a CUDA device; CPU tensors take
    the plain version, and any other device raises."""
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {device}")
    return device.type == "cuda"


def sparse_relax(dist, active, n_active: int, scout: int, rowptr, colidx, w,
                 deg) -> torch.Tensor:
    """int32[m]: dist relaxed over the out-edges of the active vertices,
    a new tensor (dist itself when scout is 0).

    dist int32[m]; active bool[m]; n_active, scout: the active vertices'
    count and out-degree sum; rowptr int64[m + 1], colidx int32[nnz] and
    w int32[nnz] the CSR and its weights; deg int32[m] the out-degrees.
    """
    global LAUNCHES
    if not takes_f1(dist.device):
        return sparse_relax_plain(dist, active, n_active, scout, rowptr,
                                  colidx, w, deg)
    _check(dist, active, rowptr, colidx, w, deg)
    if scout == 0:
        return dist
    new = _f1(dist, active, scout, rowptr, colidx, w, deg)
    LAUNCHES += 1
    return new


def _f1(dist, active, scout: int, rowptr, colidx, w, deg) -> torch.Tensor:
    """F1's three launches on dist's stream into a new tensor, with its
    scratch (the tile totals, the compacted ids and offsets) from the
    caching allocator."""
    from gardenia_tpu_torch.ops import _build

    so = _build.lib()
    m = dist.shape[0]
    new = torch.empty_like(dist)
    scratch = torch.empty(so.gdn_frontier_relax_scratch(m),
                          dtype=torch.uint8, device=dist.device)
    with torch.cuda.device(dist.device):
        code = so.gdn_frontier_relax(
            active.data_ptr(), deg.data_ptr(), rowptr.data_ptr(),
            colidx.data_ptr(), w.data_ptr(), dist.data_ptr(), new.data_ptr(),
            m, scout, scratch.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    _build.check(code, "sparse_relax (F1)")
    return new
