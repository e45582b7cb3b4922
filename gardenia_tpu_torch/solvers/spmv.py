"""SpMV — y += A x over the graph's CSR; torch counterpart of
gardenia_tpu/solvers/spmv.py (reference src/spmv/{spmv.h,omp_base.cc,
warp.cu,vector.cu}).

Variants:
  'ell'     — degree-bucketed ELL slabs holding the edge values
              (ops/spmv.spmv_ell).
  'hybrid'  — the degree-relabelled hybrid block-sparse layout
              (ops/bsr.spmv_hybrid): dense 128x128 panels through kernel
              K1 at S = 1 plus an ELL remainder.  x and y keep the
              original ids: x is permuted in with old_of_new, y out with
              new_of_old.
  'auto'    — hybrid on a CUDA device, ell on the CPU (the reference's
              rule: hybrid on the accelerator).
  'segment' — COO scatter-add, the forward product (ops/spmv.
              spmv_segment).
  'push_pb' — propagation-blocking push (ops/spmv.make_push_pb): the
              TRANSPOSE product y[i] += sum_j A[j, i] x[j]; callers that
              want the forward product pass the transposed graph, as the
              reference's pb variants use the reverse edge list.

Each variant's matrix is built once per graph and edge-value array and
cached with the array (Graph._dev's retain=), so later calls with the
same array reuse it.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from gardenia_tpu_torch import resolve_device

VARIANTS = ("ell", "hybrid", "auto", "segment", "push_pb")
# threshold of a hybrid layout built from edge values (always, once the
# default 0.2 fill is applied): gardenia_tpu/solvers/spmv.py:66-68
WEIGHTED_DENSE_THRESHOLD = 64


@dataclasses.dataclass
class HybridRun:
    """The hybrid variant's cached state for one edge-value array."""
    hyb: object                    # ops/bsr.HybridMatrix of the relabelled g
    new_of_old: torch.Tensor       # i64[m]
    old_of_new: torch.Tensor       # i64[m]


def hybrid_layout(g, Ax, device) -> HybridRun:
    """The relabelled threshold-64 hybrid layout of A = (g's structure,
    edge values Ax in g's CSR order), cached per id(Ax).  Uniform values
    factor into int8 count panels times `scale`; others take int8, bf16
    or f32 panels by build_hybrid's value guard."""
    from gardenia_tpu_torch.core import build, views
    from gardenia_tpu_torch.ops.bsr import build_hybrid

    def mk():
        g2, new_of_old, old_of_new = views.relabel_maps(g, device)
        # the values arrive in g's CSR edge order; g2's CSR orders its
        # edges by (new src, new dst)
        new = new_of_old.cpu().numpy()
        src, dst = build.csr_to_coo(g.rowptr, g.colidx)
        order = np.lexsort((new[dst], new[src]))
        w2 = np.asarray(Ax, np.float32)[order]
        hyb = build_hybrid(g2.rowptr, g2.colidx, w2, num_cols=g2.n,
                           dense_threshold=WEIGHTED_DENSE_THRESHOLD)
        return HybridRun(hyb.to(device), new_of_old, old_of_new)
    return g._dev(("torch", "spmv_hybrid", str(device), id(Ax)), mk,
                  retain=Ax)


def _f32(a, dev) -> torch.Tensor:
    """a (a numpy array or a tensor) as an f32 tensor on dev."""
    if isinstance(a, torch.Tensor):
        return a.to(device=dev, dtype=torch.float32)
    return torch.from_numpy(np.asarray(a, np.float32)).to(dev)


def spmv_solver(g, Ax=None, x=None, y=None, *, variant: str = "ell",
                device="cuda") -> torch.Tensor:
    """y + A x as an f32 tensor on `device`.

    Ax: edge values in g's CSR order (default: the graph's weights, else
    the reference's synthetic 0.2, src/spmv/main.cc:28-37); x
    defaults to 0.3 everywhere, y to zero."""
    from gardenia_tpu_torch.core import views
    from gardenia_tpu_torch.ops.semiring import F32_PLUS_TIMES
    from gardenia_tpu_torch.ops.spmv import (make_push_pb, spmv_ell,
                                             spmv_segment)
    dev = resolve_device(device)
    if variant not in VARIANTS:
        raise ValueError(f"unknown SpMV variant {variant!r} "
                         f"({', '.join(VARIANTS)})")
    if Ax is None:      # one default array a graph, so its matrix is reused
        Ax = g._dev(("spmv_default_values",), lambda: (
            np.full(g.nnz, 0.2, np.float32) if g.weights is None
            else np.asarray(g.weights, np.float32)))
    x = _f32(np.full(g.n, 0.3, np.float32) if x is None else x, dev)
    y = (torch.zeros(g.m, dtype=torch.float32, device=dev) if y is None
         else _f32(y, dev))
    if variant == "auto":
        variant = "hybrid" if dev.type == "cuda" else "ell"

    if variant == "hybrid":
        from gardenia_tpu_torch.ops.bsr import spmv_hybrid
        run = hybrid_layout(g, Ax, dev)
        y2 = spmv_hybrid(run.hyb, x[run.old_of_new], num_rows=g.m)
        return y2[run.new_of_old] + y
    if variant == "push_pb":
        push = g._dev(("torch", "spmv_push_pb", str(dev), id(Ax)),
                      lambda: make_push_pb(g, Ax, device=dev), retain=Ax)
        return push(x) + y
    if variant == "segment":
        def vals():
            return torch.from_numpy(np.asarray(Ax, np.float32)).to(dev)
        w = g._dev(("torch", "spmv_segment_vals", str(dev), id(Ax)), vals,
                   retain=Ax)
        src, dst = views.coo(g, dev)
        return spmv_segment(src, dst, w, x, semiring=F32_PLUS_TIMES,
                            num_rows=g.m, init=y)

    def ell():
        from gardenia_tpu_torch.ops.ell import build_ell
        return build_ell(g.rowptr, g.colidx, np.asarray(Ax, np.float32),
                         num_cols=g.n).to(dev)
    mat = g._dev(("torch", "spmv_ell", str(dev), id(Ax)), ell, retain=Ax)
    return spmv_ell(mat, x, semiring=F32_PLUS_TIMES, num_rows=g.m, init=y)
