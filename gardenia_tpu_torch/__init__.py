"""gardenia_tpu_torch — the PyTorch/CUDA port of gardenia_tpu (NVIDIA Hopper).

The JAX package `gardenia_tpu` stays the reference.  This package imports
torch, never jax, and nothing of `gardenia_tpu`: the reference's host code
(`core`, `native`, `verify`) has its copies here under the same module
names, and everything that touches a device is written here in PyTorch,
with hand-written CUDA kernels under `csrc/` where the reference had a
Pallas kernel.

Slice 1 is pull PageRank on the degree-relabelled hybrid layout:
  core/views -> ops/bsr.spmv_hybrid (ops/panel K1 + ops/spmv.spmv_ell)
  -> solvers/pr.pr_solver -> cli / bench.
Slice 2 is triangle counting:
  solvers/tc host prep (numpy) -> ops/tc_count (H1 bitmap, K3 search
  count, K4 hash count) -> solvers/tc.tc_solver -> cli / bench; the
  bsearch variant runs ops/intersect in plain torch.
Slice 3 is connected components:
  core/views (relabel maps, hybrid/ELL, CSR) -> solvers/cc.cc_sv (ops/
  pointer_jump, ops/frontier sparse rounds; dense rounds through
  ops/bsr.spmv_hybrid_min_select = ops/minselect K2 + the ELL min-select)
  and cc_afforest -> cli / bench.
Slice 6 is BFS, multi-source BFS and Brandes BC (and PR's push and delta):
  solvers/bfs (pull, do, do_fused over ops/frontier and the count sweep
  ops/bsr.spmv_hybrid; bfs_multi_source) and solvers/bc (bc_batched,
  bc_solver) -> ops/bsr.spmv_hybrid_batched (ops/panel K1 on tensor cores
  for S > 8 + a row gather and segment sum, ops/spmv.spmv_batched)
  -> cli / bench.
Then SpMV, SSSP, MST, SCC, clustering and random walks:
  solvers/spmv (ell, hybrid = the threshold-64 relabelled layout through
  ops/bsr.spmv_hybrid and K1 at S = 1, segment, push_pb = ops/spmv.
  make_push_pb), solvers/sssp and sssp_nf (host-driven rounds over
  ops/frontier and the weighted in-ELL's min-plus spmv_ell), solvers/
  mst, scc, clustering, sampling (scatter_reduce_ hooks and closures,
  ops/pointer_jump) -> cli / bench.
Slice 9 is vertex colouring, SymGS and SGD:
  solvers/vc (host-chosen dense, sparse (ops/frontier) and core rounds;
  the core pass's sequential first-fit is kernel V1, ops/vc_core) ->
  solvers/symgs (colour-ordered CSR, a segment sum a block) and
  solvers/sgd (mini-batched epochs by index_add_, the full-gradient step,
  utils/checkpoint) -> cli / bench.
"""

from __future__ import annotations

import torch

__version__ = "0.1.0"


def resolve_device(name="cuda") -> torch.device:
    """torch.device for `name`.  A CUDA device must exist: nothing falls
    back to the CPU on its own — the CPU is used only when asked for."""
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {name!r} requested but torch.cuda.is_available() is "
            f"False (torch {torch.__version__}, CUDA {torch.version.cuda})")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {name!r}")
    return dev


__all__ = ["resolve_device", "__version__"]
