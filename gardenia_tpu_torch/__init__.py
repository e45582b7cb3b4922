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
