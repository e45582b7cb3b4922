"""gardenia_tpu_torch — the PyTorch/CUDA port of gardenia_tpu (NVIDIA Hopper).

The JAX package `gardenia_tpu` stays the reference.  This package imports
torch and never jax: host code that is jax-free (`gardenia_tpu.core`,
`gardenia_tpu.native`, `gardenia_tpu.verify`) is imported from the
reference, and everything that touches a device is written here in
PyTorch, with hand-written CUDA kernels under `csrc/` where the reference
had a Pallas kernel.

Slice 1 is pull PageRank on the degree-relabelled hybrid layout:
  core/views -> ops/bsr.spmv_hybrid (ops/panel K1 + ops/spmv.spmv_ell)
  -> solvers/pr.pr_solver -> cli / bench.
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
