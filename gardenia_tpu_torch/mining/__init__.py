"""Graph mining (reference L6: mining/{kcl_*,motif_*,sgl,fsm}): k-clique
counting (kcl, with kernel Q1 in ops/kcl_count), the motif census (motif,
over the wedge streams of wedgestream), subgraph listing (sgl, over the
pattern engine of pattern) and frequent-subgraph mining (fsm: the label
aggregate of fsm_agg for k <= 2, gSpan in gspan beyond, with dfscode's
canonical forms)."""

from gardenia_tpu_torch.mining.kcl import kcl_solver
from gardenia_tpu_torch.mining.motif import motif_solver
from gardenia_tpu_torch.mining.sgl import sgl_solver
from gardenia_tpu_torch.mining.fsm import fsm_solver

__all__ = ["kcl_solver", "motif_solver", "sgl_solver", "fsm_solver"]
