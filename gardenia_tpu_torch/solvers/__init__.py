"""Solvers of the port, one module per GARDENIA kernel: pr, tc, cc, bfs,
bc, spmv, sssp and sssp_nf, mst, scc, clustering, sampling, vc, symgs and
sgd."""

from gardenia_tpu_torch.solvers.spmv import spmv_solver
from gardenia_tpu_torch.solvers.pr import pr_solver
from gardenia_tpu_torch.solvers.bfs import bfs_solver
from gardenia_tpu_torch.solvers.sssp import sssp_solver
from gardenia_tpu_torch.solvers.cc import cc_solver
from gardenia_tpu_torch.solvers.vc import vc_solver
from gardenia_tpu_torch.solvers.bc import bc_solver
from gardenia_tpu_torch.solvers.tc import tc_solver
from gardenia_tpu_torch.solvers.scc import scc_solver
from gardenia_tpu_torch.solvers.mst import mst_solver
from gardenia_tpu_torch.solvers.symgs import symgs_solver
from gardenia_tpu_torch.solvers.sgd import sgd_solver

__all__ = ["spmv_solver", "pr_solver", "bfs_solver", "sssp_solver",
           "cc_solver", "vc_solver", "bc_solver", "tc_solver",
           "scc_solver", "mst_solver", "symgs_solver", "sgd_solver"]
