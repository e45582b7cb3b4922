"""Multi-device solvers of the port on torch.distributed (one process a
rank): the 1D and 2D meshes, the partitions, and every solver of
gardenia_tpu.parallel — PR, BFS, data-parallel multi-source BFS, TC, VC,
SCC (the CLI's `--dist=`), SSSP, CC, BC, SpMV, SymGS, MST, SGD, and the
2D mesh's TC, SCC and VC."""

from gardenia_tpu_torch.parallel.bc import bc_batched_dist
from gardenia_tpu_torch.parallel.bfs import (bfs_multi_source_dist,
                                             bfs_solver_dist)
from gardenia_tpu_torch.parallel.cc import cc_solver_dist
from gardenia_tpu_torch.parallel.color import scc_solver_dist, vc_solver_dist
from gardenia_tpu_torch.parallel.mesh import (Mesh, Mesh2D, call_each,
                                              describe, make_mesh,
                                              make_mesh2d, run_on_ranks,
                                              time_each)
from gardenia_tpu_torch.parallel.mst import mst_solver_dist
from gardenia_tpu_torch.parallel.partition import (Partition1D, ShardedEll,
                                                   partition_ell_1d)
from gardenia_tpu_torch.parallel.pr import pr_solver_dist
from gardenia_tpu_torch.parallel.sgd import (make_dist_sgd_step,
                                             sgd_train_dist)
from gardenia_tpu_torch.parallel.spmv import spmv_solver_dist
from gardenia_tpu_torch.parallel.sssp import sssp_solver_dist
from gardenia_tpu_torch.parallel.symgs import symgs_solver_dist
from gardenia_tpu_torch.parallel.tc import tc_solver_dist
from gardenia_tpu_torch.parallel.two_d import (partition_edges_2d,
                                               scc_solver_dist2d,
                                               tc_solver_dist2d,
                                               vc_solver_dist2d)

__all__ = ["ShardedEll", "partition_ell_1d", "make_mesh",
           "pr_solver_dist", "bfs_solver_dist",
           "bfs_multi_source_dist", "tc_solver_dist",
           "sgd_train_dist", "make_dist_sgd_step", "vc_solver_dist",
           "scc_solver_dist", "sssp_solver_dist", "cc_solver_dist",
           "bc_batched_dist", "spmv_solver_dist", "symgs_solver_dist",
           "mst_solver_dist",
           # the port's own: the process groups and the 2D mesh
           "Mesh", "Mesh2D", "make_mesh2d", "run_on_ranks", "call_each",
           "time_each", "describe", "Partition1D", "partition_edges_2d",
           "tc_solver_dist2d", "scc_solver_dist2d", "vc_solver_dist2d"]
