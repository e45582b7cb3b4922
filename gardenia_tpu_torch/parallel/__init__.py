"""Multi-device solvers of the port on torch.distributed (one process a
rank): the mesh, the 1D partitions, and the solvers that the CLI's
`--dist=` runs — PR, BFS, data-parallel multi-source BFS, TC, VC, SCC."""

from gardenia_tpu_torch.parallel.bfs import (bfs_multi_source_dist,
                                             bfs_solver_dist)
from gardenia_tpu_torch.parallel.color import scc_solver_dist, vc_solver_dist
from gardenia_tpu_torch.parallel.mesh import (Mesh, call_each, describe,
                                              make_mesh, run_on_ranks,
                                              time_each)
from gardenia_tpu_torch.parallel.partition import (Partition1D, ShardedEll,
                                                   partition_ell_1d)
from gardenia_tpu_torch.parallel.pr import pr_solver_dist
from gardenia_tpu_torch.parallel.tc import tc_solver_dist

__all__ = ["Mesh", "make_mesh", "run_on_ranks", "call_each", "time_each",
           "describe", "ShardedEll",
           "Partition1D", "partition_ell_1d", "pr_solver_dist",
           "bfs_solver_dist", "bfs_multi_source_dist", "tc_solver_dist",
           "vc_solver_dist", "scc_solver_dist"]
