"""Solvers of the port, one module per GARDENIA kernel: pr, tc, cc, bfs,
bc, spmv, sssp and sssp_nf, mst, scc, clustering, sampling, vc, symgs and
sgd."""
