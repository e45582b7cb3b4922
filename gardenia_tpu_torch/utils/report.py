"""Benchmark reporting contract — the same print format as
gardenia_tpu/utils/report.py (the reference's printf lines, e.g.
'runtime [omp_base] = 1.23 ms').  A copy: the port imports nothing of
gardenia_tpu."""

from __future__ import annotations


def report_runtime(variant: str, seconds: float, *, gflops: float = None,
                   gbytes: float = None) -> str:
    ms = seconds * 1e3
    if gflops is not None or gbytes is not None:
        line = (f"\truntime [{variant}] = {ms:.4f} ms ( "
                f"{gflops or 0:5.2f} GFLOP/s {gbytes or 0:5.1f} GB/s)")
    else:
        line = f"\truntime [{variant}] = {ms:f} ms."
    print(line)
    return line


def gteps(num_edges: int, seconds: float, iters: int = 1) -> float:
    """Giga traversed-edges-per-second."""
    if seconds <= 0:
        return 0.0
    return num_edges * iters / seconds / 1e9


def spmv_bytes(m: int, nnz: int, idx_size: int = 4, val_size: int = 4) -> int:
    """Analytic byte model (reference src/spmv/spmv_util.h:6-14)."""
    return (2 * idx_size * m + idx_size * nnz
            + 2 * val_size * nnz + 2 * val_size * m)
