"""Run statistics reporting — the port's copy of
gardenia_tpu/utils/statistics.py (reference include/statistics.h is an
empty reportStat stub; here it reports): degree distribution summary,
solver counters, and an environment check (include/env_check.h analog)
that names torch, CUDA and the cards in place of jax.devices()."""

from __future__ import annotations

import os
from typing import Dict

import torch


def graph_stats(g) -> Dict:
    deg = g.degrees
    return {
        "num_vertices": int(g.m),
        "num_edges": int(g.nnz),
        "min_degree": int(deg.min()) if g.m else 0,
        "max_degree": int(deg.max()) if g.m else 0,
        "avg_degree": float(deg.mean()) if g.m else 0.0,
        "degree_variance": float(deg.var()) if g.m else 0.0,
        "symmetric": bool(g.symmetric),
        "weighted": g.weights is not None,
    }


def report_stats(stats: Dict, prefix: str = "") -> None:
    for k, v in stats.items():
        print(f"{prefix}{k} = {v}")


def env_check() -> Dict:
    """Environment report: torch and its CUDA, the cards and their names
    (none on a CPU-only build), and the host's cores."""
    count = torch.cuda.device_count()
    return {
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "device_count": count,
        "devices": [torch.cuda.get_device_name(i) for i in range(count)],
        "omp_threads_analog": os.cpu_count(),
    }
