"""Error metrics for solver verification — ports of the reference's
tolerance models (src/spmv/spmv_util.h:16-53)."""

from __future__ import annotations

import numpy as np


def maximum_relative_error(a, b, eps: float = None) -> float:
    """max_i |a-b| / (|a|+|b|+eps) — spmv_util.h:16-30."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    if eps is None:
        eps = float(np.sqrt(np.finfo(np.float32).eps))
    err = np.abs(a - b)
    denom = np.abs(a) + np.abs(b) + eps
    rel = np.where(err != 0, err / denom, 0.0)
    return float(rel.max()) if rel.size else 0.0


def l2_error(a, b) -> float:
    """sum (a-b)^2 / sum b^2 — spmv_util.h:45-53."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    denom = float((b * b).sum())
    return float(((a - b) ** 2).sum()) / denom if denom else 0.0


def check(ok: bool, label: str = "") -> bool:
    """Print the reference's Correct/Wrong contract (src/*/verifier.cc)."""
    print("Correct" if ok else f"Wrong {label}".rstrip())
    return ok
