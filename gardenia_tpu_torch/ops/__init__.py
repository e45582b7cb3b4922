"""Device operators of the port: semirings, ELL SpMV, the hybrid layout
and its dense-panel kernel (K1, csrc/dense_panel_matmul.cu), and triangle
counting's per-pair counts (K3, K4, H1, csrc/tc_*.cu) and membership
counts."""

from gardenia_tpu_torch.ops.semiring import (
    Semiring, F32_PLUS_TIMES, F32_MIN_PLUS, I32_MIN_PLUS, I32_PLUS_TIMES,
    I32_MIN_SELECT2,
)
from gardenia_tpu_torch.ops.ell import EllMatrix, EllBucket, build_ell
from gardenia_tpu_torch.ops.spmv import spmv_ell, spmv_segment

__all__ = [
    "Semiring", "F32_PLUS_TIMES", "F32_MIN_PLUS", "I32_MIN_PLUS",
    "I32_PLUS_TIMES", "I32_MIN_SELECT2",
    "EllMatrix", "EllBucket", "build_ell", "spmv_ell", "spmv_segment",
]
