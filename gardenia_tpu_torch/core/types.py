"""Core scalar types and tuning constants.

TPU-native counterpart of the reference's typedef block
(reference include/common.h:29-82).  All device arrays are 32-bit:
XLA TPU vector units are 32-bit-lane machines and 64-bit integer arithmetic
is emulated, so edge offsets are int32 on device (graphs with >= 2^31 edges
keep int64 offsets on the host and must be sharded before upload).
"""

from __future__ import annotations

import numpy as np

# --- scalar dtypes (reference common.h:29-62) --------------------------------
VID_DTYPE = np.int32     # vidType / VertexId
EID_DTYPE = np.int64     # eidType (host); device rowptr uses int32
EID_DEVICE_DTYPE = np.int32
SCORE_DTYPE = np.float32  # ScoreT
VALUE_DTYPE = np.float32  # ValueT
LATENT_DTYPE = np.float32  # LatentT
DIST_DTYPE = np.int32    # DistT
COMP_DTYPE = np.int32    # CompT
WEIGHT_DTYPE = np.int32  # WeightT (integral edge weights from .gr/.el/.mtx)
VLABEL_DTYPE = np.uint8  # vlabel_t
ELABEL_DTYPE = np.uint8  # elabel_t

# --- algorithm constants (reference common.h:64-82) --------------------------
MYINFINITY = 1_000_000_000  # "infinity" distance (common.h:66)
MAXCOLOR = 128              # max colors for VC (common.h:65)

# --- TPU layout constants ----------------------------------------------------
LANES = 128      # VPU lane count: minor-most dim of every 2D tile
SUBLANES = 8     # float32 sublane count
# Default cap on ELL slab width: rows with degree > ELL_WIDTH_CAP are split
# into multiple virtual rows (the TPU analog of the reference's CSR-vector /
# warp-per-row mapping, src/spmv/vector.cu:26-62).
ELL_WIDTH_CAP = 256
# Narrowest slab width; narrower rows are padded up to this.  Width
# buckets are exact up to ELL_EXACT_WIDTH and power-of-two beyond — on
# power-law tails (degree-1/2/3 rows dominate) exact narrow buckets cut
# slab padding from ~1.5x to ~1.1x, and every slot costs a real gather.
ELL_MIN_WIDTH = 1
ELL_EXACT_WIDTH = 8


def next_pow2(x: int) -> int:
    """Smallest power of two >= x (>= 1)."""
    if x <= 1:
        return 1
    return 1 << (int(x) - 1).bit_length()


def round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m
