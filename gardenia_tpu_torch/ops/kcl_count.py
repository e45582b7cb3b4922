"""Per-vertex k-clique counts in each vertex's local bitmap graph (kernel
Q1) — counterpart of the XLA expansion, mask and rotation passes of
gardenia_tpu/mining/kcl.py:175-790, which have no Pallas kernel behind
them.

    ldag = prepare(rowptr, colidx)      # the oriented DAG on the device
    cnt = local_count(ldag, k)          # int64[m]

cnt[u] is the number of k-cliques whose first vertex in DAG order is u.
Q1 (csrc/kcl_local_count.cu) stages N+(u) in shared memory, builds the
local graph A over it (bit j of row i set iff N+(u)[j] is in
N+(N+(u)[i])) by streaming each neighbour's row, and counts k-2 levels of
ANDs and popcounts over A.  What bounds it is the stream and its
membership tests (about the sum over arcs of the target's out-degree:
4.35 G at R-MAT-20) and the count's word ANDs.  Q1's first form (commit
7384147) spent up to
ten shared-memory search steps a test, walked candidate sets by ballot
with most lanes idle, and launched each degree class apart sized to the
class's power of two.  This one:
  - tests an id by one read of a filter (2^FILTER_SHIFT = 128 bits a
    slot of a hash table of positions, P >= 2d slots: `hash_bits`,
    `hash_slot`, `filter_bit`), probing the table only for the hits and
    the <= ~1/256 of misses that pass;
  - counts k = 4 with G = `group_lanes(W)` lanes a root for rows of up to
    8 words, and on the tensor cores above (single-bit AND-popcount
    products of A by its transpose, the upper triangle only);
  - launches at most three runs of `ldag.order` (descending out-degree:
    the widest first), `launch_plan`: the hubs (d > HUB_DEGREE) and the
    rest of the CTA shape (d > WARP_DEGREE), each a persistent grid whose
    CTAs take vertices from a counter, its shared memory sized to its own
    widest vertex (`shared_bytes`); then a warp a vertex (k - 1 <= d <=
    WARP_DEGREE: one or two words a row).
Vertices with d < k - 1 are skipped at set-up.

On CUDA tensors `local_count` launches Q1 or raises (k outside
[MIN_K, MAX_K] or an out-degree above MAX_DEGREE: `route` sends those
to the expansion before any launch).  On CPU tensors, and only there, it
takes `local_count_plain`, the level expansion of mining/kcl.py.
LAUNCHES counts Q1's launches (one a run of the plan), never the plain
version's.  The limits are constants of the .cu; `kernel_limits()`
reads them from the built library, and every launch checks that they
equal the copies here, which the CPU (no library) needs to choose a
route.  `hash_bits`, `hash_slot`, `group_lanes` and `shared_bytes` copy
the kernel's sizes for the tests and for the card's edge cases; the
library exports its own (`kernel_sizes`), and `cta_info` the CTA shape's
registers and CTAs an SM.
"""

from __future__ import annotations

import bisect
from typing import NamedTuple

import numpy as np
import torch

MIN_K, MAX_K = 3, 8
WARP_DEGREE = 64          # d <= this: a warp a vertex (one or two words a row)
MAX_DEGREE = 1024         # d <= this: a CTA a vertex, W <= 32 words a row
# the CTA shape's vertices above this out-degree (the hubs) launch apart:
# each run's shared memory is sized to its own widest vertex, so the rest
# fit more CTAs an SM (scripts/probe_q1.py --cut)
HUB_DEGREE = 512
HASH_MUL = 2654435769     # the table's multiplicative hash, as in the .cu
FILTER_MUL = 2246822519   # the filter's
FILTER_SHIFT = 7          # filter bits = 2^FILTER_SHIFT x table slots

LAUNCHES = 0


class LocalDag(NamedTuple):
    rowptr: torch.Tensor      # int64[m+1]
    colidx: torch.Tensor      # int32[nnz], each row strictly ascending
    order: torch.Tensor       # int32[m]: by descending out-degree, then id
    degrees: np.ndarray       # int64[m]: their out-degrees, on the host
    max_degree: int


def prepare(rowptr: torch.Tensor, colidx: torch.Tensor) -> LocalDag:
    """The DAG's CSR, checked (int64 rowptr, int32 colidx, contiguous, on
    one device, rows strictly ascending: Q1's window test needs the ends)
    and its vertices in Q1's work order: descending out-degree (the
    widest, whose local graphs cost the most, first), ties by id."""
    if rowptr.dtype != torch.int64 or rowptr.dim() != 1:
        raise TypeError(f"rowptr must be a 1-D int64 tensor, got "
                        f"{rowptr.dtype} {tuple(rowptr.shape)}")
    if colidx.dtype != torch.int32 or colidx.dim() != 1:
        raise TypeError(f"colidx must be a 1-D int32 tensor, got "
                        f"{colidx.dtype} {tuple(colidx.shape)}")
    if rowptr.device != colidx.device:
        raise ValueError(f"rowptr on {rowptr.device}, colidx on "
                         f"{colidx.device}")
    if not (rowptr.is_contiguous() and colidx.is_contiguous()):
        raise ValueError("rowptr and colidx must be contiguous")
    m, nnz = rowptr.numel() - 1, colidx.numel()
    deg = rowptr[1:] - rowptr[:-1]
    if m < 0 or int(rowptr[0]) != 0 or int(rowptr[-1]) != nnz or \
            bool((deg < 0).any()):
        raise ValueError("rowptr is not the offsets of colidx's rows")
    if nnz > 1:
        # within a row each id must exceed the one before it
        row_start = torch.zeros(nnz, dtype=torch.bool, device=colidx.device)
        row_start[rowptr[:-1][deg > 0]] = True
        if bool(((colidx[1:] <= colidx[:-1]) & ~row_start[1:]).any()):
            raise ValueError("the DAG's rows are not strictly ascending")
    sdeg, order = torch.sort(deg, descending=True, stable=True)
    return LocalDag(rowptr, colidx, order.int(), sdeg.cpu().numpy(),
                    int(deg.max()) if m else 0)


def route(max_degree: int, k: int) -> str:
    """"q1" where Q1 takes (k, the widest out-degree), else "expand"."""
    return "q1" if MIN_K <= k <= MAX_K and max_degree <= MAX_DEGREE \
        else "expand"


def words(d: int) -> int:
    """Words a local row: W = ceil(d / 32)."""
    return (d + 31) // 32


def hash_bits(d: int) -> int:
    """log2 of the slots of a vertex's table: the least b with 2^b >= 2d
    (b >= 1), so a table is at most half full."""
    return max(1, (2 * d - 1).bit_length())


def _top_bits(ids, mul: int, bits: int) -> np.ndarray:
    ids = np.asarray(ids, np.uint64)
    return (((ids * np.uint64(mul)) & np.uint64(0xFFFFFFFF))
            >> np.uint64(32 - bits)).astype(np.int64)


def hash_slot(ids, bits: int) -> np.ndarray:
    """The first slot each id probes in a table of 2^bits slots: the top
    bits of id x HASH_MUL mod 2^32."""
    return _top_bits(ids, HASH_MUL, bits)


def filter_bit(ids, bits: int) -> np.ndarray:
    """Each id's bit in the filter of a table of 2^bits slots (2^(bits +
    FILTER_SHIFT) bits): the top bits of id x FILTER_MUL mod 2^32."""
    return _top_bits(ids, FILTER_MUL, bits + FILTER_SHIFT)


def group_lanes(W: int) -> int:
    """Lanes a root at k = 4 in the CTA shape for rows of W <= 8 words
    (wider rows go to the tensor cores): the least power of two >= W."""
    return 1 << max(0, (W - 1).bit_length())


def shared_bytes(dmax: int) -> int:
    """Dynamic shared memory of a CTA-shape launch whose widest vertex has
    out-degree dmax: the local graph (4 dmax W), the staged ids (4 dmax),
    the table (4 B a slot) and the filter (2^FILTER_SHIFT bits a slot),
    2^hash_bits(dmax) slots."""
    slots = 1 << hash_bits(dmax)
    return 4 * dmax * words(dmax) + 4 * dmax + 4 * slots + \
        (slots << FILTER_SHIFT) // 8


def launch_plan(ldag: LocalDag, k: int):
    """[(first, end, dmax)]: the runs of `ldag.order` that Q1 launches on,
    each with its widest out-degree, empty runs left out: the CTA shape's
    hubs (d > HUB_DEGREE), the rest of the CTA shape (d > WARP_DEGREE),
    then the warp shape's (k - 1 <= d <= WARP_DEGREE)."""
    deg = ldag.degrees

    def above(d):                      # vertices of out-degree > d
        return bisect.bisect_left(deg, -d, key=lambda x: -x)
    ends = [0, above(max(HUB_DEGREE, WARP_DEGREE)), above(WARP_DEGREE),
            above(k - 2)]
    return [(first, end, int(deg[first]))
            for first, end in zip(ends, ends[1:]) if end > first]


def kernel_limits() -> dict:
    """Q1's limits as the built library exports them (needs nvcc)."""
    from gardenia_tpu_torch.ops import _build
    so = _build.lib()
    return {"min_k": so.gdn_kcl_min_k(), "max_k": so.gdn_kcl_max_k(),
            "warp_degree": so.gdn_kcl_warp_degree(),
            "max_degree": so.gdn_kcl_max_degree()}


def kernel_sizes(d: int, ids=()) -> dict:
    """The library's own sizes at out-degree d (needs nvcc), to hold the
    copies here to: hash_bits(d), the slots and filter bits of `ids` at
    that size, group_lanes(W) and shared_bytes(d)."""
    from gardenia_tpu_torch.ops import _build
    so = _build.lib()
    bits = so.gdn_kcl_hash_bits(d)
    fbits = bits + so.gdn_kcl_filter_shift()
    return {"hash_bits": bits,
            "slots": [so.gdn_kcl_hash_slot(int(i), bits) for i in ids],
            "filter_bits": [so.gdn_kcl_filter_bit(int(i), fbits)
                            for i in ids],
            "group_lanes": so.gdn_kcl_group_lanes(words(d)),
            "shared_bytes": so.gdn_kcl_shared_bytes(d)}


def cta_info(dmax: int) -> dict:
    """The CTA shape's resources at k = 4 for a launch whose widest vertex
    has out-degree dmax (needs nvcc and a card)."""
    import ctypes
    from gardenia_tpu_torch.ops import _build
    regs, per_sm = ctypes.c_int(), ctypes.c_int()
    _build.check(_build.lib().gdn_kcl_cta_info(dmax, ctypes.byref(regs),
                                               ctypes.byref(per_sm)),
                 "kcl_local_count cta_info")
    return {"threads": _build.lib().gdn_kcl_cta_threads(),
            "registers": regs.value, "ctas_per_sm": per_sm.value,
            "shared_bytes": shared_bytes(dmax)}


def local_count_plain(ldag: LocalDag, k: int) -> torch.Tensor:
    """int64[m] by the level expansion (mining/kcl.expand_counts)."""
    from gardenia_tpu_torch.mining.kcl import expand_counts
    return expand_counts(ldag.rowptr, ldag.colidx, k)


def local_count(ldag: LocalDag, k: int) -> torch.Tensor:
    """int64[m]: the k-cliques whose first vertex in DAG order is u."""
    global LAUNCHES
    dev = ldag.colidx.device
    if dev.type == "cpu":
        return local_count_plain(ldag, k)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if route(ldag.max_degree, k) != "q1":
        raise ValueError(f"Q1 takes {MIN_K} <= k <= {MAX_K} and out-degrees "
                         f"<= {MAX_DEGREE}, got k {k}, out-degree "
                         f"{ldag.max_degree}")
    from gardenia_tpu_torch.ops import _build
    want = {"min_k": MIN_K, "max_k": MAX_K, "warp_degree": WARP_DEGREE,
            "max_degree": MAX_DEGREE}
    if kernel_limits() != want:
        raise RuntimeError(f"csrc/kcl_local_count.cu exports "
                           f"{kernel_limits()}, ops/kcl_count.py has {want}")
    plan = launch_plan(ldag, k)
    cnt = torch.zeros(ldag.rowptr.numel() - 1, dtype=torch.int64, device=dev)
    counters = torch.zeros(max(1, len(plan)), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        for i, (first, end, dmax) in enumerate(plan):
            code = _build.lib().gdn_kcl_local_count(
                ldag.rowptr.data_ptr(), ldag.colidx.data_ptr(),
                ldag.order[first:].data_ptr(), end - first, cnt.data_ptr(),
                counters[i:].data_ptr(), k, dmax, stream)
            _build.check(code, f"kcl_local_count (k {k}, {end - first} "
                               f"vertices, d <= {dmax})")
            LAUNCHES += 1
    return cnt
