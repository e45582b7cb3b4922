"""Per-pair intersection counts of triangle counting's rotate path —
counterparts of gardenia_tpu/solvers/tc.py's `_rot_count_pallas` (K3),
`_merge_count_pallas` (K4) and its XLA hub-bitmap pass (H1).

Each wrapper takes the chunk table (or the hub bitmap) and one stream of
row-index pairs, and returns the int32 count of every pair:

  rot_count(table, cu, cv, W)  K3, csrc/tc_rot_count.cu
      #{(j, k): j < W, a_j >= 0, a_j == b_k}, a = table[cu], b = table[cv]
  merge_count(table, cu, cv, W)   K4, csrc/tc_merge_count.cu
      |set(a[:W]) & set(b)| over the valid (>= 0) lanes
  bitmap_count(bmp, hu, hv)    H1, csrc/tc_bitmap_count.cu
      popcount(bmp[hu] & bmp[hv]) over the row's words

table is int32 (C, 128) whose rows hold distinct ascending ids with -1
pads trailing; bmp is the hub bitmap's uint32 words viewed as int32.
Indices must lie in range: the kernels do not check them (the plain
versions raise).

K3 and K4 compute the same count two ways.  K3 gives min(W, 32) lanes to
a pair (four pairs a warp at W8, two at W16), stages row cv as it is,
sorted, and finds each id of a's W-prefix by a 7-step search: no table
to build, so it leads on the narrow classes; whether its row gathers or
its searches' dependent shared-memory loads bound it there is not shown.
K4 gives a warp to a pair and builds a hash table of row cv per staging,
one or two loads a lookup: it leads where a lane holds several ids and a
row serves many pairs.  On an NVIDIA H100 80GB HBM3 at 700.00 W, on the
R-MAT-20 classes (one run of chip_smoke.py [6]): K3 W8 0.117 ms, W16
0.175, W32 0.200, W64 0.931, W128 2.048; K4 0.260, 0.343, 0.274, 0.903,
1.798.  solvers/tc.MERGE_MIN_W routes by that.

All three are fastest on streams in which runs of pairs share a row (K3
and K4: cv, H1: hu), as solvers/tc.tc_data orders them: each stages that
row once per run of a block of pairs (kernel_blocks() reads the block
sizes from the kernels).  Any order counts right.

On CUDA tensors each wrapper launches its kernel, in one launch for the
whole stream, or raises; on CPU tensors, and only there, it takes its
plain version, which steps through the stream `chunk` pairs at a time so
that no (n, 128) gather is ever made whole.  LAUNCHES counts each
kernel's launches (never the plain versions'), so a run can show that its
path went through the kernels.
"""

from __future__ import annotations

import torch

LANES = 128
ROT_WIDTHS = (8, 16, 32, 64, 128)
PLAIN_CHUNK = 1 << 16          # pairs per step of the plain versions
PAD_KEY = 1 << 28              # the bitonic merge's first pad key

LAUNCHES = {"rot_count": 0, "merge_count": 0, "bitmap_count": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def kernel_blocks() -> dict:
    """The kernels' own block sizes, read from the built library (needs
    nvcc): rot_block, consecutive pairs a K3 lane group takes;
    merge_block, consecutive pairs a K4 warp takes; bitmap_block,
    consecutive hub pairs an H1 CTA takes; bitmap_tile_words, the words
    of the hu row H1 holds in shared memory at a time."""
    from gardenia_tpu_torch.ops import _build
    so = _build.lib()
    return {"rot_block": so.gdn_tc_rot_block(),
            "merge_block": so.gdn_tc_merge_block(),
            "bitmap_block": so.gdn_tc_bitmap_block(),
            "bitmap_tile_words": so.gdn_tc_bitmap_tile_words()}


def _steps(n: int, chunk: int):
    chunk = max(1, int(chunk))
    return ((lo, min(n, lo + chunk)) for lo in range(0, n, chunk))


def rot_count_plain(table: torch.Tensor, cu: torch.Tensor, cv: torch.Tensor,
                    W: int, *, chunk: int = PLAIN_CHUNK) -> torch.Tensor:
    """K3 in torch ops: the XLA formulation of tc.py:241-254 — the W-lane
    prefix of a tiled across the row, b's pads set to -2, and
    sum_{s < W} sum_i [A_i == roll(B, s)_i] per pair."""
    out = torch.empty(cu.shape[0], dtype=torch.int32, device=table.device)
    for lo, hi in _steps(cu.shape[0], chunk):
        a = table[cu[lo:hi]]
        A = a[:, :W].repeat(1, LANES // W) if W < LANES else a
        B = table[cv[lo:hi]]
        # pad sentinels must never match: A keeps -1, B gets -2
        B = B.masked_fill(B == -1, -2)
        acc = torch.zeros_like(A)
        for s in range(W):
            acc += A == torch.roll(B, s, dims=1)
        out[lo:hi] = acc.sum(dim=1, dtype=torch.int32)
    return out


def merge_count_plain(table: torch.Tensor, cu: torch.Tensor,
                      cv: torch.Tensor, W: int = LANES, *,
                      chunk: int = PLAIN_CHUNK) -> torch.Tensor:
    """K4 in torch ops: `_bitonic_intersect` (tc.py:271-300) per pair,
    with b lane-reversed and a's lanes from W on taken as pads.  Pads
    become keys >= 2^28, so ids must stay below it (tc.py:428)."""
    if table.numel() and int(table.max()) >= PAD_KEY:
        raise ValueError("the bitonic merge's pad keys collide with vertex "
                         f"ids >= 2^28 (table max {int(table.max())})")
    out = torch.empty(cu.shape[0], dtype=torch.int32, device=table.device)
    lane = torch.arange(LANES, dtype=torch.int32, device=table.device)

    def roll(x, s):
        return torch.roll(x, s, dims=1)

    for lo, hi in _steps(cu.shape[0], chunk):
        a = table[cu[lo:hi]]
        b_rev = table[cv[lo:hi]].flip(1)
        a = torch.where((a < 0) | (lane >= W), PAD_KEY + lane, a)
        b = torch.where(b_rev < 0, PAD_KEY + (1 << 20) - lane, b_rev)
        # cross stage of merging [a, rev(b)]: position i pairs with i+128
        mn, mx = torch.minimum(a, b), torch.maximum(a, b)
        for s in (64, 32, 16, 8, 4, 2, 1):
            keep_lo = (lane & s) == 0
            mn = torch.where(keep_lo, torch.minimum(mn, roll(mn, 128 - s)),
                             torch.maximum(mn, roll(mn, s)))
            mx = torch.where(keep_lo, torch.minimum(mx, roll(mx, 128 - s)),
                             torch.maximum(mx, roll(mx, s)))
        eq = ((mn == roll(mn, 1)) & (lane > 0)).to(torch.int32)
        eq += (mx == roll(mx, 1)) & (lane > 0)
        # sorted-sequence boundary: mn[127] (roll(mn, 1) at lane 0) vs mx[0]
        eq += (mx == roll(mn, 1)) & (lane == 0)
        out[lo:hi] = eq.sum(dim=1, dtype=torch.int32)
    return out


def _popcount32(x: torch.Tensor) -> torch.Tensor:
    """Set bits of each int32 word (SWAR; torch has no popcount), as
    int64.  The word is widened first, so no shift sees a sign bit."""
    x = x.to(torch.int64) & 0xFFFFFFFF
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return (x * 0x01010101 >> 24) & 0xFF


def bitmap_count_plain(bmp: torch.Tensor, hu: torch.Tensor, hv: torch.Tensor,
                       *, chunk: int = 2048) -> torch.Tensor:
    """H1 in torch ops: popcount(bmp[hu] & bmp[hv]) per pair, as the XLA
    pass of tc.py:351-361 computes it."""
    out = torch.empty(hu.shape[0], dtype=torch.int32, device=bmp.device)
    for lo, hi in _steps(hu.shape[0], chunk):
        both = bmp[hu[lo:hi]] & bmp[hv[lo:hi]]
        out[lo:hi] = _popcount32(both).sum(dim=1).to(torch.int32)
    return out


def _check(what: str, rows: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
           width_ok) -> None:
    for name, t in (("rows", rows), ("first index", a),
                    ("second index", b)):
        if t.dtype != torch.int32:
            raise TypeError(f"{what}: {name} must be int32, got {t.dtype}")
    if rows.dim() != 2 or not width_ok(rows.shape[1]):
        raise ValueError(f"{what}: bad row table shape {tuple(rows.shape)}")
    if a.dim() != 1 or a.shape != b.shape:
        raise ValueError(f"{what}: index streams must be 1-D of one length, "
                         f"got {tuple(a.shape)} and {tuple(b.shape)}")
    devs = {rows.device, a.device, b.device}
    if len(devs) != 1:
        raise ValueError(f"{what}: tensors on different devices: {devs}")
    if rows.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: unsupported device {rows.device}")


def _launch(name: str, entry: str, rows: torch.Tensor, a: torch.Tensor,
            b: torch.Tensor, *extra) -> torch.Tensor:
    """Launch kernel `entry` over the pair stream (a, b) of `rows`."""
    for t in (rows, a, b):
        if not t.is_contiguous():
            raise ValueError(f"{name}: inputs must be contiguous")
    if rows.data_ptr() % 16:
        raise ValueError(f"{name}: the row table must be 16-byte aligned")
    from gardenia_tpu_torch.ops import _build

    n = a.shape[0]
    out = torch.empty(n, dtype=torch.int32, device=rows.device)
    if n == 0:
        return out
    so = _build.lib()
    with torch.cuda.device(rows.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = getattr(so, entry)(rows.data_ptr(), a.data_ptr(),
                                  b.data_ptr(), out.data_ptr(), n, *extra,
                                  stream)
    _build.check(code, name)
    LAUNCHES[name] += 1
    return out


def rot_count(table: torch.Tensor, cu: torch.Tensor, cv: torch.Tensor,
              W: int, *, chunk: int = PLAIN_CHUNK) -> torch.Tensor:
    """i32[n] equal (a_j, b_k) pairs, j < W, per pair (kernel K3): the
    valid ids among table[cu]'s first W lanes that occur in table[cv].
    Rows hold distinct ascending ids with -1 pads trailing; the kernel
    searches where the plain version counts (j, k) pairs, and a repeated
    id would make the two differ."""
    _check("rot_count", table, cu, cv, lambda w: w == LANES)
    if W not in ROT_WIDTHS:
        raise ValueError(f"rot_count: W={W} not in {ROT_WIDTHS}")
    if table.device.type == "cpu":
        return rot_count_plain(table, cu, cv, W, chunk=chunk)
    return _launch("rot_count", "gdn_tc_rot_count", table, cu, cv, W)


def merge_count(table: torch.Tensor, cu: torch.Tensor, cv: torch.Tensor,
                W: int = LANES, *, chunk: int = PLAIN_CHUNK) -> torch.Tensor:
    """i32[n] |set(table[cu][:W]) & set(table[cv])| per pair (kernel K4):
    the full intersection when cu's ids lie in its first W lanes, as the
    width classes put them.  Rows ascending, -1 pads trailing; the kernel
    has no id ceiling."""
    _check("merge_count", table, cu, cv, lambda w: w == LANES)
    if W not in ROT_WIDTHS:
        raise ValueError(f"merge_count: W={W} not in {ROT_WIDTHS}")
    if table.device.type == "cpu":
        return merge_count_plain(table, cu, cv, W, chunk=chunk)
    return _launch("merge_count", "gdn_tc_merge_count", table, cu, cv, W)


def bitmap_count(bmp: torch.Tensor, hu: torch.Tensor, hv: torch.Tensor, *,
                 chunk: int = 2048) -> torch.Tensor:
    """i32[n] popcount(bmp[hu] & bmp[hv]) per pair (kernel H1).  bmp's
    rows hold a multiple of 4 words (one 16-byte load each)."""
    _check("bitmap_count", bmp, hu, hv, lambda w: w > 0 and w % 4 == 0)
    if bmp.device.type == "cpu":
        return bitmap_count_plain(bmp, hu, hv, chunk=chunk)
    return _launch("bitmap_count", "gdn_tc_bitmap_count", bmp, hu, hv,
                   bmp.shape[1])
