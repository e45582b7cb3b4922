"""The sweep of one SymGS colour block (kernel GS1) — counterpart of one
masked slab SpMV of gardenia_tpu/solvers/symgs.py, which is XLA and has no
Pallas kernel behind it.

    sweep_block(col, val, b, diag, update, x, block)

updates, in place, every row i of one block of the colour-ordered CSR
(solvers/symgs.color_ordered):

    x[i] = (b[i] - sum_{k in row i} val[k] * x[col[k]]) / diag[i]
           where update[i], else x[i]

block = (r0, r1, offsets, e0, e1, width): rows r0 .. r1 - 1 over arcs e0 ..
e1 - 1, offsets int64[r1 - r0 + 1] the rows' arc offsets from e0, width
the block's widest row.  col int32[nnz] holds column positions in the
ordered x, val f32[nnz], b and diag f32[m], update bool[m], x f32[m].

`sweep_block` launches GS1 (csrc/symgs_sweep.cu) on CUDA tensors: one
launch a block, group_lanes(width) lanes a row, nothing read back.  On
CPU tensors, and only there, it takes `sweep_block_plain`, the route the
port took before GS1: the gather x[col], the product, torch.segment_reduce
over the offsets and the row update (about seven launches on a card, cub's
segmented reduce among them).  Any other device raises.  Both round each
product to float32 and sum in float32; only the order of a row's sum
differs.  GS1 checks nothing a launch: color_ordered builds the system
once, with these types, and holds its colouring proper (`check_proper`)
on every device.  LAUNCHES counts GS1's
launches, never the plain version's, so a run can show that its blocks
went through GS1.
"""

from __future__ import annotations

import numpy as np
import torch

LAUNCHES = 0
LANES = (8, 16, 32)     # the group sizes GS1 is built for


def group_lanes(width: int) -> int:
    """GS1's lanes a row for a block whose widest row has `width` arcs:
    the least of LANES that holds it, 32 for wider rows (which loop in
    strides of 32)."""
    return 8 if width <= 8 else 16 if width <= 16 else 32


def sweep_block_plain(col, val, b, diag, update, x, block) -> None:
    """sweep_block in torch ops, on any device."""
    r0, r1, offsets, e0, e1, _ = block
    prod = val[e0:e1] * x[col[e0:e1]]
    rsum = torch.segment_reduce(prod, "sum", offsets=offsets, initial=0.0)
    xs = x[r0:r1]
    torch.where(update[r0:r1], (b[r0:r1] - rsum) / diag[r0:r1], xs, out=xs)


def check_proper(rowptr: np.ndarray, col: np.ndarray,
                 colors: np.ndarray) -> None:
    """Raise ValueError if an arc of the ordered CSR (rowptr, col) joins
    two rows of one colour (colors: each ordered row's): GS1 updates a
    block in place, which is the plain version's function only when no
    row of a block reads x of another row of it.  color_ordered holds
    every system to it, so that both routes take the same colourings.  A
    self-arc is allowed."""
    lens = np.diff(rowptr)
    colors = colors.astype(np.int32)
    same = np.flatnonzero(np.repeat(colors, lens) == colors[col])
    if same.size:
        rows = np.searchsorted(rowptr, same, side="right") - 1
        bad = int((col[same] != rows).sum())
        if bad:
            raise ValueError(f"the colouring is not proper: {bad} arcs join "
                             f"two rows of one colour, and GS1 updates a "
                             f"colour's rows in place")


def takes_gs1(device: torch.device) -> bool:
    """Whether sweep_block launches GS1: on a CUDA device; CPU tensors take
    the plain version, and any other device raises."""
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {device}")
    return device.type == "cuda"


def sweep_block(col, val, b, diag, update, x, block) -> None:
    """Update the rows of one colour block of the ordered x in place
    (arguments as above: the system as color_ordered builds it, x f32[m]
    on its device)."""
    global LAUNCHES
    if not takes_gs1(x.device):
        sweep_block_plain(col, val, b, diag, update, x, block)
        return
    _gs1(col, val, b, diag, update, x, block)
    LAUNCHES += 1


def _gs1(col, val, b, diag, update, x, block) -> None:
    """GS1's launch on x's stream."""
    from gardenia_tpu_torch.ops import _build

    r0, r1, offsets, e0, _, width = block
    with torch.cuda.device(x.device):
        code = _build.lib().gdn_symgs_sweep(
            offsets.data_ptr(), col.data_ptr(), val.data_ptr(),
            b.data_ptr(), diag.data_ptr(), update.data_ptr(), x.data_ptr(),
            r0, r1 - r0, e0, group_lanes(width),
            torch.cuda.current_stream().cuda_stream)
    _build.check(code, "sweep_block (GS1)")
