"""Dense-panel min-select of the hybrid layout — counterpart of
gardenia_tpu/ops/pallas_bsr.py::dense_panel_minselect (kernel K2) — and
its min-plus twin (kernel M1, the masked reduce-min of
gardenia_tpu/ops/bsr.py::spmv_hybrid_min_plus).

    y[r, i] = min over j with panel[r, i, j] != 0 of
              x2d[src[r, j // 128], j % 128],   sentinel where no such j

the min-select semiring (CC label propagation) over one width bucket of
dense panels.  `dense_panel_minselect` launches K2
(csrc/dense_panel_minselect.cu) on CUDA tensors and takes
`dense_panel_minselect_plain` on CPU tensors, and only there: on a CUDA
tensor it launches the kernel or raises.  Unlike the TPU kernel it takes
the operand-block table `src` and the label table `x2d` and gathers the
labels itself (Mosaic could not gather, so the TPU kernel took them
pre-gathered), and it returns (R, 128) rather than (R, 128, 1).  Split
rows repeat across slots; the caller combines their slots with an amin
scatter (ops/bsr.spmv_hybrid_min_select).

    y[r, i] = min(sentinel, min over j with panel[r, i, j] != 0 of
                  x2d[src[r, j // 128], j % 128] + int(panel[r, i, j]) * scale)

is the min-plus semiring (SSSP relaxation) over the weighted panels, in
int32 that wraps on overflow, int(cell) truncated toward zero:
`dense_panel_minplus` launches M1, the same kernel templated on the
reduce's operand, and takes `dense_panel_minplus_plain` on CPU tensors.

LAUNCHES counts K2's launches and MINPLUS_LAUNCHES M1's (never the plain
versions'), so a run can show that its main path went through them.
"""

from __future__ import annotations

import torch

LANES = 128
MAX_WIDTH = 32          # K2 stages a slot's W*128 labels (<= 16 KB) at once
LAUNCHES = 0
MINPLUS_LAUNCHES = 0
# the plain version's temporaries: panel cells per step (5 bytes each)
PLAIN_STEP_CELLS = 1 << 28

_DTYPE_CODE = {torch.int8: 0, torch.bfloat16: 1, torch.float32: 2}


def dense_panel_minselect_plain(panel: torch.Tensor, src: torch.Tensor,
                                x2d: torch.Tensor,
                                sentinel: int) -> torch.Tensor:
    """(R, 128) int32 in torch ops, over steps of slots that keep the
    broadcast compare under PLAIN_STEP_CELLS cells."""
    R, W = src.shape
    out = torch.empty((R, LANES), dtype=torch.int32, device=panel.device)
    step = max(1, PLAIN_STEP_CELLS // (LANES * W * LANES))
    for r0 in range(0, R, step):
        r1 = min(R, r0 + step)
        xg = x2d[src[r0:r1]].reshape(r1 - r0, 1, W * LANES)
        out[r0:r1] = torch.where(panel[r0:r1] != 0, xg,
                                 sentinel).amin(dim=2)
    return out


def dense_panel_minplus_plain(panel: torch.Tensor, src: torch.Tensor,
                              x2d: torch.Tensor, sentinel: int,
                              scale: int) -> torch.Tensor:
    """(R, 128) int32 in torch ops, over steps of slots as
    dense_panel_minselect_plain takes them."""
    R, W = src.shape
    out = torch.empty((R, LANES), dtype=torch.int32, device=panel.device)
    step = max(1, PLAIN_STEP_CELLS // (LANES * W * LANES))
    for r0 in range(0, R, step):
        r1 = min(R, r0 + step)
        pn = panel[r0:r1]
        xg = x2d[src[r0:r1]].reshape(r1 - r0, 1, W * LANES)
        cand = xg + pn.to(torch.int32) * scale
        out[r0:r1] = torch.where(pn != 0, cand, sentinel).amin(dim=2) \
            .clamp_(max=sentinel)
    return out


def _check(panel, src, x2d):
    if panel.dtype not in _DTYPE_CODE:
        raise TypeError(f"panel dtype {panel.dtype} not in "
                        f"{sorted(map(str, _DTYPE_CODE))}")
    if src.dtype != torch.int32:
        raise TypeError(f"src must be int32, got {src.dtype}")
    if x2d.dtype != torch.int32:
        raise TypeError(f"x2d must be int32, got {x2d.dtype}")
    if src.dim() != 2 or panel.dim() != 3 or x2d.dim() != 2:
        raise ValueError("expected panel (R,128,W*128), src (R,W), "
                         "x2d (qx,128)")
    R, W = src.shape
    if tuple(panel.shape) != (R, LANES, W * LANES):
        raise ValueError(f"panel shape {tuple(panel.shape)} != "
                         f"{(R, LANES, W * LANES)} for src {(R, W)}")
    if x2d.shape[1] != LANES:
        raise ValueError(f"x2d shape {tuple(x2d.shape)} != (qx, {LANES})")
    devs = {panel.device, src.device, x2d.device}
    if len(devs) != 1:
        raise ValueError(f"tensors on different devices: {devs}")


def _prepare(panel, src, x2d, sentinel) -> torch.Tensor:
    """The kernels' checks on CUDA tensors; the (R, 128) int32 output."""
    if panel.device.type != "cuda":
        raise ValueError(f"unsupported device {panel.device}")
    for name, t in (("panel", panel), ("src", src), ("x2d", x2d)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if panel.data_ptr() % 16:
        raise ValueError("panel must be 16-byte aligned")
    R, W = src.shape
    if W > MAX_WIDTH:
        raise ValueError(f"panel width {W} > {MAX_WIDTH} blocks")
    if not -2 ** 31 <= sentinel < 2 ** 31:
        raise ValueError(f"sentinel {sentinel} is not an int32")
    return torch.empty((R, LANES), dtype=torch.int32, device=panel.device)


def dense_panel_minselect(panel: torch.Tensor, src: torch.Tensor,
                          x2d: torch.Tensor, sentinel: int) -> torch.Tensor:
    """(R, 128) int32: per slot r and row i, the min label over the
    panel's nonzero columns, else `sentinel`.

    panel: (R, 128, W*128) int8 | bfloat16 | float32, zero = no edge.
    src:   (R, W) int32 operand block ids into x2d.
    x2d:   (qx, 128) int32 labels.
    """
    global LAUNCHES
    _check(panel, src, x2d)
    if panel.device.type == "cpu":
        return dense_panel_minselect_plain(panel, src, x2d, sentinel)
    out = _prepare(panel, src, x2d, sentinel)
    if out.shape[0] == 0:
        return out
    from gardenia_tpu_torch.ops import _build
    R, W = src.shape
    so = _build.lib()
    with torch.cuda.device(panel.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = so.gdn_dense_panel_minselect(
            panel.data_ptr(), _DTYPE_CODE[panel.dtype], src.data_ptr(),
            x2d.data_ptr(), out.data_ptr(), R, W, sentinel, stream)
    _build.check(code, "dense_panel_minselect")
    LAUNCHES += 1
    return out


def dense_panel_minplus(panel: torch.Tensor, src: torch.Tensor,
                        x2d: torch.Tensor, sentinel: int,
                        scale: int = 1) -> torch.Tensor:
    """(R, 128) int32: per slot r and row i, the least x + weight * scale
    over the panel's nonzero columns, at most `sentinel` (M1).

    panel: (R, 128, W*128) int8 | bfloat16 | float32 integral weights,
           zero = no edge.
    src:   (R, W) int32 operand block ids into x2d.
    x2d:   (qx, 128) int32 distances.
    scale: the layout's integral constant-value factor.
    """
    global MINPLUS_LAUNCHES
    _check(panel, src, x2d)
    if int(scale) != scale or not -2 ** 31 <= scale < 2 ** 31:
        raise ValueError(f"scale {scale} is not an int32")
    scale = int(scale)
    if panel.device.type == "cpu":
        return dense_panel_minplus_plain(panel, src, x2d, sentinel, scale)
    out = _prepare(panel, src, x2d, sentinel)
    if out.shape[0] == 0:
        return out
    from gardenia_tpu_torch.ops import _build
    R, W = src.shape
    with torch.cuda.device(panel.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = _build.lib().gdn_dense_panel_minplus(
            panel.data_ptr(), _DTYPE_CODE[panel.dtype], src.data_ptr(),
            x2d.data_ptr(), out.data_ptr(), R, W, sentinel, scale, stream)
    _build.check(code, "dense_panel_minplus")
    MINPLUS_LAUNCHES += 1
    return out
