"""Dense-panel matmul of the hybrid layout — counterpart of
gardenia_tpu/ops/pallas_bsr.py::dense_panel_matmul.

`dense_panel_matmul` launches kernel K1 (csrc/dense_panel_matmul.cu) on
CUDA tensors and takes `dense_panel_matmul_plain` on CPU tensors, and only
there: on a CUDA tensor it launches the kernel or raises.  Unlike the TPU
kernel it takes the operand-block table `src` and the padded operand
`x3d` and gathers x3d[src] itself, and it has no hi/lo operand split.

LAUNCHES counts the kernel's launches (never the plain version's), so a
run can show that its main path went through K1.
"""

from __future__ import annotations

import torch

LANES = 128
LAUNCHES = 0

_DTYPE_CODE = {torch.int8: 0, torch.bfloat16: 1, torch.float32: 2}


def dense_panel_matmul_plain(panel: torch.Tensor, src: torch.Tensor,
                             x3d: torch.Tensor, S: int) -> torch.Tensor:
    """(R, 128, S) f32 = panel[r] @ x3d[src[r]] per row slot, in torch ops."""
    R, W = src.shape
    xg = x3d[src].reshape(R, W * LANES, S)
    return torch.einsum("riw,rwk->rik", panel.float(), xg)


def _check(panel, src, x3d, S):
    if panel.dtype not in _DTYPE_CODE:
        raise TypeError(f"panel dtype {panel.dtype} not in "
                        f"{sorted(map(str, _DTYPE_CODE))}")
    if src.dtype != torch.int32:
        raise TypeError(f"src must be int32, got {src.dtype}")
    if x3d.dtype != torch.float32:
        raise TypeError(f"x3d must be float32, got {x3d.dtype}")
    if src.dim() != 2 or panel.dim() != 3 or x3d.dim() != 3:
        raise ValueError("expected panel (R,128,W*128), src (R,W), "
                         "x3d (qx,128,S)")
    R, W = src.shape
    if tuple(panel.shape) != (R, LANES, W * LANES):
        raise ValueError(f"panel shape {tuple(panel.shape)} != "
                         f"{(R, LANES, W * LANES)} for src {(R, W)}")
    if S < 1 or x3d.shape[1:] != (LANES, S):
        raise ValueError(f"x3d shape {tuple(x3d.shape)} != (qx, {LANES}, {S})")
    devs = {panel.device, src.device, x3d.device}
    if len(devs) != 1:
        raise ValueError(f"tensors on different devices: {devs}")


def dense_panel_matmul(panel: torch.Tensor, src: torch.Tensor,
                       x3d: torch.Tensor, S: int) -> torch.Tensor:
    """(R, 128, S) f32: out[r] = panel[r] @ x3d[src[r]].reshape(W*128, S).

    panel: (R, 128, W*128) int8 | bfloat16 | float32, zero-padded slots.
    src:   (R, W) int32 operand block ids into x3d.
    x3d:   (qx, 128, S) float32 operand blocks.
    """
    global LAUNCHES
    _check(panel, src, x3d, S)
    if panel.device.type == "cpu":
        return dense_panel_matmul_plain(panel, src, x3d, S)
    if panel.device.type != "cuda":
        raise ValueError(f"unsupported device {panel.device}")
    for name, t in (("panel", panel), ("src", src), ("x3d", x3d)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if panel.data_ptr() % 16:
        raise ValueError("panel must be 16-byte aligned")
    from gardenia_tpu_torch.ops import _build

    R, W = src.shape
    out = torch.empty((R, LANES, S), dtype=torch.float32, device=panel.device)
    if R == 0:
        return out
    so = _build.lib()
    with torch.cuda.device(panel.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = so.gdn_dense_panel_matmul(
            panel.data_ptr(), _DTYPE_CODE[panel.dtype], src.data_ptr(),
            x3d.data_ptr(), out.data_ptr(), R, W, S, stream)
    _build.check(code, "dense_panel_matmul")
    LAUNCHES += 1
    return out
