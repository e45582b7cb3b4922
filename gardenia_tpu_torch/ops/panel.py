"""Dense-panel matmul of the hybrid layout — counterpart of
gardenia_tpu/ops/pallas_bsr.py::dense_panel_matmul.

`dense_panel_matmul` launches kernel K1 on CUDA tensors and takes
`dense_panel_matmul_plain` on CPU tensors, and only there: on a CUDA
tensor it launches a kernel or raises.  Unlike the TPU kernel it takes the
operand-block table `src` and the padded operand `x3d` and gathers
x3d[src] itself, and it has no hi/lo operand split argument.

K1 has two routes, chosen by the shapes and types alone:
  'simt' — csrc/dense_panel_matmul.cu, CUDA cores, f32 operand, every
           panel type: S <= 8 (PageRank, SpMV, the BFS count sweep), and
           f32 panels at any S (weighted graphs stay f32-exact).
  'tc'   — csrc/dense_panel_matmul_tc.cu, tensor cores (mma.sync, bf16
           x bf16 -> f32), int8 and bf16 panels: S > 8 (multi-source BFS,
           batched BC), and a bf16 operand at any S.
Precision is the operand's dtype: a bf16 operand takes one product (a 0/1
mask is exact), an f32 operand is split into three bf16 terms inside the
kernel, which carry f32's 24 mantissa bits.

LAUNCHES counts the kernels' launches by route (never the plain
version's), so a run can show that its main path went through K1 and by
which kernel.
"""

from __future__ import annotations

import torch

LANES = 128
LAUNCHES = {"simt": 0, "tc": 0}
SIMT_MAX_S = 8          # the CUDA-core kernel reads the panel once up to here

_DTYPE_CODE = {torch.int8: 0, torch.bfloat16: 1, torch.float32: 2}


def dense_panel_matmul_plain(panel: torch.Tensor, src: torch.Tensor,
                             x3d: torch.Tensor, S: int) -> torch.Tensor:
    """(R, 128, S) f32 = panel[r] @ x3d[src[r]] per row slot, in torch ops
    (f32 products of the cells and the operand as given, f32 or bf16)."""
    R, W = src.shape
    xg = x3d[src].reshape(R, W * LANES, S).float()
    return torch.einsum("riw,rwk->rik", panel.float(), xg)


def kernel_route(panel_dtype, x_dtype, S: int) -> str:
    """Which of K1's kernels takes these types at S operand columns."""
    if panel_dtype == torch.float32:
        return "simt"
    if S > SIMT_MAX_S or x_dtype == torch.bfloat16:
        return "tc"
    return "simt"


def _check(panel, src, x3d, S):
    if panel.dtype not in _DTYPE_CODE:
        raise TypeError(f"panel dtype {panel.dtype} not in "
                        f"{sorted(map(str, _DTYPE_CODE))}")
    if src.dtype != torch.int32:
        raise TypeError(f"src must be int32, got {src.dtype}")
    if x3d.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"x3d must be float32 or bfloat16, got {x3d.dtype}")
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
    x3d:   (qx, 128, S) float32 | bfloat16 operand blocks.
    """
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
    route = kernel_route(panel.dtype, x3d.dtype, S)
    if route == "simt" and x3d.dtype != torch.float32:
        x3d = x3d.float()            # exact; f32 panels keep f32 products
    from gardenia_tpu_torch.ops import _build

    R, W = src.shape
    out = torch.empty((R, LANES, S), dtype=torch.float32, device=panel.device)
    if R == 0:
        return out
    so = _build.lib()
    with torch.cuda.device(panel.device):
        stream = torch.cuda.current_stream().cuda_stream
        if route == "tc":
            code = so.gdn_dense_panel_matmul_tc(
                panel.data_ptr(), _DTYPE_CODE[panel.dtype], src.data_ptr(),
                x3d.data_ptr(), _DTYPE_CODE[x3d.dtype], out.data_ptr(), R, W,
                S, stream)
        else:
            code = so.gdn_dense_panel_matmul(
                panel.data_ptr(), _DTYPE_CODE[panel.dtype], src.data_ptr(),
                x3d.data_ptr(), out.data_ptr(), R, W, S, stream)
    _build.check(code, f"dense_panel_matmul ({route})")
    LAUNCHES[route] += 1
    return out
