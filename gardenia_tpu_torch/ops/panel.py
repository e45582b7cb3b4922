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
  'tc'   — csrc/dense_panel_matmul_tc.cu, tensor cores (wgmma on
           TMA-staged tiles, bf16 x bf16 -> f32), int8 and bf16 panels:
           S > 8 (multi-source BFS, batched BC), and a bf16 operand at any S.
Precision is the operand's dtype: a bf16 operand takes one product (a 0/1
mask is exact), an f32 operand is split into three bf16 terms, which carry
f32's 24 mantissa bits, by a second kernel of the same source
(`split_operand`).  `dense_panel_matmul_arrays` serves several panel
arrays on one operand (a hybrid layout's dense part) and makes the operand
ready for the 'tc' kernel once for all of them (`tc_operand`).

TMA wants 16-byte row strides, so the 'tc' route pads the operand's
columns to a multiple of TC_COL_ALIGN (`padded_columns`; the split writes
its terms padded) and crops the output back to S (`crop_columns`); S = 128
pays no copy.

LAUNCHES counts the matmul kernels' launches by route, SPLIT_LAUNCHES the
split kernel's (never the plain versions'), so a run can show that its
main path went through K1 and by which kernel.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

LANES = 128
LAUNCHES = {"simt": 0, "tc": 0}
SPLIT_LAUNCHES = {"split": 0}
SIMT_MAX_S = 8          # the CUDA-core kernel reads the panel once up to here
TC_COL_ALIGN = 8        # bf16 columns in 16 bytes: TMA's row-stride unit

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


def padded_columns(S: int) -> int:
    """The operand columns the 'tc' kernel reads for S: S rounded up to a
    multiple of TC_COL_ALIGN."""
    return -(-S // TC_COL_ALIGN) * TC_COL_ALIGN


def pad_columns(x3d: torch.Tensor, Sp: int) -> torch.Tensor:
    """x3d (qx, 128, S) with zero columns up to Sp, contiguous and 16-byte
    aligned; x3d itself where it already is."""
    S = x3d.shape[-1]
    if Sp != S:
        return F.pad(x3d, (0, Sp - S))
    if not x3d.is_contiguous() or x3d.data_ptr() % 16:
        return x3d.clone(memory_format=torch.contiguous_format)
    return x3d


def crop_columns(out: torch.Tensor, S: int) -> torch.Tensor:
    """The first S columns of a (R, 128, Sp) kernel output, contiguous."""
    return out if out.shape[-1] == S else out[..., :S].contiguous()


def split_operand_plain(x3d: torch.Tensor) -> torch.Tensor:
    """(3, qx, 128, Sp) bf16 terms hi, mid, lo of an f32 x3d (qx, 128, S):
    hi + mid + lo == x exactly in f32 (each residual of a rounding to fewer
    bits is exact), columns S..Sp-1 zero, Sp = padded_columns(S)."""
    x = pad_columns(x3d.float(), padded_columns(x3d.shape[-1]))
    terms = []
    for _ in range(3):
        t = x.to(torch.bfloat16)
        terms.append(t)
        x = x - t.float()
    return torch.stack(terms)


def split_operand(x3d: torch.Tensor) -> torch.Tensor:
    """split_operand_plain's terms by the split kernel on a CUDA tensor,
    by the plain version on a CPU one."""
    if x3d.dtype != torch.float32 or x3d.dim() != 3 or \
            x3d.shape[1] != LANES:
        raise ValueError(f"x3d must be float32 (qx, {LANES}, S), got "
                         f"{x3d.dtype} {tuple(x3d.shape)}")
    if x3d.device.type == "cpu":
        return split_operand_plain(x3d)
    if x3d.device.type != "cuda":
        raise ValueError(f"unsupported device {x3d.device}")
    from gardenia_tpu_torch.ops import _build
    x3d = x3d.contiguous()
    qx, _, S = x3d.shape
    Sp = padded_columns(S)
    xt = torch.empty((3, qx, LANES, Sp), dtype=torch.bfloat16,
                     device=x3d.device)
    with torch.cuda.device(x3d.device):
        code = _build.lib().gdn_split_bf16x3(
            x3d.data_ptr(), xt.data_ptr(), qx * LANES, S, Sp,
            torch.cuda.current_stream().cuda_stream)
    _build.check(code, "split_operand")
    SPLIT_LAUNCHES["split"] += 1
    return xt


def tc_operand(x3d: torch.Tensor) -> torch.Tensor:
    """x3d (qx, 128, S) as the 'tc' kernel reads it, (terms, qx, 128, Sp)
    bf16: a bf16 operand padded to Sp (one term), an f32 one split into
    three."""
    if x3d.dtype == torch.bfloat16:
        return pad_columns(x3d, padded_columns(x3d.shape[-1]))[None]
    return split_operand(x3d)


def tc_kernel_info(panel_dtype, x_dtype) -> dict:
    """The 'tc' kernel's resources on this card for a panel and operand
    type: registers a thread at launch, local (spilled) bytes a thread,
    shared memory a CTA, stages, CTAs an SM."""
    from gardenia_tpu_torch.ops import _build
    vals = [ctypes.c_int() for _ in range(5)]
    _build.check(_build.lib().gdn_dense_panel_matmul_tc_info(
        _DTYPE_CODE[panel_dtype], 1 if x_dtype == torch.bfloat16 else 3,
        *map(ctypes.byref, vals)), "dense_panel_matmul_tc_info")
    return dict(zip(("registers", "local_bytes", "smem_bytes", "stages",
                     "ctas_per_sm"), (v.value for v in vals)))


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
    return dense_panel_matmul_arrays([(panel, src)], x3d, S)[0]


def dense_panel_matmul_arrays(arrays, x3d: torch.Tensor,
                              S: int) -> list:
    """[dense_panel_matmul(panel, src, x3d, S) for panel, src in arrays],
    with x3d made ready for the 'tc' kernel (tc_operand) once for all the
    arrays that take it."""
    arrays = list(arrays)
    for panel, src in arrays:
        _check(panel, src, x3d, S)
    if x3d.device.type == "cpu":
        return [dense_panel_matmul_plain(panel, src, x3d, S)
                for panel, src in arrays]
    if x3d.device.type != "cuda":
        raise ValueError(f"unsupported device {x3d.device}")
    for panel, src in arrays:
        for name, t in (("panel", panel), ("src", src), ("x3d", x3d)):
            if not t.is_contiguous():
                raise ValueError(f"{name} must be contiguous")
        if panel.data_ptr() % 16:
            raise ValueError("panel must be 16-byte aligned")
    from gardenia_tpu_torch.ops import _build

    so = _build.lib()
    qx = x3d.shape[0]
    ready = {}          # the operand as each route's kernel reads it
    outs = []
    with torch.cuda.device(x3d.device):
        stream = torch.cuda.current_stream().cuda_stream
        for panel, src in arrays:
            route = kernel_route(panel.dtype, x3d.dtype, S)
            R, W = src.shape
            Sp = padded_columns(S) if route == "tc" else S
            out = torch.empty((R, LANES, Sp), dtype=torch.float32,
                              device=x3d.device)
            if R:
                if route not in ready:
                    # f32 panels keep f32 products: a bf16 operand widens
                    ready[route] = (tc_operand(x3d) if route == "tc"
                                    else x3d.float())
                xr = ready[route]
                if route == "tc":
                    code = so.gdn_dense_panel_matmul_tc(
                        panel.data_ptr(), _DTYPE_CODE[panel.dtype],
                        src.data_ptr(), xr.data_ptr(), xr.shape[0],
                        out.data_ptr(), R, W, Sp, qx * LANES, stream)
                else:
                    code = so.gdn_dense_panel_matmul(
                        panel.data_ptr(), _DTYPE_CODE[panel.dtype],
                        src.data_ptr(), xr.data_ptr(), out.data_ptr(), R, W,
                        S, stream)
                _build.check(code, f"dense_panel_matmul ({route})")
                LAUNCHES[route] += 1
            outs.append(crop_columns(out, S))
    return outs
