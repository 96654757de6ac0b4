"""Dropout applied from its uint8 draw: the CUDA kernel, its wrapper, its
plain PyTorch version and the autograd Function around them.

No Pallas kernel of the JAX package corresponds (its `nn.dropout` is XLA
elementwise code). nn.py::dropout draws the bits and calls `Dropout`; this
module computes, for a drop threshold t and a scale,

    out = bits >= t ? x * scale : 0

forward on x and backward on the output's cotangent dy (what autograd of the
plain version's `where` and `* scale` gives), saving only the uint8 bits in
between. The kernel is `csrc/dropout.cu`; its source note says why it exists
and what bounds it.

Routing in `drop`: a CUDA tensor launches the kernel (f32 or bf16, below
2**31 elements; anything else raises, with no fallback), a CPU tensor runs
`dropout_plain`, the `torch.where` formulation, unchanged. The kernel takes
x and the bits as rows of contiguous elements, one row stride each
(`launch_rows`: the key projection's `roi[:, :n]`, a slice of the label
drop's roi axis, a tensor-parallel part of the bits); a tensor of any
other layout is copied to a contiguous one first. Its output is
contiguous, as the plain version's is: the `where` takes its layout from
the mask, which is drawn contiguous in x's shape or sliced along its last
axis. Each launch counts in `launch.counter("dropout")` under "forward" or
"backward".
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from tf_vqa_regat_tpu_torch.ops.kernels import build, launch

SOURCE = build.CSRC_DIR / "dropout.cu"

# the kernel's indices are 32-bit
MAX_NUMEL = 2**31 - 1
DTYPES = {torch.float32: 0, torch.bfloat16: 1}

_P, _L, _I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
LIB = launch.Library(
    SOURCE,
    {"regat_dropout": ([_P, _P, _P, _L, _L, _L, _L, _I, _I, ctypes.c_float, _P], _I)})
# launches by "forward" / "backward"
COUNTS = launch.counter("dropout")


def rows(t: torch.Tensor, n: int) -> Optional[torch.Tensor]:
    """t as a view of `n` rows whose elements are contiguous (one row
    stride), or None where its layout has no such view."""
    try:
        v = t.view(n, -1)
    except RuntimeError:
        return None
    return v if v.shape[1] == 1 or v.stride(1) == 1 else None


def launch_rows(x: torch.Tensor, bits: torch.Tensor):
    """(x, bits) as views of the same rows for the kernel: the rows of the
    fewest leading axes both have a view of (none: one row, where both are
    contiguous), else contiguous copies as one row. Raises where the kernel
    does not take them."""
    if x.dtype not in DTYPES:
        raise ValueError(f"the dropout kernel takes {sorted(map(str, DTYPES))}, not {x.dtype}")
    if bits.dtype != torch.uint8 or bits.shape != x.shape:
        raise ValueError(f"bits are {bits.dtype}{tuple(bits.shape)}, the kernel takes uint8 "
                         f"of x's shape {tuple(x.shape)}")
    if x.numel() > MAX_NUMEL:
        raise ValueError(f"{x.numel()} elements exceed the dropout kernel's 32-bit indices")
    for k in range(x.dim()):
        n = math.prod(x.shape[:k])
        xr, br = rows(x, n), rows(bits, n)
        if xr is not None and br is not None:
            return xr, br
    return x.contiguous().view(1, -1), bits.contiguous().view(1, -1)


def dropout_plain(x: torch.Tensor, bits: torch.Tensor, t: int, scale: float) -> torch.Tensor:
    """What the kernel computes, as PyTorch ops (nn.py's formulation): x *
    scale where bits >= t, 0 elsewhere."""
    return torch.where(bits >= t, x * scale, torch.zeros_like(x))


def kernel(x: torch.Tensor, bits: torch.Tensor, t: int, scale: float,
           direction: str) -> torch.Tensor:
    """bits >= t ? x * scale : 0 by one launch of the kernel, as a new
    contiguous tensor; `direction` ("forward": x is the input; "backward":
    x is the output's cotangent) names the launch in `COUNTS`."""
    launch.check_tensors(x.device, (("bits", bits, torch.uint8, None),))
    out = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    if x.numel():
        xr, br = launch_rows(x, bits)
        LIB.launch(f"dropout {direction}", "regat_dropout", x.device, xr.data_ptr(),
                   br.data_ptr(), out.data_ptr(), xr.shape[0], xr.shape[1], xr.stride(0),
                   br.stride(0), DTYPES[x.dtype], t, scale)
        COUNTS[direction] += 1
    return out


def drop(x: torch.Tensor, bits: torch.Tensor, t: int, scale: float,
         direction: str) -> torch.Tensor:
    """bits >= t ? x * scale : 0: the kernel on a CUDA tensor, the plain
    version on a CPU tensor."""
    if x.device.type == "cuda":
        return kernel(x, bits, t, scale, direction)
    if x.device.type == "cpu":
        return dropout_plain(x, bits, t, scale)
    raise ValueError(f"no dropout kernel for device {x.device}")


class Dropout(torch.autograd.Function):
    """Dropout from its draw: Dropout.apply(x, bits, t, scale) -> out. The
    backward applies the same function to the cotangent, from the saved
    bits alone."""

    @staticmethod
    def forward(ctx, x, bits, t, scale):
        ctx.save_for_backward(bits)
        ctx.t, ctx.scale = t, scale
        return drop(x, bits, t, scale, "forward")

    @staticmethod
    def backward(ctx, dy):
        (bits,) = ctx.saved_tensors
        return drop(dy, bits, ctx.t, ctx.scale, "backward"), None, None, None
