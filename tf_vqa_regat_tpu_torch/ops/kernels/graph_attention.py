"""Fused masked graph attention (one direction, explicit relations): the CUDA
kernel, its wrapper, its plain PyTorch version and its gradient.

Counterpart of tf_vqa_regat_tpu/ops/pallas/graph_attention.py
(`fused_graph_attention`; kernels `_fwd_kernel_v2`, the one the JAX package
runs, and `_fwd_kernel`, its per-head v1; VJP `_fused_bwd`), with the same
public signature and layouts. The kernel is `csrc/graph_attention.cu`; its
source note says what bounds it on an H100 and what the design does about it.

    out = softmax(q k^T / sqrt(dh) + bias) . vw        per head, over n keys

The bias ([b, R, H, n], or anything that broadcasts to it) arrives
precombined: edge-label bias, adjacency at -9e15, key mask at -9e15. A bias
shared across heads ([b, R, 1, n], as the model builds it) is read through a
head stride of 0 and never copied H-fold.

Softmax semantics. The default (v2) normalises by the row max over ALL heads
with a +1e-30 denominator, as `_fwd_kernel_v2` does: a head whose whole
segment underflows against another head's max gets all-zero weights. With
`per_head=True` (v1) each head takes an exact softmax of its own, so such a
head gets its own softmax (uniform weights when its keys tie). Both give
uniform weights to a row whose keys all sit at the same mask value (an empty
adjacency row, or a padded example). The JAX package runs v2
(`_KERNEL_VERSION = 2`), and so does the model here.

Routing in `fused_graph_attention`:
- grad enabled and an input requiring grad: `GraphAttention`, an autograd
  Function whose forward is the kernel on a CUDA tensor (the plain version
  on a CPU tensor) and whose backward transcribes `_fused_bwd` in PyTorch
  ops on either device (the JAX backward is XLA, outside any Pallas kernel);
- otherwise a CPU tensor runs `graph_attention_plain` and a CUDA tensor
  launches the kernel.
A CUDA call raises on a dtype, shape, device or layout the kernel does not
take; there is no fallback.
"""

from __future__ import annotations

import ctypes
import math

import torch

from tf_vqa_regat_tpu_torch.ops.kernels import build

SOURCE = build.CSRC_DIR / "graph_attention.cu"


def _weights(q, k, bias, per_head):
    """Attention weights [b, R, H, n]: aff = q.k * scale + bias (in that
    order: a non-edge key's aff then rounds to exactly -9e15), normalised by
    the global-max / eps softmax, or per head with `per_head`."""
    scale = 1.0 / math.sqrt(q.shape[3])
    aff = torch.einsum("brhd,bnhd->brhn", q, k) * scale + bias
    if per_head:
        return torch.softmax(aff, dim=-1)
    e = torch.exp(aff - aff.amax(dim=(2, 3), keepdim=True))
    return e / (e.sum(dim=-1, keepdim=True) + 1e-30)


def graph_attention_plain(
    q: torch.Tensor,  # [b, R, H, dh]
    k: torch.Tensor,  # [b, n, H, dh]
    vw: torch.Tensor,  # [b, n, H, o]
    bias: torch.Tensor,  # broadcastable to [b, R, H, n]
    per_head: bool = False,
) -> torch.Tensor:  # [b, R, H, o]
    """The kernel's function in PyTorch ops, on any device."""
    return torch.einsum("brhn,bnho->brho", _weights(q, k, bias, per_head), vw)


def graph_attention_backward(g, q, k, vw, bias, per_head):
    """(dq, dk, dvw, daff [b, R, H, n]) for the output cotangent g
    [b, R, H, o]: `_fused_bwd` in PyTorch ops, the weights recomputed."""
    scale = 1.0 / math.sqrt(q.shape[3])
    w = _weights(q, k, bias, per_head)
    dvw = torch.einsum("brhn,brho->bnho", w, g)
    dw = torch.einsum("brho,bnho->brhn", g, vw)
    daff = w * (dw - torch.sum(w * dw, dim=-1, keepdim=True))
    dq = scale * torch.einsum("brhn,bnhd->brhd", daff, k)
    dk = scale * torch.einsum("brhn,brhd->bnhd", daff, q)
    return dq, dk, dvw, daff


class _Kernel:
    """The compiled kernel, built at first launch, and its launch counts:
    `launches` of the global-max (v2) mode, `per_head_launches` of v1."""

    def __init__(self):
        self.launches = 0
        self.per_head_launches = 0
        self._lib = None

    def lib(self) -> ctypes.CDLL:
        if self._lib is None:
            lib = build.load(SOURCE)
            p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
            lib.regat_graph_attention_fwd.argtypes = (
                [p] * 5 + [i] * 3 + [f] + [i] * 7 + [p]
            )
            lib.regat_graph_attention_fwd.restype = i
            lib.regat_graph_attention_smem_bytes.argtypes = [i] * 3
            lib.regat_graph_attention_smem_bytes.restype = ctypes.c_size_t
            self._lib = lib
        return self._lib

    def __call__(self, q, k, vw, bias, per_head=False):
        """out [b, R, H, o]; `bias` broadcastable to [b, R, H, n]."""
        if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, vw, bias)):
            # the launch is opaque to autograd: its output would have no grad_fn
            raise RuntimeError(
                "the kernel would drop a gradient: call fused_graph_attention "
                "(which routes through GraphAttention) or run under torch.no_grad()"
            )
        b, R, H, dh = q.shape
        n, o = k.shape[1], vw.shape[3]
        dev = q.device
        f32 = torch.float32
        _check("q", q, (b, R, H, dh), f32, dev)
        _check("k", k, (b, n, H, dh), f32, dev)
        _check("vw", vw, (b, n, H, o), f32, dev)
        bias = _expand_bias(bias, (b, R, H, n))
        if bias.device != dev or bias.dtype != f32:
            raise ValueError(f"bias is {bias.dtype} on {bias.device}, expected {f32} on {dev}")
        lib = self.lib()
        smem = lib.regat_graph_attention_smem_bytes(H, dh, n)
        if smem > 227 * 1024:
            raise ValueError(f"shapes need {smem} B of shared memory per block")
        out = torch.empty((b, R, H, o), dtype=f32, device=dev)
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            err = lib.regat_graph_attention_fwd(
                q.data_ptr(), k.data_ptr(), vw.data_ptr(), bias.data_ptr(), out.data_ptr(),
                bias.stride(0), bias.stride(1), bias.stride(2),
                1.0 / math.sqrt(dh), b, R, n, H, dh, o, int(per_head), stream,
            )
        if err != 0:
            raise RuntimeError(f"graph attention kernel launch failed: CUDA error {err}")
        if per_head:
            self.per_head_launches += 1
        else:
            self.launches += 1
        return out


def _expand_bias(bias: torch.Tensor, shape) -> torch.Tensor:
    """`bias` as a [b, R, H, n] view: broadcast axes get stride 0 (nothing is
    copied); keys must be contiguous, so a bias broadcast along the key axis
    is copied."""
    bias = bias.expand(shape)
    return bias if bias.stride(3) == 1 else bias.contiguous()


def _check(name, t, shape, dtype, device):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} is {t.dtype}, the kernel takes {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


KERNEL = _Kernel()


class GraphAttention(torch.autograd.Function):
    """The fused attention with its gradient (`_fused` with its custom VJP):
    forward through the kernel, backward by `graph_attention_backward`.
    dbias = daff, summed back over the axes the bias was broadcast along (the
    head axis for the model's shared bias)."""

    @staticmethod
    def forward(ctx, q, k, vw, bias, per_head):
        if q.device.type == "cuda":
            out = KERNEL(q, k, vw, bias, per_head)
        elif q.device.type == "cpu":
            out = graph_attention_plain(q, k, vw, bias, per_head)
        else:
            raise ValueError(f"no graph attention kernel for device {q.device}")
        ctx.save_for_backward(q, k, vw, bias)
        ctx.per_head = per_head
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, vw, bias = ctx.saved_tensors
        dq, dk, dvw, daff = graph_attention_backward(
            g.contiguous(), q, k, vw, bias, ctx.per_head
        )
        dbias = daff.sum_to_size(bias.shape) if ctx.needs_input_grad[3] else None
        return dq, dk, dvw, dbias, None


def fused_graph_attention(
    q: torch.Tensor,  # [b, R, H, dh]
    k: torch.Tensor,  # [b, n, H, dh]
    vw: torch.Tensor,  # [b, n, H, o]  V pre-projected by the grouped kernel
    bias: torch.Tensor,  # broadcastable to [b, R, H, n], f32
    per_head: bool = False,  # v1's per-head softmax instead of v2's global max
) -> torch.Tensor:  # [b, R, H, o]
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, vw, bias)):
        return GraphAttention.apply(q, k, vw, bias, per_head)
    if q.device.type == "cpu":
        return graph_attention_plain(q, k, vw, bias, per_head)
    if q.device.type != "cuda":
        raise ValueError(f"no graph attention kernel for device {q.device}")
    return KERNEL(q, k, vw, bias, per_head)
