"""Fused implicit graph attention (one direction): the CUDA kernel, its wrapper,
its plain PyTorch version and its gradient.

Counterpart of tf_vqa_regat_tpu/ops/pallas/implicit_attention.py
(`fused_implicit_graph_attention`, kernel `_kernel_v3`, VJP `_fused_v3_fwd` /
`_fused_v3_bwd`), with the same public signature and layouts. The kernel is
`csrc/implicit_attention.cu`; its source note says what bounds it on an H100
and what the design does about it. It has two variants: eval, and train,
which also stores the post-relu pos weights `pwr` for the backward.

Routing in `fused_implicit_graph_attention`:
- grad enabled and an input requiring grad: `ImplicitAttention`, an
  autograd Function whose forward is the train variant on a CUDA tensor (the
  plain version on a CPU tensor) and whose backward transcribes
  `_fused_v3_bwd` in PyTorch ops on either device;
- otherwise a CPU tensor runs `implicit_attention_plain`, the same function
  in PyTorch ops, and a CUDA tensor launches the eval variant.
A CUDA call raises on a dtype, shape, device or layout the kernel does not
take, and any call raises where a gradient would be dropped (w.r.t. the
position matrix) or a dropout rate comes without its mask.
There is no fallback.

Both versions follow the TPU kernel's semantics, not `softmax`'s: the weights
are normalised by the row max over ALL heads with a +1e-30 denominator, so a
head whose segment underflows against that max gets zeros (a per-head softmax
would give uniform weights), and a fully masked row gets uniform weights.
The sinusoid's per-lane frequency is the TPU kernel's single f32 constant
100 * 1000^(-8j/P) (`_rep_matrix`), so the argument is rounded once.

The backward is plain PyTorch because the JAX package's is XLA, outside any
Pallas kernel; a fused backward kernel is a later performance item.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional

import numpy as np
import torch

from tf_vqa_regat_tpu_torch.nn import drop_threshold
from tf_vqa_regat_tpu_torch.ops.kernels import build

NEG_INF = -9e15  # additive key mask (reference graph_att_layer.py:95)
SOURCE = build.CSRC_DIR / "implicit_attention.cu"


def lane_frequencies(P: int, wave_length: float = 1000.0) -> np.ndarray:
    """[P] f32: lane p's sinusoid frequency, 100 * wave^(-(8/P) * (j % k)),
    with k = P/8 and j = p % (P/4); computed in float64 and rounded once, as
    the TPU kernel's `_rep_matrix` does."""
    k = P // 8
    j = np.arange(P) % (2 * k)
    return np.asarray(100.0 * wave_length ** (-(8.0 / P) * (j % k)), np.float32)


@functools.lru_cache(maxsize=None)
def _lane_frequencies_on(P: int, device: torch.device) -> torch.Tensor:
    """`lane_frequencies(P)` on `device`, copied there once."""
    return torch.from_numpy(lane_frequencies(P)).to(device)


def _prepare(H, b_pos, key_mask, drop_rate, dropmask, device):
    """(additive key mask [b, n], pos-FC bias [H], keep-mask or None,
    inverse keep rate) — the kernel's extra inputs, shared by all versions."""
    if key_mask is None:
        raise ValueError("key_mask is required ([b, n] bool)")
    if drop_rate > 0.0 and dropmask is None:
        raise ValueError(f"drop_rate {drop_rate} needs its [b, R, n, P] uint8 keep-mask")
    mrow = torch.where(key_mask.to(device=device, dtype=torch.bool), 0.0, NEG_INF)
    b_vec = (
        torch.zeros(H, dtype=torch.float32, device=device)
        if b_pos is None
        else b_pos
    )
    keep, inv_keep = None, 1.0
    if dropmask is not None and drop_rate > 0.0:
        # nn.dropout's quantised t/256 drop probability
        keep, inv_keep = dropmask, 256.0 / (256 - drop_threshold(drop_rate))
    return mrow, b_vec, keep, inv_keep


def _embedding(pos_mat: torch.Tensor, P: int, keep, inv_keep) -> torch.Tensor:
    """[b, R, n, 4] -> the kernel's sinusoid embedding [b, R, n, P], with the
    keep-mask applied."""
    lane = torch.arange(P, device=pos_mat.device)
    x = pos_mat[..., lane // (P // 4)] * _lane_frequencies_on(P, pos_mat.device)
    pe = torch.where(lane % (P // 4) >= P // 8, torch.cos(x), torch.sin(x))
    if keep is not None:
        pe = pe * (keep.to(torch.float32) * inv_keep)
    return pe


def _weights(q, k, pwr, mrow):
    """Attention weights [b, R, H, n] from the post-relu pos weights: the
    global-max / eps softmax of QK^T/sqrt(dh) + log(max(pwr, 1e-6)) + mask."""
    bias = torch.log(torch.clamp(pwr, min=1e-6)) + mrow[:, None, None, :]
    aff = torch.einsum("brhd,bnhd->brhn", q, k) * (1.0 / math.sqrt(q.shape[3])) + bias
    e = torch.exp(aff - aff.amax(dim=(2, 3), keepdim=True))
    return e / (e.sum(dim=-1, keepdim=True) + 1e-30)


def implicit_attention_plain(
    q: torch.Tensor,  # [b, R, H, dh]
    k: torch.Tensor,  # [b, n, H, dh]
    vw: torch.Tensor,  # [b, n, H, o]
    pos_mat: torch.Tensor,  # [b, R, n, 4]
    w_pos: torch.Tensor,  # [P, H] weight-normed pos-FC kernel
    b_pos: Optional[torch.Tensor],  # [H] or None
    key_mask: torch.Tensor,  # [b, n] bool
    drop_rate: float = 0.0,
    dropmask: Optional[torch.Tensor] = None,  # [b, R, n, P] uint8 keep-mask
    save_pwr: bool = False,
):
    """The kernel's function in PyTorch ops, on any device: out [b, R, H, o],
    or (out, pwr [b, R, H, n]) with `save_pwr`, as the train variant."""
    H, P = q.shape[2], w_pos.shape[0]
    mrow, b_vec, keep, inv_keep = _prepare(
        H, b_pos, key_mask, drop_rate, dropmask, q.device
    )
    pe = _embedding(pos_mat, P, keep, inv_keep)
    pwr = torch.relu(torch.einsum("brnp,ph->brhn", pe, w_pos) + b_vec[:, None])
    out = torch.einsum("brhn,bnho->brho", _weights(q, k, pwr, mrow), vw)
    return (out, pwr) if save_pwr else out


def implicit_attention_backward(g, q, k, vw, pos_mat, w_pos, mrow, keep, inv_keep, pwr):
    """(dq, dk, dvw, dw_pos, db_pos) for the output cotangent g [b, R, H, o]:
    `_fused_v3_bwd` in PyTorch ops. The embedding and the weights are
    recomputed; dW_pos and db_pos are taken directly, where the JAX package
    reaches w_pos through its block-scattered kernel."""
    scale = 1.0 / math.sqrt(q.shape[3])
    w = _weights(q, k, pwr, mrow)
    dvw = torch.einsum("brhn,brho->bnho", w, g)
    dw = torch.einsum("brho,bnho->brhn", g, vw)
    daff = w * (dw - torch.sum(w * dw, dim=-1, keepdim=True))
    dq = scale * torch.einsum("brhn,bnhd->brhd", daff, k)
    dk = scale * torch.einsum("brhn,brhd->bnhd", daff, q)
    # d log(max(relu(x), 1e-6)): nonzero only where pwr > 1e-6
    dpwr = torch.where(pwr > 1e-6, daff / pwr, torch.zeros_like(daff))
    pe = _embedding(pos_mat, w_pos.shape[0], keep, inv_keep)
    dw_pos = torch.einsum("brnp,brhn->ph", pe, dpwr)
    db_pos = dpwr.sum(dim=(0, 1, 3))
    return dq, dk, dvw, dw_pos, db_pos


class _Kernel:
    """The compiled kernel, built at first launch, and its launch counts:
    `launches` of the eval variant, `train_launches` of the train variant."""

    def __init__(self):
        self.launches = 0
        self.train_launches = 0
        self._lib = None

    def lib(self) -> ctypes.CDLL:
        if self._lib is None:
            lib = build.load(SOURCE)
            p, i = ctypes.c_void_p, ctypes.c_int
            f = ctypes.c_float
            lib.regat_implicit_attention_fwd.argtypes = (
                [p] * 9 + [f, f, p, p] + [i] * 7 + [p]
            )
            lib.regat_implicit_attention_fwd.restype = i
            lib.regat_implicit_attention_smem_bytes.argtypes = [i] * 4
            lib.regat_implicit_attention_smem_bytes.restype = ctypes.c_size_t
            self._lib = lib
        return self._lib

    def __call__(
        self, q, k, vw, pos_mat, w_pos, b_pos, key_mask, drop_rate, dropmask,
        save_pwr=False,
    ):
        """out [b, R, H, o], or (out, pwr [b, R, H, n]) with `save_pwr`
        (the train variant)."""
        if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (q, k, vw, pos_mat, w_pos, b_pos)
        ):
            # the launch is opaque to autograd: its output would have no grad_fn
            raise RuntimeError(
                "the kernel would drop a gradient: call fused_implicit_graph_attention "
                "(which routes through ImplicitAttention) or run under torch.no_grad()"
            )
        b, R, H, dh = q.shape
        n, o, P = k.shape[1], vw.shape[3], w_pos.shape[0]
        dev = q.device
        mrow, b_vec, keep, inv_keep = _prepare(
            H, b_pos, key_mask, drop_rate, dropmask, dev
        )
        if P % 8:
            raise ValueError(f"pos embedding width {P} must be a multiple of 8")
        f32 = torch.float32
        _check("q", q, (b, R, H, dh), f32, dev)
        _check("k", k, (b, n, H, dh), f32, dev)
        _check("vw", vw, (b, n, H, o), f32, dev)
        _check("pos_mat", pos_mat, (b, R, n, 4), f32, dev)
        _check("w_pos", w_pos, (P, H), f32, dev)
        _check("b_pos", b_vec, (H,), f32, dev)
        _check("key_mask", mrow, (b, n), f32, dev)
        if keep is not None:
            _check("dropmask", keep, (b, R, n, P), torch.uint8, dev)
        lib = self.lib()
        smem = lib.regat_implicit_attention_smem_bytes(n, H, dh, P)
        if smem > 227 * 1024:
            raise ValueError(f"shapes need {smem} B of shared memory per block")
        out = torch.empty((b, R, H, o), dtype=f32, device=dev)
        pwr = torch.empty((b, R, H, n), dtype=f32, device=dev) if save_pwr else None
        if pwr is not None:
            _check("pwr", pwr, (b, R, H, n), f32, dev)
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            err = lib.regat_implicit_attention_fwd(
                q.data_ptr(), k.data_ptr(), vw.data_ptr(), pos_mat.data_ptr(),
                w_pos.data_ptr(), b_vec.data_ptr(), mrow.data_ptr(),
                _lane_frequencies_on(P, dev).data_ptr(),
                keep.data_ptr() if keep is not None else None,
                inv_keep, 1.0 / math.sqrt(dh), out.data_ptr(),
                pwr.data_ptr() if pwr is not None else None,
                b, R, n, H, dh, o, P, stream,
            )
        if err != 0:
            raise RuntimeError(f"implicit attention kernel launch failed: CUDA error {err}")
        if save_pwr:
            self.train_launches += 1
            return out, pwr
        self.launches += 1
        return out


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


class ImplicitAttention(torch.autograd.Function):
    """The fused attention with its gradient (`_fused_v3` with its custom VJP):
    forward through the train variant, which keeps `pwr`; backward by
    `implicit_attention_backward`. No gradient w.r.t. the position matrix,
    the key mask or the keep-mask."""

    @staticmethod
    def forward(ctx, q, k, vw, pos_mat, w_pos, b_pos, key_mask, drop_rate, dropmask):
        args = (q, k, vw, pos_mat, w_pos, b_pos, key_mask, drop_rate, dropmask)
        if q.device.type == "cuda":
            out, pwr = KERNEL(*args, save_pwr=True)
        elif q.device.type == "cpu":
            out, pwr = implicit_attention_plain(*args, save_pwr=True)
        else:
            raise ValueError(f"no implicit attention kernel for device {q.device}")
        mrow, _, keep, inv_keep = _prepare(
            q.shape[2], b_pos, key_mask, drop_rate, dropmask, q.device
        )
        ctx.save_for_backward(q, k, vw, pos_mat, w_pos, mrow, keep, pwr)
        ctx.inv_keep = inv_keep
        ctx.has_b_pos = b_pos is not None
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, vw, pos_mat, w_pos, mrow, keep, pwr = ctx.saved_tensors
        dq, dk, dvw, dw_pos, db_pos = implicit_attention_backward(
            g.contiguous(), q, k, vw, pos_mat, w_pos, mrow, keep, ctx.inv_keep, pwr
        )
        return (dq, dk, dvw, None, dw_pos, db_pos if ctx.has_b_pos else None,
                None, None, None)


def fused_implicit_graph_attention(
    q: torch.Tensor,  # [b, R, H, dh]
    k: torch.Tensor,  # [b, n, H, dh]
    vw: torch.Tensor,  # [b, n, H, o]  V pre-projected by the grouped kernel
    pos_mat: torch.Tensor,  # [b, R, n, 4] pairwise position matrix
    w_pos: torch.Tensor,  # [P, H] weight-normed pos-FC kernel
    b_pos: Optional[torch.Tensor],  # [H] pos-FC bias or None
    key_mask: torch.Tensor,  # [b, n] bool
    drop_rate: float = 0.0,
    dropmask: Optional[torch.Tensor] = None,  # [b, R, n, P] uint8 keep-mask
) -> torch.Tensor:  # [b, R, H, o]
    args = (q, k, vw, pos_mat, w_pos, b_pos, key_mask, drop_rate, dropmask)
    if torch.is_grad_enabled():
        if pos_mat.requires_grad:
            raise ValueError(
                "implicit attention has no gradient w.r.t. pos_mat; detach it"
            )
        if any(t is not None and t.requires_grad for t in (q, k, vw, w_pos, b_pos)):
            return ImplicitAttention.apply(*args)
    if q.device.type == "cpu":
        return implicit_attention_plain(*args)
    if q.device.type != "cuda":
        raise ValueError(f"no implicit attention kernel for device {q.device}")
    return KERNEL(*args)
