"""Fused implicit graph attention (one direction): the CUDA kernel, its wrapper
and its plain PyTorch version.

Counterpart of tf_vqa_regat_tpu/ops/pallas/implicit_attention.py
(`fused_implicit_graph_attention`, kernel `_kernel_v3`), with the same public
signature and layouts. The kernel is `csrc/implicit_attention.cu`; its source
note says what bounds it on an H100 and what the design does about it.

- A CPU tensor runs `implicit_attention_plain`, the same function in PyTorch
  ops.
- A CUDA tensor launches the kernel, or the call raises on a dtype, shape,
  device or layout the kernel does not take. There is no fallback.

Both follow the TPU kernel's semantics, not `softmax`'s: the weights are
normalised by the row max over ALL heads with a +1e-30 denominator, so a head
whose segment underflows against that max gets zeros (a per-head softmax
would give uniform weights), and a fully masked row gets uniform weights.
The sinusoid's per-lane frequency is the TPU kernel's single f32 constant
100 * 1000^(-8j/P) (`_rep_matrix`), so the argument is rounded once.

Forward only: serving needs no gradient. The training slice adds a
`torch.autograd.Function` whose backward transcribes `_fused_v3_bwd`.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional

import numpy as np
import torch

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
    inverse keep rate) — the kernel's extra inputs, shared by both versions."""
    if key_mask is None:
        raise ValueError("key_mask is required ([b, n] bool)")
    mrow = torch.where(key_mask.to(device=device, dtype=torch.bool), 0.0, NEG_INF)
    b_vec = (
        torch.zeros(H, dtype=torch.float32, device=device)
        if b_pos is None
        else b_pos
    )
    keep, inv_keep = None, 1.0
    if dropmask is not None and drop_rate > 0.0:
        # nn.dropout's quantised t/256 drop probability (nn.py)
        t = min(255, max(1, int(round(drop_rate * 256.0))))
        keep, inv_keep = dropmask, 256.0 / (256 - t)
    return mrow, b_vec, keep, inv_keep


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
) -> torch.Tensor:  # [b, R, H, o]
    """The kernel's function in PyTorch ops, on any device."""
    dh, H, P = q.shape[3], q.shape[2], w_pos.shape[0]
    mrow, b_vec, keep, inv_keep = _prepare(
        H, b_pos, key_mask, drop_rate, dropmask, q.device
    )
    lane = torch.arange(P, device=q.device)
    x = pos_mat[..., lane // (P // 4)] * _lane_frequencies_on(P, q.device)  # [b, R, n, P]
    pe = torch.where(lane % (P // 4) >= P // 8, torch.cos(x), torch.sin(x))
    if keep is not None:
        pe = pe * (keep.to(torch.float32) * inv_keep)
    pw = torch.einsum("brnp,ph->brhn", pe, w_pos) + b_vec[:, None]
    bias = torch.log(torch.clamp(torch.relu(pw), min=1e-6)) + mrow[:, None, None, :]
    aff = torch.einsum("brhd,bnhd->brhn", q, k) * (1.0 / math.sqrt(dh)) + bias
    e = torch.exp(aff - aff.amax(dim=(2, 3), keepdim=True))
    w = e / (e.sum(dim=-1, keepdim=True) + 1e-30)
    return torch.einsum("brhn,bnho->brho", w, vw)


class _Kernel:
    """The compiled kernel, built at first launch, and its launch count."""

    def __init__(self):
        self.launches = 0
        self._lib = None

    def lib(self) -> ctypes.CDLL:
        if self._lib is None:
            lib = build.load(SOURCE)
            p, i = ctypes.c_void_p, ctypes.c_int
            f = ctypes.c_float
            lib.regat_implicit_attention_fwd.argtypes = (
                [p] * 9 + [f, f, p] + [i] * 7 + [p]
            )
            lib.regat_implicit_attention_fwd.restype = i
            lib.regat_implicit_attention_smem_bytes.argtypes = [i] * 4
            lib.regat_implicit_attention_smem_bytes.restype = ctypes.c_size_t
            self._lib = lib
        return self._lib

    def __call__(self, q, k, vw, pos_mat, w_pos, b_pos, key_mask, drop_rate, dropmask):
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
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            err = lib.regat_implicit_attention_fwd(
                q.data_ptr(), k.data_ptr(), vw.data_ptr(), pos_mat.data_ptr(),
                w_pos.data_ptr(), b_vec.data_ptr(), mrow.data_ptr(),
                _lane_frequencies_on(P, dev).data_ptr(),
                keep.data_ptr() if keep is not None else None,
                inv_keep, 1.0 / math.sqrt(dh), out.data_ptr(),
                b, R, n, H, dh, o, P, stream,
            )
        if err != 0:
            raise RuntimeError(f"implicit attention kernel launch failed: CUDA error {err}")
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
    if q.device.type == "cpu":
        return implicit_attention_plain(
            q, k, vw, pos_mat, w_pos, b_pos, key_mask, drop_rate, dropmask
        )
    if q.device.type != "cuda":
        raise ValueError(f"no implicit attention kernel for device {q.device}")
    return KERNEL(q, k, vw, pos_mat, w_pos, b_pos, key_mask, drop_rate, dropmask)
