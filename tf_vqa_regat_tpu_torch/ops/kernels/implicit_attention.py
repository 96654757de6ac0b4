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
take, and on shapes whose tiling plan does not fit (`tiling_plan`); any call
raises where a gradient would be dropped (w.r.t. the position matrix) or a
dropout rate comes without its mask. There is no fallback.

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

import collections
import ctypes
import functools
import math
from typing import Optional

import numpy as np
import torch

from tf_vqa_regat_tpu_torch.nn import drop_threshold
from tf_vqa_regat_tpu_torch.ops.kernels import build
from tf_vqa_regat_tpu_torch.ops.kernels import graph_attention as ga

NEG_INF = -9e15  # additive key mask (reference graph_att_layer.py:95)
SOURCE = build.CSRC_DIR / "implicit_attention.cu"
MAX_HEADS = 16  # the kernel's kMaxHeads: pos-FC sums a thread keeps in registers


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
    keep, inv_keep = _keep(drop_rate, dropmask)
    mrow = torch.where(key_mask.to(device=device, dtype=torch.bool), 0.0, NEG_INF)
    b_vec = (
        torch.zeros(H, dtype=torch.float32, device=device)
        if b_pos is None
        else b_pos
    )
    return mrow, b_vec, keep, inv_keep


def _keep(drop_rate, dropmask):
    """(keep-mask or None, inverse keep rate) for a dropout rate and its
    [b, R, n, P] uint8 keep-mask."""
    if drop_rate > 0.0 and dropmask is None:
        raise ValueError(f"drop_rate {drop_rate} needs its [b, R, n, P] uint8 keep-mask")
    if dropmask is not None and drop_rate > 0.0:
        # nn.dropout's quantised t/256 drop probability
        return dropmask, 256.0 / (256 - drop_threshold(drop_rate))
    return None, 1.0


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


def _up4(x: int) -> int:
    return -(-x // 4) * 4


def smem_bytes(H: int, dh: int, n: int, o: int, P: int) -> int:
    """Shared memory of one block (the kernel's `Layout`): K [H, n, dh] (B2
    pads its rows to dh+4; B1 rotates them instead) and VW [nP, H, o]; the
    pos-FC kernel in f64 [P, H] with 64 bytes between its two lane halves,
    its bias [H] (rounded up to 4), the lane frequencies [P] and the key-mask
    row [nP]; and per group a q tile [TILE, H, dh+4], the bias / weights
    [TILE, H, nP] and the row maxima [TILE] (rounded up to 4), in f32
    words; nP = n rounded up to 4."""
    nP, dP = _up4(n), dh + 4
    group = ga.TILE * H * dP + ga.TILE * H * nP + _up4(ga.TILE)
    return 4 * (H * n * dh + nP * H * o + 2 * P * H + 16 + _up4(H) + P + nP
                + ga.GROUPS * group)


def tiling_plan(b: int, R: int, n: int, H: int, dh: int, o: int, P: int) -> ga.TilingPlan:
    """The launch's plan for q [b, R, H, dh], k [b, n, H, dh], vw [b, n, H, o]
    and a pos-FC kernel [P, H]: B2's chunk rule (`ga.chunk_rows`), this
    kernel's shared memory. Raises ValueError on a shape the kernel does not
    take, before anything is built."""
    if min(b, R, n, H, dh, o, P) < 1:
        raise ValueError(f"empty implicit attention: b={b} R={R} n={n} H={H} dh={dh} o={o} P={P}")
    if dh % 4 or o % 4:
        raise ValueError(f"the kernel reads 16-byte vectors: dh={dh} and o={o} must be "
                         "multiples of 4")
    if P % 32:
        raise ValueError(f"pos embedding width {P}: the kernel reads the keep-mask of a "
                         "geometry's sin and cos lanes as 32-bit words, so P must be a "
                         "multiple of 32")
    if H % 4 or H > MAX_HEADS:
        raise ValueError(f"{H} heads: the kernel keeps up to {MAX_HEADS} pos-FC sums per "
                         "thread and reads them 4 at a time")
    smem = smem_bytes(H, dh, n, o, P)
    if smem > ga.SMEM_LIMIT:
        raise ValueError(f"H={H}, dh={dh}, n={n}, o={o}, P={P} need {smem} B of shared memory "
                         f"per block, over the {ga.SMEM_LIMIT} B a block may use")
    rows = ga.chunk_rows(b, R)
    return ga.TilingPlan(rows, (-(-R // rows), b), smem)


class _Launch(ctypes.Structure):
    """The launch's scalars (`IaLaunch` in the source), built once per shape
    and key-mask strides so that a call passes one pointer for them."""

    _fields_ = [(name, ctypes.c_int) for name in
                ("b", "R", "n", "H", "dh", "o", "P", "sm", "rows", "smem")] + [
                ("scale", ctypes.c_float)]


class _Kernel:
    """The compiled kernel, built at first launch, and its launch counts:
    `launches` of the eval variant, `train_launches` of the train variant,
    and both by query rows R in `launches_by_rows[("eval" | "train", R)]`.
    Per-shape work (the checks of shapes, the tiling plan, the launch's
    scalars, the shared-memory attribute per device) is done once and
    cached."""

    def __init__(self):
        self.launches = 0
        self.train_launches = 0
        self.launches_by_rows = collections.Counter()
        self._lib = None
        self._launch_args = {}  # shapes and key-mask strides -> _Launch
        self._smem_set = {}  # device index -> dynamic shared memory allowed

    def lib(self) -> ctypes.CDLL:
        if self._lib is None:
            lib = build.load(SOURCE)
            p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
            lib.regat_implicit_attention_fwd.argtypes = [p] * 9 + [f] + [p] * 4
            lib.regat_implicit_attention_fwd.restype = i
            lib.regat_implicit_attention_smem_bytes.argtypes = [i] * 5
            lib.regat_implicit_attention_smem_bytes.restype = ctypes.c_size_t
            lib.regat_implicit_attention_set_smem.argtypes = [i]
            lib.regat_implicit_attention_set_smem.restype = i
            # the plan's shared memory must be the kernel's
            for shape in ((16, 64, 20, 64, 64), (4, 8, 10, 12, 32), (12, 4, 1, 4, 96)):
                want = lib.regat_implicit_attention_smem_bytes(*shape)
                if smem_bytes(*shape) != want:
                    raise RuntimeError(f"tiling plan and kernel disagree on shared memory "
                                       f"for (H, dh, n, o, P) = {shape}: {smem_bytes(*shape)} "
                                       f"vs {want}")
            self._lib = lib
        return self._lib

    def _args(self, q, k, vw, pos_mat, w_pos, b_pos, key_mask, keep) -> _Launch:
        """The launch's scalars for these inputs, after the checks that depend
        only on shapes and the key mask's strides (cached with them). The key
        mask may be a slice of a wider one, as the model's is: its keys must
        be contiguous, its rows may be any stride apart."""
        key = (q.shape, k.shape, vw.shape, pos_mat.shape, w_pos.shape,
               None if b_pos is None else b_pos.shape, key_mask.shape, key_mask.stride(),
               None if keep is None else keep.shape)
        args = self._launch_args.get(key)
        if args is None:
            b, R, H, dh = q.shape
            n, o, P = k.shape[1], vw.shape[3], w_pos.shape[0]
            want = [("k", k, (b, n, H, dh)), ("vw", vw, (b, n, H, o)),
                    ("pos_mat", pos_mat, (b, R, n, 4)), ("w_pos", w_pos, (P, H)),
                    ("key_mask", key_mask, (b, n)), ("b_pos", b_pos, (H,)),
                    ("dropmask", keep, (b, R, n, P))]
            for name, t, shape in want:
                if t is not None and tuple(t.shape) != shape:
                    raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
            if n > 1 and key_mask.stride(1) != 1 or key_mask.stride(0) >= 2**31:
                raise ValueError(f"key_mask strides {key_mask.stride()}: its keys must be "
                                 "contiguous")
            plan = tiling_plan(b, R, n, H, dh, o, P)
            args = self._launch_args[key] = _Launch(
                b, R, n, H, dh, o, P, key_mask.stride(0), plan.rows, plan.smem_bytes,
                1.0 / math.sqrt(dh))
        return args

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
        if key_mask is None:
            raise ValueError("key_mask is required ([b, n] bool)")
        keep, inv_keep = _keep(drop_rate, dropmask)
        args = self._args(q, k, vw, pos_mat, w_pos, b_pos, key_mask, keep)
        dev, f32 = q.device, torch.float32
        # (name, tensor, dtype, alignment the kernel's vector reads need; None:
        # the key mask, whose layout `_args` checked)
        for name, t, dtype, align in (
            ("q", q, f32, 16), ("k", k, f32, 16), ("vw", vw, f32, 16),
            ("pos_mat", pos_mat, f32, 16), ("w_pos", w_pos, f32, 4), ("b_pos", b_pos, f32, 4),
            ("key_mask", key_mask, torch.bool, None), ("dropmask", keep, torch.uint8, 4),
        ):
            if t is None:
                continue
            if t.device != dev or t.dtype != dtype:
                raise ValueError(f"{name} is {t.dtype} on {t.device}, the kernel takes {dtype} "
                                 f"on {dev}")
            if align is not None and (not t.is_contiguous() or t.data_ptr() % align):
                raise ValueError(f"{name} must be contiguous and {align}-byte aligned")
        lib = self.lib()
        if dev.index != torch.cuda.current_device():
            with torch.cuda.device(dev):
                return self(q, k, vw, pos_mat, w_pos, b_pos, key_mask, drop_rate, dropmask,
                            save_pwr)
        if self._smem_set.get(dev.index, 0) < args.smem:
            err = lib.regat_implicit_attention_set_smem(args.smem)
            if err != 0:
                raise RuntimeError(f"implicit attention kernel: {args.smem} B of shared memory "
                                   f"refused: CUDA error {err}")
            self._smem_set[dev.index] = args.smem
        out = q.new_empty((args.b, args.R, args.H, args.o))
        pwr = q.new_empty((args.b, args.R, args.H, args.n)) if save_pwr else None
        err = lib.regat_implicit_attention_fwd(
            q.data_ptr(), k.data_ptr(), vw.data_ptr(), pos_mat.data_ptr(), w_pos.data_ptr(),
            None if b_pos is None else b_pos.data_ptr(), key_mask.data_ptr(),
            _lane_frequencies_on(args.P, dev).data_ptr(),
            None if keep is None else keep.data_ptr(), inv_keep,
            out.data_ptr(), None if pwr is None else pwr.data_ptr(), ctypes.addressof(args),
            # the raw handle of the current stream (what `.cuda_stream` gives,
            # without building a Stream object on every call)
            torch._C._cuda_getCurrentRawStream(dev.index),
        )
        if err != 0:
            raise RuntimeError(f"implicit attention kernel launch failed: CUDA error {err}")
        self.launches_by_rows["train" if save_pwr else "eval", args.R] += 1
        if save_pwr:
            self.train_launches += 1
            return out, pwr
        self.launches += 1
        return out


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
