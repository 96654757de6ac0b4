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
take, and on shapes whose tiling plan does not fit (`tiling_plan`); there is
no fallback.
"""

from __future__ import annotations

import collections
import ctypes
import math
from typing import NamedTuple

import torch

from tf_vqa_regat_tpu_torch.ops.kernels import build
from tf_vqa_regat_tpu_torch.train.profiling import mark

SOURCE = build.CSRC_DIR / "graph_attention.cu"

# The kernel's constants (csrc/graph_attention.cu): thread groups per block
# (each with its own tile buffers) and query rows per tile. The plan aims at
# SMS blocks in flight (an H100 SXM's SMs) within the shared memory one block
# may use.
GROUPS = 2
TILE = 5
SMS = 132
SMEM_LIMIT = 232_448


class TilingPlan(NamedTuple):
    """How one launch cuts the work: a block per `rows` query rows of one
    example (a grid of `grid` = (chunks per example, b) blocks), and the
    dynamic shared memory each block takes."""

    rows: int
    grid: tuple[int, int]
    smem_bytes: int


def smem_bytes(H: int, dh: int, n: int, o: int) -> int:
    """Shared memory of one block (the kernel's `Layout`): K [H, n, dh+4] and
    VW [nP, H, o], and per group a q tile [TILE, H, dh+4], the weights
    [TILE, H, nP] and the maxima [TILE, H] (rounded up to 4), in f32; nP = n
    rounded up to 4."""
    nP, dP = -(-n // 4) * 4, dh + 4
    group = TILE * H * dP + TILE * H * nP + -(-TILE * H // 4) * 4
    return 4 * (H * n * dP + nP * H * o + GROUPS * group)


def chunk_rows(b: int, R: int) -> int:
    """Query rows per block for b examples of R rows, where each block stages
    its example's K and VW once, so the fewer blocks per example the better,
    as long as SMS blocks or more are in flight: the chunk starts at
    R / ceil(SMS / b) rows and shrinks until the grid holds SMS blocks, but
    never below 8 rows (at R=100: a whole example at b=256, 34 rows at b=64,
    20 at b=32, 8 at b <= 8). B1's plan takes the same rule."""
    rows = min(R, max(8, -(-R // -(-SMS // b))))
    while rows > 8 and b * -(-R // rows) < SMS:
        rows -= 1
    return rows


def tiling_plan(b: int, R: int, n: int, H: int, dh: int, o: int) -> TilingPlan:
    """The launch's plan for q [b, R, H, dh], k [b, n, H, dh], vw [b, n, H, o]:
    `chunk_rows` rows per block. Raises ValueError on a shape the kernel does
    not take, before anything is built."""
    if min(b, R, n, H, dh, o) < 1:
        raise ValueError(f"empty graph attention: b={b} R={R} n={n} H={H} dh={dh} o={o}")
    if dh % 4 or o % 4:
        raise ValueError(f"the kernel reads 16-byte vectors: dh={dh} and o={o} must be "
                         "multiples of 4")
    smem = smem_bytes(H, dh, n, o)
    if smem > SMEM_LIMIT:
        raise ValueError(f"H={H}, dh={dh}, n={n}, o={o} need {smem} B of shared memory per "
                         f"block, over the {SMEM_LIMIT} B a block may use")
    rows = chunk_rows(b, R)
    return TilingPlan(rows, (-(-R // rows), b), smem)


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


class _Launch(ctypes.Structure):
    """The launch's scalars (`GaLaunch` in the source), built once per shape
    and bias strides so that a call passes one pointer for them."""

    _fields_ = [(name, ctypes.c_int) for name in
                ("sb", "sr", "sh", "b", "R", "n", "H", "dh", "o", "rows", "smem")] + [
                ("scale", ctypes.c_float)]


class _Kernel:
    """The compiled kernel, built at first launch, and its launch counts:
    `launches` of the global-max (v2) mode, `per_head_launches` of v1,
    and both by query rows R in `launches_by_rows[("v2" | "v1", R)]`.
    Per-shape work (the tiling plan, the launch's scalars, the shared-memory
    attribute per device) is done once and cached."""

    def __init__(self):
        self.launches = 0
        self.per_head_launches = 0
        self.launches_by_rows = collections.Counter()
        self._lib = None
        self._launch_args = {}  # (shapes, bias strides) -> (_Launch, copy the bias)
        self._smem_set = {}  # device index -> dynamic shared memory allowed

    def lib(self) -> ctypes.CDLL:
        if self._lib is None:
            lib = build.load(SOURCE)
            p, i = ctypes.c_void_p, ctypes.c_int
            lib.regat_graph_attention_fwd.argtypes = [p] * 6 + [i, p]
            lib.regat_graph_attention_fwd.restype = i
            lib.regat_graph_attention_smem_bytes.argtypes = [i] * 4
            lib.regat_graph_attention_smem_bytes.restype = ctypes.c_size_t
            lib.regat_graph_attention_set_smem.argtypes = [i]
            lib.regat_graph_attention_set_smem.restype = i
            # the plan's shared memory must be the kernel's
            for shape in ((16, 64, 20, 64), (4, 8, 10, 12), (3, 4, 1, 4)):
                want = lib.regat_graph_attention_smem_bytes(*shape)
                if smem_bytes(*shape) != want:
                    raise RuntimeError(f"tiling plan and kernel disagree on shared memory "
                                       f"for (H, dh, n, o) = {shape}: {smem_bytes(*shape)} "
                                       f"vs {want}")
            self._lib = lib
        return self._lib

    def _args(self, q, k, vw, bias) -> tuple[_Launch, bool]:
        """The launch's scalars for these inputs, and whether the bias must be
        copied (broadcast along its keys), after the checks that depend only
        on shapes and strides (cached with them)."""
        key = (q.shape, k.shape, vw.shape, bias.shape, bias.stride())
        cached = self._launch_args.get(key)
        if cached is None:
            b, R, H, dh = q.shape
            n, o = k.shape[1], vw.shape[3]
            for name, t, shape in (("k", k, (b, n, H, dh)), ("vw", vw, (b, n, H, o))):
                if tuple(t.shape) != shape:
                    raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
            view = _expand_bias(bias, (b, R, H, n))
            if max(view.stride()) >= 2**31:
                raise ValueError(f"bias strides {view.stride()} exceed the kernel's int32")
            plan = tiling_plan(b, R, n, H, dh, o)
            args = _Launch(*view.stride()[:3], b, R, n, H, dh, o, plan.rows,
                           plan.smem_bytes, 1.0 / math.sqrt(dh))
            cached = self._launch_args[key] = (args, view.data_ptr() != bias.data_ptr())
        return cached

    def __call__(self, q, k, vw, bias, per_head=False):
        """out [b, R, H, o]; `bias` broadcastable to [b, R, H, n]."""
        if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                        or vw.requires_grad or bias.requires_grad):
            # the launch is opaque to autograd: its output would have no grad_fn
            raise RuntimeError(
                "the kernel would drop a gradient: call fused_graph_attention "
                "(which routes through GraphAttention) or run under torch.no_grad()"
            )
        dev = q.device
        for name, t in (("q", q), ("k", k), ("vw", vw), ("bias", bias)):
            if t.device != dev or t.dtype != torch.float32:
                raise ValueError(f"{name} is {t.dtype} on {t.device}, the kernel takes "
                                 f"torch.float32 on {dev}")
            if name != "bias" and (not t.is_contiguous() or t.data_ptr() % 16):
                raise ValueError(f"{name} must be contiguous and 16-byte aligned")
        args, copy_bias = self._args(q, k, vw, bias)
        if copy_bias:
            bias = _expand_bias(bias, (args.b, args.R, args.H, args.n))
        lib = self.lib()
        if dev.index != torch.cuda.current_device():
            with torch.cuda.device(dev):
                return self(q, k, vw, bias, per_head)
        if self._smem_set.get(dev.index, 0) < args.smem:
            err = lib.regat_graph_attention_set_smem(args.smem)
            if err != 0:
                raise RuntimeError(f"graph attention kernel: {args.smem} B of shared memory "
                                   f"refused: CUDA error {err}")
            self._smem_set[dev.index] = args.smem
        out = q.new_empty((args.b, args.R, args.H, args.o))
        err = lib.regat_graph_attention_fwd(
            q.data_ptr(), k.data_ptr(), vw.data_ptr(), bias.data_ptr(), out.data_ptr(),
            ctypes.addressof(args), int(per_head),
            # the raw handle of the current stream (what `.cuda_stream` gives,
            # without building a Stream object on every call)
            torch._C._cuda_getCurrentRawStream(dev.index),
        )
        if err != 0:
            raise RuntimeError(f"graph attention kernel launch failed: CUDA error {err}")
        if per_head:
            self.per_head_launches += 1
        else:
            self.launches += 1
        self.launches_by_rows["v1" if per_head else "v2", args.R] += 1
        return out


def _expand_bias(bias: torch.Tensor, shape) -> torch.Tensor:
    """`bias` as a [b, R, H, n] view: broadcast axes get stride 0 (nothing is
    copied); keys must be contiguous, so a bias broadcast along the key axis
    is copied (the kernel's wrapper learns which once per shape and
    strides)."""
    bias = bias.expand(shape)
    return bias if bias.stride(3) == 1 else bias.contiguous()


KERNEL = _Kernel()


class GraphAttention(torch.autograd.Function):
    """The fused attention with its gradient (`_fused` with its custom VJP):
    forward through the kernel, backward by `graph_attention_backward`.
    dbias = daff, summed back over the axes the bias was broadcast along (the
    head axis for the model's shared bias). The backward is bracketed by the
    phase marks `b2_backward_begin` / `b2_backward_end` (train/profiling.py)."""

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
        mark("b2_backward_begin", g.device)
        dq, dk, dvw, daff = graph_attention_backward(
            g.contiguous(), q, k, vw, bias, ctx.per_head
        )
        dbias = daff.sum_to_size(bias.shape) if ctx.needs_input_grad[3] else None
        mark("b2_backward_end", g.device)
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
