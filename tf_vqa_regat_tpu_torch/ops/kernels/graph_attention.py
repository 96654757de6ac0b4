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
  Function whose forward is the kernel on a CUDA tensor, which then also
  keeps v2's row maxima (the plain version on a CPU tensor), and whose
  backward is the backward kernel on a CUDA tensor (`KERNEL.backward`,
  tiled by `backward_plan`) and `graph_attention_backward`, which
  transcribes `_fused_bwd` in PyTorch ops, on a CPU tensor (the JAX
  backward is XLA, outside any Pallas kernel);
- otherwise a CPU tensor runs `graph_attention_plain` and a CUDA tensor
  launches the kernel.
A CUDA call raises on a dtype, shape, device or layout the kernel does not
take, and on shapes whose tiling plan does not fit (`tiling_plan`,
`backward_plan`); there is no fallback. The backward kernel computes what
the transcription computes without any [b, R, H, n] tensor in HBM, and adds
its partial sums in a fixed order (two launches give equal bits).
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

# The backward kernel's constants (the source's kBwd*): threads per block,
# blocks in flight per SM (so each may take half the SM's shared memory, less
# the 1 KB the card keeps per block), query rows per tile, and at most: keys
# per thread in the dK / dVW sums and rows per thread in dq (what a thread
# keeps in registers).
BWD_THREADS = 256
BWD_BLOCKS_PER_SM = 2
BWD_SMEM_LIMIT = 233_472 // BWD_BLOCKS_PER_SM - 1024
BWD_TILE = 8
BWD_MAX_KEYS = 10
BWD_MAX_ROWS_D = 2
# The backward's specialised instances (the source's kBwdInstances): (heads
# per block, keys n, head width dh, value width o) whose widths are compiled
# in; the one every configuration runs. Any other shape that
# `backward_plan` takes runs the general instance, which reads its widths at
# run time.
BWD_SPECIALISED = ((4, 20, 64, 64),)


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


def _up4(x: int) -> int:
    return -(-x // 4) * 4


class BackwardPlan(NamedTuple):
    """How one backward launch cuts the work: a block per (example, group of
    `heads` heads, chunk of `rows` query rows), a grid of `grid` = (head
    groups x `chunks`, b) blocks, and the dynamic shared memory each block
    takes."""

    heads: int
    rows: int
    chunks: int
    grid: tuple[int, int]
    smem_bytes: int


def bwd_smem_bytes(hb: int, dh: int, n: int, o: int) -> int:
    """Shared memory of one backward block (the kernel's `BwdLayout`): K [hb,
    n, dh+4] and VW [hb, n, o+4] of hb heads; two tile buffers, each of q
    [TILE, hb, dh+4], g [TILE, hb, o+4], the bias [TILE, hb, nP] and the row
    maxima [TILE]; the weights and daff [TILE, hb, nP]; in f32 words, nP = n
    rounded up to 4."""
    nP, T = _up4(n), BWD_TILE
    buf = T * hb * (dh + 4 + o + 4 + nP) + T
    return 4 * (hb * n * (dh + 4 + o + 4) + 2 * buf + 2 * T * hb * nP)


def _bwd_fits(hb: int, n: int, dh: int, o: int) -> bool:
    """Whether a backward block of hb heads fits: a thread per (head, 4
    channels) of a q row and of a g row in half the block each, so at most
    BWD_MAX_KEYS keys of dK / dVW and 2 rows of dq a thread; the shared
    memory."""
    qc, gc = hb * dh // 4, hb * o // 4
    half = BWD_THREADS // 2
    if max(qc, gc) > half:
        return False
    return (-(-BWD_TILE // (BWD_THREADS // qc)) <= BWD_MAX_ROWS_D
            and -(-n // (half // qc)) <= BWD_MAX_KEYS and -(-n // (half // gc)) <= BWD_MAX_KEYS
            and bwd_smem_bytes(hb, dh, n, o) <= BWD_SMEM_LIMIT)


def backward_chunks(b: int, R: int, groups: int, tile: int, blocks_per_sm: int):
    """(tiles per block, row chunks per example) of a backward launch of b x
    groups x chunks blocks that each take whole `tile`-row tiles: the count
    that keeps the estimated time least, waves of SMS x blocks_per_sm
    blocks times the block's tiles plus one for its staging; the fewest
    chunks on a tie. B1's backward plan takes the same rule."""
    tiles, best = -(-R // tile), None
    for per_chunk in range(tiles, 0, -1):  # tiles per block; fewer chunks first
        chunks = -(-tiles // per_chunk)
        cost = -(-b * groups * chunks // (SMS * blocks_per_sm)) * (per_chunk + 1)
        if best is None or cost < best[0]:
            best = (cost, per_chunk, chunks)
    return best[1:]


def backward_plan(b: int, R: int, n: int, H: int, dh: int, o: int) -> BackwardPlan:
    """The backward launch's plan for q [b, R, H, dh], k [b, n, H, dh] and
    vw [b, n, H, o]. Heads per block: those of a specialised instance
    (BWD_SPECIALISED) at (n, dh, o) that divides H, else the most of 8, 4, 2
    and 1 that divides H and fits (`_bwd_fits`). Rows per block:
    `backward_chunks` (the whole example at b >= 64, R=100). Raises
    ValueError on a shape the kernel does not take, before anything is
    built."""
    if min(b, R, n, H, dh, o) < 1:
        raise ValueError(f"empty graph attention: b={b} R={R} n={n} H={H} dh={dh} o={o}")
    if dh % 4 or o % 4:
        raise ValueError(f"the backward kernel reads 16-byte vectors: dh={dh} and o={o} must "
                         "be multiples of 4")
    hb = next((i[0] for i in BWD_SPECIALISED if i[1:] == (n, dh, o) and H % i[0] == 0), None)
    if hb is None:
        hb = next((h for h in (8, 4, 2, 1) if H % h == 0 and _bwd_fits(h, n, dh, o)), None)
    if hb is None:
        raise ValueError(f"n={n}, dh={dh}, o={o}: no backward block of 1 head fits (at most "
                         f"{BWD_MAX_ROWS_D} dq rows and {BWD_MAX_KEYS} dK / dVW keys a thread, "
                         f"{BWD_SMEM_LIMIT} B of shared memory)")
    groups = H // hb
    per_chunk, chunks = backward_chunks(b, R, groups, BWD_TILE, BWD_BLOCKS_PER_SM)
    return BackwardPlan(hb, per_chunk * BWD_TILE, chunks, (groups * chunks, b),
                        bwd_smem_bytes(hb, dh, n, o))


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


class _BwdLaunch(ctypes.Structure):
    """The backward launch's scalars (`GaBwdLaunch` in the source)."""

    _fields_ = [(name, ctypes.c_int) for name in
                ("sb", "sr", "sh", "shared", "b", "R", "n", "H", "dh", "o", "hb", "rows",
                 "chunks", "smem")] + [("scale", ctypes.c_float)]


class _Kernel:
    """The compiled kernels, built at first launch, and their launch counts:
    `launches` of the global-max (v2) mode, `per_head_launches` of v1,
    and both by query rows R in `launches_by_rows[("v2" | "v1", R)]`;
    `backward_launches` of the backward (one per forward launch under grad
    in training). Per-shape work (the tiling plans, the launches' scalars,
    the shared-memory attributes per device) is done once and cached."""

    def __init__(self):
        self.launches = 0
        self.per_head_launches = 0
        self.backward_launches = 0
        self.launches_by_rows = collections.Counter()
        self._lib = None
        self._launch_args = {}  # (shapes, bias strides) -> (_Launch, copy the bias)
        self._bwd_args = {}  # (shapes, bias strides) -> (_BwdLaunch, copy the bias)
        self._smem_set = {}  # device index -> dynamic shared memory allowed
        self._bwd_smem_set = {}  # (device index, specialised instance or None) -> the same

    def lib(self) -> ctypes.CDLL:
        if self._lib is None:
            lib = build.load(SOURCE)
            p, i = ctypes.c_void_p, ctypes.c_int
            lib.regat_graph_attention_fwd.argtypes = [p] * 7 + [i, p]
            lib.regat_graph_attention_fwd.restype = i
            lib.regat_graph_attention_smem_bytes.argtypes = [i] * 4
            lib.regat_graph_attention_smem_bytes.restype = ctypes.c_size_t
            lib.regat_graph_attention_set_smem.argtypes = [i]
            lib.regat_graph_attention_set_smem.restype = i
            lib.regat_graph_attention_bwd.argtypes = [p] * 14 + [i, p]
            lib.regat_graph_attention_bwd.restype = i
            lib.regat_graph_attention_bwd_smem_bytes.argtypes = [i] * 4
            lib.regat_graph_attention_bwd_smem_bytes.restype = ctypes.c_size_t
            lib.regat_graph_attention_bwd_specialised.argtypes = [i] * 4
            lib.regat_graph_attention_bwd_specialised.restype = i
            lib.regat_graph_attention_bwd_set_smem.argtypes = [i] * 5
            lib.regat_graph_attention_bwd_set_smem.restype = i
            # the backward plan's specialised instances are the source's
            for hb, n, dh, o in BWD_SPECIALISED:
                if not lib.regat_graph_attention_bwd_specialised(hb, n, dh, o):
                    raise RuntimeError(f"the backward kernel has no specialised instance for "
                                       f"(hb, n, dh, o) = {(hb, n, dh, o)}, which "
                                       "backward_plan chooses")
            # the plans' shared memory must be the kernels'
            for what, plan, kernel, shapes in (
                ("tiling plan", smem_bytes, lib.regat_graph_attention_smem_bytes,
                 ((16, 64, 20, 64), (4, 8, 10, 12), (3, 4, 1, 4))),
                ("backward plan", bwd_smem_bytes, lib.regat_graph_attention_bwd_smem_bytes,
                 ((4, 64, 20, 64), (2, 128, 20, 128), (2, 8, 7, 12), (1, 4, 1, 4))),
            ):
                for shape in shapes:
                    want = kernel(*shape)
                    if plan(*shape) != want:
                        raise RuntimeError(f"{what} and kernel disagree on shared memory "
                                           f"for {shape}: {plan(*shape)} vs {want}")
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

    def __call__(self, q, k, vw, bias, per_head=False, save_max=False):
        """out [b, R, H, o]; `bias` broadcastable to [b, R, H, n]. With
        `save_max` (a launch under grad) (out, v2's row maxima of the
        affinities [b, R], or None in v1), for the backward."""
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
                return self(q, k, vw, bias, per_head, save_max)
        if self._smem_set.get(dev.index, 0) < args.smem:
            err = lib.regat_graph_attention_set_smem(args.smem)
            if err != 0:
                raise RuntimeError(f"graph attention kernel: {args.smem} B of shared memory "
                                   f"refused: CUDA error {err}")
            self._smem_set[dev.index] = args.smem
        out = q.new_empty((args.b, args.R, args.H, args.o))
        rowmax = q.new_empty((args.b, args.R)) if save_max and not per_head else None
        err = lib.regat_graph_attention_fwd(
            q.data_ptr(), k.data_ptr(), vw.data_ptr(), bias.data_ptr(), out.data_ptr(),
            None if rowmax is None else rowmax.data_ptr(), ctypes.addressof(args), int(per_head),
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
        return (out, rowmax) if save_max else out

    def _backward_args(self, g, q, k, vw, bias) -> tuple[_BwdLaunch, bool]:
        """The backward launch's scalars for these inputs, and whether the
        bias must be copied (as for the forward), after the checks that
        depend only on shapes and strides (cached with them). The bias is
        shared when it is broadcast along the heads, as the model's [b, R, 1,
        n] is: its gradient is then daff summed over the heads."""
        key = (q.shape, k.shape, vw.shape, bias.shape, bias.stride())
        cached = self._bwd_args.get(key)
        if cached is None:
            b, R, H, dh = q.shape
            n, o = k.shape[1], vw.shape[3]
            for name, t, shape in (("k", k, (b, n, H, dh)), ("vw", vw, (b, n, H, o)),
                                   ("g", g, (b, R, H, o))):
                if tuple(t.shape) != shape:
                    raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
            view = _expand_bias(bias, (b, R, H, n))
            if max(view.stride()) >= 2**31:
                raise ValueError(f"bias strides {view.stride()} exceed the kernel's int32")
            plan = backward_plan(b, R, n, H, dh, o)
            # shared: one bias row for all heads (its head axis has size 1 or
            # is missing)
            shared = bias.dim() < 2 or bias.shape[-2] == 1
            args = _BwdLaunch(*view.stride()[:3], int(shared), b, R, n, H, dh, o, plan.heads,
                              plan.rows, plan.chunks, plan.smem_bytes, 1.0 / math.sqrt(dh))
            cached = self._bwd_args[key] = (args, view.data_ptr() != bias.data_ptr())
        return cached

    def backward(self, g, q, k, vw, bias, rowmax, per_head=False):
        """(dq, dk, dvw, dbias) for the output cotangent g [b, R, H, o] of a
        launch under grad, as `graph_attention_backward` computes them
        (`rowmax`: the row maxima that launch kept, v2; None in v1), in one
        launch of the backward kernel and, where partial sums are to be
        added, one of its reduce. dbias is [b, R, 1, n], daff summed over
        the heads, for a bias shared across heads, else daff [b, R, H, n]."""
        if not per_head and rowmax is None:
            raise ValueError("the v2 backward kernel needs the row maxima of the forward")
        args, copy_bias = self._backward_args(g, q, k, vw, bias)
        b, R, H, n = args.b, args.R, args.H, args.n
        dev = q.device
        for name, t, want in (("g", g, (b, R, H, args.o)), ("q", q, None), ("k", k, None),
                              ("vw", vw, None), ("bias", bias, None),
                              ("rowmax", rowmax, (b, R))):
            if t is None:
                continue
            if t.device != dev or t.dtype != torch.float32:
                raise ValueError(f"{name} is {t.dtype} on {t.device}, the kernel takes "
                                 f"torch.float32 on {dev}")
            if want is not None and tuple(t.shape) != want:
                raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {want}")
            if name != "bias" and (not t.is_contiguous() or t.data_ptr() % 16):
                raise ValueError(f"{name} must be contiguous and 16-byte aligned")
        if copy_bias:
            bias = _expand_bias(bias, (b, R, H, n))
        lib = self.lib()
        if dev.index != torch.cuda.current_device():
            with torch.cuda.device(dev):
                return self.backward(g, q, k, vw, bias, rowmax, per_head)
        instance = (args.hb, n, args.dh, args.o)
        # the attribute is the kernel's: the general instance's serves every
        # shape it runs, so it only grows
        which = dev.index, instance if instance in BWD_SPECIALISED else None
        if self._bwd_smem_set.get(which, 0) < args.smem:
            err = lib.regat_graph_attention_bwd_set_smem(*instance, args.smem)
            if err != 0:
                raise RuntimeError(f"graph attention backward: {args.smem} B of shared memory "
                                   f"refused: CUDA error {err}")
            self._bwd_smem_set[which] = args.smem
        groups = H // args.hb
        dq, dk, dvw = torch.empty_like(q), torch.empty_like(k), torch.empty_like(vw)
        dbias = q.new_empty((b, R, 1 if args.shared else H, n))
        # the head groups' sums of a shared bias's gradient; with several row
        # chunks per example, their partial dK and dVW
        ws_b = q.new_empty((groups, b, R, n)) if args.shared and groups > 1 else None
        ws_k = q.new_empty((args.chunks, *k.shape)) if args.chunks > 1 else None
        ws_v = q.new_empty((args.chunks, *vw.shape)) if args.chunks > 1 else None
        err = lib.regat_graph_attention_bwd(
            g.data_ptr(), q.data_ptr(), k.data_ptr(), vw.data_ptr(), bias.data_ptr(),
            None if rowmax is None else rowmax.data_ptr(), dq.data_ptr(), dk.data_ptr(),
            dvw.data_ptr(), dbias.data_ptr(), *(None if t is None else t.data_ptr()
                                                for t in (ws_k, ws_v, ws_b)),
            ctypes.addressof(args), int(per_head), torch._C._cuda_getCurrentRawStream(dev.index),
        )
        if err != 0:
            raise RuntimeError(f"graph attention backward launch failed: CUDA error {err}")
        self.backward_launches += 1
        return dq, dk, dvw, dbias


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
    forward through the kernel, which keeps v2's row maxima; backward by the
    backward kernel on a CUDA tensor, by `graph_attention_backward` on a CPU
    tensor. dbias = daff, summed back over the axes the bias was broadcast
    along (the head axis for the model's shared bias, in the kernel). The
    backward is bracketed by the phase marks `b2_backward_begin` /
    `b2_backward_end` (train/profiling.py)."""

    @staticmethod
    def forward(ctx, q, k, vw, bias, per_head):
        rowmax = None
        if q.device.type == "cuda":
            out, rowmax = KERNEL(q, k, vw, bias, per_head, save_max=True)
        elif q.device.type == "cpu":
            out = graph_attention_plain(q, k, vw, bias, per_head)
        else:
            raise ValueError(f"no graph attention kernel for device {q.device}")
        ctx.save_for_backward(q, k, vw, bias, rowmax)
        ctx.per_head = per_head
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, vw, bias, rowmax = ctx.saved_tensors
        mark("b2_backward_begin", g.device)
        # daff in the bias's head layout (the kernel) or per head (the
        # transcription), summed to the bias's shape
        if g.device.type == "cuda":
            dq, dk, dvw, daff = KERNEL.backward(
                g.contiguous(), q, k, vw, bias, rowmax, ctx.per_head
            )
        else:
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
