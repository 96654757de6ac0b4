"""One direction of graph self-attention (counterpart of
tf_vqa_regat_tpu/ops/graph_attention.py, `graph_attention_apply` with
impl="pallas").

Per direction: Q and K weight-normed FCNets; V projected FIRST by the grouped
weight-normed kernel (softmax @ (V @ W) == (softmax @ V) @ W, so the
[b, R, H, D] attended values never exist); then one fused kernel attends, and
the shared output bias is added last. On a CUDA tensor that is one kernel
launch per direction:
- implicit (a position matrix, `pair_pos_fc`): the fused implicit attention
  (ops/kernels/implicit_attention.py, B1) builds the geometry bias itself;
- explicit (an adjacency mask and an edge-label bias, no `pair_pos_fc`):
  the bias is combined here in JAX's order (zeros [b, R, 1, n], + label
  bias, adjacency -> -9e15, + key mask), shared across heads, and the fused
  masked attention (ops/kernels/graph_attention.py, B2) attends.

In training, dropout at `drop_rate` precedes the Q and K projections
(FCNet), and the sinusoid embedding's uint8 keep-mask [b, R, n, P] is drawn
here with the step's generator and handed to the kernel, as the JAX fused
branch draws it (graph_attention.py:155-170).

Under a bf16 `dtype` Q, K and V·W are computed and stored in bf16 and cast
to f32 here, at the kernel's edge, where the JAX kernel wrappers cast them
(ops/pallas/implicit_attention.py:331-334, graph_attention.py:266-268):
both kernels take f32 only. B2's bias is f32 (a bf16 label bias meets f32
zeros first), B1's pos-FC weight is materialised in f32, and the output
and `+ b` stay f32 (graph_attention.py:171-176, :254-255). This is the JAX
`--use_pallas` path, where the sinusoid and the pos-FC stay f32 inside B1.

Tensor parallelism (`shard_`, JAX `param_shardings` at tp > 1): a rank holds
its H/tp heads of the Q and K kernels (their head-major output columns) and
of the grouped `v` [H/tp, D, o], so its Q, K and V·W are those heads only.
They are gathered over the model group to all H heads, and every rank
launches B1 or B2 on all H heads: both kernels normalise each head's
softmax by the row max over all heads (+1e-30), so a launch on H/tp heads
would change the weights wherever a head's segment underflows or a row is
fully masked. The dropout masks (FCNet's input dropout, B1's keep-mask)
come from the step's generator, seeded by the data index, and are drawn at
the full shapes: the tp ranks of a data group draw the same masks, and the
masks of tp = 1.

Under --debug_nans the fused attention's output is checked by the
Function's name (train/debug_nans.py::check_output).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from tf_vqa_regat_tpu_torch.nn import glorot_uniform, keep_mask
from tf_vqa_regat_tpu_torch.ops.kernels.graph_attention import fused_graph_attention
from tf_vqa_regat_tpu_torch.ops.kernels.implicit_attention import (
    NEG_INF,
    fused_implicit_graph_attention,
)
from tf_vqa_regat_tpu_torch.ops.weight_norm import FCNet, wn_scale
from tf_vqa_regat_tpu_torch.parallel.tensor import TensorParallel, copy_to, gather
from tf_vqa_regat_tpu_torch.train.debug_nans import check_output


class GroupedProjection(nn.Module):
    """The grouped 1x1 conv (groups=H) under WeightNorm: `v` [H, D, o] with a
    scalar `g` over the whole tensor and one shared bias `b` [H*o]."""

    def __init__(self, hidden_dim: int, num_heads: int, generator: torch.Generator):
        super().__init__()
        o = hidden_dim // num_heads
        flat = glorot_uniform((hidden_dim, num_heads * o), generator)
        v = flat.reshape(hidden_dim, num_heads, o).permute(1, 0, 2).contiguous()
        self.v = nn.Parameter(v)
        self.g = nn.Parameter(torch.linalg.vector_norm(v))
        self.b = nn.Parameter(torch.zeros(num_heads * o))
        self.tp: Optional[TensorParallel] = None

    def kernel(self) -> torch.Tensor:
        return self.v * wn_scale(self.v, self.g, self.tp)


class GraphSelfAttention(nn.Module):
    """Parameters as the JAX `graph_attention_init` pytree: `query`, `key`,
    `out` and, when `pos_emb_dim` > 0 (implicit), `pair_pos_fc`."""

    def __init__(
        self, hidden_dim: int, num_heads: int, pos_emb_dim: int,
        generator: torch.Generator, drop_rate: float = 0.0,
        dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        self.num_heads = num_heads
        self.drop_rate = drop_rate
        self.dtype = dtype
        self.query = FCNet(
            [hidden_dim, hidden_dim], generator, activation=None, drop_rate=drop_rate,
            dtype=dtype,
        )
        self.key = FCNet(
            [hidden_dim, hidden_dim], generator, activation=None, drop_rate=drop_rate,
            dtype=dtype,
        )
        self.out = GroupedProjection(hidden_dim, num_heads, generator)
        self.pair_pos_fc = (
            FCNet([pos_emb_dim, num_heads], generator, activation=None)
            if pos_emb_dim > 0 else None
        )
        self.tp: Optional[TensorParallel] = None

    @torch.no_grad()
    def shard_(self, tp: TensorParallel) -> None:
        """Keep this rank's heads of `query`, `key` and `out` (module
        docstring); the biases, the scalars `g` and `pair_pos_fc` stay
        whole."""
        self.tp = tp
        self.query.layers[0].shard_(tp, "cols")
        self.key.layers[0].shard_(tp, "cols")
        self.out.tp = tp
        self.out.v = nn.Parameter(tp.shard(self.out.v.data, 0))

    def forward(
        self,
        roi: torch.Tensor,  # [b, R, D]
        pos_mat: Optional[torch.Tensor],  # [b, R, n, 4] (implicit), or None
        key_mask: torch.Tensor,  # [b, n] bool
        generator: Optional[torch.Generator] = None,
        adj_mask: Optional[torch.Tensor] = None,  # [b, R, n], > 0 = edge (explicit)
        label_bias: Optional[torch.Tensor] = None,  # [b, R, n] (explicit)
    ) -> torch.Tensor:  # [b, R, D]
        b, R, D = roi.shape
        n = key_mask.shape[1]
        H, tp = self.num_heads, self.tp
        h = H if tp is None else H // tp.size  # this rank's heads
        if tp is not None:
            roi = copy_to(roi, tp)
        trunc = roi[:, :n]
        cd = self.dtype
        q = self.query(roi, generator).view(b, R, h, D // H)
        k = self.key(trunc, generator).view(b, n, h, D // H)
        vw = torch.einsum("bnd,hdo->bnho", trunc.to(cd), self.out.kernel().to(cd))
        # the kernels' edge: f32 in (the kernels take f32 only), f32 out
        q, k, vw = q.float(), k.float(), vw.float()
        if tp is not None:  # every rank attends over all H heads
            q, k, vw = gather(q, tp, 2), gather(k, tp, 2), gather(vw, tp, 2)
        vw = vw.contiguous()
        if pos_mat is None:
            out = fused_graph_attention(q, k, vw, explicit_bias(adj_mask, label_bias, key_mask))
            check_output("GraphAttention (B2)", out)
            return out.reshape(b, R, D) + self.out.b
        layer = self.pair_pos_fc.layers[0]
        drop_rate, dropmask = 0.0, None
        if self.training and self.drop_rate > 0.0:
            drop_rate = self.drop_rate
            shape = (b, R, n, layer.v.shape[0])
            dropmask = keep_mask(shape, drop_rate, generator, roi.device).view(torch.uint8)
        out = fused_implicit_graph_attention(
            q, k, vw, pos_mat, layer.kernel(), layer.b, key_mask, drop_rate, dropmask
        )
        check_output("ImplicitAttention (B1)", out)
        return out.reshape(b, R, D) + self.out.b


def explicit_bias(
    adj_mask: torch.Tensor, label_bias: torch.Tensor, key_mask: torch.Tensor
) -> torch.Tensor:
    """[b, R, 1, n] f32, shared across heads, built in the JAX order
    (graph_attention.py:180, 218-227) so that the mask values round alike:
    a non-edge valid key sits at -9e15, a padded key at -9e15 more."""
    bias = torch.zeros(label_bias.shape[:2] + (1, label_bias.shape[2]),
                       dtype=torch.float32, device=label_bias.device)
    bias = bias + label_bias[:, :, None, :]
    bias = torch.where((adj_mask > 0)[:, :, None, :], bias, NEG_INF)
    return bias + torch.where(key_mask[:, None, None, :], 0.0, NEG_INF)
