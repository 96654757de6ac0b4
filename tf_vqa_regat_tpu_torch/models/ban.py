"""BAN fusion: bilinear attention with glimpses (counterpart of
tf_vqa_regat_tpu/models/ban.py, `ban_init` + `ban_apply`).

A BiAttention gives `glimpse` attention maps over (roi x question token)
pairs through a rank-3 bilinear form; each glimpse then pools the pair
features bilinearly and adds the result to the question sequence as a
residual, so the next glimpse's question projection sees the updated
sequence. The joint embedding is that sequence summed over tokens.

- The attention logits of padded rois are -1e9 (finite, so a fully padded
  serve slot gets uniform weights, not NaN); question pad tokens are not
  masked, as in JAX. The softmax runs over the flattened R*T.
- `h_mat` is a bare weight-normed tensor [glimpse, 3h] with a scalar g over
  the whole tensor.
- Dropout: the config's `dropout` itself (the family has no reference code
  pinning the graph rate), before every FCNet layer in training, plus a
  second draw on the attention's visual projection (BCNet drops v_ again).
- Dtypes, as the JAX module casts (checked against its jaxpr at bfloat16):
  every FCNet computes and stores in the compute dtype, so the second
  dropout acts on a bf16 tensor with JAX's bf16-rounded scale; `h_mat` is
  rounded to the compute dtype. The attention logits and each glimpse's
  pooling are products of rounded operands with an f32 result: the
  operands are widened and multiplied in f32 (a product of three bf16
  values is exact in f32, so only the order of the f32 sums can differ
  from JAX's). The logits, the softmax over R*T and the question sequence
  with its residual updates stay f32 (f32 + bf16 promotes to f32 in both
  frameworks). At float32 every cast is the identity.
- Contraction order, fixed (not left to torch.einsum, whose order and
  intermediates depend on whether opt_einsum is installed): the logits
  scale q_ by each glimpse's row of `h_mat` ([b, g*T, 3h]) and take one
  batched product with v_ ([b, R, g*T], read as [b, g, R, T]), never a
  [b, g, R, 3h] tensor; a glimpse's pooling is att[:, g] @ q1 ([b, R, h]),
  then v1 times that, summed over the rois.
- Tracing (ops/kernels/marks.py): the span marks `ban_forward_begin` /
  `_end` bracket the forward on the device's clock, in train and eval
  steps alike; under autograd, `ban_backward_begin` / `_end` are launched
  from identity functions at the outputs and the inputs, so they bracket
  the module's backward nodes. `CALLS` counts the forward calls under
  "train" and "eval" (a counter of ops/kernels/launch.py, so
  train/graphs.py keeps it replay-aware).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from tf_vqa_regat_tpu_torch.nn import dropout
from tf_vqa_regat_tpu_torch.ops.weight_norm import FCNet, wn_scale
from tf_vqa_regat_tpu_torch.ops.kernels import launch
from tf_vqa_regat_tpu_torch.ops.kernels.marks import mark

K = 3  # bilinear rank multiplier of the attention maps (BCNet's k=3)
CALLS = launch.counter("ban")


class WNTensor(nn.Module):
    """`v` and a scalar `g`, initialised to ||v||_F: the weight-normed
    tensor g * v / ||v||_F (JAX `wn_kernel`)."""

    def __init__(self, v: torch.Tensor):
        super().__init__()
        self.v = nn.Parameter(v)
        self.g = nn.Parameter(torch.linalg.vector_norm(v))

    def forward(self) -> torch.Tensor:
        return self.v * wn_scale(self.v, self.g)


class _BackwardEnd(torch.autograd.Function):
    """Identity on BAN's inputs; its backward, which runs once the whole
    module's backward has, marks `ban_backward_end`."""

    @staticmethod
    def forward(ctx, visual, q_seq):
        ctx.device = visual.device
        ctx.set_materialize_grads(False)
        return visual.view_as(visual), q_seq.view_as(q_seq)

    @staticmethod
    def backward(ctx, d_visual, d_q_seq):
        mark("ban_backward_end", ctx.device)
        return d_visual, d_q_seq


class _BackwardBegin(torch.autograd.Function):
    """Identity on BAN's outputs; its backward, the first of the module's,
    marks `ban_backward_begin`."""

    @staticmethod
    def forward(ctx, joint, att):
        ctx.device = joint.device
        ctx.set_materialize_grads(False)
        return joint.view_as(joint), att.view_as(att)

    @staticmethod
    def backward(ctx, d_joint, d_att):
        mark("ban_backward_begin", ctx.device)
        return d_joint, d_att


class BAN(nn.Module):
    def __init__(
        self, v_dim: int, q_dim: int, glimpse: int, generator: torch.Generator,
        drop_rate: float = 0.0, dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        h = q_dim  # hidden width = num_hid, as ReGAT builds BAN(v_rel_dim, num_hid, gamma)

        def fc(dims, activation="relu"):
            return FCNet(dims, generator, activation=activation, drop_rate=drop_rate,
                         dtype=dtype)

        self.drop_rate = drop_rate
        self.dtype = dtype
        self.att_v_net = fc([v_dim, h * K])
        self.att_q_net = fc([q_dim, h * K])
        self.h_mat = WNTensor(torch.randn(glimpse, h * K, generator=generator))
        self.h_bias = nn.Parameter(torch.randn(glimpse, generator=generator))
        self.b_v_net = nn.ModuleList(fc([v_dim, h]) for _ in range(glimpse))
        self.b_q_net = nn.ModuleList(fc([q_dim, h]) for _ in range(glimpse))
        self.q_prj = nn.ModuleList(fc([h, h], activation=None) for _ in range(glimpse))

    def forward(
        self,
        visual: torch.Tensor,  # [b, R, v_dim]
        q_seq: torch.Tensor,  # [b, T, q_dim]
        roi_mask: torch.Tensor,  # [b, R] bool
        generator: Optional[torch.Generator] = None,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(joint embedding [b, q_dim], attention maps [b, glimpse, R, T])."""
        b, R, _ = visual.shape
        T = q_seq.shape[1]
        glimpse = self.h_bias.shape[0]
        cd = self.dtype
        device = visual.device
        mark("ban_forward_begin", device)
        CALLS["train" if self.training else "eval"] += 1
        # the backward marks need a backward that reaches the inputs
        bracket = torch.is_grad_enabled() and (visual.requires_grad or q_seq.requires_grad)
        if bracket:
            visual, q_seq = _BackwardEnd.apply(visual, q_seq)
        v_ = self.att_v_net(visual, generator)
        v_ = dropout(v_, self.drop_rate, self.training, generator)
        q_ = self.att_q_net(q_seq, generator)
        h_mat = self.h_mat().to(cd)
        qh = (h_mat.float()[None, :, None, :] * q_.float()[:, None]).reshape(b, glimpse * T, -1)
        logits = torch.bmm(v_.float(), qh.transpose(1, 2))  # [b, R, g*T]
        logits = logits.view(b, R, glimpse, T).permute(0, 2, 1, 3)
        logits = logits + self.h_bias[None, :, None, None]
        logits = torch.where(
            roi_mask[:, None, :, None], logits, torch.full_like(logits, -1e9)
        )
        att = torch.softmax(logits.reshape(b, glimpse, R * T), dim=-1).reshape(b, glimpse, R, T)
        for g in range(glimpse):
            v1 = self.b_v_net[g](visual, generator)
            q1 = self.b_q_net[g](q_seq, generator)
            aq = torch.bmm(att[:, g].to(cd).float(), q1.float())  # [b, R, h]
            b_emb = (v1.float() * aq).sum(dim=1)
            q_seq = q_seq + self.q_prj[g](b_emb, generator)[:, None, :]
        joint = q_seq.sum(dim=1)
        if bracket:
            joint, att = _BackwardBegin.apply(joint, att)
        mark("ban_forward_end", device)
        return joint, att
