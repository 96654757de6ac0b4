"""MuTAN fusion: multimodal Tucker fusion (counterpart of
tf_vqa_regat_tpu/models/mutan.py, `mutan_init` + `mutan_apply`).

A Mutan block over inputs (x0, x1) computes
    z = sum_r (W0_r L0 x0) * (W1_r L1 x1),   out = L_out z
a rank-`rank` Tucker factorisation of the full bilinear interaction. One
block scores the rois for a 2-glimpse attention; a second scores the
answers from the question and the glimpse-weighted visual sums, so MuTAN
returns answer logits and the model has no classifier.

- The block takes one of two formulations, chosen as JAX chooses
  (`_mutan_block_apply`): where the question side stays [b, 1, d] against a
  [b, R, d] visual side (eval always; train under `mutan_shared_qdrop` or
  without dropout) the rank sum is reassociated into per-example folded
  weights; otherwise it runs naively, m0 * m1 summed over the rank. In train
  with input dropout the question side is broadcast to [b, R, 1200] before
  its dropout, so every roi draws its own mask (the upstream `block` library
  flattens rois into the batch).
- Dtype contract, as the JAX module casts (checked against its jaxpr at
  bfloat16): every plain dense layer takes operands rounded to the compute
  dtype and returns their product in f32, plus the f32 bias
  (`nn.dot_f32`), so the input dropout, the naive branch's merges m0, m1,
  m and its z stay f32. The reassociated branch keeps the fold, zb and z in
  the compute dtype (a bf16 product rounds its f32 sums once), which
  departs from JAX's own naive branch (ADVICE.md:3); the port keeps JAX's
  choice. The attention MLP stores bf16 outputs (FCNet at the compute
  dtype), the roi logits widen to f32 for the softmax, and the glimpse sum
  multiplies rounded operands into an f32 result. At float32 every cast
  is the identity.
- Input dropout is 0.1 whenever the config's `dropout` > 0, on both inputs of
  both blocks; the attention MLP has none. The roi softmax runs in f32 with
  padded rois at -1e9.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from tf_vqa_regat_tpu_torch.nn import dot_f32, dropout, glorot_uniform
from tf_vqa_regat_tpu_torch.ops.weight_norm import FCNet

MM_DIM = 1200  # ReGAT's fusions.Mutan(..., mm_dim=1200)
ATT_DIM = 360  # MuTAN_Attention's dim_out
MLP_HID = 512  # hidden width of the attention MLP
INPUT_DROP = 0.1  # the block library's dropout_input


class Linear(nn.Module):
    """Plain dense layer: `w` [in, out] (glorot), `b` [out] (zeros); no
    weight norm. Operands rounded to `dtype`, an f32 result (JAX `_linear`)."""

    def __init__(
        self, in_dim: int, out_dim: int, generator: torch.Generator,
        dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        self.w = nn.Parameter(glorot_uniform((in_dim, out_dim), generator))
        self.b = nn.Parameter(torch.zeros(out_dim))
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return dot_f32(x, self.w, self.dtype) + self.b


def _one_question_per_example(h0: torch.Tensor, x1: torch.Tensor) -> bool:
    """h0 [b, 1, d] against a visual side [b, R, d1]: the question side is
    the same for every roi."""
    return h0.dim() == 3 and h0.shape[1] == 1 and x1.dim() == 3


class MutanBlock(nn.Module):
    def __init__(
        self, dim0: int, dim1: int, out_dim: int, rank: int,
        generator: torch.Generator, drop_input: float = 0.0, shared_qdrop: bool = False,
        dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        self.rank = rank
        self.drop_input = drop_input
        self.shared_qdrop = shared_qdrop
        self.dtype = dtype
        self.linear0 = Linear(dim0, MM_DIM, generator, dtype)
        self.linear1 = Linear(dim1, MM_DIM, generator, dtype)
        self.merge0 = Linear(MM_DIM, MM_DIM * rank, generator, dtype)
        self.merge1 = Linear(MM_DIM, MM_DIM * rank, generator, dtype)
        self.linear_out = Linear(MM_DIM, out_dim, generator, dtype)

    def forward(
        self, x0: torch.Tensor, x1: torch.Tensor,
        generator: Optional[torch.Generator] = None,
    ) -> torch.Tensor:
        """x0 [b, d0] with x1 [b, d1], or x0 [b, 1, d0] (a question over
        every roi) with x1 [b, R, d1]."""
        h0, h1 = self.linear0(x0), self.linear1(x1)
        if self.training and self.drop_input > 0.0:
            if not self.shared_qdrop and _one_question_per_example(h0, x1):
                h0 = h0.expand(h0.shape[0], x1.shape[1], h0.shape[2])
            h0 = dropout(h0, self.drop_input, True, generator)
            h1 = dropout(h1, self.drop_input, True, generator)
        if _one_question_per_example(h0, x1):
            z = self.reassociated(h0, h1)
        else:
            z = self.naive(h0, h1)
        return self.linear_out(z)

    def naive(self, h0: torch.Tensor, h1: torch.Tensor) -> torch.Tensor:
        """z = sum_r m0_r * m1_r, the merges materialised at [..., rank*1200]
        (m0 broadcasts over the rois where h0 is [b, 1, 1200])."""
        m = self.merge0(h0) * self.merge1(h1)
        return m.reshape(*m.shape[:-1], self.rank, MM_DIM).sum(dim=-2)

    def reassociated(self, h0: torch.Tensor, h1: torch.Tensor) -> torch.Tensor:
        """The same sum with the nesting reordered, for h0 [b, 1, 1200]:
        z = h1 @ fold + zb with fold[b] = sum_r W1_r * m0_r[b] and
        zb[b] = sum_r m0_r[b] * b1_r, so the visual merge [b, R, rank*1200]
        is never built. fold, zb and z are in the compute dtype."""
        b, cd = h0.shape[0], self.dtype
        m0r = self.merge0(h0).reshape(b, self.rank, MM_DIM).to(cd)
        w1r = self.merge1.w.to(cd).reshape(MM_DIM, self.rank, MM_DIM)
        fold = torch.einsum("krj,brj->bkj", w1r, m0r)  # [b, 1200, 1200]
        b1r = self.merge1.b.to(cd).reshape(self.rank, MM_DIM)
        zb = torch.einsum("brj,rj->bj", m0r, b1r)
        return torch.bmm(h1.to(cd), fold) + zb[:, None, :]


class MuTAN(nn.Module):
    def __init__(
        self, v_dim: int, q_dim: int, num_ans: int, rank: int, glimpse: int,
        generator: torch.Generator, drop_rate: float = 0.0, shared_qdrop: bool = False,
        dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        drop_input = INPUT_DROP if drop_rate > 0 else 0.0
        self.dtype = dtype
        self.att_fusion = MutanBlock(
            q_dim, v_dim, ATT_DIM, rank, generator, drop_input, shared_qdrop, dtype
        )
        self.att_linear0 = FCNet([ATT_DIM, MLP_HID], generator, activation=None, dtype=dtype)
        self.att_linear1 = FCNet([MLP_HID, glimpse], generator, activation=None, dtype=dtype)
        # shared_qdrop does not reach out_fusion: its inputs have no roi axis
        self.out_fusion = MutanBlock(
            q_dim, v_dim * glimpse, num_ans, rank, generator, drop_input, dtype=dtype
        )

    def forward(
        self,
        visual: torch.Tensor,  # [b, R, v_dim]
        question: torch.Tensor,  # [b, q_dim], the GRU's last state
        roi_mask: torch.Tensor,  # [b, R] bool
        generator: Optional[torch.Generator] = None,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(answer logits [b, num_ans], attention [b, R, glimpse])."""
        alpha = self.att_fusion(question[:, None, :], visual, generator)
        alpha = self.att_linear1(self.att_linear0(alpha)).float()
        alpha = torch.where(roi_mask[..., None], alpha, torch.full_like(alpha, -1e9))
        alpha = torch.softmax(alpha, dim=1)
        cd = self.dtype
        v_out = torch.einsum(
            "brg,brd->bgd", alpha.to(cd).float(), visual.to(cd).float()
        ).reshape(visual.shape[0], -1)
        return self.out_fusion(question, v_out, generator), alpha
