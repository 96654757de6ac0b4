"""GRU question encoder with Keras-v2 semantics (counterpart of
tf_vqa_regat_tpu/ops/gru.py).

`reset_after=True`: separate input and recurrent bias rows, and the candidate
uses ``r * (h @ U_h + b_rh)``. Gates are laid out z, r, h along the 3h axis.
torch's nn.GRU (cuDNN) orders them r, z, n and is a library kernel, so it is
not used. The input projection for all steps is one matmul; the 14-step
recurrence is a Python loop.

Under a bf16 `dtype` both matmuls take bf16-rounded operands and return
unrounded f32 (`nn.dot_f32`, JAX's preferred_element_type=f32); the gates
and the state stay f32, so the output is f32 at either dtype.
"""

from __future__ import annotations

import torch
from torch import nn

from tf_vqa_regat_tpu_torch.nn import dot_f32, glorot_uniform, orthogonal


class GRU(nn.Module):
    """Parameters `kernel` [in, 3h], `recurrent_kernel` [h, 3h], `bias`
    [2, 3h] (row 0 input bias, row 1 recurrent bias)."""

    def __init__(
        self, in_dim: int, hidden_dim: int, generator: torch.Generator,
        dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        self.dtype = dtype
        self.kernel = nn.Parameter(glorot_uniform((in_dim, 3 * hidden_dim), generator))
        self.recurrent_kernel = nn.Parameter(
            orthogonal((hidden_dim, 3 * hidden_dim), generator)
        )
        self.bias = nn.Parameter(torch.zeros(2, 3 * hidden_dim))

    def forward(self, x_seq: torch.Tensor) -> torch.Tensor:
        """[b, T, in] -> all hidden states [b, T, h], from h0 = 0."""
        b, T, _ = x_seq.shape
        cd = self.dtype
        mx_all = dot_f32(x_seq, self.kernel, cd) + self.bias[0]
        rec = self.recurrent_kernel.to(cd).float()
        h = torch.zeros((b, rec.shape[0]), dtype=torch.float32, device=x_seq.device)
        states = []
        for t in range(T):
            mh = dot_f32(h, rec, cd) + self.bias[1]
            xz, xr, xh = mx_all[:, t].chunk(3, dim=-1)
            rz, rr, rh = mh.chunk(3, dim=-1)
            z = torch.sigmoid(xz + rz)
            r = torch.sigmoid(xr + rr)
            hh = torch.tanh(xh + r * rh)
            h = z * h + (1.0 - z) * hh
            states.append(h)
        return torch.stack(states, dim=1)
