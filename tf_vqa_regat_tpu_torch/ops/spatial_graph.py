"""The 11-class spatial relation graph, built inside the step from the boxes
(counterpart of tf_vqa_regat_tpu/ops/spatial_graph.py: `build_spatial_graph`
under `jax.vmap`, as models/regat.py applies it, and `broadcast_adj_labels`).

Labels, for every ordered box pair (i, j) of an example:
  0      no relation (centre distance >= half the image diagonal)
  1      box j strictly inside box i (the reverse edge gets 2)
  2      box j strictly covers box i
  3      IoU >= 0.5
  4..11  8 angular sectors of pi/4 when the centres are close
  12     self loop (dropped by the one-hot when label_num = 11)
A padded box (an all-zero row) has no edges. The JAX function's quirks are
kept, since the published accuracy was obtained with them: the fourth
quadrant's -arccos(sin) + 2pi, and a lower triangle that takes the reverse
edge's own formula (`sector_j`) instead of the quadrant formula.

This is elementwise work that the JAX package leaves to XLA, so it is plain
PyTorch ops here too.
"""

from __future__ import annotations

import math

import torch


def _pairwise_iou(bb: torch.Tensor) -> torch.Tensor:
    """[b, R, 4] -> [b, R, R] IoU with the reference's +1 box convention."""
    x1, y1, x2, y2 = bb.unbind(-1)
    ix1 = torch.maximum(x1[:, :, None], x1[:, None, :])
    iy1 = torch.maximum(y1[:, :, None], y1[:, None, :])
    ix2 = torch.minimum(x2[:, :, None], x2[:, None, :])
    iy2 = torch.minimum(y2[:, :, None], y2[:, None, :])
    inter = torch.clamp(ix2 - ix1 + 1.0, min=0.0) * torch.clamp(iy2 - iy1 + 1.0, min=0.0)
    area = (x2 - x1 + 1.0) * (y2 - y1 + 1.0)
    union = area[:, :, None] + area[:, None, :] - inter
    return inter / torch.clamp(union, min=1e-12)


def build_spatial_graph(bb: torch.Tensor, norm_bb: torch.Tensor) -> torch.Tensor:
    """bb [b, R, 4] raw boxes (x1, y1, x2, y2), norm_bb [b, R, 6] normalised
    box features (only row 0's last two entries are read: they give the
    image size) -> [b, R, R] int32 labels 0..12."""
    R = bb.shape[1]
    x1, y1, x2, y2 = bb.unbind(-1)
    w = x2 - x1 + 1.0
    h = y2 - y1 + 1.0
    cx = 0.5 * (x1 + x2)
    cy = 0.5 * (y1 + y2)

    # A padded example has norm_bb row 0 = 0, so the size is inf (never NaN:
    # h[0] = 1 there); its pairs are invalid and get label 0 all the same.
    image_h = h[:, 0] / norm_bb[:, 0, -1]
    image_w = w[:, 0] / norm_bb[:, 0, -2]
    image_diag = torch.sqrt(image_h**2 + image_w**2)

    valid = torch.sum(bb, dim=-1) != 0.0  # [b, R]
    pair_valid = valid[:, :, None] & valid[:, None, :]

    inside = (  # j strictly inside i -> label(i, j) = 1
        (x1[:, :, None] < x1[:, None, :])
        & (x2[:, :, None] > x2[:, None, :])
        & (y1[:, :, None] < y1[:, None, :])
        & (y2[:, :, None] > y2[:, None, :])
    )
    covers = inside.transpose(1, 2)  # j covers i -> label(i, j) = 2
    overlap = _pairwise_iou(bb) >= 0.5

    y_diff = cy[:, :, None] - cy[:, None, :]
    x_diff = cx[:, :, None] - cx[:, None, :]
    diag = torch.sqrt(y_diff**2 + x_diff**2)
    close = diag < 0.5 * image_diag[:, None, None]
    safe_diag = torch.clamp(diag, min=1e-12)
    sin_ij = y_diff / safe_diag
    cos_ij = x_diff / safe_diag

    two_pi = 2.0 * math.pi
    angle_i = torch.where(
        (sin_ij >= 0) & (cos_ij >= 0),
        torch.asin(sin_ij),
        torch.where(
            (sin_ij < 0) & (cos_ij >= 0),
            torch.asin(sin_ij) + two_pi,
            torch.where(
                (sin_ij >= 0) & (cos_ij < 0),
                torch.acos(cos_ij),
                -torch.acos(torch.clamp(sin_ij, -1.0, 1.0)) + two_pi,
            ),
        ),
    )
    angle_j = torch.where(sin_ij >= 0, two_pi - angle_i, angle_i - math.pi)
    sector_i = torch.ceil(angle_i / (math.pi / 4.0)).to(torch.int32) + 3  # 4..11
    sector_j = torch.ceil(angle_j / (math.pi / 4.0)).to(torch.int32) + 3
    r = torch.arange(R, device=bb.device)
    upper = r[:, None] < r[None, :]
    sector = torch.where(upper, sector_i, sector_j.transpose(1, 2))

    zero = torch.zeros_like(sector)
    labels = torch.where(close, sector, zero)
    labels = torch.where(overlap, 3, labels)
    labels = torch.where(covers, 2, labels)
    labels = torch.where(inside, 1, labels)
    labels = torch.where(pair_valid, labels, zero)
    eye = r[:, None] == r[None, :]
    labels = torch.where(eye & valid[:, :, None], 12, labels)
    return labels.to(torch.int32)


def broadcast_adj_labels(adj: torch.Tensor, label_num: int) -> torch.Tensor:
    """Integer labels [..., R, R] -> one-hot f32 [..., R, R, label_num]:
    labels 1..label_num map to slices 0..label_num-1; label 0 (no edge) and
    labels past label_num (the self loop 12 when label_num = 11) give all-zero
    rows."""
    classes = torch.arange(1, label_num + 1, dtype=adj.dtype, device=adj.device)
    return (adj[..., None] == classes).to(torch.float32)
