"""Pairwise position matrix and sinusoidal position embedding (counterpart of
tf_vqa_regat_tpu/ops/position.py), with the same (query, key) pairing and
the same lane layout."""

from __future__ import annotations

import numpy as np
import torch


def _pair_geometry(bb: torch.Tensor, q_sel: slice, k_sel: slice) -> torch.Tensor:
    """[b, R, 4] boxes (xmin, ymin, xmax, ymax) -> [b, Rq, Rk, 4]: row roi i
    (of `q_sel`) against column roi j (of `k_sel`): (log|dx/w_i|,
    log|dy/h_i|, log(w_i/w_j), log(h_i/h_j)), the first two clamped at 1e-3
    (reference position_emb.py:117-151)."""
    xmin, ymin, xmax, ymax = bb.unbind(-1)
    w = xmax - xmin + 1.0
    h = ymax - ymin + 1.0
    cx = 0.5 * (xmin + xmax)
    cy = 0.5 * (ymin + ymax)
    qw, qh, qcx, qcy = (t[:, q_sel, None] for t in (w, h, cx, cy))
    kw, kh, kcx, kcy = (t[:, None, k_sel] for t in (w, h, cx, cy))
    dx = torch.log(torch.clamp(torch.abs(qcx - kcx) / qw, min=1e-3))
    dy = torch.log(torch.clamp(torch.abs(qcy - kcy) / qh, min=1e-3))
    dw = torch.log(qw / kw)
    dh = torch.log(qh / kh)
    return torch.stack([dx, dy, dw, dh], dim=-1)


def position_matrix(bb: torch.Tensor, nongt_dim: int) -> torch.Tensor:
    """[b, R, 4] boxes -> [b, R, n, 4]: query roi i (all R) against key roi
    j (the first n = nongt_dim)."""
    return _pair_geometry(bb, slice(None), slice(None, nongt_dim))


def position_matrix_ref_compat(bb: torch.Tensor, nongt_dim: int) -> torch.Tensor:
    """The TF reference's position matrix (--ref_compat_pos; JAX
    ops/position.py::position_matrix_ref_compat): the first n = min(nongt_dim,
    R) ROWS of the pairwise matrix against all R columns, [b, n, R, 4], read
    flat as [b, R, n, 4], as the reference's attention layer reshapes it.
    A (query, key) slot then holds another pair's geometry whenever R != n;
    the shape is the corrected matrix's, so B1 takes it unchanged."""
    b, R, _ = bb.shape
    n = min(nongt_dim, R)
    return _pair_geometry(bb, slice(None, n), slice(None)).reshape(b, R, n, 4)


def position_embedding(
    pos_mat: torch.Tensor, feat_dim: int, wave_length: float = 1000.0
) -> torch.Tensor:
    """[b, R, n, 4] -> [b, R, n, feat_dim]; per geometric feature, feat_dim/8
    sin lanes then feat_dim/8 cos lanes (reference position_emb.py:96-115).
    The argument is (100 * pos) * wave^(-(8/feat_dim) * j), each product
    rounded in f32, the frequency itself rounded once from float64."""
    k = feat_dim // 8
    lane = np.arange(feat_dim)
    freq_idx = (lane % (2 * k)) % k
    inv_dim = torch.from_numpy(
        np.asarray(wave_length ** (-(8.0 / feat_dim) * freq_idx), np.float32)
    ).to(pos_mat.device)
    is_cos = torch.from_numpy((lane % (2 * k)) >= k).to(pos_mat.device)
    scaled = torch.repeat_interleave(100.0 * pos_mat, 2 * k, dim=-1) * inv_dim
    return torch.where(is_cos, torch.cos(scaled), torch.sin(scaled))
