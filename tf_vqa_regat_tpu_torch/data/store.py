"""Device-resident image tables and the on-device gather (counterpart of
tf_vqa_regat_tpu/data/device_store.py: `build_image_arrays` for the adaptive
layout and `gather_image_features`).

The split's feature and box tables are uploaded once, at f32; a request then
ships only token ids and an image index, and its rows are gathered on the
device, clipped to the table and zeroed past the example's box count.
bf16 and int8 tables are ROADMAP Queue A item 3; the normalised-box table
comes with the spatial relations, which read it (item 4).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from tf_vqa_regat_tpu_torch.data.synthetic import SyntheticDataset


class ImageStore:
    """`features` [T, v] and `bb` [T, 4] f32, per-image `img_start` and
    `img_len` [num_images] int64, all on `device`."""

    def __init__(self, ds: SyntheticDataset, device: torch.device):
        def put(a, dtype):
            return torch.from_numpy(np.ascontiguousarray(a)).to(device=device, dtype=dtype)

        self.features = put(ds.features, torch.float32)
        self.bb = put(ds.bb, torch.float32)
        self.img_start = put(ds.pos_boxes[:, 0], torch.int64)
        self.img_len = put(ds.pos_boxes[:, 1] - ds.pos_boxes[:, 0], torch.int64)


def gather_image_features(
    store: ImageStore,
    img: torch.Tensor,  # [B] image indices
    n_box: torch.Tensor,  # [B] valid box count per example (0 = fully padded)
    num_rois: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(features, bb), each [B, num_rois, ...]."""
    r = torch.arange(num_rois, device=img.device)
    rows = store.img_start[img][:, None] + r[None, :]  # [B, R]
    roi_ok = (r[None, :] < n_box[:, None])[..., None]
    rows = torch.clamp(rows, 0, store.features.shape[0] - 1)

    def take(tab):
        out = tab[rows]
        return torch.where(roi_ok, out, torch.zeros_like(out))

    return take(store.features), take(store.bb)
