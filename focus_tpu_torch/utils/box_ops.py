"""Box coordinate utilities (counterpart of ``focus_tpu/utils/box_ops.py``),
the subset the eval path uses. Accepts [..., 4] tensors."""

import torch


def box_cxcywh_to_xyxy(b):
    cx, cy, w, h = b.unbind(-1)
    return torch.stack(
        [cx - 0.5 * w, cy - 0.5 * h, cx + 0.5 * w, cy + 0.5 * h], dim=-1
    )
