"""Box coordinate utilities (counterpart of ``focus_tpu/utils/box_ops.py``),
the subset the eval path and the datasets use. Accepts [..., 4] tensors, and
host numpy arrays in ``zero_empty_boxes_np``."""

import numpy as np
import torch


def box_cxcywh_to_xyxy(b):
    cx, cy, w, h = b.unbind(-1)
    return torch.stack(
        [cx - 0.5 * w, cy - 0.5 * h, cx + 0.5 * w, cy + 0.5 * h], dim=-1
    )


def zero_empty_boxes_np(boxes: np.ndarray, fmt: str = "cxcywh") -> np.ndarray:
    """Zero out degenerate boxes (host numpy, for the data pipeline)."""
    if fmt == "cxcywh":
        empty = (boxes[..., 2] <= 0) | (boxes[..., 3] <= 0)
    elif fmt == "xyxy":
        empty = (boxes[..., 2] - boxes[..., 0] <= 0) | (
            boxes[..., 3] - boxes[..., 1] <= 0
        )
    else:
        raise ValueError(fmt)
    out = boxes.copy()
    out[empty] = 0.0
    return out
