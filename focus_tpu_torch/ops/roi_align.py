"""RoIAlign as separable bilinear-weight matmuls (counterpart of
``focus_tpu/ops/roi_align.py``).

RoIAlign's sampling grid is axis-separable: every output bin (i, j)
averages bilinear samples whose y-positions depend only on i and
x-positions only on j, so the op factors into two small dense weight
matrices per box,

    out[o, i, j, c] = sum_{y, x}  Wy[o, i, y] * Wx[o, j, x] * feat[y, x, c].

Semantics match torchvision with ``sampling_ratio=-1`` (adaptive
ceil(bin_size) samples per bin, emulated with a static max sample count and
masking), including the boundary rules (positions < -1 or > size are
dropped; otherwise clamped to [0, size-1]), in both forms: ``aligned=True``
shifts the box by half a pixel, ``aligned=False`` (``DETECTION.ALIGNED
False``, the Caffe2 yamls') does not and takes each box at least one pixel
wide and tall. Empty or degenerate boxes give all-zero weight rows in the
aligned form. The JAX function's ``sampling_ratio > 0`` is not ported: the
models take the adaptive count alone.
"""

from __future__ import annotations

import math

import torch


def _axis_weights(start, roi_size, n_out: int, n_in: int, max_samples: int):
    """Per-box interpolation matrix for one axis.

    start: [O] roi start coordinate (scaled and offset, feature coords)
    roi_size: [O] roi extent in feature coords
    Returns W: [O, n_out, n_in].
    """
    bin_size = roi_size / n_out  # [O]
    count = torch.ceil(bin_size).clamp(1, max_samples)

    dt, dev = start.dtype, start.device
    i = torch.arange(n_out, dtype=dt, device=dev)  # output bin index
    s = torch.arange(max_samples, dtype=dt, device=dev)  # sample in bin
    # pos[o, i, s] = start + i*bin + (s + .5) * bin / count
    pos = (
        start[:, None, None]
        + i[None, :, None] * bin_size[:, None, None]
        + (s[None, None, :] + 0.5) * bin_size[:, None, None]
        / count[:, None, None]
    )
    valid_s = s[None, None, :] < count[:, None, None]
    # torchvision boundary rule: drop if pos < -1 or pos > n_in, else clamp
    in_range = (pos >= -1.0) & (pos <= n_in)
    pos_c = pos.clamp(0.0, n_in - 1)
    y = torch.arange(n_in, dtype=dt, device=dev)
    w = (1.0 - (pos_c[..., None] - y).abs()).clamp(min=0.0)  # [O,n_out,S,n_in]
    w = torch.where((valid_s & in_range)[..., None], w, torch.zeros_like(w))
    return w.sum(dim=2) / count[:, None, None]  # [O, n_out, n_in]


def roi_align(features, boxes, output_size, spatial_scale: float,
              aligned: bool = True):
    """RoIAlign (``sampling_ratio=-1``) over a batch of feature maps, NHWC.

    features: [N, H, W, C]
    boxes: [N, O, 4] xyxy in *input-image* coordinates (one fixed set of O
        boxes per feature map).
    Returns [N, O, out_h, out_w, C].
    """
    n_out_h, n_out_w = output_size
    N, H, W, C = features.shape
    dtype = torch.promote_types(features.dtype, torch.float32)
    boxes = boxes.to(dtype)

    offset = 0.5 if aligned else 0.0
    x0, y0, x1, y1 = (boxes * spatial_scale - offset).unbind(-1)
    roi_w = x1 - x0
    roi_h = y1 - y0
    if not aligned:
        roi_w = roi_w.clamp_min(1.0)
        roi_h = roi_h.clamp_min(1.0)

    max_s_h = max(1, math.ceil(H / n_out_h) + 1)
    max_s_w = max(1, math.ceil(W / n_out_w) + 1)

    O = boxes.shape[1]
    wy = _axis_weights(y0.reshape(-1), roi_h.reshape(-1), n_out_h, H,
                       max_s_h).reshape(N, O, n_out_h, H)
    wx = _axis_weights(x0.reshape(-1), roi_w.reshape(-1), n_out_w, W,
                       max_s_w).reshape(N, O, n_out_w, W)

    f = features.to(dtype)
    # two-stage contraction: rows then columns (keeps peak memory low)
    tmp = torch.einsum("noiy,nywc->noiwc", wy, f)
    out = torch.einsum("nojw,noiwc->noijc", wx, tmp)
    return out.to(features.dtype)
