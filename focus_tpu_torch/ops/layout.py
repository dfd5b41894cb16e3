"""Box-layout splat: paint per-object vectors into their box regions
(counterpart of ``focus_tpu/ops/layout.py``).

The reference (``slowfast/models/ORViT/layout.py:28-63``,
``ORViT/utils.py:8-28``) loops over (batch, frame) and calls
``F.grid_sample`` on an 8x8 constant image per object. Because the sampled
image is constant per object, grid_sample reduces to a closed-form
separable coverage weight: sampling a constant-1 8x8 image
(align_corners=True, zero padding) at normalised coordinate u gives

    cov(u) = clip(1 - max(|u| - 1, 0) * 3.5, 0, 1)      (3.5 = (8-1)/2)

so layout[b,t,i,j] = sum_o v[b,t,o] * cov(gx(o,j)) * cov(gy(o,i)).

Quirk kept for checkpoint parity: the reference feeds *xyxy* boxes into a
grid builder that expects [x0, y0, w, h] (``layout.py:110-120``), so the
effective divisor is x1 (= x0 + w), not the width.
"""

import torch

from focus_tpu_torch.utils.box_ops import box_cxcywh_to_xyxy

_SRC_RES = 8  # the reference's constant source image is 8x8


def _coverage(u):
    """Bilinear coverage of an align_corners constant image at coord u
    (u in grid_sample's [-1, 1] space)."""
    ramp = (_SRC_RES - 1) / 2.0
    return (1.0 - (u.abs() - 1.0).clamp(min=0.0) * ramp).clamp(0.0, 1.0)


def boxes_to_layout(vecs, boxes_cxcywh, H: int, W: int):
    """vecs: [..., O, D]; boxes_cxcywh: [..., O, 4] normalised cxcywh.
    Returns [..., H, W, D]: the sum over objects of their splatted vectors.

    All-zero boxes are removed in the reference; here they contribute zero
    weight (guarded against the 0/0 in the grid math).
    """
    xyxy = box_cxcywh_to_xyxy(boxes_cxcywh)
    legal = (boxes_cxcywh != 0).any(dim=-1)  # [..., O]
    x0, y0, x1, y1 = xyxy.unbind(-1)
    # the reference divides by x1 / y1, not by the width / height
    dx = torch.where(x1 == 0, torch.ones_like(x1), x1)
    dy = torch.where(y1 == 0, torch.ones_like(y1), y1)

    xs = torch.linspace(0.0, 1.0, W, dtype=vecs.dtype, device=vecs.device)
    ys = torch.linspace(0.0, 1.0, H, dtype=vecs.dtype, device=vecs.device)
    gx = (xs - x0[..., None]) / dx[..., None] * 2.0 - 1.0  # [..., O, W]
    gy = (ys - y0[..., None]) / dy[..., None] * 2.0 - 1.0  # [..., O, H]
    wx = _coverage(gx) * legal[..., None].to(gx.dtype)
    wy = _coverage(gy)
    # out[..., i, j, d] = sum_o wy[..., o, i] wx[..., o, j] v[..., o, d]
    f32 = torch.float32
    out = torch.einsum("...oi,...oj,...od->...ijd",
                       wy.to(f32), wx.to(f32), vecs.to(f32))
    return out.to(vecs.dtype)


def box2spatial_layout(boxes_cxcywh, action_map, H: int, W: int):
    """Vectorised counterpart of reference ORViT/utils.py:8-28.

    boxes_cxcywh: [BS, T, O, 4]; action_map: [BS, T, O, d]
    Returns [BS, T, H, W, d] (channels-last)."""
    return boxes_to_layout(action_map, boxes_cxcywh, H, W)
