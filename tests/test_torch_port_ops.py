"""The port's plain ops against the JAX package's on the same numpy inputs
(float32, atol 1e-5), and the box layout against its golden fixture."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from focus_tpu.ops import attention as jattn
from focus_tpu.ops import layout as jlayout
from focus_tpu.ops import roi_align as jroi
from focus_tpu_torch.ops import attention as tattn
from focus_tpu_torch.ops import layout as tlayout
from focus_tpu_torch.ops import roi_align as troi

FIXDIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures")
ATOL = 1e-5


def both(fn_j, fn_t, *arrays, **kw):
    ref = fn_j(*[jnp.asarray(a) for a in arrays], **kw)
    out = fn_t(*[torch.from_numpy(a) for a in arrays], **kw)
    return np.asarray(ref), out.numpy()


def xyxy_boxes(rs, n, o, crop):
    """Boxes in image pixels: inside, straddling the edge, and degenerate."""
    c = rs.rand(n, o, 2) * crop
    wh = rs.rand(n, o, 2) * crop * 0.6
    boxes = np.concatenate([c - wh / 2, c + wh / 2], -1)
    boxes[:, 0] = [-30.0, 10.0, crop + 20.0, crop + 40.0]  # partly outside
    boxes[:, 1, 2:] = boxes[:, 1, :2]  # zero-size
    return boxes.astype(np.float32)


@pytest.mark.parametrize("out_hw,hw", [((7, 7), (7, 9)), ((4, 5), (7, 9)),
                                       ((14, 14), (14, 14))])
def test_roi_align_matches_jax(out_hw, hw):
    rs = np.random.RandomState(0)
    (H, W), crop = hw, 224
    feats = rs.randn(2, H, W, 5).astype(np.float32)
    boxes = xyxy_boxes(rs, 2, 4, crop)
    ref = jroi.roi_align(jnp.asarray(feats), jnp.asarray(boxes), out_hw,
                         spatial_scale=H / crop, sampling_ratio=-1,
                         aligned=True)
    out = troi.roi_align(torch.from_numpy(feats), torch.from_numpy(boxes),
                         out_hw, spatial_scale=H / crop)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL)


def test_box2spatial_layout_matches_jax():
    rs = np.random.RandomState(1)
    boxes = (rs.rand(2, 3, 4, 4) * 0.5 + 0.25).astype(np.float32)
    boxes[0, 1, 2] = 0.0  # an all-zero (removed) box
    vecs = rs.randn(2, 3, 4, 6).astype(np.float32)
    ref = jlayout.box2spatial_layout(jnp.asarray(boxes), jnp.asarray(vecs), 7, 7)
    out = tlayout.box2spatial_layout(torch.from_numpy(boxes),
                                     torch.from_numpy(vecs), 7, 7)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL)


def test_box2spatial_layout_golden():
    d = dict(np.load(os.path.join(FIXDIR, "box_layout.npz")))
    H, W = (int(v) for v in d["hw"])
    out = tlayout.box2spatial_layout(torch.from_numpy(d["boxes"]),
                                     torch.from_numpy(d["vecs"]), H, W)
    # reference returns [B, C, T, H, W]; ours is [B, T, H, W, C]
    np.testing.assert_allclose(out.numpy(), d["out"].transpose(0, 2, 3, 4, 1),
                               atol=3e-5)


def test_cls_attention_matches_jax():
    rs = np.random.RandomState(2)
    cls_q = rs.randn(6, 1, 8).astype(np.float32)
    k = rs.randn(6, 25, 8).astype(np.float32)
    v = rs.randn(6, 25, 8).astype(np.float32)
    ref, out = both(jattn.cls_attention, tattn.cls_attention, cls_q, k, v,
                    scale=8 ** -0.5)
    np.testing.assert_allclose(out, ref, atol=ATOL)


def test_space_stage_matches_jax():
    rs = np.random.RandomState(3)
    F, P, d = 3, 5, 8
    q, k, v = (rs.randn(4, F * P, d).astype(np.float32) for _ in range(3))
    ref = jattn.space_stage(*map(jnp.asarray, (q, k, v)), F, d ** -0.5)
    out = tattn.space_stage(*map(torch.from_numpy, (q, k, v)), F, d ** -0.5)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL)


def test_temporal_stage_k2w_and_diagonal_match_jax():
    rs = np.random.RandomState(4)
    B, F, P, h, d = 2, 3, 4, 2, 4
    C, S = h * d, F * P
    xs = rs.randn(B, S, F, C).astype(np.float32)
    wk2 = (rs.randn(C, C) * 0.3).astype(np.float32)
    q2 = rs.randn(B, S, C).astype(np.float32)
    ref_d = jattn.take_diagonal(jnp.asarray(xs), F)
    out_d = tattn.take_diagonal(torch.from_numpy(xs), F)
    np.testing.assert_allclose(out_d.numpy(), np.asarray(ref_d), atol=ATOL)
    ref = jattn.temporal_stage_k2w(jnp.asarray(q2), jnp.asarray(wk2),
                                   jnp.asarray(xs), F, d ** -0.5, h)
    out = tattn.temporal_stage_k2w(torch.from_numpy(q2), torch.from_numpy(wk2),
                                   torch.from_numpy(xs), F, d ** -0.5, h)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL)


def test_joint_attention_matches_jax():
    rs = np.random.RandomState(5)
    q, k, v = (rs.randn(2, 3, 10, 8).astype(np.float32) for _ in range(3))
    ref = jattn.joint_attention(*map(jnp.asarray, (q, k, v)), 8 ** -0.5)
    out = tattn.joint_attention(*map(torch.from_numpy, (q, k, v)), 8 ** -0.5)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL)
