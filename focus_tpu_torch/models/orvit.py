"""ORViT: object-region attention block (counterpart of
``focus_tpu/models/orvit.py``, reference ``slowfast/models/ORViT/orvit.py``).

1. object crops via the separable-matmul RoIAlign (``ops/roi_align.py``);
2. object descriptors: MLP + spatial amax-pool + learned [T, O, d]
   box-category embedding + 4->d coordinate MLP (orvit.py:135-143);
3. patch+object tokens concatenated per frame and run through trajectory
   attention over T x (H*W + O) tokens (orvit.py:145-152);
4. object-token outputs discarded; the MotionStream (box-only joint
   attention splatted back to the patch grid by ``boxes_to_layout``) added
   to the patch tokens (orvit.py:160-163);
5. residual + MLP (orvit.py:169-170).

Under ``TPU.MESH.SEQ`` (``parallel/tensor.py``) a seq rank holds the patch
tokens of its F / SEQ frames: RoIAlign and the object tokens are its
frames', the trajectory attention runs over its window of query frames at
N = H W + O, and the motion stream runs on every frame's boxes (its input)
on every seq rank, each keeping its frames' rows of the layout. Under
``TPU.MESH.MODEL`` the ``TwoLayerReluMlp``s are column then row parallel
(the JAX names ``fc1`` / ``fc2``), as are the MLPs and the heads of the
attentions.
"""

import torch
import torch.nn.functional as F
from torch import nn

from focus_tpu_torch.models.motionformer import (
    DropPath,
    Mlp,
    SelfAttentionBlock,
    TrajectoryAttention,
    layer_norm,
    linear,
)
from focus_tpu_torch.ops.layout import box2spatial_layout
from focus_tpu_torch.ops.roi_align import roi_align
from focus_tpu_torch.parallel import tensor as tp
from focus_tpu_torch.utils.box_ops import box_cxcywh_to_xyxy


class ObjectsCrops(nn.Module):
    """(reference ORViT/utils.py:30-76). features: [BS, T, H, W, d],
    boxes: [BS, T, O, 4] normalised cxcywh -> [BS, T, O, H, W, d]."""

    def __init__(self, cfg):
        super().__init__()
        self.crop = cfg.DATA.TRAIN_CROP_SIZE

    def forward(self, features, boxes):
        BS, T, H, W, d = features.shape
        # unnormalise to input-image pixels (reference utils.py:62-63)
        xyxy = box_cxcywh_to_xyxy(boxes) * self.crop
        out = roi_align(
            features.reshape(BS * T, H, W, d), xyxy.reshape(BS * T, -1, 4),
            (H, W), spatial_scale=H / self.crop,
        )  # [BS*T, O, H, W, d]
        return out.reshape(BS, T, boxes.shape[2], H, W, d)


class TwoLayerReluMlp(nn.Sequential):
    """linear(no bias)/relu/linear(no bias)/relu (reference orvit.py:59-72),
    a torch Sequential so its weights are named ``0`` and ``2``; column
    then row parallel where the model axis split ``0``."""

    par, sharded = None, False

    def __init__(self, in_features, hidden, out):
        super().__init__(
            nn.Linear(in_features, hidden, bias=False), nn.ReLU(),
            nn.Linear(hidden, out, bias=False), nn.ReLU(),
        )

    def attach_parallel(self, par, dims):
        self.par = par
        self.sharded = self[0].weight.shape[0] != self[0].out_features

    def forward(self, x):
        if self.sharded:
            h = F.relu(linear(tp.copy_in(x, self.par), self[0]))
            return F.relu(tp.row_linear(h, self[2], self.par))
        return F.relu(linear(F.relu(linear(x, self[0])), self[2]))


class MotionStream(nn.Module):
    """Box-coordinate-only stream (reference orvit.py:204-269)."""

    def __init__(self, cfg, dim, num_heads, mlp_ratio=4.0, qkv_bias=False,
                 nb_frames=8):
        super().__init__()
        c = cfg
        if c.ORVIT.MOTION_STREAM_SEP_POS_EMB:
            raise NotImplementedError("ORVIT.MOTION_STREAM_SEP_POS_EMB")
        self.cfg = cfg
        in_dim = c.ORVIT.MOTION_STREAM_DIM if c.ORVIT.MOTION_STREAM_DIM > 0 else dim
        self.in_dim = in_dim
        O = c.ORVIT.O
        self.c_coord_to_feature = TwoLayerReluMlp(4, in_dim // 2, in_dim)
        self.box_categories = nn.Parameter(torch.empty(nb_frames, O, in_dim))
        # the reference passes the ORViT block's num_heads through
        # (orvit.py:93,237-239); ORVIT.MOTION_STREAM_N_HEADS is never read
        self.attn = SelfAttentionBlock(
            in_dim, num_heads, mlp_ratio, qkv_bias,
            fast_gelu=bool(c.TPU.FAST_GELU),
            int8_dense=bool(c.TPU.INT8_SERVING))

    def forward(self, box_tensors, H: int, W: int, train=False):
        c = self.cfg
        BS, T, O = box_tensors.shape[:3]
        box_emb = self.c_coord_to_feature(box_tensors)
        box_emb = self.box_categories[None].to(box_emb.dtype) + box_emb
        flat = self.attn(box_emb.reshape(BS, T * O, self.in_dim), train)
        box_emb = flat.reshape(BS, T, O, self.in_dim)
        # splat object vectors into their boxes ('layout' mode, reference
        # orvit.py:182-190) with temporal average pooling
        ret = box2spatial_layout(box_tensors, box_emb, H, W)  # [BS,T,H,W,d]
        t_ratio = T // c.MF.TEMPORAL_RESOLUTION
        if t_ratio > 1:
            ret = ret.reshape(BS, -1, t_ratio, H, W, self.in_dim).mean(dim=2)
        return ret.reshape(BS, -1, self.in_dim)  # [BS, T*H*W, d]


class ORViTBlock(nn.Module):
    """(reference orvit.py:39-172). ``TPU.FAST_GELU`` and
    ``TPU.INT8_SERVING`` reach the trajectory attention, the motion stream,
    ``motion_mlp`` and ``mlp``; the ``TwoLayerReluMlp``s stay plain dense
    layers, as in the JAX package."""

    def __init__(self, cfg, dim=768, num_heads=12, mlp_ratio=4.0,
                 qkv_bias=False, attn_drop=0.0, nb_frames=8,
                 drop_path_rate=0.0):
        super().__init__()
        c = cfg
        self.cfg = cfg
        self.crop_layer = ObjectsCrops(c)
        self.patch_to_d = TwoLayerReluMlp(dim, dim // 2, dim)
        self.box_categories = nn.Parameter(torch.empty(nb_frames, c.ORVIT.O, dim))
        self.c_coord_to_feature = TwoLayerReluMlp(4, dim // 2, dim)
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        fast_gelu = bool(c.TPU.FAST_GELU)
        int8_dense = bool(c.TPU.INT8_SERVING)
        self.attn = TrajectoryAttention(dim, num_heads, qkv_bias, attn_drop,
                                        int8_dense)
        if c.ORVIT.USE_MOTION_STREAM:
            self.motion_stream = MotionStream(c, dim, num_heads, mlp_ratio,
                                              qkv_bias, nb_frames)
            self.motion_mlp = Mlp(self.motion_stream.in_dim,
                                  int(dim * mlp_ratio), dim,
                                  fast_gelu=fast_gelu, int8_dense=int8_dense)
        self.drop_path = DropPath(drop_path_rate)
        self.norm2 = nn.LayerNorm(dim, eps=1e-6)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), fast_gelu=fast_gelu,
                       int8_dense=int8_dense)

    par = None

    def attach_parallel(self, par, dims):
        self.par = par

    def forward(self, x, metadata, thw, use_kernels=True, train=False,
                generator=None):
        box_tensors = metadata["orvit_bboxes"]
        cls_token, patch_tokens = x[:, :1], x[:, 1:]
        BS, _, d = x.shape
        T, H, W = thw
        seq = self.par is not None and self.par.seq
        f0, nf = self.par.window(T) if seq else (0, T)
        patch_grid = patch_tokens.reshape(BS, nf, H, W, d)

        t_ratio = box_tensors.shape[1] // T
        box_tensors = box_tensors[:, ::t_ratio].to(patch_tokens.dtype)
        O = box_tensors.shape[-2]
        boxes = box_tensors[:, f0:f0 + nf] if seq else box_tensors
        categories = self.box_categories[f0:f0 + nf] if seq else \
            self.box_categories

        # object tokens: crop -> MLP -> spatial amax (reference :135-139)
        obj = self.patch_to_d(self.crop_layer(patch_grid, boxes))
        obj = obj.amax(dim=(3, 4))  # [BS, T, O, d]
        box_emb = self.c_coord_to_feature(boxes)
        obj = obj + categories[None].to(obj.dtype) + box_emb

        all_tokens = torch.cat(
            [patch_grid.reshape(BS, nf, H * W, d), obj], dim=2
        ).reshape(BS, nf * (H * W + O), d)
        all_tokens = torch.cat([cls_token, all_tokens], dim=1)
        all_tokens = self.attn(layer_norm(all_tokens, self.norm1),
                               (T, H * W + O, 1), use_kernels=use_kernels,
                               train=train)

        cls_token_out, rest = all_tokens[:, :1], all_tokens[:, 1:]
        patch_out = rest.reshape(BS, nf, H * W + O, d)[:, :, : H * W].reshape(
            BS, nf * H * W, d
        )
        if self.cfg.ORVIT.USE_MOTION_STREAM:
            motion = self.motion_stream(box_tensors, H, W, train)
            if seq:  # this rank's frames' rows of every frame's layout
                motion = motion[:, f0 * H * W:(f0 + nf) * H * W]
            patch_out = patch_out + self.motion_mlp(motion, train)
        y = torch.cat([cls_token_out, patch_out], dim=1)
        x = x + self.drop_path(y, train, generator)
        y = self.mlp(layer_norm(x, self.norm2), train)
        return x + self.drop_path(y, train, generator)
