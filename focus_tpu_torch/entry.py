"""Entry points of the port: the flagship eval forward, the flagship train
step, the HR-336 EPIC-Kitchens eval forward and the STEVE autoregressive
reconstruction, each with example inputs.

``entry`` is the counterpart of ``__graft_entry__._flagship_cfg`` / ``entry()``: ORViT-
Motionformer, SSv2 16x224 (the reference's
``configs/ORViT/SSv2_ORViT-MF_224_16x4.yaml``), with random init-scale
weights (every parameter from N(0, 0.02^2)) drawn from a seeded
``torch.Generator`` and inputs made as ``bench.py`` makes them.
``train_entry`` is the counterpart of the set-up of
``scripts/profile_train.py``: the same model (with the eval entry's random
init-scale weights), batch and inputs with labels, the solver settings of
``__graft_entry__._flagship_cfg`` (AdamW, base LR 5e-5, weight decay 5e-2,
steps_with_relative_lrs, no clipping), 100 steps per epoch and the
label-smoothing cross-entropy.
``hr_entry`` is the HR-336 path: ORViT-Motionformer-HR on EPIC-Kitchens
at the 336 crop (the reference's ``configs/ORViT/EK_ORVIT_MF_HR.yaml``; the
JAX package's ``scripts/bench_companions.py hr336`` at batch 4), whose
verb and noun heads and 21 x 21 patch grid (441 tokens a frame, 445 in the
ORViT blocks) the flagship lacks, with the eval entry's random init-scale
weights.
``hr_train_entry`` is its train step: the same model with the solver and
loss of ``configs/ORViT/EK_ORVIT_MF_HR.yaml`` (``EK_loss``, see
``hr_train_cfg``), one AdamW step a call on a batch with verb and noun
labels.
``steve_entry`` is the counterpart of the model that
``scripts/bench_steve_rollout.py`` builds: STEVE at the config defaults
(64 px, 7 slots, decoder D=2048 with 8 blocks, vocabulary 4096, bf16) with
the JAX package's initialisers, reconstructing a video through ``encode``
and the KV-cached token rollout.
"""

import numpy as np
import torch

from focus_tpu_torch.config import get_cfg
from focus_tpu_torch.models.build import build_model, init_weights, resolve_device
from focus_tpu_torch.models.motionformer import EK_CLASSES

INIT_SCALE = 0.02


def flagship_cfg(tiny: bool = False):
    """The flagship config. ``tiny`` shrinks widths and depth for CPU runs
    but keeps the 224 crop (with 56-pixel patches), where the position
    embedding needs no resize."""
    cfg = get_cfg()
    cfg.MODEL.MODEL_NAME = "Motionformer"
    cfg.MODEL.NUM_CLASSES = 174
    cfg.MODEL.LOSS_FUNC = "label_smoothing_cross_entropy"
    cfg.TRAIN.DATASET = "ssv2"
    cfg.DATA.TRAIN_CROP_SIZE = 224
    cfg.DATA.NUM_FRAMES = 16
    cfg.MF.PATCH_SIZE = 16
    cfg.MF.PATCH_SIZE_TEMP = 2
    cfg.MF.EMBED_DIM = 768
    cfg.MF.DEPTH = 12
    cfg.MF.NUM_HEADS = 12
    cfg.MF.TEMPORAL_RESOLUTION = 8
    cfg.MF.USE_MLP = True
    cfg.MF.QKV_BIAS = True
    cfg.ORVIT.ENABLE = True
    cfg.ORVIT.O = 4
    cfg.ORVIT.LAYERS = [1, 6, 10]
    cfg.TPU.COMPUTE_DTYPE = "bfloat16"
    if tiny:
        cfg.DATA.NUM_FRAMES = 4
        cfg.MF.PATCH_SIZE = 56
        cfg.MF.EMBED_DIM = 24
        cfg.MF.DEPTH = 3
        cfg.MF.NUM_HEADS = 2
        cfg.MF.TEMPORAL_RESOLUTION = 2
        cfg.ORVIT.LAYERS = [1]
        cfg.TPU.COMPUTE_DTYPE = "float32"
    return cfg


def example_inputs(cfg, batch: int, seed: int, device, labels=False):
    """Video [B, T, H, W, 3] in [0, 1) and boxes [B, T/2, O, 4] (normalised
    cxcywh around the centre), from numpy's RandomState as bench.py; with
    ``labels``, (video, labels [B] int64, boxes), the labels drawn next from
    the same generator as scripts/profile_train.py draws them. For
    EPIC-Kitchens the labels are a dict: verb ids in [0, 97), then noun ids
    in [0, 300), drawn in that order."""
    rs = np.random.RandomState(seed)
    T, crop = cfg.DATA.NUM_FRAMES, cfg.DATA.TRAIN_CROP_SIZE
    video = rs.rand(batch, T, crop, crop, 3).astype(np.float32)
    boxes = (rs.rand(batch, T // 2, cfg.ORVIT.O, 4) * 0.5 + 0.25).astype(
        np.float32)
    video = torch.from_numpy(video).to(device)
    boxes = torch.from_numpy(boxes).to(device)
    if not labels:
        return video, boxes
    def ids(n):
        return torch.from_numpy(rs.randint(0, n, (batch,)).astype(
            np.int64)).to(device)

    if cfg.TRAIN.DATASET == "epickitchens":
        verb = ids(EK_CLASSES[0])
        return video, {"verb": verb, "noun": ids(EK_CLASSES[1])}, boxes
    return video, ids(cfg.MODEL.NUM_CLASSES), boxes


class EvalForward:
    """``fn(video, boxes) -> probabilities`` (the EPIC-Kitchens model's
    verb and noun pair); ``fn.model`` is the module."""

    def __init__(self, model):
        self.model = model

    @torch.no_grad()
    def __call__(self, video, boxes):
        return self.model(video, {"orvit_bboxes": boxes})


def _eval_entry(cfg, device, batch, seed):
    """(EvalForward of ``cfg``'s model with random init-scale weights
    seeded with ``seed``, example inputs) on ``device``."""
    device = resolve_device(device)
    model = build_model(cfg, device=device, seed=seed)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    init_weights(model, gen, scale=INIT_SCALE)
    return EvalForward(model), example_inputs(cfg, batch, seed, device)


def entry(device="cuda", batch: int = 8, seed: int = 0, tiny: bool = False,
          fast_gelu: bool = False, int8: bool = False):
    """(fn, (video, boxes)): the flagship eval forward and example inputs,
    on ``device`` (CUDA unless the caller asks for the CPU). ``fast_gelu``
    and ``int8`` set ``TPU.FAST_GELU`` and ``TPU.INT8_SERVING``, the
    labeled serving variants, as ``bench.py``'s ``variant_cfg`` does."""
    cfg = flagship_cfg(tiny)
    cfg.TPU.FAST_GELU = fast_gelu
    cfg.TPU.INT8_SERVING = int8
    return _eval_entry(cfg, device, batch, seed)


def hr_cfg(tiny: bool = False):
    """ORViT-Motionformer-HR, EK100 16x336: the flagship's widths (D=768,
    12 layers, 12 heads, 2 x 16 x 16 patches, 8 temporal positions, the
    tanh pre-logits MLP, ORViT at [1, 6, 10] with O = 4 and its motion
    stream, bf16) with the model fields of
    ``configs/ORViT/EK_ORVIT_MF_HR.yaml``: the EPIC-Kitchens verb and noun
    heads, the 336 crop and its drop-path rate (inactive in eval).
    ``tiny`` is the flagship's tiny size at the 336 crop: a 6 x 6 grid of
    56-pixel patches, so the 4 x 4 position grid is resized."""
    cfg = flagship_cfg(tiny)
    cfg.TRAIN.DATASET = cfg.TEST.DATASET = "epickitchens"
    cfg.MODEL.NUM_CLASSES = 97
    cfg.DATA.TRAIN_CROP_SIZE = cfg.DATA.TEST_CROP_SIZE = 336
    cfg.MF.DROP_PATH = 0.2
    cfg.MF.HEAD_ACT = "tanh"
    cfg.ORVIT.USE_MOTION_STREAM = True
    cfg.ORVIT.MOTION_STREAM_ATTN_TYPE = "joint"
    return cfg


def hr_entry(device="cuda", batch: int = 4, seed: int = 0,
             tiny: bool = False):
    """(fn, (video, boxes)): the HR-336 EPIC-Kitchens eval forward, ``fn(video,
    boxes) -> (verb, {"verb": verb, "noun": noun})`` probabilities, and
    example inputs (video [batch, 16, 336, 336, 3]), on ``device`` (CUDA
    unless the caller asks for the CPU)."""
    return _eval_entry(hr_cfg(tiny), device, batch, seed)


def train_cfg(tiny: bool = False):
    """The flagship config with the solver of
    ``__graft_entry__._flagship_cfg``."""
    cfg = flagship_cfg(tiny)
    cfg.SOLVER.OPTIMIZING_METHOD = "adamw"
    cfg.SOLVER.WEIGHT_DECAY = 5e-2
    cfg.SOLVER.BASE_LR = 5e-5
    cfg.SOLVER.LR_POLICY = "steps_with_relative_lrs"
    cfg.SOLVER.LRS = [1, 0.1, 0.01]
    cfg.SOLVER.STEPS = [0, 20, 30]
    cfg.SOLVER.MAX_EPOCH = 35
    cfg.SOLVER.CLIP_GRAD_L2NORM = None
    return cfg


STEPS_PER_EPOCH = 100  # as scripts/profile_train.py builds its state


def hr_train_cfg(tiny: bool = False):
    """``hr_cfg`` with the solver fields of
    ``configs/ORViT/EK_ORVIT_MF_HR.yaml``: AdamW, base LR 1e-5 and 1e-4 for
    the ORViT parameters, weight decay 5e-2, steps_with_relative_lrs (LRS
    [1, 0.1, 0.01] at epochs [0, 19, 40], 50 epochs, no warm-up); the
    yaml's drop-path rate 0.2 is active in training.

    ``MODEL.LOSS_FUNC`` is ``EK_loss`` (plain cross-entropy on each head,
    summed), where the yaml names ``label_smoothing_cross_entropy``: the JAX
    package takes the loss from that key (``focus_tpu/engine/trainer.py``),
    and label smoothing fails there on the dual head's dict of verb and
    noun labels, so it trains EPIC-Kitchens only under ``EK_loss``, the
    reference's own verb + noun sum (``tools/train_net.py:93-100``)."""
    cfg = hr_cfg(tiny)
    cfg.SOLVER.OPTIMIZING_METHOD = "adamw"
    cfg.SOLVER.BASE_LR = 1e-5
    cfg.SOLVER.ORVIT_BASE_LR = 1e-4
    cfg.SOLVER.WEIGHT_DECAY = 5e-2
    cfg.SOLVER.LR_POLICY = "steps_with_relative_lrs"
    cfg.SOLVER.LRS = [1, 0.1, 0.01]
    cfg.SOLVER.STEPS = [0, 19, 40]
    cfg.SOLVER.MAX_EPOCH = 50
    cfg.SOLVER.WARMUP_EPOCHS = 0.0
    cfg.MODEL.LOSS_FUNC = "EK_loss"
    return cfg


class TrainStep:
    """``fn(video, labels, boxes) -> stats``: one supervised train step of
    ``fn.model`` from ``fn.state``; the stats (the loss, and the top-1 and
    top-5 errors where the step computes them) stay on the device."""

    def __init__(self, model, state, step):
        self.model, self.state, self.step = model, state, step

    def __call__(self, video, labels, boxes):
        self.state, stats = self.step(self.state, video, labels,
                                      {"orvit_bboxes": boxes})
        return stats


def _train_entry(cfg, device, batch, seed):
    """(TrainStep of ``cfg``'s model with random init-scale weights seeded
    with ``seed``, example inputs with labels) on ``device``."""
    from focus_tpu_torch.engine.trainer import (
        build_supervised_state,
        make_supervised_train_step,
    )
    from focus_tpu_torch.models.losses import get_loss_func

    device = resolve_device(device)
    model = build_model(cfg, device=device, seed=seed)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    init_weights(model, gen, scale=INIT_SCALE)
    state = build_supervised_state(cfg, model, STEPS_PER_EPOCH)
    step = make_supervised_train_step(model, cfg, get_loss_func(cfg))
    return (TrainStep(model, state, step),
            example_inputs(cfg, batch, seed, device, labels=True))


def train_entry(device="cuda", batch: int = 8, seed: int = 0,
                tiny: bool = False):
    """(fn, (video, labels, boxes)): the flagship train step from random
    init-scale weights (seeded with ``seed``) and an example batch, on
    ``device`` (CUDA unless the caller asks for the CPU)."""
    return _train_entry(train_cfg(tiny), device, batch, seed)


def hr_train_entry(device="cuda", batch: int = 4, seed: int = 0,
                   tiny: bool = False):
    """(fn, (video, labels, boxes)): the HR-336 EPIC-Kitchens train step
    (``hr_train_cfg``) from random init-scale weights (seeded with
    ``seed``) and an example batch, on ``device`` (CUDA unless the caller
    asks for the CPU): video [batch, 16, 336, 336, 3], labels {"verb":
    [batch], "noun": [batch]}, boxes [batch, 8, 4, 4]; ``fn`` returns
    {"loss"}. Batch 4 is the HR companion's (``scripts/bench_companions.py
    hr336``); the recipe's own is 2 a GPU (``TRAIN.BATCH_SIZE`` 16 over
    ``NUM_GPUS`` 8). 100 steps an epoch, as ``train_entry``."""
    return _train_entry(hr_train_cfg(tiny), device, batch, seed)


def steve_cfg(tiny: bool = False):
    """STEVE at the config defaults with the base CNN. ``tiny`` is a CPU
    size: 16 px (16 generated tokens), 3 slots, vocabulary 32, decoder
    D=32 with 2 blocks of 2 heads, float32."""
    cfg = get_cfg()
    cfg.MODEL.MODEL_NAME = "STEVE"
    cfg.MODEL.CNN_NAME = "base"
    cfg.TPU.COMPUTE_DTYPE = "bfloat16"
    if tiny:
        cfg.SLOTS.IMG_SIZE = 16
        cfg.SLOTS.NUM_SLOTS = 3
        cfg.SLOTS.VOCAB_SIZE = 32
        cfg.SLOTS.DECODER.DIM = 32
        cfg.SLOTS.DECODER.NUM_BLOCKS = 2
        cfg.SLOTS.DECODER.NUM_HEADS = 2
        cfg.SLOTS.DECODER.DROPOUT = 0.0
        cfg.TPU.COMPUTE_DTYPE = "float32"
    return cfg


class Reconstruct:
    """``fn(video) -> recon [B, T, H, W, 3]``; ``fn.model`` is the module
    and ``fn.generator`` draws the slot-initialisation noise."""

    def __init__(self, model, generator):
        self.model = model
        self.generator = generator

    @torch.no_grad()
    def __call__(self, video):
        return self.model.reconstruct_autoregressive(
            video, generator=self.generator)


def steve_entry(device="cuda", batch: int = 8, frames: int = 4, seed: int = 0,
                tiny: bool = False, int8: bool = False):
    """(fn, (video,)): STEVE's autoregressive reconstruction and an example
    video [batch, frames, H, W, 3] in [0, 1), on ``device`` (CUDA unless
    the caller asks for the CPU). ``batch * frames`` rows are rolled out.
    ``int8`` sets ``TPU.INT8_SERVING``: the W8A8 fused decode step, as
    ``scripts/bench_steve_rollout.py``'s ``kvint8`` part does."""
    device = resolve_device(device)
    cfg = steve_cfg(tiny)
    cfg.TPU.INT8_SERVING = int8
    model = build_model(cfg, device=device, seed=seed)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    rs = np.random.RandomState(seed)
    size = cfg.SLOTS.IMG_SIZE
    video = rs.rand(batch, frames, size, size, 3).astype(np.float32)
    return Reconstruct(model, gen), (torch.from_numpy(video).to(device),)
