"""Supervised training (counterpart of ``focus_tpu/engine/trainer.py``):
the train step and the loop of ``tools/train_net.py``.

One step normalises a uint8 video on the device, applies mixup there
(``MIXUP.ENABLE``; its draws from the state's generator), runs the model in
train mode (float32 logits, stochastic depth from the state's generator),
takes the loss and its gradient, over ``TPU.GRAD_ACCUM`` strided
microbatches where that is above 1, applies one optimizer update and
returns the loss and the top-1 / top-5 errors as device tensors: nothing in
it waits for the device. EPIC-Kitchens (``TRAIN.DATASET: epickitchens``)
takes a dict of verb and noun labels, trains under ``EK_loss`` alone and
without mixup (the JAX rule), and its stats are the loss alone.
Multi-label data (``DATA.MULTI_LABEL``, Charades) takes multi-hot [B, C]
labels (``bce_logit``) and no top-k; its validation reports the mean
average precision ``map``. Repeated augmentation (``AUG.NUM_SAMPLE``)
reaches the step already flattened by the loader: B x NUM_SAMPLE clips.

``train`` runs the epochs: the shuffled train split, a checkpoint every
``TRAIN.CHECKPOINT_PERIOD`` epochs, validation every ``TRAIN.EVAL_PERIOD``
(the tester's eval forward on the same model, pad rows dropped), resume
(``TRAIN.AUTO_RESUME``, ``TRAIN.CHECKPOINT_FILE_PATH``) and the preemption
save. The stats reach the host once per ``LOG_PERIOD``, and each epoch's
per-iteration losses once at its end. ``train`` returns the state, as the
JAX package's does; ``run_train`` returns the whole ``TrainRun``.

A model with BatchNorm (the ResNet family) normalises each microbatch by
its own statistics in the step and moves the running buffers once a
microbatch, in order, as the JAX step's ``scan`` carries ``batch_stats``;
validation reads the running buffers. Under ``BN.USE_PRECISE_STATS`` they
are recomputed (``engine/precise_bn.py``) before each checkpoint or
validation, where the JAX loop recomputes them. A multi-pathway batch
(SlowFast's slow and fast clips) goes whole through the step, mixup (the
same draws on every pathway) and the batch count.

A MoE model (``TPU.MOE.NUM_EXPERTS > 1``) adds ``AUX_LOSS_WEIGHT`` times
its load-balance value, the mean over its MoE layers (the JAX ``_moe_aux``
with every weight 1), to the loss, one value a microbatch under
GRAD_ACCUM, and reports it as ``moe_aux``. AVA detection
(``DETECTION.ENABLE``) runs the model on the batch's boxes and takes the
masked binary cross-entropy of the per-box probabilities
(``detection_loss``), normalised by the whole batch's box count under
GRAD_ACCUM, without mixup or top-k; its validation scores the frame mAP
through ``AVAMeter`` (``engine/tester.run_detection_eval``).

Remat, ZeRO-1, multigrid, timm weights (``MODEL.LOAD_IN_PRETRAIN``),
``LOG_MODEL_INFO`` and a ``TPU.MESH`` pipeline, sequence, model or expert
axis are not ported and raise.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from focus_tpu_torch.datasets import loader as data_loader
from focus_tpu_torch.engine.precise_bn import compute_precise_bn_stats
from focus_tpu_torch.engine.tester import make_eval_forward, run_detection_eval
from focus_tpu_torch.models import optimizer as optim
from focus_tpu_torch.models.build import (
    build_model,
    check_mesh,
    maybe_zero_init_orvit,
    resolve_device,
)
from focus_tpu_torch.models.losses import get_loss_func
from focus_tpu_torch.ops.preprocess import device_normalize
from focus_tpu_torch.parallel.train_state import TrainState
from focus_tpu_torch.utils import checkpoint as cu
from focus_tpu_torch.utils import logging, lr_policy, metrics, misc
from focus_tpu_torch.utils.meters import (
    AVAMeter,
    EPICValMeter,
    EpochTimer,
    TrainMeter,
    ValMeter,
)
from focus_tpu_torch.utils.preemption import (
    PreemptionGuard,
    PreemptionSignaled,
)
from focus_tpu_torch.utils.profiler import StepProfiler
from focus_tpu_torch.visualization.tensorboard_vis import TensorboardWriter

logger = logging.get_logger(__name__)


def topk_errors(logits, labels, ks=(1, 5)):
    """Per-batch top-k error in percent, on the device
    (``_topk_errors_device``)."""
    max_k = min(max(ks), logits.shape[-1])
    top = torch.topk(logits, max_k, dim=-1).indices
    correct = top == labels[:, None]
    return {f"top{k}_err": 100.0 * (1.0 - correct[:, :min(k, max_k)]
                                    .any(dim=1).float().mean())
            for k in ks}


def _is_ek(cfg) -> bool:
    return cfg.TRAIN.DATASET == "epickitchens"


def _check_options(cfg):
    check_mesh(cfg)
    unported = {
        "TPU.REMAT": bool(cfg.TPU.REMAT),
        "TPU.ZERO1": bool(cfg.TPU.ZERO1),
    }
    missing = [k for k, v in unported.items() if v]
    if missing:
        raise NotImplementedError(f"not ported yet: {missing}")
    if _is_ek(cfg) and cfg.MODEL.LOSS_FUNC != "EK_loss":
        raise ValueError(
            f"MODEL.LOSS_FUNC {cfg.MODEL.LOSS_FUNC} on EPIC-Kitchens: the "
            "verb and noun heads train under EK_loss alone (the JAX "
            "package's other losses fail on the dict of verb and noun "
            "labels); set MODEL.LOSS_FUNC EK_loss"
        )


def _check_train_options(cfg):
    """Raise, before anything is built, on what the loop does not run."""
    _check_options(cfg)
    if cfg.MULTIGRID.LONG_CYCLE or cfg.MULTIGRID.SHORT_CYCLE:
        raise NotImplementedError(
            "MULTIGRID.LONG_CYCLE / SHORT_CYCLE: multigrid training comes "
            "with the multigrid slice of the port"
        )
    if getattr(cfg.MODEL, "LOAD_IN_PRETRAIN", ""):
        raise NotImplementedError(
            "MODEL.LOAD_IN_PRETRAIN: timm-format image weights are not read "
            "by the port yet"
        )
    if getattr(cfg, "LOG_MODEL_INFO", False):
        raise NotImplementedError(
            "LOG_MODEL_INFO: the JAX package counts FLOPs with XLA's cost "
            "analysis, which has no counterpart in the port"
        )


def no_wd_paths(cfg):
    """Position and class embeddings excluded from weight decay
    (``_no_wd_paths``)."""
    if cfg.MODEL.MODEL_NAME == "MViT" and not cfg.MVIT.ZERO_DECAY_POS_CLS:
        return ()
    return ("pos_embed", "cls_token", "temp_embed", "st_embed")


def split_batch(batch):
    """Loader output -> (video, labels, metadata) (``_split_batch``)."""
    if isinstance(batch, (tuple, list)):
        if len(batch) == 2:
            return batch[0], batch[1], {}
        if len(batch) >= 4:
            return batch[0], batch[1], batch[3]
        return batch[0], batch[1], {}
    return batch, None, {}


def build_supervised_state(cfg, model, steps_per_epoch: int) -> TrainState:
    """The train state of a built model: ORVIT.ZERO_INIT_ORVIT applied, the
    optimizer with its groups and schedules, and a generator on the
    model's device seeded with cfg.RNG_SEED."""
    _check_options(cfg)
    maybe_zero_init_orvit(cfg, model)
    optimizer = optim.construct_optimizer(model, cfg, steps_per_epoch,
                                          no_wd_paths(cfg))
    device = next(model.parameters()).device
    generator = torch.Generator(device=device)
    generator.manual_seed(cfg.RNG_SEED)
    return TrainState(model, optimizer, generator)


# ---- mixup ---------------------------------------------------------------

GAMMA_CANDIDATES = 16  # Marsaglia-Tsang proposals a draw (each kept > 95%)


def _gamma(alpha: float, generator, device):
    """One Gamma(alpha, 1) draw on the device from ``generator``
    (Marsaglia-Tsang on GAMMA_CANDIDATES proposals, the first accepted
    kept; alpha < 1 as Gamma(alpha + 1) x U^(1 / alpha)), float64."""
    boost = alpha < 1.0
    a = alpha + 1.0 if boost else alpha
    d = a - 1.0 / 3.0
    c = 1.0 / math.sqrt(9.0 * d)
    opts = dict(generator=generator, device=device, dtype=torch.float64)
    z = torch.randn(GAMMA_CANDIDATES, **opts)
    u = torch.rand(GAMMA_CANDIDATES, **opts)
    v = (1.0 + c * z) ** 3
    ok = (v > 0) & (torch.log(u) < 0.5 * z * z + d - d * v
                    + d * torch.log(v.clamp_min(1e-300)))
    g = d * v[torch.argmax(ok.float())]
    if boost:
        g = g * torch.rand((), **opts) ** (1.0 / alpha)
    return g


def _beta(alpha: float, generator, device):
    x = _gamma(alpha, generator, device)
    y = _gamma(alpha, generator, device)
    return (x / (x + y)).float()


def sample_mixup(cfg, generator, shape, device) -> dict:
    """The draws of one mixup / CutMix step, on the device from
    ``generator``, as ``_device_mixup`` makes them: whether to mix
    (MIXUP.PROB), whether CutMix (CUTMIX_ALPHA > 0 and, where ALPHA > 0,
    SWITCH_PROB), lam from Beta(alpha, alpha) of the chosen kind (1 where
    nothing mixes), and the box centre (cy, cx) in the [.., H, W, C]
    video of ``shape``."""
    m = cfg.MIXUP
    H, W = shape[-3], shape[-2]
    use_mix = torch.rand((), generator=generator, device=device) < m.PROB
    switch = torch.rand((), generator=generator, device=device)
    use_cutmix = (switch < m.SWITCH_PROB) | (m.ALPHA <= 0.0)
    use_cutmix = use_cutmix & (m.CUTMIX_ALPHA > 0.0)
    lam_mix = _beta(max(m.ALPHA, 1e-8), generator, device)
    lam_cut = _beta(max(m.CUTMIX_ALPHA, 1e-8), generator, device)
    lam = torch.where(use_cutmix, lam_cut, lam_mix)
    lam = torch.where(use_mix, lam, torch.ones_like(lam))
    cy = torch.randint(0, H, (), generator=generator, device=device)
    cx = torch.randint(0, W, (), generator=generator, device=device)
    return {"use_mix": use_mix, "use_cutmix": use_cutmix, "lam": lam,
            "cy": cy, "cx": cx}


def _mix_video(video, draws):
    """One pathway [B, T, H, W, C] mixed by ``draws``; returns it and the
    lam of its labels."""
    use_mix, lam = draws["use_mix"], draws["lam"]
    cut = use_mix & draws["use_cutmix"]
    H, W = video.shape[-3], video.shape[-2]
    flipped = torch.flip(video, dims=(0,))
    ratio = torch.sqrt(1.0 - lam)
    cut_h = (H * ratio).to(torch.int32)
    cut_w = (W * ratio).to(torch.int32)
    cy, cx = draws["cy"].to(torch.int32), draws["cx"].to(torch.int32)
    y1, y2 = (cy - cut_h // 2).clamp(0, H), (cy + cut_h // 2).clamp(0, H)
    x1, x2 = (cx - cut_w // 2).clamp(0, W), (cx + cut_w // 2).clamp(0, W)
    ys = torch.arange(H, device=video.device)[:, None]
    xs = torch.arange(W, device=video.device)[None, :]
    in_box = ((ys >= y1) & (ys < y2) & (xs >= x1) & (xs < x2))[..., None]
    cut_video = torch.where(in_box, flipped, video)
    lam_cut = 1.0 - ((y2 - y1) * (x2 - x1)).float() / (H * W)
    mix_video = video * lam + flipped * (1.0 - lam)
    video = torch.where(cut, cut_video, torch.where(use_mix, mix_video, video))
    return video, torch.where(cut, lam_cut, lam)


def apply_mixup(video, labels, cfg, draws):
    """``_device_mixup``'s application of ``draws`` to a normalised video
    [B, T, H, W, C] and its integer labels: mixup blends each clip with
    the batch reversed; CutMix pastes the reversed batch into a box of
    side sqrt(1 - lam) around (cy, cx), clipped, and takes lam from the box
    as cut; the labels become label-smoothed (MIXUP.LABEL_SMOOTH_VALUE)
    one-hot rows mixed by that lam. A list of pathways (which share H and
    W) is mixed pathway by pathway with the same draws; the JAX function
    takes one array. Returns (video, soft labels)."""
    n = cfg.MODEL.NUM_CLASSES
    smoothing = cfg.MIXUP.LABEL_SMOOTH_VALUE
    if isinstance(video, (tuple, list)):
        mixed = [_mix_video(v, draws) for v in video]
        video, lam_final = type(video)(m[0] for m in mixed), mixed[0][1]
    else:
        video, lam_final = _mix_video(video, draws)

    on = 1.0 - smoothing + smoothing / n
    off = smoothing / n
    y1h = F.one_hot(labels.long(), n).float() * (on - off) + off
    y2h = F.one_hot(torch.flip(labels, dims=(0,)).long(),
                    n).float() * (on - off) + off
    return video, y1h * lam_final + y2h * (1.0 - lam_final)


# ---- the step ------------------------------------------------------------

def detection_loss(preds, labels, mask, denom=None):
    """Masked binary cross-entropy of the RoI head's per-box probabilities
    (``_detection_loss``): preds, labels [B, O, C], mask [B, O]; the
    probabilities clipped to [1e-7, 1 - 1e-7], the mean over classes, the
    sum over valid boxes over ``denom`` (default: their count, at least 1;
    GRAD_ACCUM passes the whole batch's count over the microbatches, so the
    microbatches' mean is the whole batch's loss)."""
    eps = 1e-7
    p = preds.clamp(eps, 1 - eps)
    labels = labels.to(p.dtype)
    bce = -(labels * torch.log(p) + (1 - labels) * torch.log(1 - p)).mean(-1)
    if denom is None:
        denom = mask.sum().clamp_min(1.0)
    return (bce * mask).sum() / denom


def _batch_size(video) -> int:
    # multi-pathway models (SlowFast) carry a tuple of videos
    return (video[0] if isinstance(video, (tuple, list)) else video).shape[0]


def _microbatch(tree, a: int, accum: int):
    """Microbatch ``a`` of ``accum``: rows a, a + accum, ... of every leaf
    (the strided split of ``train_step_accum``), each copied contiguous
    (the patch-embed kernel reads a contiguous video)."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _microbatch(v, a, accum) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_microbatch(v, a, accum) for v in tree)
    return tree[a::accum].contiguous()


def make_supervised_train_step(model, cfg, loss_fn):
    """``step(state, video, labels, metadata) -> (state, stats)``: one
    optimizer update; ``stats`` holds ``loss``, for single-label data
    other than EPIC-Kitchens and AVA ``top1_err`` and ``top5_err``, and for
    a MoE model ``moe_aux`` (device tensors; under TPU.GRAD_ACCUM each the
    mean over the microbatches). ``labels`` is a tensor, for EPIC-Kitchens
    a dict of the verb and noun labels; AVA's metadata holds ``boxes`` and
    ``boxes_mask``."""
    _check_options(cfg)
    is_ek = _is_ek(cfg)
    detection = bool(cfg.DETECTION.ENABLE)
    use_mixup = cfg.MIXUP.ENABLE and not is_ek and not detection
    want_topk = not is_ek and not cfg.DATA.MULTI_LABEL and not detection
    accum = max(int(cfg.TPU.GRAD_ACCUM or 1), 1)
    moe_on = int(cfg.TPU.MOE.NUM_EXPERTS or 0) > 1
    moe_w = float(cfg.TPU.MOE.AUX_LOSS_WEIGHT)

    def forward_backward(state, video, labels, metadata, hard_labels,
                         det_denom=None):
        extra = {"bboxes": metadata["boxes"]} if detection else {}
        if moe_on:
            moe_aux = extra["moe_aux"] = []
        logits = model(video, metadata, train=True, generator=state.generator,
                       **extra)
        if detection:
            loss = detection_loss(logits, labels, metadata["boxes_mask"],
                                  det_denom)
        else:
            loss = loss_fn(logits, labels)
        stats = {}
        if moe_on:
            aux = torch.stack(moe_aux).mean()
            loss = loss + moe_w * aux
            stats["moe_aux"] = aux.detach()
        loss.backward()
        stats["loss"] = loss.detach()
        if hard_labels is not None:
            stats.update(topk_errors(logits.detach(), hard_labels))
        return stats

    def train_step(state, video, labels, metadata):
        # normalised before mixup, so that clips blend in normalised space
        video = device_normalize(video, cfg)
        hard_labels = labels
        if use_mixup:
            first = video[0] if isinstance(video, (tuple, list)) else video
            draws = sample_mixup(cfg, state.generator, first.shape,
                                 first.device)
            video, labels = apply_mixup(video, labels, cfg, draws)
        topk_labels = hard_labels if (
            want_topk and hard_labels.ndim == 1) else None
        state.optimizer.zero_grad()
        if accum == 1:
            stats = forward_backward(state, video, labels, metadata,
                                     topk_labels)
        else:
            if _batch_size(video) % accum:
                raise ValueError(f"batch {_batch_size(video)} does not split "
                                 f"into TPU.GRAD_ACCUM={accum} microbatches")
            # the whole batch's box count, each microbatch's share of it
            det_denom = (metadata["boxes_mask"].sum().clamp_min(1.0) / accum
                         if detection else None)
            parts = [forward_backward(
                state, *(_microbatch(x, a, accum) for x in (
                    video, labels, metadata, topk_labels)), det_denom)
                for a in range(accum)]
            with torch.no_grad():  # the gradients' sum over microbatches / A
                for p in model.parameters():
                    if p.grad is not None:
                        p.grad.div_(accum)
            stats = {k: torch.stack([s[k] for s in parts]).mean()
                     for k in parts[0]}
        state.apply_gradients()
        return state, stats

    return train_step


# ---- the loop --------------------------------------------------------------

@dataclasses.dataclass
class TrainRun:
    """One ``train`` call: the final state; each epoch's per-iteration
    losses; each validation's stats (epoch, and the val meter's error or
    accuracy means over the split); the epochs' seconds on the host clock
    (loader, validation and checkpoints included), the train loader's
    waits (``first_wait_seconds`` of them for each epoch's first batch);
    the train steps and clips; each checkpoint save's seconds; validation's
    seconds and clips."""

    state: TrainState
    losses: List[List[float]] = dataclasses.field(default_factory=list)
    val_stats: List[dict] = dataclasses.field(default_factory=list)
    start_epoch: int = 0
    checkpoint: Optional[dict] = None
    seconds: float = 0.0
    wait_seconds: float = 0.0
    first_wait_seconds: float = 0.0
    steps: int = 0
    clips: int = 0
    checkpoint_seconds: List[float] = dataclasses.field(default_factory=list)
    val_seconds: float = 0.0
    val_clips: int = 0


def train_epoch(train_loader, state, train_step, train_meter, cur_epoch, cfg,
                writer=None, profiler=None, preempt_guard=None):
    """One epoch over ``train_loader``; returns (state, the epoch's
    per-iteration losses). The stats reach the host at each LOG_PERIOD-th
    iteration and the losses once at the end, so between them the loop
    never waits for the device."""
    data_size = len(train_loader)
    device = next(state.model.parameters()).device
    losses = torch.zeros(data_size, dtype=torch.float32, device=device)
    train_meter.iter_tic()
    for cur_iter, batch in enumerate(train_loader):
        if profiler is not None:
            profiler.step(data_size * cur_epoch + cur_iter)
        video, labels, metadata = split_batch(batch)
        train_meter.data_toc()
        state, stats = train_step(state, video, labels, metadata)
        losses[cur_iter] = stats["loss"]
        if (cur_iter + 1) % cfg.LOG_PERIOD == 0:
            keys = sorted(stats)
            host = dict(zip(keys, torch.stack(
                [stats[k].float() for k in keys]).tolist()))
            epoch_f = cur_epoch + float(cur_iter) / data_size
            lr = lr_policy.get_lr_at_epoch(cfg, epoch_f)["lr"]
            train_meter.update_stats(
                host.get("top1_err"), host.get("top5_err"), host["loss"], lr,
                _batch_size(video), host.get("moe_aux"),
            )
            if writer is not None:
                # (reference train_net.py:262-274)
                scalars = {"Train/loss": host["loss"], "Train/lr": lr}
                if host.get("top1_err") is not None:
                    scalars["Train/Top1_err"] = host["top1_err"]
                    scalars["Train/Top5_err"] = host["top5_err"]
                writer.add_scalars(scalars,
                                   global_step=data_size * cur_epoch + cur_iter)
        train_meter.iter_toc()
        train_meter.log_iter_stats(cur_epoch, cur_iter)
        if preempt_guard is not None and preempt_guard.poll(cur_iter):
            raise PreemptionSignaled(cur_epoch, state)
        train_meter.iter_tic()
    train_meter.log_epoch_stats(cur_epoch)
    train_meter.reset()
    return state, losses.tolist()


def _host(x):
    """A batch leaf on the host as numpy (probabilities as float32)."""
    if torch.is_floating_point(x):
        x = x.float()
    return x.cpu().numpy()


def val_stats(val_meter) -> dict:
    """The val meter's means over the split: top-1 / top-5 errors,
    EPIC-Kitchens' verb, noun and action accuracies, or for multi-label
    data and AVA the mean average precision."""
    if isinstance(val_meter, AVAMeter):
        return {"map": val_meter.full_map}
    n = max(val_meter.num_samples, 1)
    if isinstance(val_meter, EPICValMeter):
        return {k: v / n for k, v in val_meter.totals.items()}
    if val_meter.multi_label:
        return {"map": val_meter.map}
    return {"top1_err": val_meter.num_top1_mis / n,
            "top5_err": val_meter.num_top5_mis / n}


@torch.no_grad()
def eval_epoch(val_loader, forward, val_meter, cur_epoch, cfg, writer=None):
    """Validation (``eval_epoch``'s non-detection path): ``forward(video,
    metadata)`` on every batch; the loader's pad rows (index -1) are
    dropped on the host, so each val clip counts once. Multi-label data
    (``DATA.MULTI_LABEL``) keeps the probabilities and multi-hot labels for
    the meter's mean average precision and takes no top-k errors (the JAX
    package's ``eval_epoch`` takes them, and raises on such labels). AVA
    (an ``AVAMeter``) goes through ``run_detection_eval``. Returns the clips
    counted."""
    if isinstance(val_meter, AVAMeter):
        val_meter.reset()
        return run_detection_eval(val_loader, forward, val_meter,
                                  cur_epoch=cur_epoch)[1]
    is_ek = isinstance(val_meter, EPICValMeter)
    val_meter.reset()
    clips = 0
    for cur_iter, batch in enumerate(val_loader):
        video, labels, metadata = split_batch(batch)
        valid = None
        if isinstance(batch, (tuple, list)) and len(batch) >= 4:
            idx_h = _host(batch[2])
            if idx_h.ndim == 1 and (idx_h < 0).any():
                valid = idx_h >= 0
        preds = forward(video, metadata)
        if is_ek:
            _, both = preds
            verb, noun = _host(both["verb"]), _host(both["noun"])
            lv, ln = _host(labels["verb"]), _host(labels["noun"])
            if valid is not None:
                verb, noun, lv, ln = verb[valid], noun[valid], lv[valid], ln[valid]
            if verb.shape[0] == 0:
                continue
            v1, v5 = metrics.topk_accuracies(verb, lv, (1, 5))
            n1, n5 = metrics.topk_accuracies(noun, ln, (1, 5))
            a1, a5 = metrics.multitask_topk_accuracies(
                (verb, noun), (lv, ln), (1, 5)
            )
            val_meter.update_stats((v1, n1, a1), (v5, n5, a5), verb.shape[0])
            clips += verb.shape[0]
        else:
            logits = preds[0] if isinstance(preds, tuple) else preds
            logits_h, labels_h = _host(logits), _host(labels)
            if valid is not None:
                logits_h, labels_h = logits_h[valid], labels_h[valid]
            if logits_h.shape[0] == 0:
                continue
            if not val_meter.multi_label:  # multi-hot labels: mAP at the end
                errs = metrics.topk_errors(logits_h, labels_h, (1, 5))
                val_meter.update_stats(errs[0], errs[1], logits_h.shape[0])
            val_meter.update_predictions(logits_h, labels_h)
            clips += logits_h.shape[0]
        val_meter.log_iter_stats(cur_epoch, cur_iter)
    val_meter.log_epoch_stats(cur_epoch)
    if writer is not None and getattr(val_meter, "all_preds", None):
        writer.plot_eval(np.concatenate(val_meter.all_preds, axis=0),
                         np.concatenate(val_meter.all_labels, axis=0),
                         global_step=cur_epoch)
    return clips


def _build_val(cfg, device):
    """The val loader and its meter (``_build_val``)."""
    val_loader = data_loader.construct_loader(cfg, "val", device)
    if cfg.DETECTION.ENABLE:
        return val_loader, AVAMeter(
            len(val_loader), cfg, "val",
            video_idx_to_name=val_loader.dataset._video_idx_to_name)
    if _is_ek(cfg):
        return val_loader, EPICValMeter(len(val_loader), cfg)
    return val_loader, ValMeter(len(val_loader), cfg)


def train(cfg, device="cuda"):
    """Supervised training (reference train_net.py:573-747) on ``device``
    (CUDA unless the caller asks for the CPU); returns the final state."""
    return run_train(cfg, device).state


def run_train(cfg, device="cuda") -> TrainRun:
    """``train``, returning the whole ``TrainRun``."""
    device = resolve_device(device)
    _check_train_options(cfg)
    np.random.seed(cfg.RNG_SEED)
    torch.manual_seed(cfg.RNG_SEED)
    logging.setup_logging(cfg.OUTPUT_DIR)
    logger.info("Train with config:")
    logger.info(cfg.dump())

    model = build_model(cfg, device)
    train_loader = data_loader.construct_loader(cfg, "train", device)
    val_loader, val_meter = _build_val(cfg, device)
    state = build_supervised_state(cfg, model, len(train_loader))
    n_params = sum(p.numel() for p in model.parameters())
    logger.info(
        f"{cfg.MODEL.MODEL_NAME} initialised: {n_params / 1e6:.2f}M params"
    )
    start_epoch, report = cu.load_train_checkpoint(cfg, state)
    run = TrainRun(state=state, start_epoch=start_epoch, checkpoint=report)

    train_step = make_supervised_train_step(model, cfg, get_loss_func(cfg))
    forward = make_eval_forward(model, cfg)
    train_meter = TrainMeter(len(train_loader), cfg)
    writer = TensorboardWriter(cfg) if logging.is_master_process() else None
    profiler = StepProfiler(cfg)
    preempt_guard = PreemptionGuard(cfg)
    try:
        _train_epochs(cfg, run, train_loader, val_loader, val_meter,
                      train_step, forward, train_meter, writer, profiler,
                      preempt_guard)
    except PreemptionSignaled as p:
        logger.info(
            f"Preempted during epoch {p.epoch}: saving checkpoint and "
            "exiting 0 for requeue (AUTO_RESUME replays the epoch)"
        )
        cu.save_checkpoint(cfg.OUTPUT_DIR, p.state, p.epoch, cfg,
                           async_write=False)
        cu.wait_for_saves()
        profiler.stop()
        if writer is not None:
            writer.close()
        raise SystemExit(0)
    profiler.stop()
    cu.wait_for_saves()  # land any async checkpoint writes before returning
    if writer is not None:
        writer.close()
    return run


def _train_epochs(cfg, run, train_loader, val_loader, val_meter, train_step,
                  forward, train_meter, writer, profiler, preempt_guard):
    state = run.state
    epoch_timer = EpochTimer()
    t0 = time.perf_counter()
    for cur_epoch in range(run.start_epoch, cfg.SOLVER.MAX_EPOCH):
        data_loader.shuffle_dataset(train_loader, cur_epoch)
        epoch_timer.epoch_tic()
        state.model.train()
        try:
            state, losses = train_epoch(
                train_loader, state, train_step, train_meter, cur_epoch, cfg,
                writer=writer, profiler=profiler, preempt_guard=preempt_guard,
            )
        finally:
            run.wait_seconds += train_loader.wait_seconds
            run.first_wait_seconds += train_loader.first_wait_seconds
        run.losses.append(losses)
        run.steps += len(losses)
        run.clips += len(losses) * (train_loader.batch_size
                                    * train_loader.flatten_samples)
        epoch_timer.epoch_toc()
        logger.info(
            f"Epoch {cur_epoch} takes {epoch_timer.last_epoch_time():.2f}s."
        )
        is_checkp = cu.is_checkpoint_epoch(cfg, cur_epoch)
        is_eval = misc.is_eval_epoch(cfg, cur_epoch)
        if (is_checkp or is_eval) and cfg.BN.USE_PRECISE_STATS:
            compute_precise_bn_stats(state.model, train_loader,
                                     cfg.BN.NUM_BATCHES_PRECISE, split_batch,
                                     cfg)
        if is_checkp:
            t_save = time.perf_counter()
            cu.save_checkpoint(cfg.OUTPUT_DIR, state, cur_epoch + 1, cfg)
            run.checkpoint_seconds.append(time.perf_counter() - t_save)
        if is_eval:
            state.model.eval()
            t_val = time.perf_counter()
            run.val_clips += eval_epoch(val_loader, forward, val_meter,
                                        cur_epoch, cfg, writer=writer)
            run.val_seconds += time.perf_counter() - t_val
            run.val_stats.append({"epoch": cur_epoch + 1,
                                  **val_stats(val_meter)})
            state.model.train()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    run.seconds = time.perf_counter() - t0
    run.state = state
    state.model.eval()
