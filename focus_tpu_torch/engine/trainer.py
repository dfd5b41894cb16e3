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
its load-balance value (``models/moe.load_balance``: the JAX ``_moe_aux``,
the mean over its MoE layers and, in a pipelined segment, over JAX's
global microbatches, the sums over rows reduced over the data line), to
the loss, one value a microbatch under GRAD_ACCUM, and reports it as
``moe_aux``, the same on every rank. AVA detection
(``DETECTION.ENABLE``) runs the model on the batch's boxes and takes the
masked binary cross-entropy of the per-box probabilities
(``detection_loss``), normalised by the whole batch's box count under
GRAD_ACCUM, without mixup or top-k; its validation scores the frame mAP
through ``AVAMeter`` (``engine/tester.run_detection_eval``).

Under data parallelism (``parallel/mesh.py``, one process a card) each
process steps on its slice of the global batch and the step equals one
process's over the whole of it: the gradients are averaged over the
processes once, after the last microbatch (``models/optimizer.py``);
BatchNorm takes the global batch's statistics (``models/norms.py``); mixup
pairs each clip with the global batch reversed, so local clip i of
process r meets clip L - 1 - i of process W - 1 - r, whose rows an
all-gather brings (the draws are alike on every process, from generators
seeded alike); every batch-shaped draw is made at the global size and
sliced (``models/common.sharded_draws``); the loss and the top-k errors are
the processes' mean; AVA's box count is the global batch's. Validation
gathers every process's outputs before the meter, so each clip counts once
and every process holds the same meter. Rank 0 writes the checkpoints and
the TensorBoard events.

Multigrid training (``MULTIGRID.LONG_CYCLE`` / ``SHORT_CYCLE``,
``utils/multigrid.py``) rewrites the config before the build; at each
long-cycle shape change the model is rebuilt with the schedule's BN type
and the weights, the optimizer state, the step and the generator carry
over, the loaders and meters are rebuilt, and the LR schedule continues
from (epoch, step) under the new steps per epoch
(``_rebuild_for_long_cycle``). The short cycle is the loader's.

Sequence, tensor, pipeline and expert parallelism (``TPU.MESH.SEQ``,
``MODEL``, ``PIPE``, ``EXPERT``), ZeRO-1 (``TPU.ZERO1``) and remat
(``TPU.REMAT``) run on the Motionformer / ORViT-MF family
(``parallel/mesh.py``, ``parallel/tensor.py``, ``parallel/pipeline.py``,
``models/optimizer.py``, ``models/motionformer.py``, ``models/moe.py``):
the pipe, seq, model and expert ranks of a data line step on the same
clips, the loss and errors are the data line's mean, and the step equals
one process's over the global batch (under PIPE, the one-process
pipelined model's, ``mesh.single_process_mesh``). Each rank logs its
parameter and optimizer-state bytes.

Timm weights (``MODEL.LOAD_IN_PRETRAIN``), ``LOG_MODEL_INFO`` and what
``parallel/mesh.check_mesh`` refuses are not ported and raise.
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
from focus_tpu_torch.engine.tester import (
    gathered_host,
    make_eval_forward,
    run_detection_eval,
)
from focus_tpu_torch.models import optimizer as optim
from focus_tpu_torch.models.build import (
    build_model,
    maybe_zero_init_orvit,
    resolve_device,
)
from focus_tpu_torch.models.common import sharded_draws
from focus_tpu_torch.models.losses import get_loss_func
from focus_tpu_torch.models.moe import load_balance
from focus_tpu_torch.ops.preprocess import device_normalize
from focus_tpu_torch.parallel import mesh
from focus_tpu_torch.parallel.train_state import TrainState
from focus_tpu_torch.utils import checkpoint as cu
from focus_tpu_torch.utils import logging, lr_policy, metrics, misc
from focus_tpu_torch.utils.multigrid import MultigridSchedule
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
    mesh.check_mesh(cfg)
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


def state_bytes(state) -> dict:
    """This rank's bytes of parameters and of optimizer state (after a
    step: the moments exist from the first update)."""
    params = sum(p.numel() * p.element_size()
                 for p in state.model.parameters())
    opt = sum(v.numel() * v.element_size()
              for st in state.optimizer.optimizer.state.values()
              for v in st.values() if torch.is_tensor(v))
    return {"param_bytes": params, "optimizer_bytes": opt}


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


def _mix_video(video, draws, flipped=None):
    """One pathway [B, T, H, W, C] mixed by ``draws`` with its partner
    rows ``flipped`` (default: the batch reversed); returns it and the lam
    of its labels."""
    use_mix, lam = draws["use_mix"], draws["lam"]
    cut = use_mix & draws["use_cutmix"]
    H, W = video.shape[-3], video.shape[-2]
    if flipped is None:
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


def global_partner(x):
    """The rows that mixup pairs with this process's rows of ``x`` (a
    tensor or a list of pathways): this process's slice of the global
    batch reversed, which is process W - 1 - r's rows reversed."""
    if isinstance(x, (tuple, list)):
        return type(x)(global_partner(v) for v in x)
    return torch.flip(mesh.from_mirror(x), dims=(0,))


def apply_mixup(video, labels, cfg, draws, partner=None):
    """``_device_mixup``'s application of ``draws`` to a normalised video
    [B, T, H, W, C] and its integer labels: mixup blends each clip with
    the batch reversed; CutMix pastes the reversed batch into a box of
    side sqrt(1 - lam) around (cy, cx), clipped, and takes lam from the box
    as cut; the labels become label-smoothed (MIXUP.LABEL_SMOOTH_VALUE)
    one-hot rows mixed by that lam. A list of pathways (which share H and
    W) is mixed pathway by pathway with the same draws; the JAX function
    takes one array. ``partner`` is (video, labels) of the rows each row
    meets, ``global_partner``'s, as a process of a data-parallel step
    passes it; by default the batch reversed. Returns (video, soft
    labels)."""
    n = cfg.MODEL.NUM_CLASSES
    smoothing = cfg.MIXUP.LABEL_SMOOTH_VALUE
    if partner is None:
        partner = (None, torch.flip(labels, dims=(0,)))
    p_video, p_labels = partner
    if isinstance(video, (tuple, list)):
        p_video = p_video or [None] * len(video)
        mixed = [_mix_video(v, draws, p) for v, p in zip(video, p_video)]
        video, lam_final = type(video)(m[0] for m in mixed), mixed[0][1]
    else:
        video, lam_final = _mix_video(video, draws, p_video)

    on = 1.0 - smoothing + smoothing / n
    off = smoothing / n
    y1h = F.one_hot(labels.long(), n).float() * (on - off) + off
    y2h = F.one_hot(p_labels.long(), n).float() * (on - off) + off
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
    mean over the microbatches; under data parallelism each the processes'
    mean). ``labels`` is a tensor, for EPIC-Kitchens a dict of the verb
    and noun labels; AVA's metadata holds ``boxes`` and ``boxes_mask``.
    The batch is this process's slice of the global batch."""
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
            aux = load_balance(moe_aux)
            loss = loss + moe_w * aux
            stats["moe_aux"] = aux.detach()
        loss.backward()
        stats["loss"] = loss.detach()
        if hard_labels is not None:
            stats.update(topk_errors(logits.detach(), hard_labels))
        return stats

    def train_step(state, video, labels, metadata):
        distributed = mesh.is_distributed()
        world = mesh.data_size()  # the data line's processes
        data_group = mesh.group("data")
        partner = None
        if use_mixup and distributed:
            # the rows each local row meets, gathered before normalising
            # (elementwise, so it commutes with the reversal)
            partner = (device_normalize(global_partner(video), cfg),
                       global_partner(labels))
        # normalised before mixup, so that clips blend in normalised space
        video = device_normalize(video, cfg)
        hard_labels = labels
        if use_mixup:
            first = video[0] if isinstance(video, (tuple, list)) else video
            draws = sample_mixup(cfg, state.generator, first.shape,
                                 first.device)
            video, labels = apply_mixup(video, labels, cfg, draws, partner)
        topk_labels = hard_labels if (
            want_topk and hard_labels.ndim == 1) else None
        # the whole global batch's box count; each process's and each
        # microbatch's loss is its boxes' sum over its share of it
        det_denom = None
        if detection and (accum > 1 or distributed):
            det_denom = mesh.all_reduce_(
                metadata["boxes_mask"].sum().float(),
                data_group).clamp_min(1.0) / (accum * world)
        state.optimizer.zero_grad()
        with sharded_draws(*mesh.batch_rows(_batch_size(video))):
            if accum == 1:
                stats = forward_backward(state, video, labels, metadata,
                                         topk_labels, det_denom)
            else:
                if _batch_size(video) % accum:
                    raise ValueError(
                        f"batch {_batch_size(video)} does not split into "
                        f"TPU.GRAD_ACCUM={accum} microbatches")
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
        if distributed:  # the global batch's loss and errors
            keys = sorted(stats)
            flat = mesh.all_reduce_(torch.stack([stats[k].float()
                                                 for k in keys]),
                                    data_group) / world
            stats = dict(zip(keys, flat.unbind()))
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
    per-iteration losses, the clips it trained on over every process).
    The stats reach the host at each LOG_PERIOD-th iteration and the
    losses once at the end, so between them the loop never waits for the
    device. Under the short cycle the epoch has fewer batches than
    ``len(train_loader)``, the full batches the LR schedule counts."""
    data_size = len(train_loader)
    world = mesh.data_size()
    device = next(state.model.parameters()).device
    losses = torch.zeros(data_size, dtype=torch.float32, device=device)
    steps = clips = 0
    train_meter.iter_tic()
    for cur_iter, batch in enumerate(train_loader):
        if profiler is not None:
            profiler.step(data_size * cur_epoch + cur_iter)
        video, labels, metadata = split_batch(batch)
        train_meter.data_toc()
        state, stats = train_step(state, video, labels, metadata)
        losses[cur_iter] = stats["loss"]
        steps, clips = cur_iter + 1, clips + _batch_size(video) * world
        if (cur_iter + 1) % cfg.LOG_PERIOD == 0:
            keys = sorted(stats)
            host = dict(zip(keys, torch.stack(
                [stats[k].float() for k in keys]).tolist()))
            epoch_f = cur_epoch + float(cur_iter) / data_size
            lr = lr_policy.get_lr_at_epoch(cfg, epoch_f)["lr"]
            train_meter.update_stats(
                host.get("top1_err"), host.get("top5_err"), host["loss"], lr,
                _batch_size(video) * world, host.get("moe_aux"),
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
    return state, losses[:steps].tolist(), clips


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
    metadata)`` on every batch, the outputs, labels and sample indices of
    every process gathered (``gathered_host``); the loader's pad rows
    (index -1) are dropped on the host, so each val clip counts once.
    Multi-label data (``DATA.MULTI_LABEL``) keeps the probabilities and
    multi-hot labels for the meter's mean average precision and takes no
    top-k errors (the JAX package's ``eval_epoch`` takes them, and raises
    on such labels). AVA (an ``AVAMeter``) goes through
    ``run_detection_eval``. Returns the clips counted."""
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
            idx_h = gathered_host(batch[2])
            if idx_h.ndim == 1 and (idx_h < 0).any():
                valid = idx_h >= 0
        preds = forward(video, metadata)
        if is_ek:
            _, both = preds
            verb, noun = gathered_host(both["verb"]), gathered_host(both["noun"])
            lv, ln = gathered_host(labels["verb"]), gathered_host(labels["noun"])
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
            logits_h, labels_h = gathered_host(logits), gathered_host(labels)
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


@dataclasses.dataclass
class _Loop:
    """What the epochs run with, rebuilt at a long-cycle shape change."""

    train_loader: object
    val_loader: object
    val_meter: object
    train_step: object
    forward: object
    train_meter: object


def _build_loop(cfg, device, state, train_loader) -> _Loop:
    val_loader, val_meter = _build_val(cfg, device)
    return _Loop(train_loader, val_loader, val_meter,
                 make_supervised_train_step(state.model, cfg,
                                            get_loss_func(cfg)),
                 make_eval_forward(state.model, cfg),
                 TrainMeter(len(train_loader), cfg))


def _rebuild_for_long_cycle(cfg, state, cur_epoch, device):
    """A multigrid long-cycle shape change (JAX ``_rebuild_for_long_cycle``;
    reference train_net.py:653-675): the model built anew for the new
    (B, T, S) with the schedule's BN type (BatchNorm and SubBatchNorm keep
    the same state, ``models/norms.py``), the weights and BatchNorm
    statistics, the optimizer's state, the step and the generator carried
    over, the LR schedule continued from (``cur_epoch``, step) under the
    new steps per epoch. Returns (state, the epochs' loop)."""
    model = build_model(cfg, device)
    model.load_state_dict(state.model.state_dict())
    train_loader = data_loader.construct_loader(cfg, "train", device)
    optimizer = optim.construct_optimizer(
        model, cfg, len(train_loader), no_wd_paths(cfg),
        epoch_offset=float(cur_epoch), step_offset=int(state.step))
    optimizer.load_state_dict(state.optimizer.state_dict())
    state = TrainState(model, optimizer, state.generator, state.step)
    return state, _build_loop(cfg, device, state, train_loader)


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
    multigrid = None
    if cfg.MULTIGRID.LONG_CYCLE or cfg.MULTIGRID.SHORT_CYCLE:
        multigrid = MultigridSchedule()
        cfg = multigrid.init_multigrid(cfg)
        if cfg.MULTIGRID.LONG_CYCLE:
            cfg, _ = multigrid.update_long_cycle(cfg, cur_epoch=0)
    logger.info("Train with config:")
    logger.info(cfg.dump())

    model = build_model(cfg, device)
    train_loader = data_loader.construct_loader(cfg, "train", device)
    state = build_supervised_state(cfg, model, len(train_loader))
    loop = _build_loop(cfg, device, state, train_loader)
    n_params = sum(p.numel() for p in model.parameters())
    logger.info(
        f"{cfg.MODEL.MODEL_NAME} initialised: {n_params / 1e6:.2f}M params"
    )
    start_epoch, report = cu.load_train_checkpoint(cfg, state)
    run = TrainRun(state=state, start_epoch=start_epoch, checkpoint=report)

    writer = TensorboardWriter(cfg) if logging.is_master_process() else None
    profiler = StepProfiler(cfg)
    preempt_guard = PreemptionGuard(cfg)
    try:
        _train_epochs(cfg, run, loop, writer, profiler, preempt_guard,
                      multigrid, device)
    except PreemptionSignaled as p:
        logger.info(
            f"Preempted during epoch {p.epoch}: saving checkpoint and "
            "exiting 0 for requeue (AUTO_RESUME replays the epoch)"
        )
        cu.save_checkpoint(cfg.OUTPUT_DIR, p.state, p.epoch, cfg,
                           async_write=False)
        cu.wait_for_saves()
        mesh.barrier()
        profiler.stop()
        if writer is not None:
            writer.close()
        raise SystemExit(0)
    profiler.stop()
    logger.info(f"rank {mesh.rank()} (data {mesh.data_rank()}, pipe "
                f"{mesh.pipe_rank()}, seq {mesh.seq_rank()}, model "
                f"{mesh.model_rank()}, expert {mesh.expert_rank()}): "
                f"{state_bytes(run.state)}")
    cu.wait_for_saves()  # land any async checkpoint writes before returning
    mesh.barrier()  # every process may read them next
    if writer is not None:
        writer.close()
    return run


def _train_epochs(cfg, run, loop, writer, profiler, preempt_guard, multigrid,
                  device):
    state = run.state
    epoch_timer = EpochTimer()
    schedule = multigrid.schedule if multigrid is not None else None
    t0 = time.perf_counter()
    for cur_epoch in range(run.start_epoch, cfg.SOLVER.MAX_EPOCH):
        if multigrid is not None and cfg.MULTIGRID.LONG_CYCLE:
            cfg, changed = multigrid.update_long_cycle(cfg, cur_epoch)
            if changed:
                state, loop = _rebuild_for_long_cycle(cfg, state, cur_epoch,
                                                      device)
                run.state = state
        train_loader = loop.train_loader
        data_loader.shuffle_dataset(train_loader, cur_epoch)
        epoch_timer.epoch_tic()
        state.model.train()
        try:
            state, losses, clips = train_epoch(
                train_loader, state, loop.train_step, loop.train_meter,
                cur_epoch, cfg, writer=writer, profiler=profiler,
                preempt_guard=preempt_guard,
            )
        finally:
            run.wait_seconds += train_loader.wait_seconds
            run.first_wait_seconds += train_loader.first_wait_seconds
        run.losses.append(losses)
        run.steps += len(losses)
        run.clips += clips
        epoch_timer.epoch_toc()
        logger.info(
            f"Epoch {cur_epoch} takes {epoch_timer.last_epoch_time():.2f}s."
        )
        is_checkp = cu.is_checkpoint_epoch(cfg, cur_epoch, schedule)
        is_eval = misc.is_eval_epoch(cfg, cur_epoch, schedule)
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
            run.val_clips += eval_epoch(loop.val_loader, loop.forward,
                                        loop.val_meter, cur_epoch, cfg,
                                        writer=writer)
            run.val_seconds += time.perf_counter() - t_val
            run.val_stats.append({"epoch": cur_epoch + 1,
                                  **val_stats(loop.val_meter)})
            state.model.train()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    run.seconds = time.perf_counter() - t0
    run.state = state
    state.model.eval()
