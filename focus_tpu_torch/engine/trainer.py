"""Supervised train step (counterpart of the single-shot path of
``focus_tpu/engine/trainer.py``: ``make_supervised_train_step`` and
``build_supervised_state``).

One step normalises a uint8 video on the device, runs the model in train
mode (float32 logits, stochastic depth from the state's generator), takes
the loss and its gradient, applies one optimizer update and returns the
loss and the top-1 / top-5 errors as device tensors: nothing in it waits
for the device. EPIC-Kitchens (``TRAIN.DATASET: epickitchens``) takes a
dict of verb and noun labels and its stats are the loss alone, as the JAX
step computes no top-k for it. Mixup, gradient accumulation, the
detection loss, MoE, remat and ZeRO-1 are not ported and raise.
"""

from __future__ import annotations

import torch

from focus_tpu_torch.models import optimizer as optim
from focus_tpu_torch.models.build import maybe_zero_init_orvit
from focus_tpu_torch.ops.preprocess import device_normalize
from focus_tpu_torch.parallel.train_state import TrainState


def topk_errors(logits, labels, ks=(1, 5)):
    """Per-batch top-k error in percent, on the device
    (``_topk_errors_device``)."""
    max_k = min(max(ks), logits.shape[-1])
    top = torch.topk(logits, max_k, dim=-1).indices
    correct = top == labels[:, None]
    return {f"top{k}_err": 100.0 * (1.0 - correct[:, :min(k, max_k)]
                                    .any(dim=1).float().mean())
            for k in ks}


def _check_options(cfg):
    unported = {
        "MIXUP.ENABLE": bool(cfg.MIXUP.ENABLE),
        "TPU.GRAD_ACCUM > 1": int(cfg.TPU.GRAD_ACCUM or 1) > 1,
        "DETECTION.ENABLE": bool(cfg.DETECTION.ENABLE),
        "MoE (TPU.MOE.NUM_EXPERTS > 1)": int(cfg.TPU.MOE.NUM_EXPERTS or 0) > 1,
        "TPU.REMAT": bool(cfg.TPU.REMAT),
        "TPU.ZERO1": bool(cfg.TPU.ZERO1),
    }
    missing = [k for k, v in unported.items() if v]
    if missing:
        raise NotImplementedError(f"not ported yet: {missing}")


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


def make_supervised_train_step(model, cfg, loss_fn):
    """``step(state, video, labels, metadata) -> (state, stats)``: one
    forward, backward and optimizer update; ``stats`` holds ``loss`` and,
    for single-label data other than EPIC-Kitchens, ``top1_err`` and
    ``top5_err`` (device tensors). ``labels`` is a tensor, or for
    EPIC-Kitchens a dict of the verb and noun labels."""
    _check_options(cfg)
    is_ek = cfg.TRAIN.DATASET == "epickitchens"
    want_topk = not is_ek and not cfg.DATA.MULTI_LABEL

    def train_step(state, video, labels, metadata):
        video = device_normalize(video, cfg)
        logits = model(video, metadata, train=True, generator=state.generator)
        loss = loss_fn(logits, labels)
        state.optimizer.zero_grad()
        loss.backward()
        state.apply_gradients()
        stats = {"loss": loss.detach()}
        if want_topk and labels.ndim == 1:
            stats.update(topk_errors(logits.detach(), labels))
        return state, stats

    return train_step
