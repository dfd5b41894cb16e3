"""Supervised optimizer (counterpart of the supervised half of
``focus_tpu/models/optimizer.py``; reference ``slowfast/models/optimizer.py``).

As in the JAX package, every group's LR is a function of the update count
(``epoch_lr_schedule``), which reproduces the reference's per-iteration
``set_lr`` from the fractional epoch. Parameters fall in the reference's
{main, zero-wd} x {backbone, orvit} groups over one ``torch.optim``
optimizer, with optax's semantics:

- the schedule is read with the count of updates made before this one, so
  the first update uses ``sched(0)``;
- ``adamw`` decays decoupled (``p -= lr * wd * p`` beside the Adam step,
  which is what optax's ``adamw`` computes); ``sgd`` and ``adam`` take a
  coupled L2 term (``torch.optim``'s ``weight_decay``, optax's
  ``add_decayed_weights`` before the transform);
- global-norm clipping scales by ``max_norm / norm`` once the norm reaches
  ``max_norm``, with no epsilon (``torch.nn.utils.clip_grad_norm_`` adds
  one); value clipping clamps each element;
- a parameter that received no gradient is updated with a zero gradient,
  as optax updates every leaf (weight decay still applies).
"""

import torch

from focus_tpu_torch.utils import lr_policy


def param_label(name: str, ndim: int, cfg, no_weight_decay_paths=()) -> str:
    """The group of one parameter (``construct_optimizer``'s label rule):
    ``orvit_`` when its lowercased name contains "orvit" and
    SOLVER.ORVIT_BASE_LR > 0; ``zero`` for the no-decay names and, with
    SOLVER.ZERO_WD_1D_PARAM, for 1-D parameters; else ``main``. The
    substrings read the same in the torch and the JAX names."""
    path = name.lower()
    orvit = "orvit" in path and cfg.SOLVER.ORVIT_BASE_LR > 0
    zero = any(s in path for s in no_weight_decay_paths) or (
        cfg.SOLVER.ZERO_WD_1D_PARAM and ndim <= 1)
    kind = "zero" if zero else "main"
    return f"orvit_{kind}" if orvit else kind


def epoch_lr_schedule(cfg, steps_per_epoch: int, which: str = "lr"):
    """LR(step) = the reference's LR at epoch step / steps_per_epoch, warmup
    included (``_epoch_lr_schedule``); ``which`` is "lr" or "orvit_lr"."""

    def sched(step):
        return lr_policy.get_lr_at_epoch(cfg, step / steps_per_epoch)[which]

    return sched


def _torch_optimizer(cfg, groups):
    method = cfg.SOLVER.OPTIMIZING_METHOD
    if method == "sgd":
        return torch.optim.SGD(groups, lr=0.0, momentum=cfg.SOLVER.MOMENTUM,
                               nesterov=cfg.SOLVER.NESTEROV)
    if method == "adam":
        return torch.optim.Adam(groups, lr=0.0, eps=1e-8)
    if method == "adamw":
        return torch.optim.AdamW(groups, lr=0.0, eps=1e-8)
    raise NotImplementedError(f"Unsupported optimizer: {method}")


class Optimizer:
    """A ``torch.optim`` optimizer over labelled parameter groups, each with
    its LR schedule, behind the optional gradient clip. ``step(count)``
    applies one update from the parameters' ``.grad``; ``count`` is the
    number of updates made before it."""

    def __init__(self, optimizer, schedules, clip_value=None, clip_norm=None):
        self.optimizer = optimizer
        self.schedules = schedules
        self.clip_value = clip_value
        self.clip_norm = clip_norm

    def zero_grad(self):
        self.optimizer.zero_grad(set_to_none=True)

    @torch.no_grad()
    def step(self, count: int):
        params = [p for g in self.optimizer.param_groups for p in g["params"]]
        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        grads = [p.grad for p in params]
        if self.clip_value:
            for g in grads:
                g.clamp_(-self.clip_value, self.clip_value)
        elif self.clip_norm:
            norm = torch.linalg.vector_norm(torch.stack(
                [torch.linalg.vector_norm(g.float()) for g in grads]))
            keep = norm < self.clip_norm
            for g in grads:
                g.copy_(torch.where(keep, g, g / norm * self.clip_norm))
        for group, sched in zip(self.optimizer.param_groups, self.schedules):
            group["lr"] = sched(count)
        self.optimizer.step()


def construct_optimizer(model, cfg, steps_per_epoch: int,
                        no_weight_decay_paths=()) -> Optimizer:
    """The supervised optimizer with the reference's group structure over
    ``model``'s parameters (``construct_optimizer``)."""
    use_orvit_lr = cfg.SOLVER.ORVIT_BASE_LR > 0
    labels = ["main", "zero"] + (["orvit_main", "orvit_zero"]
                                 if use_orvit_lr else [])
    members = {label: [] for label in labels}
    for name, p in model.named_parameters():
        members[param_label(name, p.ndim, cfg, no_weight_decay_paths)].append(p)
    wd = cfg.SOLVER.WEIGHT_DECAY
    groups = [{"params": members[label], "label": label,
               "weight_decay": 0.0 if label.endswith("zero") else wd}
              for label in labels if members[label]]
    schedules = [epoch_lr_schedule(
        cfg, steps_per_epoch,
        "orvit_lr" if g["label"].startswith("orvit") else "lr") for g in groups]
    return Optimizer(_torch_optimizer(cfg, groups), schedules,
                     clip_value=cfg.SOLVER.CLIP_GRAD_VAL or None,
                     clip_norm=cfg.SOLVER.CLIP_GRAD_L2NORM or None)
