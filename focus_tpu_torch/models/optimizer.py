"""Optimizers (counterpart of ``focus_tpu/models/optimizer.py``; reference
``slowfast/models/optimizer.py``): the supervised one and STEVE's.

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
  as optax updates every leaf (weight decay still applies);
- under data parallelism (``parallel/mesh.py``) the gradients are
  averaged over the processes, in one all-reduce, before the clip, so each
  process applies the global batch's update.

STEVE's (``construct_optimizer_slot``, reference optimizer.py:13-45 and
``set_slot_lr``) is Adam in three groups by parameter prefix, ``dvae`` at
a constant LR and ``enc`` / ``dec`` (``steve_encoder``, ``steve_decoder``)
at a linear warm-up times a half-life decay, behind the same clipping;
its schedules are computed in float32 as optax computes them.
"""

import math

import numpy as np
import torch

from focus_tpu_torch.parallel import mesh
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


def epoch_lr_schedule(cfg, steps_per_epoch: int, which: str = "lr",
                      epoch_offset: float = 0.0, step_offset: int = 0):
    """LR(step) = the reference's LR at epoch epoch_offset + (step -
    step_offset) / steps_per_epoch, warmup included
    (``_epoch_lr_schedule``); ``which`` is "lr" or "orvit_lr". The offsets
    carry the schedule across a multigrid long-cycle rebuild, where the
    steps per epoch change mid-run."""

    def sched(step):
        epoch = epoch_offset + (step - step_offset) / steps_per_epoch
        return lr_policy.get_lr_at_epoch(cfg, epoch)[which]

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
        mesh.all_reduce_mean_(grads)
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
                        no_weight_decay_paths=(), epoch_offset: float = 0.0,
                        step_offset: int = 0) -> Optimizer:
    """The supervised optimizer with the reference's group structure over
    ``model``'s parameters (``construct_optimizer``); the offsets as in
    ``epoch_lr_schedule``."""
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
        "orvit_lr" if g["label"].startswith("orvit") else "lr",
        epoch_offset, step_offset) for g in groups]
    return Optimizer(_torch_optimizer(cfg, groups), schedules,
                     clip_value=cfg.SOLVER.CLIP_GRAD_VAL or None,
                     clip_norm=cfg.SOLVER.CLIP_GRAD_L2NORM or None)


# ---- STEVE ---------------------------------------------------------------

SLOT_GROUPS = ("dvae", "enc", "dec")


def slot_lr_schedules(cfg) -> dict:
    """The three slot groups' LR as functions of the update count
    (``slot_lr_schedules``): ``dvae`` SLOTS_OPTIM.DVAE; ``enc`` and ``dec``
    ENC and DEC x linear warm-up over WARMUP_STEPS (the reference's
    step + 1, so the first update has 1 / WARMUP_STEPS of it) x
    0.5^(step / HALF_LIFE), each in float32."""
    so = cfg.SLOTS_OPTIM
    f32 = np.float32

    def warm_decay(base):
        def sched(step):
            decay = np.exp(f32(f32(step) / f32(so.HALF_LIFE))
                           * f32(math.log(0.5)))
            warm = f32(lr_policy.linear_warmup(step, 0.0, 1.0, 0,
                                                so.WARMUP_STEPS))
            return float(decay * warm * f32(base))

        return sched

    return {"dvae": lambda step: float(f32(so.DVAE)),
            "enc": warm_decay(so.ENC), "dec": warm_decay(so.DEC)}


def slot_label(name: str) -> str:
    """A STEVE parameter's group by its prefix; a name of none of the
    three falls in ``dvae``, as the JAX label rule puts it."""
    if name.startswith("steve_encoder"):
        return "enc"
    if name.startswith("steve_decoder"):
        return "dec"
    return "dvae"


def construct_optimizer_slot(model, cfg) -> Optimizer:
    """Global-norm clipping (SOLVER.CLIP_GRAD_L2NORM) or value clipping
    (SOLVER.CLIP_GRAD_VAL, which wins where set), then Adam in the three
    slot groups (``construct_optimizer_slot``). SLOTS_OPTIM.CLIP is read
    nowhere, as in the JAX package."""
    members = {label: [] for label in SLOT_GROUPS}
    for name, p in model.named_parameters():
        members[slot_label(name)].append(p)
    schedules = slot_lr_schedules(cfg)
    labels = [label for label in SLOT_GROUPS if members[label]]
    groups = [{"params": members[label], "label": label} for label in labels]
    return Optimizer(torch.optim.Adam(groups, lr=0.0, eps=1e-8),
                     [schedules[label] for label in labels],
                     clip_value=cfg.SOLVER.CLIP_GRAD_VAL or None,
                     clip_norm=cfg.SOLVER.CLIP_GRAD_L2NORM or None)
