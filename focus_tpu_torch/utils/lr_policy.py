"""Learning-rate policies (a copy of the host functions of
``focus_tpu/utils/lr_policy.py``; reference ``slowfast/utils/lr_policy.py``).

Epoch-based policies for supervised training (cosine with warmup,
steps_with_relative_lrs) and the step-based anneals of STEVE. The port
evaluates its schedules on the host; the anneals compute in float32, as the
JAX package's ``*_jnp`` ones do inside its jitted step.
"""

import math

import numpy as np


# ---- step-based anneals (STEVE; reference lr_policy.py:8-41) ------------

def cosine_anneal(step, start_value, final_value, start_step,
                  final_step) -> float:
    """Cosine from ``start_value`` at ``start_step`` to ``final_value`` at
    ``final_step``, in float32 as ``cosine_anneal_jnp`` (progress clipped
    to [0, 1])."""
    f32 = np.float32
    progress = np.clip(f32(f32(step) - f32(start_step))
                       / f32(max(final_step - start_step, 1)), f32(0), f32(1))
    a = f32(0.5 * (start_value - final_value))
    b = f32(0.5 * (start_value + final_value))
    return float(a * np.cos(f32(math.pi) * progress) + b)


def linear_warmup(step, start_value, final_value, start_step,
                  final_step) -> float:
    """Linear from ``start_value`` to ``final_value`` over
    [``start_step``, ``final_step``], in float32 as ``linear_warmup_jnp``
    (the reference's step + 1)."""
    f32 = np.float32
    if step < start_step:
        return float(f32(start_value))
    progress = np.clip(f32(step + 1 - start_step)
                       / f32(max(final_step - start_step, 1)), f32(0), f32(1))
    return float(f32(final_value - start_value) * progress
                 + f32(start_value))


# ---- epoch-based policies (supervised; reference lr_policy.py:42-135) ----

def get_lr_at_epoch(cfg, cur_epoch):
    """Dict of lrs at a (fractional) epoch: {'lr': ..., ['orvit_lr': ...]}."""
    base_lrs = {"lr": cfg.SOLVER.BASE_LR}
    if cfg.SOLVER.ORVIT_BASE_LR > 0:
        base_lrs["orvit_lr"] = cfg.SOLVER.ORVIT_BASE_LR
    out = {}
    for name, base_lr in base_lrs.items():
        lr = get_lr_func(cfg.SOLVER.LR_POLICY)(cfg, cur_epoch, base_lr=base_lr)
        if cur_epoch < cfg.SOLVER.WARMUP_EPOCHS:
            lr_start = cfg.SOLVER.WARMUP_START_LR
            lr_end = get_lr_func(cfg.SOLVER.LR_POLICY)(
                cfg, cfg.SOLVER.WARMUP_EPOCHS
            )
            alpha = (lr_end - lr_start) / cfg.SOLVER.WARMUP_EPOCHS
            lr = cur_epoch * alpha + lr_start
        out[name] = lr
    return out


def lr_func_cosine(cfg, cur_epoch, base_lr=None):
    if base_lr is None:
        base_lr = cfg.SOLVER.BASE_LR
    offset = cfg.SOLVER.WARMUP_EPOCHS if cfg.SOLVER.COSINE_AFTER_WARMUP else 0.0
    assert cfg.SOLVER.COSINE_END_LR < base_lr
    return (
        cfg.SOLVER.COSINE_END_LR
        + (base_lr - cfg.SOLVER.COSINE_END_LR)
        * (math.cos(math.pi * (cur_epoch - offset) / (cfg.SOLVER.MAX_EPOCH - offset)) + 1.0)
        * 0.5
    )


def lr_func_steps_with_relative_lrs(cfg, cur_epoch, base_lr=None):
    if base_lr is None:
        base_lr = cfg.SOLVER.BASE_LR
    ind = get_step_index(cfg, cur_epoch)
    return cfg.SOLVER.LRS[ind] * base_lr


def get_step_index(cfg, cur_epoch):
    steps = list(cfg.SOLVER.STEPS) + [cfg.SOLVER.MAX_EPOCH]
    for ind, step in enumerate(steps):
        if cur_epoch < step:
            break
    return ind - 1


def get_lr_func(lr_policy):
    policy = "lr_func_" + lr_policy
    if policy not in globals():
        raise NotImplementedError(f"Unknown LR policy: {lr_policy}")
    return globals()[policy]
