"""STEVE training and segmentation eval (counterpart of
``focus_tpu/engine/slot_trainer.py``; reference
``tools/steve_train_net.py:33-457`` and ``tools/steve_eval_net.py:27-133``).

One train step runs ``STEVE.forward`` in train mode on a video batch in
[0, 1], takes ``mse + cross_entropy`` and its gradient, and applies one
update of the three-group Adam (``models/optimizer.construct_optimizer_slot``):
the Gumbel temperature and the three learning rates are functions of the
state's step before the update, as the JAX step reads them. Every draw of
a step (the two Gumbel samples, the slot initialisation, dropout) comes
from the state's generator reseeded from (``RNG_SEED``, step), as the JAX
step folds the step into its key: a step's noise depends on the two alone,
so a resumed run draws what an uninterrupted one does. Nothing in a step
waits for the device; the stats reach the host at ``LOG_PERIOD``.

``slot_train`` runs the epochs: validation after each (``val_loss = mse +
ce``, the batch means averaged), ``best_model.pt`` when it improves,
``checkpoint.pt.tar`` every epoch and ``checkpoint_epoch_NNNNN.pyth`` on
checkpoint epochs, all under ``EXP.PATH`` (else ``OUTPUT_DIR``), each the
whole train state (weights with BatchNorm's running statistics, the Adam
moments of the three groups, the step, the generator);
``TRAIN.AUTO_RESUME`` restores the last epoch checkpoint there. The
preemption save and TensorBoard scalars are the JAX loop's.

``slot_eval`` encodes the test split and scores the slots' attention masks
against the ground truth with the background segment dropped: FG-ARI and
mBO in percent, each the mean of the batches' means. A batch's ``pad_last``
repeats are dropped before its forward here and in validation, so every
clip counts once; the JAX loops score the repeats as well, which changes
nothing where the split fills its batches.

Under data parallelism (``parallel/mesh.py``) each process steps on its
slice of the global batch, drawing its rows of the global batch's noise
(``models/common.sharded_draws``); the gradients are averaged over the
processes before the global-norm clip (``models/optimizer.py``), the
res18 stem's BatchNorm takes the global batch's statistics, and the stats
are the processes' mean. Validation's losses and the eval's FG-ARI and mBO
sum each batch's clips over the processes (each clip once) before the
batch means; their noise is drawn for the batch's clips that are not
repeats, each process keeping its rows' (``DataLoader.real_slice``).
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import List, Optional

import numpy as np
import torch

from focus_tpu_torch.datasets import loader as data_loader
from focus_tpu_torch.models import optimizer as optim
from focus_tpu_torch.models.build import build_model, resolve_device
from focus_tpu_torch.models.common import sharded_draws
from focus_tpu_torch.parallel import mesh
from focus_tpu_torch.parallel.train_state import TrainState
from focus_tpu_torch.utils import checkpoint as cu
from focus_tpu_torch.utils import logging, lr_policy, metrics
from focus_tpu_torch.utils.meters import EpochTimer, MetricTracker
from focus_tpu_torch.utils.preemption import (
    PreemptionGuard,
    PreemptionSignaled,
)
from focus_tpu_torch.visualization.tensorboard_vis import TensorboardWriter

logger = logging.get_logger(__name__)


def check_slot_model(cfg):
    """Raise unless the config names the slot model these loops train."""
    if cfg.MODEL.MODEL_NAME != "STEVE":
        raise ValueError(
            f"TRAIN.METHOD slots / TEST.EVAL_TASK segmentation run a slot "
            f"model (MODEL.MODEL_NAME STEVE), not {cfg.MODEL.MODEL_NAME}"
        )


def step_seed(seed: int, step: int) -> int:
    """The generator seed of step ``step``: a hash of (seed, step)."""
    return int(np.random.SeedSequence([seed, step]).generate_state(1)[0])


def step_generator(state, cfg):
    """The state's generator reseeded for its current step."""
    state.generator.manual_seed(step_seed(cfg.RNG_SEED, state.step))
    return state.generator


def slot_tau(cfg, step: int) -> float:
    """The Gumbel temperature at ``step``: SLOTS_OPTIM's cosine anneal from
    TAU_START to TAU_FINAL over TAU_STEPS, in float32."""
    so = cfg.SLOTS_OPTIM
    return lr_policy.cosine_anneal(step, so.TAU_START, so.TAU_FINAL, 0,
                                   so.TAU_STEPS)


def make_train_step(model, cfg):
    """``step(state, video, noise=None) -> (state, stats)``: one update from
    a batch [B, T, H, W, C] in [0, 1]; ``stats`` holds ``loss``, ``mse`` and
    ``cross_entropy`` (device tensors) and ``tau`` (a float). ``noise``
    replaces the forward's Gumbel and slot noise (``STEVE.forward``)."""
    hard = bool(cfg.SLOTS.HARD)

    def train_step(state, video, noise=None):
        tau = slot_tau(cfg, state.step)
        generator = step_generator(state, cfg)
        state.optimizer.zero_grad()
        with sharded_draws(*mesh.batch_rows(video.shape[0])):
            _, ce, mse, _ = model(video, tau, hard, train=True,
                                  generator=generator, noise=noise)
        loss = mse + ce
        loss.backward()
        stats = torch.stack([loss.detach(), mse.detach(), ce.detach()])
        if mesh.is_distributed():  # the global batch's means
            stats = mesh.all_reduce_(stats.float()) / mesh.world_size()
        state.apply_gradients()
        loss, mse, ce = stats.unbind()
        return state, {"loss": loss, "mse": mse, "cross_entropy": ce,
                       "tau": tau}

    return train_step


def make_eval_step(model, cfg):
    """``step(state, video, tau) -> (recon, cross_entropy, mse, attns)``:
    the eval forward (running BatchNorm statistics, no dropout), its noise
    drawn as the train step's at the state's step."""
    hard = bool(cfg.SLOTS.HARD)

    @torch.no_grad()
    def eval_step(state, video, tau):
        return model(video, tau, hard, train=False,
                     generator=step_generator(state, cfg))

    return eval_step


def make_encode_step(model, cfg):
    """``step(state, video) -> (slots, attns_vis, attns)``, ``encode`` with
    its slot noise drawn at the state's step."""

    def encode_step(state, video):
        return model.encode(video, generator=step_generator(state, cfg))

    return encode_step


def build_slot_state(cfg, model) -> TrainState:
    """The train state of a built STEVE: the three-group Adam and a
    generator on the model's device."""
    optimizer = optim.construct_optimizer_slot(model, cfg)
    device = next(model.parameters()).device
    generator = torch.Generator(device=device)
    generator.manual_seed(cfg.RNG_SEED)
    n_params = sum(p.numel() for p in model.parameters())
    logger.info(f"STEVE initialised: {n_params / 1e6:.2f}M params")
    return TrainState(model, optimizer, generator)


def _host(stats) -> dict:
    """A step's stats as floats, in one transfer."""
    keys = sorted(k for k in stats if torch.is_tensor(stats[k]))
    host = dict(zip(keys, torch.stack([stats[k].float() for k in keys])
                    .tolist())) if keys else {}
    host.update({k: float(v) for k, v in stats.items() if k not in host})
    return host


@dataclasses.dataclass
class SlotTrainRun:
    """One ``slot_train`` call: the final state, each epoch's per-step
    losses and taus, each validation's loss, the checkpoint files written
    (in order), the epochs' seconds on the host clock (loader, validation
    and saves included), the train loader's waits, the steps and clips,
    validation's seconds and clips, the saves' seconds."""

    state: TrainState
    start_epoch: int = 0
    checkpoint: Optional[dict] = None
    losses: List[List[float]] = dataclasses.field(default_factory=list)
    taus: List[List[float]] = dataclasses.field(default_factory=list)
    val_losses: List[float] = dataclasses.field(default_factory=list)
    saved: List[str] = dataclasses.field(default_factory=list)
    seconds: float = 0.0
    wait_seconds: float = 0.0
    steps: int = 0
    clips: int = 0
    val_seconds: float = 0.0
    val_clips: int = 0
    save_seconds: float = 0.0


def slot_train_epoch(train_loader, state, train_step, cur_epoch, cfg,
                     writer=None, preempt_guard=None):
    """One epoch; returns (state, {"tau", "global_step"}, the per-step
    losses, the per-step taus)."""
    data_size = len(train_loader)
    device = next(state.model.parameters()).device
    losses = torch.zeros(data_size, dtype=torch.float32, device=device)
    taus, stats = [], None
    for cur_iter, video in enumerate(train_loader):
        if preempt_guard is not None and preempt_guard.poll(cur_iter - 1):
            raise PreemptionSignaled(cur_epoch, state)
        state, stats = train_step(state, video)
        losses[cur_iter] = stats["loss"]
        taus.append(stats["tau"])
        global_step = cur_epoch * data_size + cur_iter
        if (cur_iter + 1) % cfg.LOG_PERIOD == 0:
            host = _host(stats)
            logging.log_json_stats({
                "_type": "slot_train_iter", "epoch": cur_epoch + 1,
                "iter": f"{cur_iter + 1}/{data_size}",
                "global_step": global_step, **host})
            if writer is not None:
                writer.add_scalars({
                    "TRAIN/loss": host["loss"],
                    "TRAIN/cross_entropy": host["cross_entropy"],
                    "TRAIN/mse": host["mse"], "TRAIN/tau": host["tau"]},
                    global_step=global_step)
    tau = stats["tau"] if stats is not None else cfg.SLOTS_OPTIM.TAU_START
    return (state, {"tau": tau, "global_step": (cur_epoch + 1) * data_size - 1},
            losses[:len(taus)].tolist(), taus)


@torch.no_grad()
def slot_eval_epoch(val_loader, state, eval_step, cur_epoch, cfg, opd,
                    writer=None):
    """Validation at the last train step's tau; returns (val_loss, the clips
    scored over every process). Each batch's mse and cross-entropy are
    its clips' means over the processes."""
    mse_meter, ce_meter = MetricTracker(), MetricTracker()
    device = next(state.model.parameters()).device
    per_batch = []  # each batch's (rows x mse, rows x ce, rows) here
    for i, video in enumerate(val_loader):
        first, n, total = val_loader.real_slice(i)
        sums = torch.zeros(3, device=device)  # all pad_last repeats here
        if n:
            with sharded_draws(first, n, total):
                _, ce, mse, _ = eval_step(state, video[:n], opd["tau"])
            sums = n * torch.stack([mse.float(), ce.float(), sums[0] + 1])
        per_batch.append(sums)
    sums = (mesh.all_reduce_(torch.stack(per_batch)).tolist()
            if per_batch else [])
    clips = int(sum(row[2] for row in sums))
    for mse_n, ce_n, n in sums:
        mse_meter.update(mse_n / n)
        ce_meter.update(ce_n / n)
    val_loss = mse_meter.avg + ce_meter.avg
    logging.log_json_stats({
        "_type": "slot_val_epoch", "epoch": cur_epoch + 1, "loss": val_loss,
        "mse": mse_meter.avg, "cross_entropy": ce_meter.avg})
    if writer is not None:
        writer.add_scalars({"VAL/loss": val_loss,
                            "VAL/cross_entropy": ce_meter.avg,
                            "VAL/mse": mse_meter.avg},
                           global_step=cur_epoch + 1)
    return val_loss, clips


def slot_train(cfg, device="cuda"):
    """STEVE training (reference steve_train_net.py:214-458) on ``device``
    (CUDA unless the caller asks for the CPU); returns the final state."""
    return run_slot_train(cfg, device).state


def run_slot_train(cfg, device="cuda") -> SlotTrainRun:
    """``slot_train``, returning the whole ``SlotTrainRun``."""
    device = resolve_device(device)
    check_slot_model(cfg)
    np.random.seed(cfg.RNG_SEED)
    torch.manual_seed(cfg.RNG_SEED)
    ckpt_dir = cfg.EXP.PATH or cfg.OUTPUT_DIR
    logging.setup_logging(ckpt_dir)
    logger.info("Train with config:")
    logger.info(cfg.dump())

    model = build_model(cfg, device)
    train_loader = data_loader.construct_loader(cfg, "train", device)
    val_loader = data_loader.construct_loader(cfg, "val", device)
    state = build_slot_state(cfg, model)
    start_epoch, report = cu.load_train_checkpoint(cfg, state, ckpt_dir)
    run = SlotTrainRun(state=state, start_epoch=start_epoch,
                       checkpoint=report)

    train_step = make_train_step(model, cfg)
    eval_step = make_eval_step(model, cfg)
    writer = TensorboardWriter(cfg) if logging.is_master_process() else None
    preempt_guard = PreemptionGuard(cfg)
    try:
        _slot_train_epochs(cfg, run, train_loader, val_loader, train_step,
                           eval_step, writer, ckpt_dir, preempt_guard)
    except PreemptionSignaled as p:
        logger.info(
            f"Preempted during epoch {p.epoch}: saving checkpoint and "
            "exiting 0 for requeue (AUTO_RESUME replays the epoch)"
        )
        cu.save_checkpoint(ckpt_dir, p.state, p.epoch, cfg, async_write=False)
        cu.wait_for_saves()
        mesh.barrier()
        if writer is not None:
            writer.close()
        raise SystemExit(0)
    cu.wait_for_saves()  # land any async checkpoint writes before returning
    mesh.barrier()  # every process may read them next
    if writer is not None:
        writer.close()
    return run


def _slot_train_epochs(cfg, run, train_loader, val_loader, train_step,
                       eval_step, writer, ckpt_dir, preempt_guard):
    state = run.state
    best_val_loss = math.inf
    epoch_timer = EpochTimer()
    opd = {"tau": cfg.SLOTS_OPTIM.TAU_START, "global_step": 0}

    def save(epoch, **name):
        t0 = time.perf_counter()
        run.saved.append(cu.save_checkpoint(ckpt_dir, state, epoch, cfg,
                                            **name))
        run.save_seconds += time.perf_counter() - t0

    t0 = time.perf_counter()
    for cur_epoch in range(run.start_epoch, cfg.SOLVER.MAX_EPOCH):
        data_loader.shuffle_dataset(train_loader, cur_epoch)
        epoch_timer.epoch_tic()
        if not cfg.TRAIN.VAL_ONLY:
            try:
                state, opd, losses, taus = slot_train_epoch(
                    train_loader, state, train_step, cur_epoch, cfg, writer,
                    preempt_guard=preempt_guard)
            finally:
                run.wait_seconds += train_loader.wait_seconds
            run.losses.append(losses)
            run.taus.append(taus)
            run.steps += len(losses)
            run.clips += len(losses) * train_loader.batch_size
        epoch_timer.epoch_toc()
        logger.info(
            f"Epoch {cur_epoch} takes {epoch_timer.last_epoch_time():.2f}s "
            f"(median {epoch_timer.median_epoch_time():.2f}s)."
        )
        t_val = time.perf_counter()
        val_loss, clips = slot_eval_epoch(val_loader, state, eval_step,
                                          cur_epoch, cfg, opd, writer)
        run.val_seconds += time.perf_counter() - t_val
        run.val_clips += clips
        run.val_losses.append(val_loss)
        if cfg.TRAIN.VAL_ONLY:
            break
        if val_loss < best_val_loss:
            best_val_loss = val_loss
            save(cur_epoch + 1, name="best_model", fmt=".pt")
        if writer is not None:
            writer.add_scalars({"VAL/best_loss": best_val_loss},
                               global_step=cur_epoch + 1)
        save(cur_epoch + 1, name="checkpoint", fmt=".pt.tar")
        # the epoch-indexed checkpoints that AUTO_RESUME reads
        if cu.is_checkpoint_epoch(cfg, cur_epoch):
            save(cur_epoch + 1)
    if next(state.model.parameters()).is_cuda:
        torch.cuda.synchronize()
    run.seconds = time.perf_counter() - t0
    run.state = state


@dataclasses.dataclass
class SlotEvalRun:
    """One ``slot_eval`` call: the results, each batch's FG-ARI and mBO,
    the checkpoint's load report, the clips scored, the loop's seconds on
    the host clock (loader included) and the loader's waits."""

    results: dict
    fg_aris: List[float]
    mbos: List[float]
    checkpoint: Optional[dict]
    clips: int
    seconds: float
    wait_seconds: float


def slot_eval(cfg, device="cuda") -> dict:
    """FG-ARI and mBO in percent (reference steve_eval_net.py:27-133) on
    ``device`` (CUDA unless the caller asks for the CPU), from the test
    path's checkpoint chain (``load_test_checkpoint``)."""
    return run_slot_eval(cfg, device).results


def run_slot_eval(cfg, device="cuda") -> SlotEvalRun:
    """``slot_eval``, returning the whole ``SlotEvalRun``."""
    device = resolve_device(device)
    check_slot_model(cfg)
    np.random.seed(cfg.RNG_SEED)
    torch.manual_seed(cfg.RNG_SEED)
    logging.setup_logging(cfg.OUTPUT_DIR)
    logger.info("Test with config:")
    logger.info(cfg.dump())

    model = build_model(cfg, device)
    eval_loader = data_loader.construct_loader(cfg, "test", device)
    logger.info(f"Testing model for {len(eval_loader)} iterations")
    state = build_slot_state(cfg, model)
    report = cu.load_test_checkpoint(cfg, model)
    encode_step = make_encode_step(model, cfg)

    sums = []  # each batch's (ARI sum, clips, best-IoU sum, masks) here
    t0 = time.perf_counter()
    for batch_idx, (video, true_masks) in enumerate(eval_loader):
        first, real, total = eval_loader.real_slice(batch_idx)
        if not real:  # this process's slice is all pad_last repeats
            sums.append([0.0, 0.0, 0.0, 0.0])
            continue
        with sharded_draws(first, real, total):
            _, _, pred_masks = encode_step(state, video[:real])
        pred = pred_masks.float().cpu().numpy()  # [B, T, S, H, W, 1]
        true = true_masks[:real].float().cpu().numpy()  # [B, T, S0, H, W, 1]
        B = pred.shape[0]
        # drop the background (0th) segment, flatten time and space
        true_f = true.transpose(0, 2, 1, 3, 4, 5)[:, 1:].reshape(
            B, true.shape[2] - 1, -1)
        pred_f = pred.transpose(0, 2, 1, 3, 4, 5).reshape(B, pred.shape[2], -1)
        sums.append([float(metrics.ari_per_clip(true_f, pred_f).sum()), B,
                     *metrics.mbo_sums(true_f, pred_f)])
    if sums:
        sums = mesh.all_reduce_(torch.tensor(
            sums, dtype=torch.float64, device=device)).tolist()
    fgaris = [100 * a / n for a, n, _, _ in sums]
    mbos = [100 * (b / m if m else 0.0) for _, _, b, m in sums]
    clips = int(sum(n for _, n, _, _ in sums))
    for i in range(len(fgaris)):
        logger.info(
            f"Done batches {i + 1}. FG-ARI MEAN = {np.mean(fgaris[:i + 1]):.3f} "
            f"STD = {np.std(fgaris[:i + 1]):.3f}  mBO MEAN = "
            f"{np.mean(mbos[:i + 1]):.3f}"
        )
    seconds = time.perf_counter() - t0
    results = {"fg_ari": float(np.mean(fgaris)) if fgaris else 0.0,
               "mbo": float(np.mean(mbos)) if mbos else 0.0}
    logging.log_json_stats({"_type": "slot_eval_final", **results})
    return SlotEvalRun(results, fgaris, mbos, report, clips, seconds,
                       eval_loader.wait_seconds)
