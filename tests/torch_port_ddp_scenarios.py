"""The port's data-parallel scenarios, each run on one process or on every
process of a group (``focus_tpu_torch/parallel/mesh.py``): each makes its
global batch from a seed with numpy and runs this process's contiguous
slice of it, so one process and two must agree. ``run_all`` is the
function ``tools.run_net.launch_job`` runs on each of two gloo processes
in ``tests/test_torch_port_ddp.py``; it imports no JAX, and writes each
process's results to ``<OUTPUT_DIR>/rank<r>.pt``."""

import os

import numpy as np
import torch

from focus_tpu_torch.parallel import mesh

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MF_YAML = os.path.join(REPO, "configs", "tests", "mf_synthetic.yaml")
SLOW_YAML = os.path.join(REPO, "configs", "Kinetics", "SLOW_8x8_R50.yaml")
GLOBAL_BATCH = 4


def local(x):
    """This process's contiguous rows of a global batch (a tensor, a
    list of them, or a dict)."""
    if isinstance(x, dict):
        return {k: local(v) for k, v in x.items()}
    if isinstance(x, (tuple, list)):
        return type(x)(local(v) for v in x)
    n = x.shape[0] // mesh.world_size()
    return x[mesh.rank() * n:(mesh.rank() + 1) * n]


def _params(model):
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


def flagship_cfg(mixup=True):
    """The tiny flagship (D=24, 3 layers, float32) with TPU.GRAD_ACCUM 2;
    with ``mixup`` also mixup / CutMix and stochastic depth under AdamW,
    else (the case held against JAX) ``test_torch_port_train.py``'s Nesterov
    SGD with a global-norm clip and a warm-up into a cosine."""
    from focus_tpu_torch.entry import train_cfg

    cfg = train_cfg(tiny=True)
    cfg.TPU.GRAD_ACCUM = 2
    cfg.MIXUP.ENABLE = mixup
    s = cfg.SOLVER
    if mixup:
        cfg.MF.DROP_PATH = 0.2
        s.BASE_LR = 2e-3
    else:
        s.OPTIMIZING_METHOD = "sgd"
        s.MOMENTUM, s.NESTEROV = 0.9, True
        s.BASE_LR, s.WEIGHT_DECAY = 0.5, 1e-3
        s.LR_POLICY, s.MAX_EPOCH = "cosine", 4
        s.WARMUP_EPOCHS, s.WARMUP_START_LR = 1.0, 0.05
        s.CLIP_GRAD_L2NORM = 0.05
    return cfg


def flagship_steps(mixup=True, init=None, steps=2):
    """``steps`` train steps of the tiny flagship on global batches of 4
    (seeds 3, 4, ...); ``init`` is a state dict to start from. Returns
    each step's stats and the final parameters."""
    from focus_tpu_torch.engine.trainer import (
        build_supervised_state,
        make_supervised_train_step,
    )
    from focus_tpu_torch.entry import INIT_SCALE, example_inputs
    from focus_tpu_torch.models.build import build_model, init_weights
    from focus_tpu_torch.models.losses import get_loss_func

    cfg = flagship_cfg(mixup)
    model = build_model(cfg, "cpu", seed=0)
    if init is None:
        gen = torch.Generator().manual_seed(0)
        init_weights(model, gen, scale=INIT_SCALE)
    else:
        model.load_state_dict(init)
    state = build_supervised_state(cfg, model, 2)
    step = make_supervised_train_step(model, cfg, get_loss_func(cfg))
    stats = []
    for i in range(steps):
        video, labels, boxes = example_inputs(cfg, GLOBAL_BATCH, 3 + i, "cpu",
                                              labels=True)
        state, out = step(state, local(video), local(labels),
                          {"orvit_bboxes": local(boxes)})
        stats.append({k: float(v) for k, v in out.items()})
    return {"stats": stats, "params": _params(model)}


def resnet_steps(norm, steps=2, batch=GLOBAL_BATCH):
    """Two SGD steps of a tiny Slow R50 (width 8, 8 frames, 32 px) under
    ``norm`` ("batchnorm", or "sub_batchnorm" at NUM_SPLITS 2) on global
    batches of ``batch``; returns the losses and the parameters and
    BatchNorm statistics after."""
    from focus_tpu_torch.config import get_cfg
    from focus_tpu_torch.engine.trainer import (
        build_supervised_state,
        make_supervised_train_step,
    )
    from focus_tpu_torch.models.build import build_model
    from focus_tpu_torch.models.losses import get_loss_func

    cfg = get_cfg()
    cfg.merge_from_file(SLOW_YAML)
    cfg.RESNET.WIDTH_PER_GROUP = 8
    cfg.DATA.NUM_FRAMES = 8
    cfg.DATA.TRAIN_CROP_SIZE = 32
    cfg.MODEL.NUM_CLASSES = 10
    cfg.MODEL.DROPOUT_RATE = 0.5
    cfg.TPU.COMPUTE_DTYPE = "float32"
    cfg.BN.NORM_TYPE = norm
    cfg.BN.NUM_SPLITS = 2
    model = build_model(cfg, "cpu", seed=1)
    state = build_supervised_state(cfg, model, 2)
    step = make_supervised_train_step(model, cfg, get_loss_func(cfg))
    losses = []
    for i in range(steps):
        rs = np.random.RandomState(10 + i)
        video = torch.from_numpy(rs.rand(batch, 8, 32, 32, 3).astype(
            np.float32))
        labels = torch.from_numpy(rs.randint(0, 10, batch))
        state, out = step(state, [local(video)], local(labels), {})
        losses.append(float(out["loss"]))
    return {"losses": losses, "params": _params(model)}


def steve_steps(steps=2):
    """Two STEVE train steps (``steve_synthetic.yaml``'s size with the
    res18 CNN at its 64 px, float32) on global batches of 4 with the
    decoder's dropout on; returns each step's stats and the final
    parameters."""
    from focus_tpu_torch.engine.slot_trainer import (
        build_slot_state,
        make_train_step,
    )
    from focus_tpu_torch.entry import steve_train_cfg
    from focus_tpu_torch.models.build import build_model

    cfg = steve_train_cfg(tiny=True, float32=True)
    cfg.MODEL.CNN_NAME = "res18"
    cfg.SLOTS.IMG_SIZE = 64
    cfg.SLOTS.DECODER.DROPOUT = 0.1
    model = build_model(cfg, "cpu", seed=2)
    state = build_slot_state(cfg, model)
    step = make_train_step(model, cfg)
    size = cfg.SLOTS.IMG_SIZE
    stats = []
    for i in range(steps):
        video = torch.from_numpy(np.random.RandomState(20 + i).rand(
            GLOBAL_BATCH, cfg.SLOTS.NUM_ITERS, size, size, 3).astype(
                np.float32))
        state, out = step(state, local(video))
        stats.append({k: float(v) for k, v in out.items()})
    return {"stats": stats, "params": _params(model)}


def slot_eval_run(out_dir):
    """``slot_eval`` of ``steve_synthetic.yaml``'s STEVE (random weights
    of seed 3, written by rank 0 as the epoch-1 checkpoint it reads) over
    its 16 test clips at TEST.BATCH_SIZE 6, so the last batch pads: each
    batch's FG-ARI and mBO, the results and the clips scored."""
    from focus_tpu_torch.engine.slot_trainer import run_slot_eval
    from focus_tpu_torch.entry import steve_train_cfg
    from focus_tpu_torch.models.build import build_model
    from focus_tpu_torch.utils import checkpoint as cu

    cfg = steve_train_cfg(tiny=True, float32=True)
    cfg.TEST.BATCH_SIZE = 6
    cfg.DATA_LOADER.NUM_WORKERS = 1
    cfg.OUTPUT_DIR = cfg.EXP.PATH = out_dir
    cu.save_checkpoint(out_dir, build_model(cfg, "cpu", seed=3), 1, cfg)
    mesh.barrier()
    run = run_slot_eval(cfg, "cpu")
    return {"results": run.results, "fg_aris": run.fg_aris,
            "mbos": run.mbos, "clips": run.clips}


def mf_cfg(out_dir):
    """``mf_synthetic.yaml`` on the CPU under ``out_dir``: 64 train clips at
    global batch 8, 16 test clips at 6 (so the last test batch pads)."""
    from focus_tpu_torch.config import get_cfg

    cfg = get_cfg()
    cfg.merge_from_file(MF_YAML)
    cfg.OUTPUT_DIR = out_dir
    cfg.TEST.BATCH_SIZE = 6
    cfg.DATA_LOADER.NUM_WORKERS = 1
    return cfg


def multi_view_test(out_dir):
    """The multi-view test of ``mf_synthetic.yaml`` from its random
    initialisation: the stats, the meter's per-video predictions and
    labels, and the clips the meter counted."""
    from focus_tpu_torch.engine import tester

    cfg = mf_cfg(out_dir)
    cfg.TEST.SAVE_RESULTS_PATH = "results.pkl"
    run = tester.run_test(cfg, device="cpu")
    meter = run.meter
    return {"stats": run.stats, "preds": np.asarray(meter.video_preds),
            "labels": np.asarray(meter.video_labels),
            "counts": np.asarray(meter.clip_count)}


def preempted_train(out_dir, signal_rank=1, signal_step=3):
    """``mf_synthetic.yaml``'s train loop, one epoch of 8 steps, in which
    process ``signal_rank`` asks for preemption at step ``signal_step``
    (the flag is polled every 2 steps); returns the step each process
    stopped at (the loop exits 0 after the save)."""
    from focus_tpu_torch.engine import trainer
    from focus_tpu_torch.utils import preemption

    cfg = mf_cfg(out_dir)
    cfg.TEST.ENABLE = False
    cfg.TPU.PREEMPT_SYNC_PERIOD = 2
    cfg.TPU.PREEMPTION_SAVE = True
    make = trainer.make_supervised_train_step
    seen = {}

    def make_signalling(model, cfg, loss_fn):
        step = make(model, cfg, loss_fn)

        def signalling(state, *batch):
            state, stats = step(state, *batch)
            if state.step == signal_step and mesh.rank() == signal_rank:
                preemption.request_preemption()
            seen["step"] = state.step
            return state, stats

        return signalling

    trainer.make_supervised_train_step = make_signalling
    preemption.clear_preemption()
    try:
        trainer.run_train(cfg, device="cpu")
        stopped = None
    except SystemExit as e:
        stopped = e.code
    finally:
        trainer.make_supervised_train_step = make
        preemption.clear_preemption()
    return {"exit": stopped, "step": seen.get("step")}


def run_all(cfg, device):
    """Every scenario on this process; the results to
    ``<OUTPUT_DIR>/rank<r>.pt``. The flagship's initial weights for the
    JAX-held case come from ``<OUTPUT_DIR>/jax_init.pt``."""
    torch.set_num_threads(1)
    out = cfg.OUTPUT_DIR
    jax_init = torch.load(os.path.join(out, "jax_init.pt"))
    results = {
        "world": mesh.world_size(),
        "flagship": flagship_steps(),
        "flagship_jax": flagship_steps(mixup=False, init=jax_init),
        "batchnorm": resnet_steps("batchnorm"),
        "sub_batchnorm": resnet_steps("sub_batchnorm", batch=6),
        "steve": steve_steps(),
        "slot_eval": slot_eval_run(os.path.join(out, "slot_eval")),
        "test": multi_view_test(os.path.join(out, "test")),
        "preempt": preempted_train(os.path.join(out, "preempt")),
    }
    torch.save(results, os.path.join(out, f"rank{mesh.rank()}.pt"))
