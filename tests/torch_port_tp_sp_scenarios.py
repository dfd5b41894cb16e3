"""The port's tensor and sequence parallelism and ZeRO-1 scenarios
(``focus_tpu_torch/parallel/``), each run on one process or on every rank
of a mesh of four gloo processes: each makes its global batch from a seed
with numpy and runs its data rank's rows of it, so one process and the
mesh must agree. ``run_all`` is the function ``tools.run_net.launch_job``
runs on each of the four processes in ``tests/test_torch_port_tp_sp.py``;
it imports no JAX, sets each scenario's mesh (``parallel/mesh.set_axes``)
and writes each process's results to ``<OUTPUT_DIR>/rank<r>.pt``."""

import os

import torch

from focus_tpu_torch.parallel import mesh
from focus_tpu_torch.parallel import tensor

GLOBAL_BATCH = 4
SEEDS = (3, 4)  # the train steps' batches
EVAL_SEED = 9


def local(x):
    """This data rank's contiguous rows of a global batch (a tensor or a
    dict of them)."""
    if isinstance(x, dict):
        return {k: local(v) for k, v in x.items()}
    n = x.shape[0] // mesh.data_size()
    return x[mesh.data_rank() * n:(mesh.data_rank() + 1) * n]


def tiny_cfg(seq=1, model=1, drop_path=0.2, zero1=False, accum=1,
             sgd=False):
    """The tiny flagship (D=24, 2 heads, F=2, ORViT at [1] with its motion
    stream, float32) on a (data, seq, model) mesh; AdamW at a large LR, or
    with ``sgd`` ``test_torch_port_train.py``'s Nesterov SGD behind a
    global-norm clip, warm-up into a cosine."""
    from focus_tpu_torch.entry import train_cfg

    cfg = train_cfg(tiny=True)
    cfg.ORVIT.USE_MOTION_STREAM = True
    cfg.ORVIT.MOTION_STREAM_ATTN_TYPE = "joint"
    cfg.MF.DROP_PATH = drop_path
    cfg.TPU.MESH.SEQ, cfg.TPU.MESH.MODEL = seq, model
    cfg.TPU.ZERO1, cfg.TPU.GRAD_ACCUM = zero1, accum
    s = cfg.SOLVER
    if sgd:
        s.OPTIMIZING_METHOD = "sgd"
        s.MOMENTUM, s.NESTEROV = 0.9, True
        s.BASE_LR, s.WEIGHT_DECAY = 0.5, 1e-3
        s.LR_POLICY, s.MAX_EPOCH = "cosine", 4
        s.WARMUP_EPOCHS, s.WARMUP_START_LR = 1.0, 0.05
        s.CLIP_GRAD_L2NORM = 0.05
    else:
        s.BASE_LR = 2e-3
    return cfg


def batch(cfg, seed):
    from focus_tpu_torch.entry import example_inputs

    return example_inputs(cfg, GLOBAL_BATCH, seed, "cpu", labels=True)


def run_steps(cfg, init=None, out_dir=None, seeds=SEEDS):
    """Train steps of ``cfg``'s tiny flagship on the global batches of
    ``seeds`` (from ``init``, a full state dict, or the seeded init), then
    the eval probabilities of the batch of EVAL_SEED, gathered over the
    data line. Returns each step's stats, the full parameters after, the
    probabilities, this rank's bytes and, with ``out_dir``, the path of a
    train checkpoint written there."""
    from focus_tpu_torch.engine.trainer import (
        build_supervised_state,
        make_supervised_train_step,
        state_bytes,
    )
    from focus_tpu_torch.models.build import build_model
    from focus_tpu_torch.models.losses import get_loss_func
    from focus_tpu_torch.utils import checkpoint as cu

    model = build_model(cfg, "cpu", seed=0)
    if init is not None:
        tensor.load_full_state_dict(model, init)
    state = build_supervised_state(cfg, model, 2)
    step = make_supervised_train_step(model, cfg, get_loss_func(cfg))
    stats = []
    model.train()
    for seed in seeds:
        video, labels, boxes = batch(cfg, seed)
        state, st = step(state, local(video), local(labels),
                         {"orvit_bboxes": local(boxes)})
        stats.append({k: v.item() for k, v in st.items()})
    out = {"stats": stats, "params": tensor.full_state_dict(model),
           "bytes": state_bytes(state),
           "optimizer": state.optimizer.state_dict(),
           "generator": state.generator.get_state()}
    if out_dir is not None:
        out["checkpoint"] = cu.save_checkpoint(out_dir, state, 1, cfg,
                                               async_write=False)
    model.eval()
    video, _, boxes = batch(cfg, EVAL_SEED)
    with torch.no_grad():
        probs = model(local(video), {"orvit_bboxes": local(boxes)})
    out["probs"] = mesh.all_gather_tiled(probs, mesh.group("data"))
    return out


def _on_mesh(cfg, fn):
    mesh.set_axes(cfg)
    try:
        return fn()
    finally:
        mesh.set_axes(tiny_cfg())


def run_all(cfg, device="cpu"):
    """Every scenario on this process of the four; its results to
    ``<OUTPUT_DIR>/rank<r>.pt``."""
    torch.set_num_threads(1)
    out = cfg.OUTPUT_DIR
    init = torch.load(os.path.join(out, "jax_init.pt"), weights_only=False)
    results = {
        # seq 2 x model 2: drop path on against one process; the SGD clip
        # case without drop path against JAX's mesh step
        "seq_model": _on_mesh(tiny_cfg(2, 2), lambda: run_steps(
            tiny_cfg(2, 2))),
        "seq_model_jax": _on_mesh(tiny_cfg(2, 2, 0.0, sgd=True),
                                  lambda: run_steps(
                                      tiny_cfg(2, 2, 0.0, sgd=True), init)),
        # data 2 x model 2, ZeRO-1 and two microbatches; its checkpoint
        "zero1": _on_mesh(tiny_cfg(1, 2, zero1=True, accum=2),
                          lambda: run_steps(
                              tiny_cfg(1, 2, zero1=True, accum=2),
                              out_dir=os.path.join(out, "zero1"))),
    }
    torch.save(results, os.path.join(out, f"rank{mesh.rank()}.pt"))
