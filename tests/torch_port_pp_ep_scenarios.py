"""The port's pipeline and expert parallelism scenarios
(``focus_tpu_torch/parallel/``), each run on one process or on every rank
of a mesh of four gloo processes: each makes its global batches from a
seed with numpy and runs its data rank's rows of them, so one process and
the mesh must agree. ``run_all`` is the function
``tools.run_net.launch_job`` runs on each of the four processes in
``tests/test_torch_port_pp_ep.py``; it imports no JAX, sets each scenario's
mesh (``parallel/mesh.set_axes``) and writes each process's results to
``<OUTPUT_DIR>/rank<r>.pt``."""

import os

import torch

from focus_tpu_torch.parallel import mesh
from focus_tpu_torch.parallel import tensor

GLOBAL_BATCH = 4
SEEDS = (3, 4)  # the train steps' batches
EVAL_SEED = 9


def local(x):
    """This data rank's contiguous rows of a global batch."""
    n = x.shape[0] // mesh.data_size()
    return x[mesh.data_rank() * n:(mesh.data_rank() + 1) * n]


def tiny_cfg(pipe=1, expert=1, drop_path=0.0, zero1=False, accum=1,
             micro=2, orvit=False, depth=4):
    """The MoE yaml's tiny model (D=24, 2 heads, F=2, float32) with 2
    experts over ``depth`` blocks (with ``orvit`` the tiny ORViT-MF of JAX's
    ``_orvit_mf_cfg``: ORViT at block 1, depth 6, no experts) on a (data,
    pipe, expert) mesh of ``micro`` microbatches; the yaml's AdamW, 2
    steps an epoch, as ``test_torch_port_moe.py`` steps it."""
    from focus_tpu_torch.entry import moe_cfg

    cfg = moe_cfg(tiny=True)
    cfg.MF.DEPTH = depth
    cfg.TPU.MOE.NUM_EXPERTS = 2
    if orvit:
        cfg.MF.DEPTH = 6
        cfg.TPU.MOE.NUM_EXPERTS = 0
        cfg.ORVIT.ENABLE = True
        cfg.ORVIT.LAYERS = [1]
    cfg.MF.DROP_PATH = drop_path
    cfg.TPU.MESH.PIPE, cfg.TPU.MESH.EXPERT = pipe, expert
    cfg.TPU.MESH.PIPE_MICROBATCHES = micro
    cfg.TPU.ZERO1, cfg.TPU.GRAD_ACCUM = zero1, accum
    cfg.TRAIN.BATCH_SIZE = cfg.TEST.BATCH_SIZE = GLOBAL_BATCH
    cfg.SOLVER.STEPS, cfg.SOLVER.MAX_EPOCH = [0, 1, 2], 10
    return cfg


def batch(cfg, seed):
    from focus_tpu_torch.entry import example_inputs

    return example_inputs(cfg, GLOBAL_BATCH, seed, "cpu", labels=True)


def run_steps(cfg, init=None, out_dir=None, seeds=SEEDS, virtual=1):
    """Train steps of ``cfg``'s tiny model on the global batches of
    ``seeds`` (from ``init``, a full state dict, or the seeded init), then
    the eval probabilities of the batch of EVAL_SEED, gathered over the
    data line. Returns each step's stats, the full parameters after, the
    one-process form of the optimizer's state, the generator, the
    probabilities, this rank's bytes and, with ``out_dir``, the path of a
    train checkpoint written there. In one process, ``virtual`` is the
    data ranks it plays (``mesh.single_process_mesh``)."""
    from focus_tpu_torch.engine.trainer import (
        build_supervised_state,
        make_supervised_train_step,
        state_bytes,
    )
    from focus_tpu_torch.models.build import build_model
    from focus_tpu_torch.models.losses import get_loss_func
    from focus_tpu_torch.utils import checkpoint as cu

    with mesh.single_process_mesh(virtual):
        model = build_model(cfg, "cpu", seed=0)
        if init is not None:
            tensor.load_full_state_dict(model, init)
        state = build_supervised_state(cfg, model, 2)
        step = make_supervised_train_step(model, cfg, get_loss_func(cfg))
    stats = []
    model.train()
    for seed in seeds:
        video, labels, _ = batch(cfg, seed)
        state, st = step(state, local(video), local(labels), {})
        stats.append({k: v.item() for k, v in st.items()})
    opt = state.optimizer
    out = {"stats": stats, "params": tensor.full_state_dict(model),
           "grad_norm": opt._global_norm([p.grad for p in opt.params]),
           "bytes": state_bytes(state),
           "optimizer": state.optimizer.state_dict(),
           "generator": state.generator.get_state()}
    if out_dir is not None:
        out["checkpoint"] = cu.save_checkpoint(out_dir, state, 1, cfg,
                                               async_write=False)
    model.eval()
    video, _, _ = batch(cfg, EVAL_SEED)
    with torch.no_grad():
        probs = model(local(video))
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
    results = {}
    for name, kwargs, from_jax, ckpt in SCENARIOS:
        c = tiny_cfg(**kwargs)
        results[name] = _on_mesh(c, lambda: run_steps(
            c, init if from_jax else None,
            os.path.join(out, name) if ckpt else None))
    torch.save(results, os.path.join(out, f"rank{mesh.rank()}.pt"))


# (name, tiny_cfg's arguments, whether it starts from the JAX package's
# init (else the port's seeded one), whether it writes a checkpoint); on
# the four processes DATA is what the other axes leave. DATA 2 x PIPE 2
# takes one microbatch, which JAX's grouping spreads over both data ranks
SCENARIOS = (
    ("pp_ep", {"pipe": 2, "expert": 2}, True, False),
    ("dp_pp", {"pipe": 2, "micro": 1}, True, False),
    ("dp_moe", {}, True, False),
    ("dp_ep", {"expert": 2, "zero1": True, "accum": 2}, False, True),
)
