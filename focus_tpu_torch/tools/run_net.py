"""Train / test dispatch CLI (counterpart of ``tools/run_net.py``):

    python -m focus_tpu_torch.tools.run_net [--device cuda|cpu] --cfg X.yaml [--exp_name N]
        [--init_method tcp://host:port --num_shards n --shard_id i] [KEY VAL ...]

``TRAIN.ENABLE`` runs ``engine.trainer.train`` under ``TRAIN.METHOD: sup``
and ``engine.slot_trainer.slot_train`` under ``slots``; then
``TEST.ENABLE`` runs ``engine.tester.test`` under ``TEST.EVAL_TASK: ar``
and ``engine.slot_trainer.slot_eval`` under ``segmentation`` (each reads
its checkpoint through the test path's chain, EXP.PATH included). The
visualizations and the demo are not ported yet: each raises
``NotImplementedError`` before anything runs.

Each runs through ``launch_job``: ``NUM_GPUS`` processes a host (on the
card no more than the cards present), ``NUM_SHARDS`` hosts, one process
group of ``DIST_BACKEND`` (``gloo`` on the CPU) joined at
``--init_method``; one process in all is a direct call.
"""

import os

import torch

from focus_tpu_torch.config.defaults import assert_and_infer_cfg
from focus_tpu_torch.parallel import mesh
from focus_tpu_torch.utils.parser import load_config, parse_args


def _run(local_rank, num_processes, func, init_method, cfg, device):
    """One spawned process: join the group, run ``func``, leave."""
    device = mesh.init_distributed(cfg, local_rank, init_method, device,
                                   num_processes)
    try:
        func(cfg, device=device)
    finally:
        mesh.destroy()


def launch_job(cfg, init_method, func, device="cuda"):
    """``func(cfg, device=...)`` on every process of the job (the upstream
    launcher): one process in all (``NUM_GPUS`` and ``NUM_SHARDS`` 1, or a
    host with one card) calls it here and returns what it returns; more
    are spawned with ``torch.multiprocessing``, one a card, each joining
    the process group first, and return None. The world is the processes
    of every host: ``TPU.MESH.PIPE x SEQ x MODEL x EXPERT`` ranks a data
    line, the data axis the rest (``DATA -1`` absorbs it, as in the JAX
    package); each rank logs its parameter and optimizer bytes after
    training. A
    process already in a process group calls ``func`` itself. A
    ``TPU.MESH`` layout that the JAX package or the port refuses
    (``parallel/mesh.check_mesh``) raises before any process starts."""
    if mesh.is_distributed():
        mesh.check_mesh(cfg)
        return func(cfg, device=device)
    mesh.check_axes(cfg)  # before local_processes' warning
    procs = mesh.local_processes(cfg, device)
    mesh.check_mesh(cfg, world=procs * max(int(cfg.NUM_SHARDS), 1))
    if procs * max(int(cfg.NUM_SHARDS), 1) == 1:
        return func(cfg, device=device)
    torch.multiprocessing.spawn(
        _run, nprocs=procs,
        args=(procs, func, init_method, cfg, str(device)))
    return None


def _check_ported(cfg):
    if cfg.TENSORBOARD.ENABLE and (
        cfg.TENSORBOARD.MODEL_VIS.ENABLE or cfg.TENSORBOARD.WRONG_PRED_VIS.ENABLE
    ):
        raise NotImplementedError(
            "TENSORBOARD.MODEL_VIS / WRONG_PRED_VIS: the visualizations come "
            "with the visualization slice of the port"
        )
    if cfg.DEMO.ENABLE:
        raise NotImplementedError(
            "DEMO.ENABLE: the demo comes with the visualization slice of the "
            "port"
        )


def main(argv=None):
    """Returns the test's stats or the segmentation eval's results (None
    where TEST.ENABLE is off, or where more than one process ran it)."""
    args = parse_args(argv)
    cfg = load_config(args)
    cfg = assert_and_infer_cfg(cfg)

    cfg.EXP.NAME = args.exp_name
    cfg.EXP.PATH = os.path.join(cfg.OUTPUT_DIR, args.exp_name)
    _check_ported(cfg)
    if cfg.TRAIN.ENABLE and cfg.TRAIN.METHOD == "sup":
        from focus_tpu_torch.engine.trainer import train

        launch_job(cfg, args.init_method, train, args.device)
    elif cfg.TRAIN.ENABLE and cfg.TRAIN.METHOD == "slots":
        from focus_tpu_torch.engine.slot_trainer import slot_train

        launch_job(cfg, args.init_method, slot_train, args.device)
    if cfg.TEST.ENABLE and cfg.TEST.EVAL_TASK == "segmentation":
        from focus_tpu_torch.engine.slot_trainer import slot_eval

        return launch_job(cfg, args.init_method, slot_eval, args.device)
    if cfg.TEST.ENABLE and cfg.TEST.EVAL_TASK == "ar":
        from focus_tpu_torch.engine.tester import test

        return launch_job(cfg, args.init_method, test, args.device)
    return None


if __name__ == "__main__":
    main()
