"""Train / test dispatch CLI (counterpart of ``tools/run_net.py``):

    python -m focus_tpu_torch.tools.run_net [--device cuda|cpu] --cfg X.yaml [--exp_name N] [KEY VAL ...]

``TRAIN.ENABLE`` runs ``engine.trainer.train`` under ``TRAIN.METHOD: sup``
and ``engine.slot_trainer.slot_train`` under ``slots``; then
``TEST.ENABLE`` runs ``engine.tester.test`` under ``TEST.EVAL_TASK: ar``
and ``engine.slot_trainer.slot_eval`` under ``segmentation`` (each reads
its checkpoint through the test path's chain, EXP.PATH included). The
visualizations and the demo are not ported yet: each raises
``NotImplementedError`` before anything runs.
"""

import os

from focus_tpu_torch.config.defaults import assert_and_infer_cfg
from focus_tpu_torch.utils.parser import load_config, parse_args


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
    where TEST.ENABLE is off)."""
    args = parse_args(argv)
    cfg = load_config(args)
    cfg = assert_and_infer_cfg(cfg)

    cfg.EXP.NAME = args.exp_name
    cfg.EXP.PATH = os.path.join(cfg.OUTPUT_DIR, args.exp_name)
    _check_ported(cfg)
    if cfg.TRAIN.ENABLE and cfg.TRAIN.METHOD == "sup":
        from focus_tpu_torch.engine.trainer import train

        train(cfg, device=args.device)
    elif cfg.TRAIN.ENABLE and cfg.TRAIN.METHOD == "slots":
        from focus_tpu_torch.engine.slot_trainer import slot_train

        slot_train(cfg, device=args.device)
    if cfg.TEST.ENABLE and cfg.TEST.EVAL_TASK == "segmentation":
        from focus_tpu_torch.engine.slot_trainer import slot_eval

        return slot_eval(cfg, device=args.device)
    if cfg.TEST.ENABLE and cfg.TEST.EVAL_TASK == "ar":
        from focus_tpu_torch.engine.tester import test

        return test(cfg, device=args.device)
    return None


if __name__ == "__main__":
    main()
