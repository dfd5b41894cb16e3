"""Train / test dispatch CLI (counterpart of ``tools/run_net.py``):

    python -m focus_tpu_torch.tools.run_net [--device cuda|cpu] --cfg X.yaml [--exp_name N] [KEY VAL ...]

``TEST.ENABLE`` with ``TEST.EVAL_TASK: ar`` runs ``engine.tester.test``.
Training, the segmentation eval, the visualizations and the demo are not
ported yet: each raises ``NotImplementedError`` before anything runs.
"""

import os

from focus_tpu_torch.config.defaults import assert_and_infer_cfg
from focus_tpu_torch.utils.parser import load_config, parse_args


def _check_ported(cfg):
    if cfg.TRAIN.ENABLE:
        raise NotImplementedError(
            "TRAIN.ENABLE: the train loop (train, train_epoch, validation, "
            "resume) is the next slice of the port; set TRAIN.ENABLE False "
            "to test a checkpoint"
        )
    if cfg.TEST.ENABLE and cfg.TEST.EVAL_TASK != "ar":
        raise NotImplementedError(
            f"TEST.EVAL_TASK {cfg.TEST.EVAL_TASK}: the slot-model "
            "segmentation eval comes with the STEVE training slice of the port"
        )
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
    """Returns the test's stats (None where TEST.ENABLE is off)."""
    args = parse_args(argv)
    cfg = load_config(args)
    cfg = assert_and_infer_cfg(cfg)

    cfg.EXP.NAME = args.exp_name
    cfg.EXP.PATH = os.path.join(cfg.OUTPUT_DIR, args.exp_name)
    _check_ported(cfg)
    if cfg.TEST.ENABLE:
        from focus_tpu_torch.engine.tester import test

        return test(cfg, device=args.device)
    return None


if __name__ == "__main__":
    main()
