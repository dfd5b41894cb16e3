"""Standalone STEVE training entry (counterpart of
``tools/steve_train_net.py``):

    python -m focus_tpu_torch.tools.steve_train_net [--device cuda|cpu] --cfg X.yaml [--exp_name N] [KEY VAL ...]

through ``tools.run_net.launch_job`` (``NUM_GPUS`` processes a host).

Checkpoints go to OUTPUT_DIR/<exp_name>/checkpoints/.
"""

import os

from focus_tpu_torch.config.defaults import assert_and_infer_cfg
from focus_tpu_torch.engine.slot_trainer import slot_train
from focus_tpu_torch.tools.run_net import launch_job
from focus_tpu_torch.utils.parser import load_config, parse_args


def main(argv=None):
    """Returns the final train state (None where more than one process
    ran it)."""
    args = parse_args(argv)
    cfg = load_config(args)
    cfg = assert_and_infer_cfg(cfg)
    cfg.EXP.NAME = args.exp_name
    cfg.EXP.PATH = os.path.join(cfg.OUTPUT_DIR, args.exp_name)
    return launch_job(cfg, args.init_method, slot_train, args.device)


if __name__ == "__main__":
    main()
