"""Standalone multi-view testing entry (counterpart of ``tools/test_net.py``):

    python -m focus_tpu_torch.tools.test_net [--device cuda|cpu] --cfg X.yaml [KEY VAL ...]

through ``tools.run_net.launch_job`` (``NUM_GPUS`` processes a host).
"""

import os

from focus_tpu_torch.config.defaults import assert_and_infer_cfg
from focus_tpu_torch.engine.tester import test
from focus_tpu_torch.tools.run_net import launch_job
from focus_tpu_torch.utils.parser import load_config, parse_args


def main(argv=None):
    args = parse_args(argv)
    cfg = load_config(args)
    cfg = assert_and_infer_cfg(cfg)
    cfg.EXP.NAME = args.exp_name
    cfg.EXP.PATH = os.path.join(cfg.OUTPUT_DIR, args.exp_name)
    return launch_job(cfg, args.init_method, test, args.device)


if __name__ == "__main__":
    main()
