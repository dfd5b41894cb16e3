from focus_tpu_torch.config.defaults import assert_and_infer_cfg, get_cfg
from focus_tpu_torch.config.node import CfgNode

__all__ = ["CfgNode", "get_cfg", "assert_and_infer_cfg"]
