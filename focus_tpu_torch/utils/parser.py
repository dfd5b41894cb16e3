"""Command-line argument handling (counterpart of
``focus_tpu/utils/parser.py``).

The same surface: ``--cfg`` YAML path, ``--exp_name``,
``--shard_id/--num_shards/--init_method`` and a trailing ``KEY VALUE ...``
override list; and ``--device`` (``cuda`` by default), before the
overrides: the one way to run on the CPU.
"""

import argparse
import os
import sys

from focus_tpu_torch.config.defaults import get_cfg


def parse_args(argv=None):
    parser = argparse.ArgumentParser(
        description="FOCUS video training and testing pipeline (PyTorch)."
    )
    parser.add_argument(
        "--shard_id",
        help="Shard id of the current host, in [0, num_shards)",
        default=0,
        type=int,
    )
    parser.add_argument(
        "--num_shards", help="Number of hosts in the job", default=1, type=int
    )
    parser.add_argument(
        "--init_method",
        help="Coordinator address for multi-host init (host:port)",
        default="tcp://localhost:9848",
        type=str,
    )
    parser.add_argument(
        "--cfg",
        dest="cfg_file",
        help="Path to the config file",
        default="configs/Kinetics/SLOWFAST_4x16_R50.yaml",
        type=str,
    )
    parser.add_argument(
        "--device",
        help="Device to run on: cuda (default; raises where CUDA is absent) "
             "or cpu",
        default="cuda",
        choices=("cuda", "cpu"),
    )
    parser.add_argument(
        "opts",
        help="See focus_tpu_torch/config/defaults.py for all options",
        default=None,
        nargs=argparse.REMAINDER,
    )
    parser.add_argument(
        "--exp_name", help="Name of the experiment to run", default="steve", type=str
    )
    if argv is None and len(sys.argv) == 1:
        parser.print_help()
    return parser.parse_args(argv)


def load_config(args):
    """Build the final config: defaults <- YAML <- CLI opts <- args."""
    cfg = get_cfg()
    if args.cfg_file is not None:
        cfg.merge_from_file(args.cfg_file)
    if args.opts is not None:
        cfg.merge_from_list(args.opts)

    if hasattr(args, "num_shards") and hasattr(args, "shard_id"):
        cfg.NUM_SHARDS = args.num_shards
        cfg.SHARD_ID = args.shard_id
    if hasattr(args, "rng_seed"):
        cfg.RNG_SEED = args.rng_seed
    if hasattr(args, "output_dir"):
        cfg.OUTPUT_DIR = args.output_dir

    exp_name = getattr(args, "exp_name", None)
    make_output_dir(cfg.OUTPUT_DIR, exp_name)
    return cfg


def make_output_dir(output_dir, exp_name=None):
    """Create the experiment output directory tree."""
    path = os.path.join(output_dir, exp_name) if exp_name else output_dir
    os.makedirs(os.path.join(path, "checkpoints"), exist_ok=True)
    return path
