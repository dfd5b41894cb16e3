"""The port's multigrid training on the CPU against the JAX package's pure
functions and loader (no JAX training): the long-cycle schedule and the
per-epoch config rewrite on the three multigrid yamls and on
``tests/test_multigrid.py``'s cases, the short-cycle index stream and the
sharded batches of the loader at one, two and three processes, a tiny
long-cycle loop (its shapes, BN types and LR at every step), and the
Kinetics / Charades crops by short-cycle phase, which the JAX datasets do
not reach (they index their lists with the (index, phase) tuple)."""

import os

import numpy as np
import pytest
import torch

from focus_tpu_torch.config import get_cfg
from focus_tpu_torch.datasets import loader
from focus_tpu_torch.parallel import mesh
from focus_tpu_torch.utils.multigrid import (
    MultigridSchedule,
    get_current_long_cycle_shape,
)
from torch_port_trees import jax_cfg_like

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
YAMLS = ["Kinetics/SLOWFAST_8x8_R50_stepwise_multigrid.yaml",
         "SSv2/SLOWFAST_16x8_R50_multigrid.yaml",
         "Charades/SLOWFAST_16x8_R50_multigrid.yaml"]
# tests/test_multigrid.py's CASES: (steps, lrs, max_epoch, t, s)
CASES = [([0, 94, 154, 196], [1, 0.1, 0.01, 0.001], 239, 8, 224),
         ([0, 20, 30], [1, 0.1, 0.01], 40, 16, 224),
         ([0, 41, 49], [1, 0.1, 0.01], 57, 64, 224),
         ([0, 10, 15, 20], [1, 0.5, 0.1, 0.01], 25, 32, 112)]
REWRITTEN = ("DATA.NUM_FRAMES", "DATA.TRAIN_CROP_SIZE", "TRAIN.BATCH_SIZE",
             "BN.NORM_TYPE", "BN.NUM_SPLITS", "BN.NUM_SYNC_DEVICES",
             "MULTIGRID.LONG_CYCLE_SAMPLING_RATE", "SOLVER.STEPS",
             "SOLVER.LRS", "SOLVER.MAX_EPOCH", "MULTIGRID.DEFAULT_B",
             "MULTIGRID.DEFAULT_T", "MULTIGRID.DEFAULT_S")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _value(cfg, key):
    sec, name = key.split(".")
    v = getattr(getattr(cfg, sec), name)
    return list(v) if isinstance(v, (list, tuple)) else v


def _case_cfg(case):
    steps, lrs, max_epoch, t, s = CASES[case]
    cfg = get_cfg()
    cfg.MULTIGRID.LONG_CYCLE = cfg.MULTIGRID.SHORT_CYCLE = True
    cfg.TRAIN.BATCH_SIZE, cfg.DATA.NUM_FRAMES = 16, t
    cfg.DATA.TRAIN_CROP_SIZE, cfg.DATA.SAMPLING_RATE = s, 8
    cfg.SOLVER.LR_POLICY = "steps_with_relative_lrs"
    cfg.SOLVER.STEPS, cfg.SOLVER.LRS = list(steps), list(lrs)
    cfg.SOLVER.MAX_EPOCH, cfg.NUM_GPUS = max_epoch, 8
    return cfg


@pytest.mark.parametrize("source", YAMLS + [f"case{i}" for i in
                                             range(len(CASES))])
def test_long_cycle_schedule_and_rewrites_match_jax(source):
    """``init_multigrid``'s schedule and SOLVER rewrite, then every epoch's
    ``update_long_cycle`` (shape, batch, BN type, sampling rate), equal
    the JAX package's on the same config."""
    from focus_tpu.utils.multigrid import MultigridSchedule as JaxSchedule

    if source.startswith("case"):
        cfg = _case_cfg(int(source[4:]))
    else:
        cfg = get_cfg()
        cfg.merge_from_file(os.path.join(REPO, "configs", source))
    jcfg = jax_cfg_like(cfg)
    ours, ref = MultigridSchedule(), JaxSchedule()
    cfg, jcfg = ours.init_multigrid(cfg), ref.init_multigrid(jcfg)
    assert ours.schedule == ref.schedule and len(ours.schedule) > 4
    for epoch in range(cfg.SOLVER.MAX_EPOCH):
        cfg, changed = ours.update_long_cycle(cfg, epoch)
        jcfg, jchanged = ref.update_long_cycle(jcfg, epoch)
        assert changed == jchanged, epoch
        assert [_value(cfg, k) for k in REWRITTEN] == [
            _value(jcfg, k) for k in REWRITTEN], epoch
        assert [cfg.TRAIN.BATCH_SIZE // cfg.MULTIGRID.DEFAULT_B,
                cfg.DATA.NUM_FRAMES, cfg.DATA.TRAIN_CROP_SIZE] == list(
            get_current_long_cycle_shape(ours.schedule, epoch))


class Indices:
    """A dataset of its own indices (the loader's index stream)."""

    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return np.int64(i)


@pytest.mark.parametrize("procs", [1, 2, 3])
@pytest.mark.parametrize("kind", ["short_cycle", "train", "val"])
def test_loader_streams_match_jax(procs, kind, monkeypatch):
    """Every process's batches of two epochs, with the process group's
    rank and size patched in, equal the JAX loader's with
    ``process_index`` / ``process_count`` set: the short cycle's
    [B / f0^2, B / f1^2, B] global batches, each index carried with its
    phase; the shuffled train batches; and the padded val batches with
    their pad rows, each process's contiguous slice of the global batch."""
    from focus_tpu.datasets.loader import DataLoader as JaxLoader

    batch = 6
    n = 100 if kind == "short_cycle" else 21
    shuffle, drop_last = kind != "val", kind != "val"
    factors = (0.5, 0.5 ** 0.5) if kind == "short_cycle" else None
    seen = []
    monkeypatch.setattr(mesh, "world_size", lambda: procs)
    for p in range(procs):
        monkeypatch.setattr(mesh, "rank", lambda: p)
        ours = loader.DataLoader(
            Indices(n), batch, shuffle, drop_last, seed=3, device="cpu",
            pad_last=not drop_last, short_cycle_factors=factors)
        ref = JaxLoader(Indices(n), batch, shuffle, drop_last, seed=3,
                        pad_last=not drop_last, short_cycle_factors=factors)
        ref.process_index, ref.process_count = p, procs
        assert len(ours) == len(ref)
        for epoch in (0, 1):
            ours.set_epoch(epoch)
            ref.set_epoch(epoch)
            got = [(list(i), m.tolist()) for i, m in ours._batches()]
            want = [(list(i), m.tolist()) for i, m in ref._local_batches()]
            assert got == want, (p, epoch)
            seen.append(got)
            for b, (idx, mask) in enumerate(got if kind == "val" else []):
                assert ours.real_rows(b) == len(mask) - sum(mask)
    if kind == "short_cycle":
        sizes = [len(i) for i, _ in seen[0]]
        assert {i[1] for i in seen[0][0][0]} == {0}
        if procs == 1:
            assert sizes[:3] == [24, 12, 6]


def test_loader_refuses_a_batch_the_processes_do_not_divide(monkeypatch):
    monkeypatch.setattr(mesh, "world_size", lambda: 4)
    with pytest.raises(ValueError, match="not divisible by 4 processes"):
        loader.DataLoader(Indices(8), 6, False, False, device="cpu")


def _tiny_mg_cfg(tmp_path):
    """``tests/test_multigrid.py``'s toy long-cycle run on the port: a Slow
    R50 of width 8 on synthetic clips, two long-cycle factors, 6 epochs over
    LR steps [0, 2, 4]."""
    cfg = get_cfg()
    cfg.merge_from_file(os.path.join(REPO, "configs", "Kinetics",
                                     "SLOW_8x8_R50.yaml"))
    cfg.RESNET.WIDTH_PER_GROUP = 8
    cfg.MODEL.NUM_CLASSES = 6
    cfg.TRAIN.DATASET = cfg.TEST.DATASET = "synthetic_classification"
    cfg.TRAIN.BATCH_SIZE = cfg.TEST.BATCH_SIZE = 8
    cfg.DATA.NUM_FRAMES, cfg.DATA.SAMPLING_RATE = 4, 2
    cfg.DATA.TRAIN_CROP_SIZE = cfg.DATA.TEST_CROP_SIZE = 64
    cfg.SOLVER.LR_POLICY = "steps_with_relative_lrs"
    cfg.SOLVER.STEPS, cfg.SOLVER.LRS = [0, 2, 4], [1, 0.1, 0.01]
    cfg.SOLVER.MAX_EPOCH, cfg.SOLVER.BASE_LR = 6, 0.1
    cfg.SOLVER.WARMUP_EPOCHS = 0
    cfg.MULTIGRID.LONG_CYCLE = True
    cfg.MULTIGRID.EPOCH_FACTOR = 1.0
    cfg.MULTIGRID.LONG_CYCLE_FACTORS = [[0.5, 0.5], [1.0, 1.0]]
    cfg.MULTIGRID.BN_BASE_SIZE = 1
    cfg.TRAIN.EVAL_PERIOD, cfg.TRAIN.CHECKPOINT_PERIOD = 1, 100
    cfg.TRAIN.AUTO_RESUME = False
    cfg.BN.USE_PRECISE_STATS = False
    cfg.TENSORBOARD.ENABLE = False
    cfg.DATA_LOADER.NUM_WORKERS = 1
    cfg.LOG_PERIOD, cfg.NUM_GPUS = 1, 8
    cfg.OUTPUT_DIR = str(tmp_path)
    cfg.TPU.COMPUTE_DTYPE = "float32"
    return cfg


def test_long_cycle_loop_follows_the_schedule(tmp_path, monkeypatch):
    """A toy long-cycle run: every epoch's batches have the schedule's
    (B, T, S), the model its BN type, the validation its own loader; the
    LR of every step is ``epoch_lr_schedule`` on the rewritten config,
    continued from (epoch, step) at each rebuild; the parameters, the
    optimizer's moments and the step carry across the rebuilds."""
    from focus_tpu_torch.engine import trainer
    from focus_tpu_torch.models import optimizer as optim
    from focus_tpu_torch.models.norms import SubBatchNorm
    from focus_tpu_torch.utils import lr_policy

    cfg = _tiny_mg_cfg(tmp_path)
    ref = MultigridSchedule()
    ref_cfg = ref.init_multigrid(cfg.clone())
    seen, lrs = [], []
    train_epoch, step_fn = trainer.train_epoch, optim.Optimizer.step

    def spy_epoch(train_loader, state, train_step, train_meter, cur_epoch,
                  cfg_, **kw):
        video = next(iter(train_loader))[0]
        clip = video[0] if isinstance(video, (tuple, list)) else video
        subbn = any(isinstance(m, SubBatchNorm) for m in state.model.modules())
        momentum = state.optimizer.optimizer.state_dict()["state"]
        seen.append((cur_epoch, tuple(clip.shape[:3]), subbn,
                     len(train_loader), state.step, bool(momentum)))
        return train_epoch(train_loader, state, train_step, train_meter,
                           cur_epoch, cfg_, **kw)

    def spy_step(self, count):
        lrs.append((count, self.schedules[0](count)))
        return step_fn(self, count)

    monkeypatch.setattr(trainer, "train_epoch", spy_epoch)
    monkeypatch.setattr(optim.Optimizer, "step", spy_step)
    run = trainer.run_train(cfg, device="cpu")

    assert [s[0] for s in seen] == list(range(ref_cfg.SOLVER.MAX_EPOCH))
    expected, offset = {}, (0, 0)
    prev = None
    for epoch, shape, subbn, steps, step, momentum in seen:
        b, t, s = get_current_long_cycle_shape(ref.schedule, epoch)
        assert shape == (b * 8, t, s), epoch
        assert subbn == (b > 1)  # 8 b clips a process over BN_BASE_SIZE 1
        assert momentum == (step > 0)
        if (b, t, s) != prev:
            offset, prev = (epoch, step), (b, t, s)
        for k in range(step, step + steps):
            e = offset[0] + (k - offset[1]) / steps
            expected[k] = lr_policy.get_lr_at_epoch(ref_cfg, e)["lr"]
    assert [c for c, _ in lrs] == list(range(run.state.step))
    assert [lr for _, lr in lrs] == [expected[c] for c, _ in lrs]
    assert len({s[1] for s in seen}) == 2 and run.val_stats


@pytest.fixture(scope="module")
def k400(tmp_path_factory):
    from synthetic_data import make_kinetics_tree

    pytest.importorskip("cv2")
    root = str(tmp_path_factory.mktemp("k400mg"))
    make_kinetics_tree(root, num_videos=2, num_frames=24, size=48)
    return root


def _short_cycle_cfg(cfg):
    cfg.MULTIGRID.SHORT_CYCLE = True
    cfg.MULTIGRID.DEFAULT_S = cfg.DATA.TRAIN_CROP_SIZE
    return cfg


@pytest.mark.parametrize("dataset", ["kinetics", "charades"])
def test_short_cycle_crops_by_phase(k400, tmp_path, dataset):
    """Kinetics and Charades take the short cycle's (index, phase): phases
    0 and 1 crop SHORT_CYCLE_FACTORS x DEFAULT_S, phase 2 and a plain index
    the train crop. The JAX datasets index their lists with the tuple and
    raise (ROADMAP.md section 3, defect 8)."""
    from test_torch_port_charades import charades_cfg, make_charades_tree

    if dataset == "kinetics":
        from focus_tpu.datasets.kinetics import Kinetics as Jax
        from focus_tpu_torch.datasets.kinetics import Kinetics as Port

        cfg = get_cfg()
        cfg.DATA.PATH_TO_DATA_DIR = k400
        cfg.DATA.NUM_FRAMES, cfg.DATA.SAMPLING_RATE = 4, 2
        cfg.DATA.TRAIN_JITTER_SCALES = [40, 56]
        cfg.DATA.TRAIN_CROP_SIZE = 36
        cfg.MODEL.ARCH = "slow"
    else:
        from focus_tpu.datasets.charades import Charades as Jax
        from focus_tpu_torch.datasets.charades import Charades as Port

        root = str(tmp_path / "charades")
        make_charades_tree(root)
        cfg = charades_cfg(root)
        cfg.MODEL.ARCH = "slow"
    cfg = _short_cycle_cfg(cfg)
    crop = cfg.DATA.TRAIN_CROP_SIZE
    port = Port(cfg, "train")
    for index, size in ((0, crop), ((0, 0), round(0.5 * crop)),
                        ((1, 1), round(0.5 ** 0.5 * crop)), ((1, 2), crop)):
        video, _, idx, _ = port[index]
        assert video.shape[1:3] == (size, size), index
        assert int(idx) == (index[0] if isinstance(index, tuple) else index)
    with pytest.raises(TypeError):
        Jax(jax_cfg_like(cfg), "train")[(0, 0)]
