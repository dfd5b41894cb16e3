"""The port's supervised train loop against the JAX package's on the CPU:
the train, val and EPIC-Kitchens val meters and the epoch tables; device
mixup's application on JAX's own draws; ``TPU.GRAD_ACCUM``; ``train`` end
to end on ``configs/tests/mf_synthetic.yaml`` and on the tiny HR-336 EK
model from one ``.pyth``; the train checkpoint (round trip, resume,
preemption, async writes, ``load_train_checkpoint``'s choice) and the CLI.

Tolerances: meter lines equal (the same float64 sums of the same floats);
mixup 1e-6 (float32 elementwise); losses 1e-5 and parameters 1e-5 where
both packages run float32 on the CPU (sums in another order); checkpoints
and resume bit-equal (one package, one device)."""

import itertools
import json
import os
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from focus_tpu.utils import meters as jax_meters
from focus_tpu_torch.config.defaults import assert_and_infer_cfg
from focus_tpu_torch.entry import hr_train_cfg, train_cfg
from focus_tpu_torch.models.build import build_model
from focus_tpu_torch.utils import checkpoint as cu
from focus_tpu_torch.utils import meters
from focus_tpu_torch.utils import preemption
from focus_tpu_torch.utils.parser import load_config, parse_args
from focus_tpu_torch.utils.weights import jax_params_to_state_dict
from torch_port_trees import jax_cfg_like, make_ek_tree


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread a test: these models are small, so one runs
    them as fast as many, and beside the other test workers many spin
    against each other."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MF_YAML = os.path.join(REPO, "configs", "tests", "mf_synthetic.yaml")


@pytest.fixture(autouse=True)
def _clean_preemption_flag():
    preemption.clear_preemption()
    yield
    preemption.clear_preemption()


# ---- meters and epoch tables ------------------------------------------------

def _json_lines(monkeypatch, module, calls):
    """Run ``calls(meter_module)`` with ``module``'s json lines captured and
    the host clock a fixed count, so the timers read the same in both
    packages."""
    lines = []
    counter = itertools.count()
    monkeypatch.setattr(time, "perf_counter", lambda: float(next(counter)))
    monkeypatch.setattr(
        module.logging, "log_json_stats",
        lambda stats: lines.append(json.dumps(
            {k: round(v, 5) if isinstance(v, float) else v
             for k, v in stats.items()}, sort_keys=True)))
    calls(module)
    return lines


def _meter_cfg():
    cfg = train_cfg(tiny=True)
    cfg.LOG_PERIOD = 2
    cfg.SOLVER.MAX_EPOCH = 3
    return cfg


def _drive_train(m, cfg):
    rs = np.random.RandomState(0)
    meter = m.TrainMeter(5, cfg)
    for epoch in range(2):
        meter.iter_tic()
        for it in range(5):
            meter.data_toc()
            top = (None, None) if epoch else tuple(rs.rand(2) * 100)
            meter.update_stats(*top, float(rs.rand() * 5), 1e-3 * it, 4)
            meter.iter_toc()
            meter.log_iter_stats(epoch, it)
            meter.iter_tic()
        meter.log_epoch_stats(epoch)
        meter.reset()


def _drive_val(m, cfg):
    rs = np.random.RandomState(1)
    meter = m.ValMeter(3, cfg)
    for epoch in range(2):
        meter.reset()
        meter.iter_tic()
        for it in range(3):
            meter.update_stats(*(rs.rand(2) * 100), 8 - it)
            meter.update_predictions(rs.rand(2, 5), rs.randint(0, 5, 2))
            meter.iter_toc()
            meter.log_iter_stats(epoch, it)
        meter.log_epoch_stats(epoch)


def _drive_epic_val(m, cfg):
    rs = np.random.RandomState(2)
    meter = m.EPICValMeter(3, cfg)
    best = []
    for epoch in range(3):
        meter.reset()
        for it in range(3):
            meter.update_stats(tuple(rs.rand(3) * 100),
                               tuple(rs.rand(3) * 100), 8 - it)
            meter.log_iter_stats(epoch, it)
        best.append(meter.log_epoch_stats(epoch))
    m.logging.log_json_stats({"best": str(best),
                              "max_top1_acc": str(meter.max_top1_acc)})


@pytest.mark.parametrize("drive", [_drive_train, _drive_val, _drive_epic_val])
def test_meters_log_the_json_lines_of_jax(monkeypatch, drive):
    """``TrainMeter`` (with and without top-k errors), ``ValMeter`` and
    ``EPICValMeter`` (its best-epoch flags too) on one sequence of updates
    give JAX's json lines, timers included."""
    cfg = _meter_cfg()
    want = _json_lines(monkeypatch, jax_meters,
                       lambda m: drive(m, jax_cfg_like(cfg)))
    got = _json_lines(monkeypatch, meters, lambda m: drive(m, cfg))
    assert got == want and len(got) >= 4


def test_scalar_meter_and_epoch_timer():
    a, b = meters.ScalarMeter(3), jax_meters.ScalarMeter(3)
    for v in (5.0, 1.0, 4.0, 2.0):
        a.add_value(v)
        b.add_value(v)
    for name in ("get_win_median", "get_win_avg", "get_global_avg"):
        assert getattr(a, name)() == getattr(b, name)()
    timer = meters.EpochTimer()
    for _ in range(2):
        timer.epoch_tic()
        timer.epoch_toc()
    assert len(timer.epoch_times) == 2
    assert timer.avg_epoch_time() >= 0 and timer.last_epoch_time() >= 0


@pytest.mark.parametrize("yaml", ["SSv2_ORViT-MF_224_16x4.yaml",
                                  "EK_ORVIT_MF_HR.yaml"])
def test_eval_and_checkpoint_epochs_match_jax(yaml):
    """``is_eval_epoch`` and ``is_checkpoint_epoch`` over every epoch of
    the yaml (and under a multigrid schedule), as JAX's."""
    from focus_tpu.utils import checkpoint as jcu
    from focus_tpu.utils import misc as jmisc
    from focus_tpu_torch.utils import misc

    cfg = load_config(parse_args(
        ["--cfg", os.path.join(REPO, "configs", "ORViT", yaml)]))
    jcfg = jax_cfg_like(cfg)
    schedule = [[0, 0, 0, 6], [0, 0, 0, 20], [0, 0, 0, cfg.SOLVER.MAX_EPOCH]]
    for sched in (None, schedule):
        for fn, jfn in ((misc.is_eval_epoch, jmisc.is_eval_epoch),
                        (cu.is_checkpoint_epoch, jcu.is_checkpoint_epoch)):
            got = [fn(cfg, e, sched) for e in range(cfg.SOLVER.MAX_EPOCH)]
            assert got == [jfn(jcfg, e, sched)
                           for e in range(cfg.SOLVER.MAX_EPOCH)]
    assert misc.get_num_classes(cfg) == jmisc.get_num_classes(jcfg)


# ---- mixup ---------------------------------------------------------------------

def _jax_draws(key, cfg, H, W):
    """``_device_mixup``'s draws from ``key``, recomputed step by step."""
    k_lam, k_use, k_switch, k_box = jax.random.split(key, 4)
    m = cfg.MIXUP
    use_mix = jax.random.uniform(k_use) < m.PROB
    use_cutmix = m.CUTMIX_ALPHA > 0.0 and bool(
        m.ALPHA <= 0.0 or jax.random.uniform(k_switch) < m.SWITCH_PROB)
    a_mix, a_cut = max(m.ALPHA, 1e-8), max(m.CUTMIX_ALPHA, 1e-8)
    lam = jax.random.beta(k_lam, a_cut, a_cut) if use_cutmix else \
        jax.random.beta(k_lam, a_mix, a_mix)
    lam = lam if bool(use_mix) else jnp.float32(1.0)
    cy = jax.random.randint(k_box, (), 0, H)
    cx = jax.random.randint(jax.random.fold_in(k_box, 1), (), 0, W)
    return {"use_mix": torch.tensor(bool(use_mix)),
            "use_cutmix": torch.tensor(use_cutmix),
            "lam": torch.tensor(float(lam), dtype=torch.float32),
            "cy": torch.tensor(int(cy)), "cx": torch.tensor(int(cx))}


@pytest.mark.parametrize("seed,alpha,prob", [
    (0, 0.8, 1.0), (1, 0.8, 1.0), (6, 0.8, 1.0), (8, 0.8, 1.0),
    (3, 0.0, 1.0), (4, 0.8, 0.0)])
def test_mixup_applies_jax_draws(seed, alpha, prob):
    """The port's ``apply_mixup`` on the draws JAX's ``_device_mixup``
    makes from one key gives its video and soft labels (1e-6); the seeds
    cover mixup (0, 1), CutMix (6, 8; ALPHA 0 forces it) and no mix (PROB
    0)."""
    from focus_tpu.engine.trainer import _device_mixup
    from focus_tpu_torch.engine.trainer import apply_mixup, sample_mixup

    cfg = train_cfg(tiny=True)
    cfg.MIXUP.ENABLE = True
    cfg.MIXUP.ALPHA, cfg.MIXUP.PROB = alpha, prob
    cfg.MODEL.NUM_CLASSES = 7
    rs = np.random.RandomState(seed)
    video = rs.randn(4, 2, 24, 20, 3).astype(np.float32)
    labels = rs.randint(0, 7, (4,)).astype(np.int32)
    key = jax.random.PRNGKey(seed)
    jcfg = jax_cfg_like(cfg)
    want_v, want_y = _device_mixup(key, jnp.asarray(video),
                                   jnp.asarray(labels), jcfg)
    draws = _jax_draws(key, jcfg, 24, 20)
    got_v, got_y = apply_mixup(torch.from_numpy(video),
                               torch.from_numpy(labels), cfg, draws)
    np.testing.assert_allclose(got_v.numpy(), np.asarray(want_v), rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(got_y.numpy(), np.asarray(want_y), rtol=0,
                               atol=1e-6)
    # the port's own draws: in range, and fixed by the generator's seed
    gen = torch.Generator().manual_seed(seed)
    ours = sample_mixup(cfg, gen, video.shape, "cpu")
    again = sample_mixup(cfg, torch.Generator().manual_seed(seed),
                         video.shape, "cpu")
    assert all(torch.equal(ours[k], again[k]) for k in ours)
    assert 0.0 <= float(ours["lam"]) <= 1.0
    assert 0 <= int(ours["cy"]) < 24 and 0 <= int(ours["cx"]) < 20


def test_beta_draws_follow_the_distribution():
    """The device Beta sampler (Marsaglia-Tsang gammas) against the moments
    of Beta(a, a): mean 1/2, variance 1 / (4 (2a + 1)), over 2000 draws."""
    from focus_tpu_torch.engine.trainer import _beta

    gen = torch.Generator().manual_seed(0)
    for a in (0.8, 1.0):
        x = torch.stack([_beta(a, gen, "cpu") for _ in range(2000)]).double()
        assert abs(x.mean().item() - 0.5) < 0.02
        assert abs(x.var().item() - 1 / (4 * (2 * a + 1))) < 0.01
        assert bool(((x >= 0) & (x <= 1)).all())


# ---- train against the JAX package's train -----------------------------------

def _recording_jax_meters(monkeypatch, rec):
    """JAX's train, val and EPIC-Kitchens val meters, recording each logged
    loss and each validation's means into ``rec``."""
    import focus_tpu.engine.trainer as jtrainer

    class TrainMeter(jax_meters.TrainMeter):
        def update_stats(self, top1_err, top5_err, loss, lr, mb_size):
            rec["losses"].append(loss)
            super().update_stats(top1_err, top5_err, loss, lr, mb_size)

    class ValMeter(jax_meters.ValMeter):
        def log_epoch_stats(self, cur_epoch):
            n = max(self.num_samples, 1)
            rec["val"].append({"epoch": cur_epoch + 1,
                               "top1_err": self.num_top1_mis / n,
                               "top5_err": self.num_top5_mis / n})
            return super().log_epoch_stats(cur_epoch)

    class EPICValMeter(jax_meters.EPICValMeter):
        def log_epoch_stats(self, cur_epoch):
            n = max(self.num_samples, 1)
            rec["val"].append({"epoch": cur_epoch + 1,
                               **{k: v / n for k, v in self.totals.items()}})
            return super().log_epoch_stats(cur_epoch)

    monkeypatch.setattr(jtrainer, "TrainMeter", TrainMeter)
    monkeypatch.setattr(jtrainer, "ValMeter", ValMeter)
    monkeypatch.setattr(jax_meters, "EPICValMeter", EPICValMeter)


def run_both(cfg, tmp_path, monkeypatch):
    """The JAX package's ``train`` and the port's ``run_train`` on ``cfg``,
    both from one ``.pyth`` the port writes (a model of seed 11) through
    TRAIN.CHECKPOINT_FILE_PATH; returns (port run, JAX record, JAX params
    by torch name)."""
    import focus_tpu.engine.trainer as jtrainer
    from focus_tpu_torch.engine import trainer

    cfg.TRAIN.CHECKPOINT_FILE_PATH = cu.save_checkpoint(
        str(tmp_path / "init"), build_model(cfg, device="cpu", seed=11), 0,
        cfg, name="init")
    cfg.OUTPUT_DIR = str(tmp_path / "port")
    run = trainer.run_train(cfg, device="cpu")
    rec = {"losses": [], "val": []}
    _recording_jax_meters(monkeypatch, rec)

    def template(model, cfg_, sample, rng=None, **kwargs):
        """The variables' shapes, zero, without the init's compile: the
        ``.pyth`` loads every tensor over them."""
        keys = {"params": jax.random.PRNGKey(0),
                "dropout": jax.random.PRNGKey(1)}
        shapes = jax.eval_shape(lambda: model.init(keys, *sample, **kwargs))
        return jax.tree_util.tree_map(lambda v: jnp.zeros(v.shape, v.dtype),
                                      shapes)

    monkeypatch.setattr(jtrainer, "init_model", template)
    jcfg = jax_cfg_like(cfg)
    jcfg.OUTPUT_DIR = str(tmp_path / "jax")
    state = jtrainer.train(jcfg)
    return run, rec, jax_params_to_state_dict(jax.device_get(state.params))


def _mf_cfg(*opts):
    return assert_and_infer_cfg(load_config(parse_args(
        ["--cfg", MF_YAML, "SOLVER.MAX_EPOCH", "2", "LOG_PERIOD", "1",
         "MF.DROP_PATH", "0.0", "DATA_LOADER.NUM_WORKERS", "2", *opts])))


def test_train_matches_jax_on_mf_synthetic(tmp_path, monkeypatch):
    """``configs/tests/mf_synthetic.yaml`` (Motionformer D=24, 2 layers,
    float32, AdamW with a global-norm clip, cosine LR), 2 epochs of 8 steps
    with validation and a checkpoint after each: JAX's per-iteration
    losses (1e-5), its val top-1 / top-5 errors and its parameters after
    the last step (1e-5)."""
    cfg = _mf_cfg()
    run, rec, want = run_both(cfg, tmp_path, monkeypatch)
    losses = [x for epoch in run.losses for x in epoch]
    assert len(losses) == len(rec["losses"]) == 16 and run.steps == 16
    np.testing.assert_allclose(losses, rec["losses"], rtol=0, atol=1e-5)
    assert run.val_stats == rec["val"] and len(run.val_stats) == 2
    assert run.checkpoint["kind"] == "weights"
    assert run.checkpoint["missing"] == []
    for name, p in run.state.model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(),
                                   rtol=0, atol=1e-5, err_msg=name)
    assert len(run.checkpoint_seconds) == 2 and run.val_clips == 32
    assert cu.get_last_checkpoint(cfg.OUTPUT_DIR).endswith("00002.pyth")


class _SeededRandomState(np.random.RandomState):
    """``RandomState(None)`` seeded: the datasets' train mode draws from an
    unseeded generator, as the JAX package's do."""

    def __init__(self, seed=None):
        super().__init__(1234 if seed is None else seed)


def ek_train_tree(root):
    """An EPIC-Kitchens tree with a train list of 4 records (each of the
    two twice) and a val list of 3 (a pad row at batch 2)."""
    import pandas as pd

    ann, name, visual = make_ek_tree(root)
    df = pd.read_pickle(os.path.join(ann, name))
    df.iloc[[0, 1, 1, 0]].to_pickle(os.path.join(ann, "train.pkl"))
    df.iloc[[1, 0, 1]].to_pickle(os.path.join(ann, "val.pkl"))
    return ann, visual


def test_train_matches_jax_on_hr_epic_kitchens(tmp_path, monkeypatch):
    """The tiny HR-336 EK model (``hr_train_cfg(tiny=True)``: 6 x 6 patches
    of 56 px at the 336 crop, 4 frames, so 4 boxes a clip strided 2 to the
    2 temporal positions; EK_loss, the yaml's AdamW) on an EPIC-Kitchens
    tree, 1 epoch of 2 steps at batch 2 and validation on 3 clips (one
    pad row), with MIXUP.ENABLE set, which both packages skip on
    EPIC-Kitchens: JAX's losses (1e-5) and EPICValMeter stats. The
    datasets' train-mode generator is seeded in both."""
    import focus_tpu.native

    monkeypatch.setattr(focus_tpu.native, "available", lambda: False)
    monkeypatch.setattr(np.random, "RandomState", _SeededRandomState)
    ann, visual = ek_train_tree(str(tmp_path / "ek"))
    cfg = hr_train_cfg(tiny=True)
    cfg.EPICKITCHENS.ANNOTATIONS_DIR = ann
    cfg.EPICKITCHENS.VISUAL_DATA_DIR = visual
    cfg.EPICKITCHENS.TRAIN_LIST, cfg.EPICKITCHENS.VAL_LIST = "train.pkl", \
        "val.pkl"
    cfg.DATA.TRAIN_JITTER_SCALES = [384, 480]
    cfg.MF.DROP_PATH = 0.0
    cfg.MIXUP.ENABLE = True
    cfg.MODEL.ARCH = "slow"
    cfg.NUM_GPUS = 1
    cfg.TRAIN.BATCH_SIZE = 2
    cfg.SOLVER.MAX_EPOCH = 1
    cfg.LOG_PERIOD = 1
    cfg.TENSORBOARD.ENABLE = False
    cfg.DATA_LOADER.NUM_WORKERS = 2
    run, rec, _ = run_both(cfg, tmp_path, monkeypatch)
    np.testing.assert_allclose(run.losses[0], rec["losses"], rtol=0,
                               atol=1e-5)
    assert len(run.losses[0]) == 2
    assert run.val_stats == rec["val"] and run.val_clips == 3
    assert sorted(run.val_stats[0]) == sorted(
        ["epoch"] + [f"{h}_top{k}" for h in ("verb", "noun", "action")
                     for k in (1, 5)])


# ---- GRAD_ACCUM ----------------------------------------------------------------

def _tiny_flagship_batches(cfg, n=3, batch=4):
    rs = np.random.RandomState(7)
    T, crop = cfg.DATA.NUM_FRAMES, cfg.DATA.TRAIN_CROP_SIZE
    out = []
    for _ in range(n):
        video = rs.rand(batch, T, crop, crop, 3).astype(np.float32)
        boxes = (rs.rand(batch, T, cfg.ORVIT.O, 4) * 0.5 + 0.25).astype(
            np.float32)
        labels = rs.randint(0, cfg.MODEL.NUM_CLASSES, (batch,)).astype(
            np.int32)
        out.append((video, labels, boxes))
    return out


def test_grad_accum_matches_jax_and_the_single_shot_step():
    """TPU.GRAD_ACCUM 2 on the tiny flagship (``train_cfg(tiny=True)``,
    float32, AdamW), 3 steps of 4 clips (microbatches of rows 0, 2 and
    1, 3; 16-step boxes, strided 2 by ORViT) from the JAX model's params:
    the loss and top-k errors of every step against JAX's
    ``train_step_accum`` (1e-5) and the parameters after the third; the
    same 3 steps in one shot (GRAD_ACCUM 1) give the same losses and
    parameters. Parameters within 1e-5, but for the elements whose
    gradient is zero but for rounding (the k biases, whose exact gradient
    vanishes in the softmax): Adam scales each element by its own
    magnitude, so those may step apart by up to the LR; at most 1 in 10^4
    elements (measured 1 of ~450k at LR 1e-3), none by more than the three
    LRs' sum."""
    from focus_tpu.engine.trainer import _no_wd_paths
    from focus_tpu.engine.trainer import make_supervised_train_step as jmake
    from focus_tpu.models import losses as jlosses
    from focus_tpu.models import optimizer as joptim
    from focus_tpu.models.build import build_model as jax_build_model
    from focus_tpu.parallel import mesh as mesh_lib
    from focus_tpu.parallel.train_state import TrainState
    from focus_tpu.utils.torch_import import import_torch_params
    from focus_tpu_torch.engine.trainer import (
        build_supervised_state,
        make_supervised_train_step,
    )
    from focus_tpu_torch.models.losses import get_loss_func
    from focus_tpu_torch.utils.weights import load_jax_params

    cfg = train_cfg(tiny=True)
    cfg.NUM_GPUS = 1
    cfg.SOLVER.BASE_LR = 1e-3
    cfg.TPU.GRAD_ACCUM = 2
    jcfg = jax_cfg_like(cfg)
    batches = _tiny_flagship_batches(cfg)
    video, labels, boxes = batches[0]
    jmodel = jax_build_model(jcfg)
    # the port's seeded init as JAX's params, carried onto their
    # eval_shape by the JAX package's importer (no init compile)
    shapes = jax.eval_shape(lambda: jmodel.init(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(0)},
        jnp.asarray(video), {"orvit_bboxes": jnp.asarray(boxes)}))["params"]
    params, _ = import_torch_params(
        {k: v.numpy() for k, v in build_model(cfg, device="cpu", seed=0)
         .state_dict().items()},
        jax.tree_util.tree_map(lambda a: np.zeros(a.shape, a.dtype), shapes),
        allow_missing=False)
    spe = 2
    tx = joptim.construct_optimizer(params, jcfg, spe,
                                    no_weight_decay_paths=_no_wd_paths(jcfg))
    mesh = mesh_lib.build_mesh(jcfg)
    # placed as the step places its output state, so that the later steps
    # reuse the first one's compile
    jstate = jax.device_put(TrainState.create(params, tx),
                            mesh_lib.replicated(mesh))
    jstep = jmake(jmodel, jcfg, mesh, jlosses.get_loss_func(jcfg))

    runs = {}
    for accum in (2, 1):
        cfg.TPU.GRAD_ACCUM = accum
        model = build_model(cfg, device="cpu")
        load_jax_params(model, params)
        state = build_supervised_state(cfg, model, spe)
        step = make_supervised_train_step(model, cfg, get_loss_func(cfg))
        stats = []
        for video, labels, boxes in batches:
            state, s = step(state, torch.from_numpy(video),
                            torch.from_numpy(labels).long(),
                            {"orvit_bboxes": torch.from_numpy(boxes)})
            stats.append({k: v.item() for k, v in s.items()})
        runs[accum] = (stats, {n: p.detach().clone()
                               for n, p in model.named_parameters()})
    jstats = []
    for video, labels, boxes in batches:
        jstate, s = jstep(jstate, jnp.asarray(video), jnp.asarray(labels),
                          {"orvit_bboxes": jnp.asarray(boxes)},
                          jax.random.PRNGKey(0))
        jstats.append({k: float(v) for k, v in s.items()})
    want = jax_params_to_state_dict(jax.device_get(jstate.params))
    got, got_params = runs[2]
    assert sorted(got[0]) == sorted(jstats[0]) == ["loss", "top1_err",
                                                   "top5_err"]
    for g, j, one in zip(got, jstats, runs[1][0]):
        assert g["loss"] == pytest.approx(j["loss"], abs=1e-5)
        assert g["loss"] == pytest.approx(one["loss"], abs=1e-5)
        for k in ("top1_err", "top5_err"):  # the mean over microbatches
            assert g[k] == pytest.approx(j[k], abs=1e-4)
    lr_sum = sum(state.optimizer.schedules[0](k) for k in range(3))
    for ref in (want, runs[1][1]):
        off = total = 0
        for name, p in got_params.items():
            diff = np.abs(p.numpy() - ref[name].numpy())
            off, total = off + int((diff > 1e-5).sum()), total + diff.size
            assert diff.max() <= lr_sum, name
        assert off <= total // 10000


# ---- checkpoints: round trip, resume, preemption, async writes -------------------

def _mf_state(cfg, seed=0):
    from focus_tpu_torch.engine.trainer import build_supervised_state

    model = build_model(cfg, device="cpu", seed=seed)
    return build_supervised_state(cfg, model, 8)


def _two_steps(cfg, state):
    from focus_tpu_torch.engine.trainer import make_supervised_train_step
    from focus_tpu_torch.models.losses import get_loss_func

    step = make_supervised_train_step(state.model, cfg, get_loss_func(cfg))
    rs = np.random.RandomState(0)
    for _ in range(2):
        video = torch.from_numpy(rs.rand(2, 4, 32, 32, 3).astype(np.float32))
        labels = torch.from_numpy(rs.randint(0, 16, (2,)))
        state, _ = step(state, video, labels, {})
    torch.rand(3, generator=state.generator)  # move the generator on
    return state


def _optimizer_tensors(state):
    sd = state.optimizer.optimizer.state_dict()
    return [(i, k, v) for i, s in sorted(sd["state"].items())
            for k, v in sorted(s.items())]


def test_train_state_round_trip_is_bit_equal(tmp_path):
    """A train checkpoint holds the reference's ``.pyth`` layout plus the
    port's step and generator state; loading it into a state built from
    other weights restores the weights, AdamW's moments and step counts,
    the step and the generator bit for bit; the test path reads its
    weights."""
    cfg = _mf_cfg("OUTPUT_DIR", str(tmp_path))
    state = _two_steps(cfg, _mf_state(cfg))
    path = cu.save_checkpoint(str(tmp_path), state, 3, cfg)
    payload = torch.load(path, weights_only=False)
    assert sorted(payload) == ["cfg", "epoch", "generator_state",
                               "model_state", "optimizer_state", "step"]
    assert payload["epoch"] == 3 and payload["step"] == 2
    fresh = _mf_state(cfg, seed=5)
    assert cu.load_train_state(path, fresh) == 3
    for (k, a), (_, b) in zip(state.model.state_dict().items(),
                              fresh.model.state_dict().items()):
        assert torch.equal(a, b), k
    got, want = _optimizer_tensors(fresh), _optimizer_tensors(state)
    assert len(got) == len(want) > 0
    for (i, k, a), (j, l, b) in zip(got, want):
        assert (i, k) == (j, l) and torch.equal(a, b), (i, k)
    assert fresh.step == 2
    assert torch.equal(fresh.generator.get_state(), state.generator.get_state())
    tested = build_model(cfg, device="cpu", seed=9)
    report = cu.load_test_checkpoint(cfg, tested)
    assert report["path"] == path and report["missing"] == []
    for k, v in tested.state_dict().items():
        assert torch.equal(v, state.model.state_dict()[k]), k
    with pytest.raises(ValueError, match="no train state"):
        cu.load_train_state(cu.save_checkpoint(str(tmp_path), state.model, 4,
                                               cfg), fresh)
    made = cu.make_checkpoint_dir(str(tmp_path), "exp")
    assert made == os.path.join(str(tmp_path), "exp", "checkpoints")
    assert os.path.isdir(made)


def test_resumed_run_equals_the_uninterrupted_one(tmp_path):
    """mf_synthetic, 2 epochs, then a second job given the first's epoch-1
    checkpoint under TRAIN.AUTO_RESUME: it starts at epoch 1 and ends with
    the first job's parameters, step and epoch-2 losses, bit-equal."""
    import shutil

    from focus_tpu_torch.engine import trainer

    whole = trainer.run_train(_mf_cfg("OUTPUT_DIR", str(tmp_path / "a")),
                              device="cpu")
    job = tmp_path / "b" / "checkpoints"
    job.mkdir(parents=True)
    shutil.copy(cu.get_path_to_checkpoint(str(tmp_path / "a"), 1), job)
    resumed = trainer.run_train(
        _mf_cfg("OUTPUT_DIR", str(tmp_path / "b"), "TRAIN.AUTO_RESUME",
                "True"), device="cpu")
    assert resumed.start_epoch == 1 and resumed.checkpoint["kind"] == "resume"
    assert resumed.losses == whole.losses[1:]
    assert resumed.state.step == whole.state.step == 16
    for (k, a), (_, b) in zip(whole.state.model.state_dict().items(),
                              resumed.state.model.state_dict().items()):
        assert torch.equal(a, b), k


def test_sigterm_sets_the_flag(monkeypatch):
    import signal

    previous = signal.getsignal(signal.SIGTERM)
    monkeypatch.setattr(preemption, "_INSTALLED", False)
    try:
        assert preemption.install_signal_handlers()
        assert not preemption.preemption_requested()
        os.kill(os.getpid(), signal.SIGTERM)
        assert preemption.preemption_requested()
    finally:
        signal.signal(signal.SIGTERM, previous)


@pytest.mark.parametrize("enabled", [True, False])
def test_guard_polls_on_its_period(enabled):
    cfg = train_cfg(tiny=True)
    cfg.TPU.PREEMPT_SYNC_PERIOD = 5
    cfg.TPU.PREEMPTION_SAVE = enabled
    guard = preemption.PreemptionGuard(cfg)
    preemption.request_preemption()
    want = [False] * 4 + [enabled] + [False] * 4 + [enabled]
    assert [guard.poll(i) for i in range(10)] == want


def test_train_preempt_saves_and_resumes(tmp_path):
    """A preemption flag set before the run (a SIGTERM landing mid-epoch)
    makes ``train`` save the in-progress epoch at the sync point (step 3
    of epoch 0 at PREEMPT_SYNC_PERIOD 3) and exit 0; the next ``train``
    resumes it under AUTO_RESUME, replays epoch 0 with the step carried,
    and runs to the end."""
    from focus_tpu_torch.engine import trainer

    cfg = _mf_cfg("OUTPUT_DIR", str(tmp_path), "TRAIN.AUTO_RESUME", "True",
                  "TPU.PREEMPT_SYNC_PERIOD", "3")
    preemption.request_preemption()
    with pytest.raises(SystemExit) as e:
        trainer.train(cfg, device="cpu")
    assert e.value.code == 0
    last = cu.get_last_checkpoint(str(tmp_path))
    assert os.path.basename(last) == "checkpoint_epoch_00000.pyth"
    payload = torch.load(last, weights_only=False)
    assert payload["epoch"] == 0 and payload["step"] == 3
    preemption.clear_preemption()
    run = trainer.run_train(cfg, device="cpu")
    assert run.start_epoch == 0 and [len(x) for x in run.losses] == [8, 8]
    assert run.state.step == 3 + 16


def _state_payload(value):
    cfg = train_cfg(tiny=True)
    model = torch.nn.Linear(4, 2)
    torch.nn.init.constant_(model.weight, value)
    return cfg, model


def test_async_saves_stay_ordered_and_loads_wait(tmp_path):
    """TPU.ASYNC_CHECKPOINT: five writes to one path land in order (the
    last wins), a read waits for the writes in flight, the default is a
    synchronous write that leaves nothing pending."""
    cfg, _ = _state_payload(0.0)
    assert cfg.TPU.ASYNC_CHECKPOINT is False
    for i in range(5):
        cfg, model = _state_payload(float(i))
        path = cu.save_checkpoint(str(tmp_path), model, i, cfg,
                                  name="checkpoint", async_write=True)
    sd = cu.load_state_dict_file(path)  # no explicit wait
    assert torch.equal(sd["weight"], torch.full((2, 4), 4.0))
    assert not cu._PENDING_SAVES
    cfg.TPU.ASYNC_CHECKPOINT = True
    path = cu.save_checkpoint(str(tmp_path), model, 7, cfg)
    cu.wait_for_saves()
    assert torch.load(path, weights_only=False)["epoch"] == 7
    cfg.TPU.ASYNC_CHECKPOINT = False
    path = cu.save_checkpoint(str(tmp_path), model, 8, cfg)
    assert os.path.exists(path) and not cu._PENDING_SAVES


@pytest.mark.parametrize("case", ["auto_resume", "auto_resume_empty",
                                  "no_auto_resume", "train_state_reset",
                                  "nothing", "missing"])
def test_load_train_checkpoint_chooses_as_jax(tmp_path, monkeypatch, case):
    """The start of a run: the same file and start epoch as JAX's
    ``load_train_checkpoint`` on the same files (its readers stood in for:
    the port's files are torch archives, which JAX reads as weights). A
    missing TRAIN.CHECKPOINT_FILE_PATH raises in both."""
    import focus_tpu.utils.checkpoint as jcu
    import focus_tpu.utils.torch_import as jax_import

    cfg = _mf_cfg("OUTPUT_DIR", str(tmp_path / "out"))
    state = _mf_state(cfg)
    weights = cu.save_checkpoint(str(tmp_path / "w"), state.model, 0, cfg)
    if case in ("auto_resume", "no_auto_resume"):
        cu.save_checkpoint(cfg.OUTPUT_DIR, state, 1, cfg)
        cu.save_checkpoint(cfg.OUTPUT_DIR, state, 2, cfg)
    cfg.TRAIN.AUTO_RESUME = case.startswith("auto_resume")
    cfg.TRAIN.CHECKPOINT_FILE_PATH = {
        "train_state_reset": cu.save_checkpoint(str(tmp_path / "s"), state,
                                                3, cfg),
        "nothing": "", "missing": str(tmp_path / "none.pyth"),
    }.get(case, weights)
    cfg.TRAIN.CHECKPOINT_EPOCH_RESET = True
    jcfg = jax_cfg_like(cfg)
    if case == "missing":
        with pytest.raises(FileNotFoundError):
            cu.load_train_checkpoint(cfg, state)
        with pytest.raises(FileNotFoundError):
            jcu.load_train_checkpoint(jcfg, "template")
        return
    seen = []

    def jax_load(path, template):
        seen.append(path)
        return template, torch.load(path, weights_only=False)["epoch"]

    monkeypatch.setattr(jcu, "load_checkpoint", jax_load)
    monkeypatch.setattr(jax_import, "load_into_state",
                        lambda path, s, c, **kw: seen.append(path) or s)
    _, jepoch = jcu.load_train_checkpoint(jcfg, "template")
    epoch, report = cu.load_train_checkpoint(cfg, state)
    assert epoch == jepoch
    assert ([report["path"]] if report else []) == seen
    assert epoch == (2 if case == "auto_resume" else 0)


# ---- the CLI ---------------------------------------------------------------------

def test_cli_trains_then_tests(tmp_path):
    """``run_net`` trains mf_synthetic on the CPU (a checkpoint an epoch),
    then tests the last checkpoint; ``train_net`` trains alone; without
    ``--device cpu`` and without a card it raises."""
    from focus_tpu_torch.tools import run_net, train_net

    args = ["--device", "cpu", "--cfg", MF_YAML, "OUTPUT_DIR",
            str(tmp_path / "a")]
    stats = run_net.main(args)
    assert sorted(stats) == ["split", "top1_acc", "top5_acc"]
    assert os.path.basename(cu.get_last_checkpoint(str(tmp_path / "a"))) == \
        "checkpoint_epoch_00001.pyth"
    state = train_net.main(args[:-1] + [str(tmp_path / "b")])
    assert state.step == 8
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            train_net.main(args[2:])


@pytest.mark.parametrize("opts,error,match", [
    (["TRAIN.METHOD", "slots"], ValueError, "slot model"),
    (["TRAIN.DATASET", "epickitchens"], ValueError, "EK_loss"),
    (["TPU.MESH.SEQ", "4"], ValueError, "does not divide MF.TEMPORAL"),
    (["LOG_MODEL_INFO", "True"], NotImplementedError, "LOG_MODEL_INFO"),
    (["TPU.MESH.MODEL", "2"], ValueError, "not divisible by model axis 2"),
])
def test_cli_refuses_what_the_port_does_not_train(tmp_path, opts, error,
                                                  match):
    """Raised before anything is built: slot-model training of a model
    that is not STEVE, EPIC-Kitchens under a loss other than EK_loss (the
    EK yaml's label_smoothing_cross_entropy fails in JAX on the dict
    labels), the options not yet ported, a seq axis that does not divide
    the frames and a model axis that one process cannot hold (the JAX
    package's divisibility refusal)."""
    from focus_tpu_torch.tools import run_net

    args = ["--device", "cpu", "--cfg", MF_YAML, "OUTPUT_DIR", str(tmp_path)]
    with pytest.raises(error, match=match):
        run_net.main(args + opts)
    assert not os.path.exists(os.path.join(str(tmp_path), "checkpoints"))


def test_cli_refuses_the_ek_yamls_loss(tmp_path):
    """The EK yaml sets neither TRAIN.METHOD nor TEST.EVAL_TASK, whose
    defaults are the slot models' (so ``TRAIN.METHOD sup TEST.EVAL_TASK
    ar`` are needed, as in JAX); under them its
    label_smoothing_cross_entropy raises, naming EK_loss."""
    from focus_tpu_torch.tools import run_net

    yaml = os.path.join(REPO, "configs", "ORViT", "EK_ORVIT_MF_HR.yaml")
    args = ["--device", "cpu", "--cfg", yaml, "OUTPUT_DIR", str(tmp_path)]
    with pytest.raises(ValueError, match="slot model"):
        run_net.main(args)
    with pytest.raises(ValueError, match="label_smoothing_cross_entropy.*"
                                         "EK_loss"):
        run_net.main(args + ["TRAIN.METHOD", "sup", "TEST.EVAL_TASK", "ar"])


def test_profiler_traces_its_step_window(tmp_path):
    """TPU.PROFILER traces steps [PROFILER_START_STEP, + NUM_STEPS) into a
    Chrome trace under OUTPUT_DIR/profiler, and does nothing when off."""
    from focus_tpu_torch.utils.profiler import StepProfiler

    cfg = train_cfg(tiny=True)
    cfg.OUTPUT_DIR = str(tmp_path)
    cfg.TPU.PROFILER_START_STEP, cfg.TPU.PROFILER_NUM_STEPS = 1, 2
    off = StepProfiler(cfg)
    cfg.TPU.PROFILER = True
    prof = StepProfiler(cfg)
    x = torch.ones(64, 64)
    for step in range(5):
        off.step(step)
        prof.step(step)
        x = x @ x / 64
    prof.stop()
    assert os.path.isfile(prof.trace_path)
    assert prof.trace_path == os.path.join(str(tmp_path), "profiler",
                                           "trace_step1.json")
    with open(prof.trace_path) as f:
        assert "aten::mm" in f.read()
    assert not off.enabled and off._prof is None


def test_tensorboard_writer_gate_and_panels(tmp_path, monkeypatch):
    """The writer logs scalars where TensorBoard imports, does nothing where
    it does not (or where TENSORBOARD.ENABLE is off), and refuses the eval
    panels."""
    from focus_tpu_torch.visualization import tensorboard_vis as tv

    cfg = train_cfg(tiny=True)
    cfg.OUTPUT_DIR = str(tmp_path)
    cfg.TENSORBOARD.ENABLE = True
    writer = tv.TensorboardWriter(cfg)
    if writer.enabled:
        writer.add_scalars({"Train/loss": 1.5}, global_step=0)
        writer.close()
        assert os.listdir(os.path.join(str(tmp_path), "runs-ssv2"))
    monkeypatch.setattr(tv, "_summary_writer_class", lambda: None)
    off = tv.TensorboardWriter(cfg)
    assert not off.enabled and off.writer is None
    off.add_scalars({"Train/loss": 1.5})
    off.plot_eval(np.zeros((2, 3)), np.zeros(2))
    off.close()
    cfg.TENSORBOARD.HISTOGRAM.ENABLE = True
    with pytest.raises(NotImplementedError, match="HISTOGRAM"):
        tv.TensorboardWriter(cfg)
