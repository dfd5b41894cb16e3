"""Training the port's ResNet video family against the JAX package's on the
CPU: SlowFast's train step (BatchNorm in train mode, SGD with Nesterov
momentum behind weight decay and the global-norm clip, cosine with warm-up,
``TPU.GRAD_ACCUM`` 2) against ``make_supervised_train_step`` (the gradient
read off its first update); precise BN against ``compute_precise_bn_stats``; ``train`` on
slow R50 over ``synthetic_classification`` against
``focus_tpu.engine.trainer.train`` (validation and a checkpoint), and where
the loop runs precise BN; the running statistics through a train checkpoint; mixup over
a pathway list; the multi-view test path on SlowFast's pathways.

The train-mode gradients of these narrow random networks are ill-conditioned
in float32: BatchNorm's statistics over a few values a channel, and its
variance E[x^2] - E[x]^2 (flax's form), leave both packages' float32
gradients up to ~25% per tensor from the same gradient in float64 (measured
on SlowFast at width 8-32, 32-64 px; the port's float32 closer to it than
JAX's), and a few SGD steps carry that into the weights. So the train step
and one precise-BN case compare the two packages in float64, and ``train``
computes in float64 over float32 weights (``TPU.COMPUTE_DTYPE`` patched in
both packages), where the functions agree to rounding: the step's losses,
gradients, running statistics and parameters within 1e-6 relative (1e-6 of
each tensor's largest value; the optimizer's clip norm is taken in
float32); ``train``'s per-iteration losses 1e-5 relative and its
parameters and statistics 1e-5 of each tensor's largest value (float32
weights and gradients). These comparisons leave out the nonlocal block,
whose JAX affinity is float32 whatever the dtype. In float32: precise BN's
statistics within 1e-3 of each buffer's largest value (JAX's own float32
forward lies 2.2e-4 of the largest logit from float64 at these weights, and
it recovers each batch's statistics as (new - 0.9 old) / 0.1, which scales
the rounding by 10). Checkpoints bit-equal (one package, one device); the
test path's summed probabilities 1e-6 from a direct loop (the meter sums
in float64)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from focus_tpu_torch.models.build import build_model
from focus_tpu_torch.utils import checkpoint as cu
from focus_tpu_torch.utils.weights import jax_params_to_state_dict
from torch_port_trees import jax_cfg_like
from test_torch_port_resnet import (
    clips,
    jax_model,
    jax_variables,
    port_of,
    running_stats,
    slow_cfg,
    slowfast_cfg,
)

F64_RTOL = 1e-6
PRECISE_F32_RTOL = 1e-3
LOOP_RTOL = 1e-5


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """These models are small: one intra-op thread runs them as fast as
    many, and beside the other test workers many spin against each other."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def sgd_cfg(cfg, accum=1):
    """The Kinetics ResNet recipe's solver (``SLOWFAST_8x8_R50.yaml``):
    SGD, momentum 0.9, Nesterov, weight decay 1e-4, cosine with a linear
    warm-up from 0.01."""
    cfg.NUM_GPUS = 1
    cfg.MODEL.LOSS_FUNC = "cross_entropy"
    cfg.SOLVER.OPTIMIZING_METHOD = "sgd"
    cfg.SOLVER.BASE_LR = 0.1
    cfg.SOLVER.MOMENTUM = 0.9
    cfg.SOLVER.NESTEROV = True
    cfg.SOLVER.WEIGHT_DECAY = 1e-4
    cfg.SOLVER.LR_POLICY = "cosine"
    cfg.SOLVER.MAX_EPOCH = 4
    cfg.SOLVER.WARMUP_EPOCHS = 1.0
    cfg.SOLVER.WARMUP_START_LR = 0.01
    cfg.TPU.GRAD_ACCUM = accum
    return cfg


def rel_l2(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def assert_tensors_close(got, want, rtol, what, scale=None):
    """Each tensor of ``got`` within ``rtol`` of its reference's largest
    magnitude (or of ``scale``)."""
    assert sorted(got) == sorted(want), what
    bad = {}
    for k in got:
        ref = want[k].to(got[k].dtype)
        err = float((got[k] - ref).abs().max())
        bound = rtol * (scale or float(ref.abs().max()))
        if not err <= bound:
            bad[k] = (err, bound)
    assert not bad, f"{what}: {bad}"


def to_float64(tree):
    return jax.tree_util.tree_map(lambda v: np.asarray(v, np.float64), tree)


def port_float64(cfg, variables):
    model = port_of(cfg, variables).double()
    model.dtype = torch.float64
    return model


def test_slowfast_train_steps_match_jax_under_grad_accum():
    """Two steps of SlowFast R50 (width 8, 8 frames, 32 px, 4 clips in
    microbatches of rows 0, 2 and 1, 3; no nonlocal, whose JAX affinity is
    float32 whatever the dtype) from one set of weights and statistics, in
    float64: each step's loss against JAX's ``train_step_accum``; the first
    step's gradient (the microbatches' mean after the global-norm clip at
    0.05) against the one JAX's first update applied, recovered from it as
    (p0 - p1) / (lr0 (1 + momentum)) - wd p0 (Nesterov's first step, from a
    zero trace; within 1e-6 of the whole gradient's largest element); the
    running statistics after each step (moved once a
    microbatch, in order) and the parameters after the second update."""
    from focus_tpu.engine.trainer import _no_wd_paths
    from focus_tpu.engine.trainer import make_supervised_train_step as jmake
    from focus_tpu.models import losses as jlosses
    from focus_tpu.models import optimizer as joptim
    from focus_tpu.parallel import mesh as mesh_lib
    from focus_tpu.parallel.train_state import TrainState
    from focus_tpu_torch.engine.trainer import (
        build_supervised_state,
        make_supervised_train_step,
    )
    from focus_tpu_torch.models.losses import get_loss_func

    cfg = sgd_cfg(slowfast_cfg(crop=32, classes=7), accum=2)
    cfg.NONLOCAL.LOCATION = [[[], []]] * 4
    assert cfg.SOLVER.CLIP_GRAD_L2NORM == 0.05  # the defaults' clip
    jcfg = jax_cfg_like(cfg)
    batches = []
    for seed in (5, 6):
        xs = clips(cfg, batch=4, seed=seed)
        labels = np.random.RandomState(seed).randint(0, 7, 4).astype(np.int32)
        batches.append((xs, labels))
    jmodel = jax_model(cfg)
    variables = to_float64(jax_variables(
        jmodel, [jnp.asarray(x) for x in batches[0][0]]))
    spe = 2

    model = port_float64(cfg, variables)
    p0 = {n: p.detach().clone() for n, p in model.named_parameters()}
    state = build_supervised_state(cfg, model, spe)
    step = make_supervised_train_step(model, cfg, get_loss_func(cfg))
    losses, stats_after, grads = [], [], None
    for xs, labels in batches:
        state, s = step(state, [torch.from_numpy(x).double() for x in xs],
                        torch.from_numpy(labels).long(), {})
        losses.append(s["loss"].item())
        stats_after.append(running_stats(model))
        if grads is None:  # clipped in place by the update
            grads = {n: p.grad.clone() for n, p in model.named_parameters()}
    lr0 = state.optimizer.schedules[0](0)

    with jax.enable_x64(True):
        jvars = jax.tree_util.tree_map(jnp.asarray, variables)
        tx = joptim.construct_optimizer(
            jvars["params"], jcfg, spe,
            no_weight_decay_paths=_no_wd_paths(jcfg))
        jstate = TrainState.create(jvars["params"], tx,
                                   batch_stats=jvars["batch_stats"])
        jstep = jmake(jmodel.clone(dtype=jnp.float64), jcfg,
                      mesh_lib.build_mesh(jcfg), jlosses.get_loss_func(jcfg))
        jsteps = []
        for xs, labels in batches:
            jstate, s = jstep(jstate, [jnp.asarray(x, jnp.float64)
                                       for x in xs],
                              jnp.asarray(labels), {}, jax.random.PRNGKey(0))
            # on the host and back: the step's output state would compile
            # the step a second time (and the step donates its input)
            host = jax.device_get(jstate)
            jstate = jax.tree_util.tree_map(jnp.asarray, host)
            jsteps.append((float(s["loss"]), host))

    def torch64(tree):
        return jax_params_to_state_dict(jax.device_get(tree))

    p1 = torch64(jsteps[0][1].params)
    wd, m = cfg.SOLVER.WEIGHT_DECAY, cfg.SOLVER.MOMENTUM
    want = {n: (p0[n] - p1[n]) / (lr0 * (1 + m)) - wd * p0[n] for n in p0}
    # in units of the whole gradient's largest element: where a tensor's
    # gradient is far below weight decay's share of the update (the fast
    # stem's one-channel BN), the recovery cancels
    assert_tensors_close(grads, want, F64_RTOL, "gradient", scale=max(
        float(g.abs().max()) for g in want.values()))
    for got_loss, got_stats, (loss, jst) in zip(losses, stats_after, jsteps):
        assert got_loss == pytest.approx(loss, rel=F64_RTOL)
        assert_tensors_close(got_stats, torch64(jst.batch_stats), F64_RTOL,
                             "running")
    assert_tensors_close(
        {n: p.detach() for n, p in model.named_parameters()},
        torch64(jsteps[1][1].params), F64_RTOL, "param")


def _precise_batches(cfg, n=3):
    out = []
    for seed in range(n):
        xs = clips(cfg, batch=2, seed=10 + seed)
        out.append((xs[0], np.zeros(2, np.int32), np.arange(2), {}))
    return out


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_precise_bn_matches_jax(dtype):
    """Precise BN over the first 2 of 3 batches of slow R50 (in float32
    with its nonlocal): every running mean and variance against
    ``compute_precise_bn_stats`` (float64 1e-7, float32 1e-3 of each
    buffer's largest value), which differ from the running statistics
    before; a count of 0 leaves them."""
    from focus_tpu.engine.precise_bn import compute_precise_bn_stats as jpbn
    from focus_tpu.engine.trainer import _split_batch
    from focus_tpu.parallel.train_state import TrainState
    from focus_tpu_torch.engine.precise_bn import compute_precise_bn_stats
    from focus_tpu_torch.engine.trainer import split_batch

    import optax

    f64 = dtype == "float64"
    cfg = slow_cfg(width=4, crop=32)
    if f64:  # JAX's nonlocal affinity is float32 whatever the dtype
        cfg.NONLOCAL.LOCATION = [[[]]] * 4
    jmodel = jax_model(cfg)
    batches = _precise_batches(cfg)
    variables = jax_variables(jmodel, [jnp.asarray(batches[0][0])])
    if f64:
        variables = to_float64(variables)
        batches = [(v.astype(np.float64), *rest) for v, *rest in batches]
    model = port_float64(cfg, variables) if f64 else port_of(cfg, variables)
    before = running_stats(model)
    assert compute_precise_bn_stats(model, batches, 0, split_batch, cfg) == 0
    assert all(torch.equal(before[k], v)
               for k, v in running_stats(model).items())
    torch_batches = [tuple(torch.from_numpy(np.asarray(x)) if i < 3 else x
                           for i, x in enumerate(b)) for b in batches]
    assert compute_precise_bn_stats(model, torch_batches, 2, split_batch,
                                    cfg) == 2
    with jax.enable_x64(f64):
        if f64:
            jmodel = jmodel.clone(dtype=jnp.float64)
        jstate = TrainState.create(variables["params"], optax.sgd(0.1),
                                   batch_stats=variables["batch_stats"])
        jbatches = [(jnp.asarray(v), lab, idx, meta)
                    for v, lab, idx, meta in batches]
        want = jax_params_to_state_dict(jax.device_get(jpbn(
            jmodel, jstate, jbatches, 2, _split_batch).batch_stats))
    got = running_stats(model)
    assert_tensors_close(got, want, F64_RTOL if f64 else PRECISE_F32_RTOL,
                         "precise")
    assert not torch.allclose(got["s1.pathway0_stem.bn.running_mean"],
                              before["s1.pathway0_stem.bn.running_mean"])


def _slow_loop_cfg(tmp_path, epochs):
    cfg = sgd_cfg(slow_cfg(width=4, crop=32))
    cfg.NONLOCAL.LOCATION = [[[]]] * 4  # JAX's affinity is float32
    cfg.TRAIN.DATASET = cfg.TEST.DATASET = "synthetic_classification"
    cfg.TRAIN.BATCH_SIZE = cfg.TEST.BATCH_SIZE = 16
    cfg.DATA.TEST_CROP_SIZE = 32
    cfg.SOLVER.MAX_EPOCH = epochs
    cfg.LOG_PERIOD = 1
    cfg.DATA_LOADER.NUM_WORKERS = 2
    cfg.OUTPUT_DIR = str(tmp_path / "port")
    return cfg


def test_train_matches_jax_on_slow_synthetic(tmp_path, monkeypatch):
    """``train`` of slow R50 (width 4, 4 frames, 32 px) on
    ``synthetic_classification`` under the recipe's SGD, an epoch of 4
    steps at batch 16 (the running statistics moved each step), then
    validation on them and a checkpoint, both packages from one ``.pyth``
    (weights and running statistics) that the port writes, computing in
    float64 over float32 weights (``TPU.COMPUTE_DTYPE`` patched to float64
    in both): the per-iteration losses, the val top-1 / top-5 errors, and
    the parameters and running statistics at the end against JAX's
    ``train`` (its state's template from the variables' shapes, which the
    checkpoint fills). Precise BN in the loop is the next test's; its
    statistics are held against JAX in ``test_precise_bn_matches_jax``."""
    import focus_tpu.engine.trainer as jtrainer
    import focus_tpu.models.build as jbuild
    from focus_tpu_torch.engine import trainer
    from focus_tpu_torch.models import build as tbuild
    from test_torch_port_trainer import _recording_jax_meters

    cfg = _slow_loop_cfg(tmp_path, epochs=1)
    init = build_model(cfg, device="cpu", seed=11)
    cfg.TRAIN.CHECKPOINT_FILE_PATH = cu.save_checkpoint(
        str(tmp_path / "init"), init, 0, cfg, name="init")
    monkeypatch.setattr(tbuild, "compute_dtype", lambda c: torch.float64)
    run = trainer.run_train(cfg, device="cpu")
    rec = {"losses": [], "val": []}
    _recording_jax_meters(monkeypatch, rec)
    monkeypatch.setattr(jbuild, "compute_dtype", lambda c: jnp.float64)

    def template(model, cfg_, sample, rng=None, **kwargs):
        """The variables' shapes, zero, without the init's compile: the
        checkpoint loads every tensor over them. The running statistics
        float64 (flax makes them float32 whatever the dtype; the step's
        float64 ones would compile it a second time)."""
        keys = {"params": jax.random.PRNGKey(0),
                "dropout": jax.random.PRNGKey(1)}
        shapes = jax.eval_shape(lambda: model.init(keys, *sample, **kwargs))
        return {k: jax.tree_util.tree_map(lambda v: jnp.zeros(
            v.shape, jnp.float64 if k == "batch_stats" else v.dtype), tree)
            for k, tree in shapes.items()}

    monkeypatch.setattr(jtrainer, "init_model", template)
    jcfg = jax_cfg_like(cfg)
    jcfg.OUTPUT_DIR = str(tmp_path / "jax")
    with jax.enable_x64(True):
        jstate = jax.device_get(jtrainer.train(jcfg))

    losses = [x for epoch in run.losses for x in epoch]
    assert len(losses) == len(rec["losses"]) == 4
    np.testing.assert_allclose(losses, rec["losses"], rtol=LOOP_RTOL)
    assert run.val_stats == rec["val"] and len(run.val_stats) == 1
    assert run.checkpoint["missing"] == []
    assert_tensors_close(
        {n: p.detach() for n, p in run.state.model.named_parameters()},
        jax_params_to_state_dict(jstate.params), LOOP_RTOL, "param")
    assert_tensors_close(running_stats(run.state.model),
                         jax_params_to_state_dict(jstate.batch_stats),
                         LOOP_RTOL, "running")


def test_train_runs_precise_bn_before_checkpoints_and_validation(
        tmp_path, monkeypatch):
    """Under ``BN.USE_PRECISE_STATS``, 3 epochs with a checkpoint every 2nd
    and validation at the 3rd: precise BN runs where the JAX loop runs it,
    after epochs 2 and 3 and not after the first, each time over
    ``NUM_BATCHES_PRECISE`` batches, and the last checkpoint holds the
    precise statistics the model ends with."""
    from focus_tpu_torch.engine import precise_bn, trainer

    cfg = _slow_loop_cfg(tmp_path, epochs=3)
    cfg.TRAIN.BATCH_SIZE = 32
    cfg.TRAIN.CHECKPOINT_PERIOD, cfg.TRAIN.EVAL_PERIOD = 2, 3
    cfg.BN.USE_PRECISE_STATS = True
    cfg.BN.NUM_BATCHES_PRECISE = 2
    calls = []

    def spy(model, loader, num_batches, split_batch_fn, cfg_):
        calls.append((len(calls), precise_bn.compute_precise_bn_stats(
            model, loader, num_batches, split_batch_fn, cfg_)))
        return calls[-1][1]

    epochs = []
    train_epoch = trainer.train_epoch

    def counted_epoch(*args, **kwargs):
        epochs.append(args[4])
        return train_epoch(*args, **kwargs)

    monkeypatch.setattr(trainer, "compute_precise_bn_stats", spy)
    monkeypatch.setattr(trainer, "train_epoch", counted_epoch)
    run = trainer.run_train(cfg, device="cpu")
    assert epochs == [0, 1, 2] and [n for _, n in calls] == [2, 2]
    assert len(run.val_stats) == 1 and len(run.checkpoint_seconds) == 2
    saved = cu.load_state_dict_file(cu.get_last_checkpoint(cfg.OUTPUT_DIR))
    for k, v in running_stats(run.state.model).items():
        assert torch.equal(saved[k], v), k


def test_running_stats_through_the_train_checkpoint(tmp_path):
    """After two SlowFast train steps the running statistics have moved; a
    train checkpoint restores them (and the weights) bit-equal into a
    model of another seed, and the test path's reader loads them into a
    fresh model whose eval forward equals the trained model's."""
    from focus_tpu_torch.engine.trainer import (
        build_supervised_state,
        make_supervised_train_step,
    )
    from focus_tpu_torch.models.losses import get_loss_func

    cfg = sgd_cfg(slowfast_cfg(crop=32, classes=7))
    model = build_model(cfg, device="cpu", seed=1)
    init = running_stats(model)
    state = build_supervised_state(cfg, model, 2)
    step = make_supervised_train_step(model, cfg, get_loss_func(cfg))
    xs = [torch.from_numpy(x) for x in clips(cfg, batch=4)]
    for _ in range(2):
        state, _ = step(state, xs, torch.tensor([0, 1, 2, 3]), {})
    moved = running_stats(model)
    assert not any(torch.equal(moved[k], init[k]) for k in moved
                   if k.endswith("running_var"))
    path = cu.save_checkpoint(str(tmp_path), state, 1, cfg)

    other = build_model(cfg, device="cpu", seed=2)
    other_state = build_supervised_state(cfg, other, 2)
    assert cu.load_train_state(path, other_state) == 1
    assert other_state.step == 2
    for k, v in other.state_dict().items():
        assert torch.equal(v, model.state_dict()[k]), k

    fresh = build_model(cfg, device="cpu", seed=3)
    cfg.TEST.CHECKPOINT_FILE_PATH = path
    report = cu.load_test_checkpoint(cfg, fresh)
    assert report["missing"] == []
    with torch.no_grad():
        assert torch.equal(fresh(xs), model(xs))


def test_mixup_mixes_every_pathway_with_one_draw():
    """Mixup on [slow, fast]: each pathway equals the single-tensor mixup
    of it with the same draws (CutMix's box in each pathway's H, W, which
    they share), and the soft labels are the single-tensor ones."""
    from focus_tpu_torch.engine.trainer import apply_mixup, sample_mixup

    cfg = slowfast_cfg(crop=32, classes=7)
    cfg.MIXUP.ENABLE = True
    cfg.MIXUP.CUTMIX_ALPHA = 1.0
    gen = torch.Generator().manual_seed(0)
    xs = [torch.from_numpy(x) for x in clips(cfg, batch=4)]
    labels = torch.tensor([0, 1, 2, 3])
    for switch in (0.0, 1.0):  # mixup, then CutMix
        cfg.MIXUP.SWITCH_PROB = switch
        draws = sample_mixup(cfg, gen, xs[1].shape, "cpu")
        mixed, soft = apply_mixup(xs, labels, cfg, draws)
        assert isinstance(mixed, list) and len(mixed) == 2
        for got, x in zip(mixed, xs):
            want, want_soft = apply_mixup(x, labels, cfg, draws)
            assert torch.equal(got, want) and torch.equal(soft, want_soft)


class PathwayClips:
    """A Kinetics-shaped test split: 4 videos x 1 view x 3 crops of uint8
    frames, each clip split into slow and fast pathways by
    ``pack_pathway_output``; (pathways, label, index, {})."""

    def __init__(self, cfg, mode):
        from focus_tpu_torch.datasets.utils import pack_pathway_output

        self.views = cfg.TEST.NUM_ENSEMBLE_VIEWS * cfg.TEST.NUM_SPATIAL_CROPS
        rs = np.random.RandomState(cfg.RNG_SEED)
        T, crop = cfg.DATA.NUM_FRAMES, cfg.DATA.TEST_CROP_SIZE
        self.clips = [tuple(pack_pathway_output(cfg, rs.randint(
            0, 256, (T, crop, crop, 3)).astype(np.uint8)))
            for _ in range(4 * self.views)]
        self.labels = rs.randint(0, cfg.MODEL.NUM_CLASSES, 4)

    def __len__(self):
        return len(self.clips)

    def __getitem__(self, i):
        return (self.clips[i], np.int32(self.labels[i // self.views]),
                np.int32(i), {})


def test_test_path_ensembles_slowfast_pathways(tmp_path):
    """``tester.run_test`` on SlowFast with a 48-px test crop above the
    32-px train crop, 4 videos x 3 crops at batch 5 (a padded last batch):
    every clip counted once, and each video's summed probabilities equal a
    direct loop through ``EvalForward`` on the same clips."""
    from focus_tpu_torch.datasets.build import DATASET_REGISTRY
    from focus_tpu_torch.engine import tester
    from focus_tpu_torch.entry import EvalForward
    from focus_tpu_torch.ops.preprocess import device_normalize

    if "Resnet_pathway_clips" not in DATASET_REGISTRY:
        DATASET_REGISTRY.register(PathwayClips, name="Resnet_pathway_clips")
    cfg = slowfast_cfg(crop=32, classes=7)
    cfg.TEST.DATASET = "resnet_pathway_clips"
    cfg.DATA.TEST_CROP_SIZE = 48
    cfg.TEST.NUM_ENSEMBLE_VIEWS, cfg.TEST.NUM_SPATIAL_CROPS = 1, 3
    cfg.TEST.BATCH_SIZE = 5
    cfg.DATA_LOADER.NUM_WORKERS = 1
    cfg.OUTPUT_DIR = str(tmp_path)
    run = tester.run_test(cfg, device="cpu")
    assert run.clips == 12 and run.batches == 3
    model = build_model(cfg, device="cpu")
    forward = EvalForward(model)
    data = PathwayClips(cfg, "test")
    want = np.zeros((4, 7), np.float32)
    for i in range(len(data)):
        pathways = [torch.from_numpy(p)[None] for p in data[i][0]]
        want[i // 3] += forward(device_normalize(pathways, cfg))[0].numpy()
    np.testing.assert_allclose(np.asarray(run.meter.video_preds), want,
                               rtol=0, atol=1e-6)
    assert (np.asarray(run.meter.clip_count) == 3).all()
