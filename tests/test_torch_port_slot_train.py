"""The port's STEVE training slice on the CPU against the JAX package, at
the size of ``configs/tests/steve_synthetic.yaml`` (the res18 encoder at
64 px, which its position grid needs), float32, on the same numpy inputs
and on weights carried across by ``utils/weights.py``.

Both sides replay the same Gumbel and slot noise (the JAX package's
``gumbel_softmax`` and ``_sample_slot_noise`` patched, the port's
``STEVE.forward(noise=...)`` and ``sample_slot_noise``), and dropout is
neutralised on both: ``SLOTS.DECODER.DROPOUT`` 0 and the position
embedding's fixed 0.1 patched to 0.

Tolerances: tensors by relative L2 (norm of the difference over the
norm of the reference); a gradient by relative L2 1e-4, where the
parameter's gradient is zero but for rounding (BatchNorm removes a bias
before it; one bias shifts every slot's logits alike) the difference is
held under 1e-7 of the whole gradient's norm instead.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from focus_tpu.config import get_cfg as jax_get_cfg
from focus_tpu.models import optimizer as joptim
from focus_tpu.models.build import build_model as jax_build_model
from focus_tpu.models.build import init_model
from focus_tpu.models.steve import slot_attention as jsa
from focus_tpu.models.steve import steve as jsteve
from focus_tpu.utils import lr_policy as jlr
from focus_tpu.utils import metrics as jmetrics
from focus_tpu_torch.config import get_cfg
from focus_tpu_torch.entry import steve_train_entry
from focus_tpu_torch.engine import slot_trainer as tst
from focus_tpu_torch.models import common as tcommon
from focus_tpu_torch.models import optimizer as toptim
from focus_tpu_torch.models.build import build_model
from focus_tpu_torch.models.steve import slot_attention as tsa
from focus_tpu_torch.parallel.train_state import TrainState
from focus_tpu_torch.utils import checkpoint as tcu
from focus_tpu_torch.utils import metrics as tmetrics
from focus_tpu_torch.utils.weights import (
    jax_grads_to_state_dict,
    load_jax_adam_state,
    load_jax_params,
)


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
SYNTH = os.path.join(REPO, "configs", "tests", "steve_synthetic.yaml")
B, T = 2, 2
FWD_REL = 1e-5  # recon, ce, mse, attns, BatchNorm's running statistics
GRAD_REL = 1e-4
ZERO_GRAD_FLOOR = 1e-7  # of the whole gradient's norm
SCHED_REL = 1e-6  # float32 exp / cos: XLA's and numpy's differ by an ulp
STEPS = 3
STEP_LOSS_REL = 1e-5
# Adam moves an element by about its LR a step whatever the gradient's
# size, so a parameter's update (its change over the steps) is held
# elementwise to a share of the LRs summed over those steps, and all
# updates together by relative L2
UPDATE_MAX = 0.05
UPDATE_REL = 1e-2
METRIC_ATOL = 1e-12
EVAL_ATOL = 1e-6


def configure(cfg, cnn):
    cfg.merge_from_file(SYNTH)
    cfg.MODEL.CNN_NAME = cnn
    cfg.SLOTS.DECODER.DROPOUT = 0.0
    cfg.DATA_LOADER.NUM_WORKERS = 2
    if cnn == "res18":  # its position grid is the image's: 64 px
        cfg.SLOTS.IMG_SIZE = cfg.DATA.TRAIN_CROP_SIZE = 64
        cfg.DATA.TEST_CROP_SIZE = 64
    return cfg


def rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def t2n(t):
    return t.detach().cpu().numpy()


class NoDropPE(jsteve.LearnedPositionalEmbedding1D):
    dropout: float = 0.0


def replay_jax_noise(mp, gumbel, slots):
    """Patch the JAX package to draw ``gumbel`` (z_soft's, then z_hard's,
    in every forward traced) and ``slots``, and to build its position
    embedding without dropout."""
    calls = []

    def gumbel_softmax(rng, logits, tau, hard, axis=-1):
        noise = jnp.asarray(gumbel[len(calls) % 2])
        calls.append(1)
        y_soft = jax.nn.softmax((logits + noise) / tau, axis=axis)
        if not hard:
            return y_soft
        y_hard = jax.nn.one_hot(jnp.argmax(y_soft, axis=axis),
                                logits.shape[axis], dtype=logits.dtype)
        return y_hard - jax.lax.stop_gradient(y_soft) + y_soft

    mp.setattr(jsteve, "gumbel_softmax", gumbel_softmax)
    mp.setattr(jsa, "_sample_slot_noise", lambda rng, shape: jnp.asarray(slots))
    mp.setattr(jsteve, "LearnedPositionalEmbedding1D", NoDropPE)


def make_noise(cfg, rs):
    h = cfg.SLOTS.IMG_SIZE // 4
    gumbel = [(-np.log(rs.exponential(size=(B * T, h, h, cfg.SLOTS.VOCAB_SIZE))
                       + 1e-30)).astype(np.float32) for _ in range(2)]
    slots = rs.randn(B, cfg.SLOTS.NUM_SLOTS, cfg.SLOTS.SIZE).astype(np.float32)
    return gumbel, slots


def torch_noise(gumbel, slots):
    return {"gumbel": [torch.from_numpy(g) for g in gumbel],
            "slots": torch.from_numpy(slots)}


_JAX_INIT = {}


def jax_init(cnn):
    """(JAX model, its initial variables) of ``configure(cnn)``, made once.
    The base CNN's are the port's seeded init carried onto the variables'
    ``eval_shape`` by the JAX package's importer (no init compile; its
    importer reads a ConvTranspose weight as a convolution's, so the port's
    ``upconv`` weight, [I, O, kh, kw] flipped, goes in as the [O, I, kh,
    kw] that gives flax's kernel). res18's are the JAX package's own init
    (a traced init is a compile): at the port's init one gradient of its
    float32 step lies 1.4e-4 from JAX's, past the tests' 1e-4."""
    from focus_tpu.utils.torch_import import import_torch_params

    if cnn not in _JAX_INIT:
        jcfg = configure(jax_get_cfg(), cnn)
        jm = jax_build_model(jcfg)
        S = jcfg.SLOTS.IMG_SIZE
        if cnn != "base":
            _JAX_INIT[cnn] = jm, jax.device_get(init_model(
                jm, jcfg, (jnp.zeros((B, T, S, S, 3)), 1.0, True)))
            return _JAX_INIT[cnn]
        rngs = {k: jax.random.PRNGKey(i) for i, k in enumerate(
            ("params", "slots", "gumbel", "dropout"))}
        shapes = jax.eval_shape(lambda: jm.init(
            rngs, jnp.zeros((B, T, S, S, 3)), 1.0, True))
        zeros = jax.tree_util.tree_map(lambda a: np.zeros(a.shape, a.dtype),
                                       shapes)
        sd = {k: v.numpy() for k, v in build_model(
            configure(get_cfg(), cnn), "cpu").state_dict().items()}
        for k in sd:
            if k.endswith("upconv.weight"):
                kernel = sd[k].transpose(2, 3, 0, 1)[::-1, ::-1]
                sd[k] = np.ascontiguousarray(kernel.transpose(3, 2, 0, 1))
        variables = {"params": import_torch_params(
            sd, zeros["params"], allow_missing=False)[0]}
        _JAX_INIT[cnn] = jm, jax.device_get(variables)
    return _JAX_INIT[cnn]


def port_model(cfg, variables):
    model = build_model(cfg, "cpu")
    load_jax_params(model, jax.device_get(variables["params"]),
                    jax.device_get(variables.get("batch_stats")))
    model.steve_decoder.pos.dropout = 0.0
    return model


# ---- the training forward, its gradients, BatchNorm's statistics -----------

@pytest.fixture(scope="module", params=["base", "res18"])
def forward_pair(request):
    """One training forward and gradient of each side from the same
    weights, video, tau and noise."""
    cnn = request.param
    jcfg, cfg = configure(jax_get_cfg(), cnn), configure(get_cfg(), cnn)
    rs = np.random.RandomState(0)
    S = cfg.SLOTS.IMG_SIZE
    video = rs.rand(B, T, S, S, 3).astype(np.float32)
    gumbel, slots = make_noise(cfg, rs)
    tau = 0.7
    with pytest.MonkeyPatch.context() as mp:
        replay_jax_noise(mp, gumbel, slots)
        jm, variables = jax_init(cnn)
        has_bn = "batch_stats" in variables
        rngs = {k: jax.random.PRNGKey(i)
                for i, k in enumerate(("gumbel", "slots", "dropout"))}

        def loss_fn(params):
            v = {"params": params}
            if has_bn:
                v["batch_stats"] = variables["batch_stats"]
            out = jm.apply(v, jnp.asarray(video), jnp.float32(tau), True,
                           train=True, rngs=rngs,
                           mutable=["batch_stats"] if has_bn else False)
            (recon, ce, mse, attns), new = out if has_bn else (out, {})
            return mse + ce, (recon, ce, mse, attns, new)

        (_, jout), jgrads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
            variables["params"])
    model = port_model(cfg, variables)
    tout = model(torch.from_numpy(video), tau, True, train=True,
                 noise=torch_noise(gumbel, slots))
    (tout[1] + tout[2]).backward()
    return {"cnn": cnn, "jax": jax.device_get(jout), "port": tout,
            "jax_grads": jax_grads_to_state_dict(jax.device_get(jgrads)),
            "model": model}


def test_steve_forward_train_matches_jax(forward_pair):
    """recon, cross-entropy, mse and the masked video of one training
    forward (hard Gumbel, train mode) against the JAX package's."""
    (jrecon, jce, jmse, jattns, _), (recon, ce, mse, attns) = (
        forward_pair["jax"][:4] + (None,), forward_pair["port"])
    for name, got, ref in (("recon", recon, jrecon), ("ce", ce, jce),
                           ("mse", mse, jmse), ("attns", attns, jattns)):
        assert np.isfinite(t2n(got)).all()
        assert rel(t2n(got), ref) <= FWD_REL, (name, rel(t2n(got), ref))


def test_steve_gradients_match_jax(forward_pair):
    """Every parameter's gradient of mse + ce against
    ``jax.value_and_grad``."""
    ref = forward_pair["jax_grads"]
    scale = float(np.sqrt(sum(float((r.double() ** 2).sum())
                              for r in ref.values())))
    named = dict(forward_pair["model"].named_parameters())
    assert set(named) == set(ref)
    worst = {}
    for name, p in named.items():
        got = p.grad if p.grad is not None else torch.zeros_like(p)
        diff = float((got.double() - ref[name].double()).norm())
        norm = float(ref[name].double().norm())
        if norm > ZERO_GRAD_FLOOR * scale / GRAD_REL:
            worst[name] = diff / norm
            assert diff <= GRAD_REL * norm, (name, diff / norm)
        else:
            assert diff <= ZERO_GRAD_FLOOR * scale, (name, diff, scale)
    assert worst  # most gradients are held relatively


def test_res18_running_statistics_match_flax(forward_pair):
    """BatchNorm's running mean and (biased) variance after one training
    forward against flax's updated ``batch_stats``."""
    if forward_pair["cnn"] != "res18":
        assert not any(k.endswith("running_mean")
                       for k in forward_pair["model"].state_dict())
        return
    new = jax_grads_to_state_dict(
        jax.device_get(forward_pair["jax"][4]["batch_stats"]))
    sd = forward_pair["model"].state_dict()
    assert len(new) == 10  # bn1 and the two blocks' bn1, bn2: mean, var
    for name, ref in new.items():
        assert rel(sd[name].numpy(), ref.numpy()) <= FWD_REL, name


# ---- schedules ---------------------------------------------------------------

def test_slot_schedules_match_jax():
    """The three learning rates and tau of the MOVi-E recipe over the first
    steps and around the warm-up and anneal ends, against the JAX
    package's jitted schedules. As optax reads them at the count before
    the update, step 0's enc and dec rates are 1 / WARMUP_STEPS of their
    base (the warm-up's step + 1), not 0."""
    jcfg, cfg = jax_get_cfg(), get_cfg()
    for c in (jcfg, cfg):
        c.merge_from_file(os.path.join(REPO, "configs", "movi_e", "base.yaml"))
    so = cfg.SLOTS_OPTIM
    js = joptim.slot_lr_schedules(jcfg)
    ts = toptim.slot_lr_schedules(cfg)
    lrs = jax.jit(lambda s: {k: f(s) for k, f in js.items()})
    tau = jax.jit(lambda s: jlr.cosine_anneal_jnp(
        s.astype(jnp.float32), so.TAU_START, so.TAU_FINAL, 0, so.TAU_STEPS))
    steps = list(range(6)) + [19999, 20000, 20001, 29999, 30000, 123456]
    for step in steps:
        ref = lrs(jnp.int32(step))
        for k in ("dvae", "enc", "dec"):
            assert abs(ts[k](step) - float(ref[k])) <= SCHED_REL * float(
                ref[k]), (k, step)
        want = float(tau(jnp.int32(step)))
        assert abs(tst.slot_tau(cfg, step) - want) <= SCHED_REL * want
    assert ts["dvae"](0) == pytest.approx(so.DVAE)
    assert ts["enc"](0) == pytest.approx(so.ENC / so.WARMUP_STEPS, rel=1e-6)
    assert ts["dec"](0) == pytest.approx(so.DEC / so.WARMUP_STEPS, rel=1e-6)


def test_slot_optimizer_groups():
    """Three Adam groups by prefix, global-norm clipping at
    CLIP_GRAD_L2NORM (SLOTS_OPTIM.CLIP read nowhere)."""
    cfg = configure(get_cfg(), "base")
    model = build_model(cfg, "cpu")
    opt = toptim.construct_optimizer_slot(model, cfg)
    groups = {g["label"]: g["params"] for g in opt.optimizer.param_groups}
    assert list(groups) == ["dvae", "enc", "dec"]
    for name, p in model.named_parameters():
        label = toptim.slot_label(name)
        assert any(p is q for q in groups[label]), name
    assert opt.clip_norm == cfg.SOLVER.CLIP_GRAD_L2NORM
    assert opt.clip_value is None


# ---- train steps against make_train_step -------------------------------------

@pytest.fixture(scope="module")
def jax_steps():
    """STEPS JAX train steps (NUM_GPUS 1) on fixed noise and batches, with
    every state kept, and the inputs."""
    from focus_tpu.engine.slot_trainer import make_train_step
    from focus_tpu.parallel import mesh as mesh_lib
    from focus_tpu.parallel.train_state import TrainState as JaxState

    jcfg = configure(jax_get_cfg(), "base")
    cfg = configure(get_cfg(), "base")
    rs = np.random.RandomState(3)
    S = cfg.SLOTS.IMG_SIZE
    videos = [rs.rand(B, T, S, S, 3).astype(np.float32) for _ in range(STEPS)]
    gumbel, slots = make_noise(cfg, rs)
    with pytest.MonkeyPatch.context() as mp:
        replay_jax_noise(mp, gumbel, slots)
        jm, variables = jax_init("base")
        tx = joptim.construct_optimizer_slot(variables["params"], jcfg)
        mesh = mesh_lib.build_mesh(jcfg)
        # placed as the step places its output state, so that the second
        # step reuses the first one's compile
        state = jax.device_put(JaxState.create(variables["params"], tx),
                               mesh_lib.replicated(mesh))
        step = make_train_step(jm, jcfg, mesh)
        rng = jax.random.PRNGKey(0)
        states, stats = [jax.device_get(state)], []
        for v in videos:
            state, s = step(state, jnp.asarray(v), rng)
            states.append(jax.device_get(state))
            stats.append({k: float(x) for k, x in jax.device_get(s).items()})
    return {"cfg": cfg, "variables": variables, "videos": videos,
            "noise": (gumbel, slots), "states": states, "stats": stats}


def port_state(cfg, variables):
    model = port_model(cfg, variables)
    return tst.build_slot_state(cfg, model), tst.make_train_step(model, cfg)


def check_updates(model, cfg, init, jax_params, steps):
    """The port's parameters against the JAX package's after ``steps``
    (update counts) from ``init``, by their updates."""
    ref = jax_grads_to_state_dict(jax_params)
    start = jax_grads_to_state_dict(init)
    sched = toptim.slot_lr_schedules(cfg)
    diff2 = norm2 = 0.0
    for name, p in model.named_parameters():
        lr_sum = sum(sched[toptim.slot_label(name)](k) for k in steps)
        got = p.detach().double() - start[name].double()
        want = ref[name].double() - start[name].double()
        # a float32 parameter holds its update to its own rounding
        ulp = torch.finfo(torch.float32).eps * ref[name].double().abs()
        assert bool(((got - want).abs() <= UPDATE_MAX * lr_sum + ulp).all()), \
            name
        diff2 += float(((got - want) ** 2).sum())
        norm2 += float((want ** 2).sum())
    assert np.sqrt(diff2 / norm2) <= UPDATE_REL


def test_three_train_steps_match_jax(jax_steps):
    """Losses, taus and the parameters after three updates (clipping, the
    three groups' Adam) against ``make_train_step``; the parameters by
    their updates (``check_updates``)."""
    cfg, (gumbel, slots) = jax_steps["cfg"], jax_steps["noise"]
    state, step = port_state(cfg, jax_steps["variables"])
    for v, ref in zip(jax_steps["videos"], jax_steps["stats"]):
        state, stats = step(state, torch.from_numpy(v),
                            torch_noise(gumbel, slots))
        assert stats["tau"] == pytest.approx(ref["tau"], rel=SCHED_REL)
        for k in ("loss", "mse", "cross_entropy"):
            assert float(stats[k]) == pytest.approx(ref[k], rel=STEP_LOSS_REL)
    assert state.step == STEPS
    check_updates(state.model, cfg, jax_steps["states"][0].params,
                  jax_steps["states"][-1].params, range(STEPS))


def test_carried_adam_state_continues_as_jax(jax_steps):
    """The JAX state after two steps (params and every group's Adam moments
    and count, through ``load_jax_adam_state``) takes the third step as the
    JAX package does."""
    cfg, (gumbel, slots) = jax_steps["cfg"], jax_steps["noise"]
    two = jax_steps["states"][2]
    state, step = port_state(cfg, {"params": two.params})
    n = load_jax_adam_state(state.optimizer.optimizer, state.model,
                            two.opt_state)
    assert n == len(list(state.model.parameters()))
    state.step = int(two.step)
    state, stats = step(state, torch.from_numpy(jax_steps["videos"][2]),
                        torch_noise(gumbel, slots))
    assert float(stats["loss"]) == pytest.approx(
        jax_steps["stats"][2]["loss"], rel=STEP_LOSS_REL)
    check_updates(state.model, cfg, two.params, jax_steps["states"][3].params,
                  [2])


# ---- segmentation metrics and slot_eval -------------------------------------

@pytest.mark.parametrize("shape", [(2, 4, 3, 50), (3, 6, 5, 128)])
def test_segmentation_metrics_match_jax(shape):
    """``evaluate_ari`` and ``evaluate_mbo`` on random masks (one empty
    ground-truth mask included) against the JAX package's."""
    Bm, N0, N1, D = shape
    rs = np.random.RandomState(Bm + D)
    seg = rs.randint(0, N0, size=(Bm, D))
    seg[:, :] = np.where(seg == N0 - 1, 0, seg)  # segment N0-1 stays empty
    true = np.stack([(seg == s) for s in range(N0)], axis=1).astype(np.float32)
    pred = rs.rand(Bm, N1, D).astype(np.float32)
    for fn in ("evaluate_ari", "evaluate_mbo"):
        got = getattr(tmetrics, fn)(true, pred)
        ref = getattr(jmetrics, fn)(true, pred)
        assert abs(got - ref) <= METRIC_ATOL, (fn, got, ref)
    table = rs.randint(0, 5, size=(N0, N1))
    assert tmetrics.compute_ari(table) == jmetrics.compute_ari(table)


def test_slot_eval_matches_jax(tmp_path, monkeypatch):
    """FG-ARI and mBO of ``slot_eval`` on ``synthetic_video_with_masks`` from
    one checkpoint, carried across (the port's ``.pyth`` written from the
    JAX weights, the JAX package's own file read by its ``slot_eval``),
    with the same slot noise on both sides."""
    from focus_tpu.engine import slot_trainer as jst
    from focus_tpu.utils import checkpoint as jcu

    jcfg = configure(jax_get_cfg(), "base")
    cfg = configure(get_cfg(), "base")
    rs = np.random.RandomState(5)
    slots = rs.randn(cfg.TEST.BATCH_SIZE, cfg.SLOTS.NUM_SLOTS,
                     cfg.SLOTS.SIZE).astype(np.float32)
    from focus_tpu.parallel.train_state import TrainState as JaxState

    _, variables = jax_init("base")
    for c, d in ((jcfg, "jax"), (cfg, "port")):
        c.OUTPUT_DIR = c.EXP.PATH = str(tmp_path / d)
    jstate = JaxState.create(variables["params"],
                             joptim.construct_optimizer_slot(
                                 variables["params"], jcfg))
    jcu.save_checkpoint(jcfg.OUTPUT_DIR, jstate, 1, jcfg)
    # the state slot_eval builds before its checkpoint overwrites it: the
    # same, without tracing the init again
    monkeypatch.setattr(jst, "build_slot_state", lambda *a: jstate)
    model = port_model(cfg, variables)
    tcu.save_checkpoint(cfg.OUTPUT_DIR, model, 1, cfg)

    monkeypatch.setattr(jsa, "_sample_slot_noise",
                        lambda rng, shape: jnp.asarray(slots))
    monkeypatch.setattr(tsa, "sample_slot_noise",
                        lambda shape, generator, device: torch.from_numpy(
                            slots).to(device))
    ref = jst.slot_eval(jcfg)
    run = tst.run_slot_eval(cfg, "cpu")
    assert run.checkpoint["path"].endswith("checkpoint_epoch_00001.pyth")
    assert run.clips == 16
    for k in ("fg_ari", "mbo"):
        assert abs(run.results[k] - ref[k]) <= EVAL_ATOL, (k, run.results,
                                                             ref)


# ---- the loop ----------------------------------------------------------------

def loop_cfg(tmp_path, epochs, resume=False):
    cfg = configure(get_cfg(), "base")
    cfg.SLOTS.DECODER.DROPOUT = 0.1  # the yaml's: the loop as it is run
    cfg.OUTPUT_DIR = str(tmp_path)
    cfg.EXP.PATH = str(tmp_path / "synth")
    cfg.SOLVER.MAX_EPOCH = epochs
    cfg.TRAIN.AUTO_RESUME = resume
    cfg.TRAIN.CHECKPOINT_PERIOD = 1
    cfg.TRAIN.BATCH_SIZE = cfg.TEST.BATCH_SIZE = 16
    return cfg


def params_of(model):
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


def test_resumed_run_equals_uninterrupted(tmp_path):
    """Two epochs in one run against one epoch, then AUTO_RESUME to two, of
    4 steps each (batch 16): the same losses, taus and final weights
    (running statistics and Adam moments included) bit for bit; the three
    checkpoint names written."""
    whole = tst.run_slot_train(loop_cfg(tmp_path / "whole", 2), "cpu")
    first = tst.run_slot_train(loop_cfg(tmp_path / "parts", 1), "cpu")
    second = tst.run_slot_train(loop_cfg(tmp_path / "parts", 2, True), "cpu")
    assert second.start_epoch == 1 and second.checkpoint["kind"] == "resume"
    assert first.losses + second.losses == whole.losses
    assert first.taus + second.taus == whole.taus
    assert whole.state.step == second.state.step == 8
    a, b = params_of(whole.state.model), params_of(second.state.model)
    assert all(torch.equal(a[k], b[k]) for k in a)
    ma = whole.state.optimizer.optimizer.state_dict()["state"]
    mb = second.state.optimizer.optimizer.state_dict()["state"]
    assert all(torch.equal(ma[i]["exp_avg_sq"], mb[i]["exp_avg_sq"])
               for i in ma)
    names = sorted(os.listdir(tmp_path / "whole" / "synth" / "checkpoints"))
    assert names == ["best_model.pt", "checkpoint.pt.tar",
                     "checkpoint_epoch_00001.pyth",
                     "checkpoint_epoch_00002.pyth"]
    assert all(np.isfinite(x) for x in whole.val_losses)
    assert whole.val_clips == 2 * 16


def test_run_net_trains_and_evaluates(tmp_path):
    """``run_net --device cpu --cfg configs/tests/steve_synthetic.yaml``:
    one epoch, best_model.pt and the epoch checkpoint, then FG-ARI and mBO
    in percent."""
    from focus_tpu_torch.tools import run_net

    out = run_net.main(["--device", "cpu", "--cfg", SYNTH, "--exp_name",
                        "synth", "OUTPUT_DIR", str(tmp_path)])
    names = os.listdir(tmp_path / "synth" / "checkpoints")
    assert {"best_model.pt", "checkpoint_epoch_00001.pyth"} <= set(names)
    assert set(out) == {"fg_ari", "mbo"}
    assert -100.0 <= out["fg_ari"] <= 100.0 and 0.0 <= out["mbo"] <= 100.0


def test_steve_train_entry_loss_falls():
    """Eight steps of ``steve_train_entry`` on one fixed batch lower the
    loss (the JAX package's ``test_slot_train_loss_decreases``)."""
    fn, (video,) = steve_train_entry(device="cpu", batch=4, tiny=True)
    losses = [float(fn(video)["loss"]) for _ in range(8)]
    assert fn.state.step == 8
    assert losses[-1] < losses[0], losses


def test_entry_points_refuse_missing_cuda():
    """Without CUDA the entry points raise; they never fall back."""
    if torch.cuda.is_available():
        pytest.skip("CUDA is available here")
    from focus_tpu_torch.tools import steve_eval_net, steve_train_net

    with pytest.raises(RuntimeError, match="CUDA"):
        steve_train_entry(tiny=True)
    for tool in (steve_train_net, steve_eval_net):
        with pytest.raises(RuntimeError, match="CUDA"):
            tool.main(["--cfg", SYNTH, "OUTPUT_DIR", "/nonexistent"])


# ---- dropout and the Gumbel softmax ------------------------------------------

@pytest.mark.parametrize("draw", [
    lambda g, dev: tcommon.uniform((3,), g, dev),
    lambda g, dev: tcommon.normal((3,), g, dev),
    lambda g, dev: tcommon.exponential((3,), g, dev),
    lambda g, dev: tcommon.dropout(torch.ones(3, device=dev), 0.5, True, g),
], ids=["uniform", "normal", "exponential", "dropout"])
def test_draws_refuse_a_generator_on_another_device(draw):
    """Every draw is made on the data's device by a generator there; a
    generator on another device is refused, so no draw crosses between
    the host and the card."""
    assert draw(torch.Generator(), "cpu").device.type == "cpu"
    with pytest.raises(ValueError, match="cannot draw"):
        draw(torch.Generator(), "meta")


def test_dropout_rate_scale_eval_and_generator():
    x = torch.ones(200_000)
    g = torch.Generator().manual_seed(7)
    y = tcommon.dropout(x, 0.25, True, g)
    kept = y != 0
    assert abs(float(kept.float().mean()) - 0.75) < 0.01
    assert torch.equal(y[kept], torch.full_like(y[kept], 1 / 0.75))
    assert tcommon.dropout(x, 0.25, False, g) is x
    assert tcommon.dropout(x, 0.0, True, g) is x
    y2 = tcommon.dropout(x, 0.25, True, torch.Generator().manual_seed(7))
    assert torch.equal(y, y2)
    # a module in train mode: the same masks from the same seed, none in eval
    mha = tcommon.TransformerDecoder(2, 8, 2, dropout=0.3)
    torch.nn.init.normal_(mha.blocks[0].ffn[0].weight)
    q, enc = torch.randn(2, 5, 8), torch.randn(2, 3, 8)
    outs = [mha(q, enc, train=True,
                generator=torch.Generator().manual_seed(1)) for _ in range(2)]
    assert torch.equal(outs[0], outs[1])
    assert not torch.equal(outs[0], mha(q, enc))
    assert torch.equal(mha(q, enc), mha(q, enc, train=False,
                                         generator=torch.Generator()))


def test_gumbel_softmax_matches_jax(monkeypatch):
    """Soft and straight-through hard samples and their gradients against
    the JAX package's ``gumbel_softmax`` on the same Exp(1) draws (its
    ``jax.random.exponential`` patched to return them)."""
    from focus_tpu.models import common as jcommon

    rs = np.random.RandomState(9)
    logits = rs.randn(3, 4, 10).astype(np.float32)
    e = rs.exponential(size=logits.shape).astype(np.float32)
    w = rs.randn(*logits.shape).astype(np.float32)
    monkeypatch.setattr(jax.random, "exponential",
                        lambda rng, shape, dtype: jnp.asarray(e, dtype))
    noise = -torch.log(torch.from_numpy(e) + torch.finfo(torch.float32).tiny)
    for hard in (False, True):
        def jfn(lg):
            y = jcommon.gumbel_softmax(jax.random.PRNGKey(0), lg, 0.5, hard)
            return jnp.sum(y * w), y

        (_, ref), gref = jax.value_and_grad(jfn, has_aux=True)(
            jnp.asarray(logits))
        lg = torch.from_numpy(logits).requires_grad_()
        y = tcommon.gumbel_softmax(lg, 0.5, hard, noise=noise)
        (y * torch.from_numpy(w)).sum().backward()
        np.testing.assert_allclose(t2n(y), np.asarray(ref), atol=1e-6)
        np.testing.assert_allclose(t2n(lg.grad), np.asarray(gref), atol=1e-5)
    # drawn noise, -log(Exp(1) + tiny): the same from the same seed
    a = tcommon.gumbel_softmax(torch.zeros(4, 6), 1.0, False,
                               torch.Generator().manual_seed(3))
    b = tcommon.gumbel_softmax(torch.zeros(4, 6), 1.0, False,
                               torch.Generator().manual_seed(3))
    assert torch.equal(a, b) and torch.allclose(a.sum(-1), torch.ones(4))


def test_train_state_step_noise_depends_on_step_alone():
    """The step generator's seed is a function of (RNG_SEED, step): the
    same draws whatever the generator drew before."""
    cfg = configure(get_cfg(), "base")
    model = build_model(cfg, "cpu")
    state = TrainState(model, None, torch.Generator(), step=5)
    a = torch.rand(3, generator=tst.step_generator(state, cfg))
    torch.rand(100, generator=state.generator)
    b = torch.rand(3, generator=tst.step_generator(state, cfg))
    state.step = 6
    c = torch.rand(3, generator=tst.step_generator(state, cfg))
    assert torch.equal(a, b) and not torch.equal(a, c)


def test_unported_backbones_raise():
    """A model name the port does not build raises, naming itself; MViT,
    the last backbone of the JAX package's registry to be ported, builds."""
    cfg = get_cfg()
    cfg.MODEL.MODEL_NAME = "NoSuchNet"
    with pytest.raises(NotImplementedError, match="NoSuchNet"):
        build_model(cfg, "cpu")
    cfg.MODEL.MODEL_NAME = "MViT"
    cfg.MVIT.EMBED_DIM, cfg.MVIT.DEPTH = 8, 2
    assert type(build_model(cfg, "cpu")).__name__ == "MViT"
