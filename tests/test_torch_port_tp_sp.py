"""The port's tensor and sequence parallelism, ZeRO-1 and remat on the CPU
(``focus_tpu_torch/parallel/``, ``models/motionformer.py``,
``models/optimizer.py``), float32, on the tiny flagship (D=24, 2 heads,
F=2, ORViT at [1] with its motion stream):

- the placement: every parameter split on the dim that JAX's
  ``state_shardings`` gives its path at MODEL 2, and no other;
- one spawn of four gloo processes (``tools.run_net.launch_job`` running
  ``tests/torch_port_tp_sp_scenarios.run_all``) while this process computes
  the one-process and JAX references: SEQ 2 x MODEL 2 against one process
  (drop path 0.2) and against JAX's train and eval steps on a (data 1,
  seq 2, model 2) mesh of four virtual devices; DATA 2 x MODEL 2 under
  ZeRO-1 and two microbatches against one process, and its checkpoint
  resumed in one process;
- kernels 1 and 7's window of query frames in their plain versions
  against the rows of the whole core and ``jax.vjp``;
- remat with drop path against no remat, and the recomputed blocks
  against the JAX package's scanned segments.

Each test runs at one torch thread."""

import functools
import os
import re
import socket
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from focus_tpu.ops.pallas import trajectory_block as jtb
from focus_tpu_torch.config import get_cfg
from focus_tpu_torch.models import motionformer
from focus_tpu_torch.models.build import build_model
from focus_tpu_torch.ops import trajectory_block as ttb
from focus_tpu_torch.parallel import mesh as tmesh
from focus_tpu_torch.parallel import tensor
from focus_tpu_torch.tools.run_net import launch_job
from focus_tpu_torch.utils.weights import jax_params_to_state_dict

from tests import torch_port_tp_sp_scenarios as sc
from tests.test_torch_port_kernels import core_inputs
from tests.test_torch_port_train import jax_cfg

PKG = os.path.dirname(os.path.dirname(os.path.abspath(ttb.__file__)))
TOL = 1e-5


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@functools.lru_cache(maxsize=None)
def _jax_model():
    """The JAX tiny flagship (the SGD case's config: drop path and solver
    leave the parameters as they are) and its initial parameters, made
    once: the port's seeded init carried onto the params' ``eval_shape``
    by the JAX package's importer (no init compile)."""
    from focus_tpu.models.build import build_model as jax_build_model
    from focus_tpu.utils.torch_import import import_torch_params

    cfg = sc.tiny_cfg(drop_path=0.0, sgd=True)
    jcfg = jax_cfg(cfg)
    video, _, boxes = sc.batch(cfg, 0)
    jmodel = jax_build_model(jcfg)
    shapes = jax.eval_shape(lambda: jmodel.init(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
        jnp.asarray(video.numpy()),
        {"orvit_bboxes": jnp.asarray(boxes.numpy())}))["params"]
    template = jax.tree_util.tree_map(lambda a: np.zeros(a.shape, a.dtype),
                                      shapes)
    sd = build_model(cfg, device="cpu", seed=0).state_dict()
    params, _ = import_torch_params({k: v.numpy() for k, v in sd.items()},
                                    template, allow_missing=False)
    return jcfg, jmodel, params


# ---- the placement ----------------------------------------------------------

def _split_dims(t):
    """The dims along which ``t`` is not constant."""
    return [d for d in range(t.ndim)
            if (t - t.narrow(d, 0, 1)).abs().max() > 0]


def test_placement_matches_state_shardings():
    """A probe leaf that varies only along the model axis of its JAX spec
    (``state_shardings`` on a (model 2) mesh), carried through the bridge,
    varies along the dim ``param_dim`` splits in the port, for every
    parameter; the split leaves are the qkv / fc1 / proj / fc2 families
    (ORViT's TwoLayerReluMlps and the motion stream included)."""
    from focus_tpu.parallel import mesh as jmesh

    jcfg, _, params = _jax_model()
    jcfg = jcfg.clone()
    jcfg.TPU.MESH.MODEL = 2
    jcfg.NUM_GPUS = 2
    specs = jmesh.state_shardings(jmesh.build_mesh(jcfg), params)

    def probe(leaf, sharding):
        axes = [i for i, a in enumerate(sharding.spec) if a == "model"]
        out = np.zeros(leaf.shape, np.float32)
        if axes:
            shape = [1] * leaf.ndim
            shape[axes[0]] = leaf.shape[axes[0]]
            out += np.arange(leaf.shape[axes[0]]).reshape(shape) + 1
        return out

    probes = jax_params_to_state_dict(jax.tree_util.tree_map(
        probe, params, specs))
    model = build_model(sc.tiny_cfg(), device="cpu")  # the whole leaves
    split = 0
    for name, p in model.named_parameters():
        want = _split_dims(probes[name])
        got = tensor.param_dim(name, p.shape, 2)
        assert want == ([] if got is None else [got]), name
        split += got is not None
    # each block's qkv (weight, bias), proj, fc1 (weight, bias) and fc2;
    # the ORViT block's two TwoLayerReluMlps; the motion stream's coordinate
    # MLP, its attention's qkv and proj and its MLP; the motion MLP
    assert split == 3 * 6 + 2 * 2 + 2 + 3 + 3 + 3


def test_shards_and_full_state_round_trip():
    """A leaf's shards put back together are the leaf: the qkv shards hold
    each rank's channels of q, k and v."""
    full = torch.arange(6 * 4, dtype=torch.float32).reshape(6, 4)
    parts = [tensor.shard(full, "attn.qkv.weight", 0, r, 2) for r in range(2)]
    assert parts[0][:, 0].tolist() == [0, 8, 16]
    assert torch.equal(tensor.unshard(parts, "attn.qkv.weight", 0), full)
    parts = [tensor.shard(full, "mlp.fc2.weight", 1, r, 2) for r in range(2)]
    assert torch.equal(tensor.unshard(parts, "mlp.fc2.weight", 1), full)


# ---- the mesh: one spawn of four processes ----------------------------------

def _jax_mesh_run(jcfg, jmodel, params, cfg):
    """JAX's supervised train step (sgd, clip) and eval step on a (data 1,
    seq 2, model 2) mesh of four virtual devices: each step's loss, the
    parameters after and the eval probabilities."""
    from focus_tpu.engine.trainer import _no_wd_paths
    from focus_tpu.engine.trainer import make_supervised_eval_step
    from focus_tpu.engine.trainer import make_supervised_train_step as jmake
    from focus_tpu.models import losses as jlosses
    from focus_tpu.models import optimizer as joptim
    from focus_tpu.parallel import mesh as jmesh
    from focus_tpu.parallel.train_state import TrainState

    jcfg = jcfg.clone()
    jcfg.TPU.MESH.SEQ = jcfg.TPU.MESH.MODEL = 2
    jcfg.NUM_GPUS = 4
    mesh = jmesh.build_mesh(jcfg, devices=jax.devices()[:4])
    tx = joptim.construct_optimizer(params, jcfg, 2,
                                    no_weight_decay_paths=_no_wd_paths(jcfg))
    state = TrainState.create(params, tx)
    sharding = jmesh.state_shardings(mesh, state)
    state = jax.device_put(state, sharding)
    step = jmake(jmodel, jcfg, mesh, jlosses.get_loss_func(jcfg),
                 state_sharding=sharding)
    losses = []
    for seed in sc.SEEDS:
        video, labels, boxes = sc.batch(cfg, seed)
        sharded = jmesh.shard_batch(mesh, (
            video.numpy(), labels.numpy().astype(np.int32),
            {"orvit_bboxes": boxes.numpy()}))
        state, stats = step(state, *sharded, jax.random.PRNGKey(0))
        losses.append(float(stats["loss"]))
    video, _, boxes = sc.batch(cfg, sc.EVAL_SEED)
    evaluate = make_supervised_eval_step(jmodel, jcfg, mesh)
    probs = evaluate(state, *jmesh.shard_batch(
        mesh, (video.numpy(), {"orvit_bboxes": boxes.numpy()})))
    return {"losses": losses, "probs": np.asarray(jax.device_get(probs)),
            "params": jax_params_to_state_dict(jax.device_get(state.params))}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    out = str(tmp_path_factory.mktemp("tp_sp"))
    jcfg, jmodel, params = _jax_model()
    init = jax_params_to_state_dict(params)
    torch.save(init, os.path.join(out, "jax_init.pt"))
    cfg = get_cfg()
    cfg.NUM_GPUS, cfg.DIST_BACKEND, cfg.OUTPUT_DIR = 4, "gloo", out
    failed, jax_side = [], {}

    def spawn():
        try:
            launch_job(cfg, f"tcp://localhost:{_free_port()}", sc.run_all,
                       "cpu")
        except Exception as e:  # noqa: BLE001 (raised in the tests below)
            failed.append(e)

    def jax_ref():  # XLA's compile runs beside the port's work
        try:
            jax_side.update(_jax_mesh_run(jcfg, jmodel, params,
                                          sc.tiny_cfg(drop_path=0.0,
                                                      sgd=True)))
        except Exception as e:  # noqa: BLE001 (raised in the tests below)
            failed.append(e)

    workers = [threading.Thread(target=f) for f in (spawn, jax_ref)]
    for t in workers:
        t.start()
    try:
        one = {
            "seq_model": sc.run_steps(sc.tiny_cfg()),
            "seq_model_jax": sc.run_steps(
                sc.tiny_cfg(drop_path=0.0, sgd=True), init),
            "zero1": sc.run_steps(sc.tiny_cfg(accum=2)),
        }
    finally:
        for t in workers:
            t.join()
        torch.set_num_threads(threads)
    if failed:
        raise failed[0]
    mesh_ranks = [torch.load(os.path.join(out, f"rank{r}.pt"),
                             weights_only=False) for r in range(4)]
    return {"out": out, "one": one, "mesh": mesh_ranks, "jax": jax_side,
            "init": init}


def _params_close(got, want, adam):
    """Every parameter within TOL; under Adam, which divides each gradient
    element by its own magnitude, at most 1 element in 10^4 may step
    differently where its gradient is rounding alone (test_torch_port_train's
    rule), and none by more than the two steps' LR."""
    off = total = 0
    for name, w in want.items():
        diff = (got[name] - w).abs()
        off, total = off + int((diff > TOL).sum()), total + diff.numel()
        assert diff.max() <= (2 * 2e-3 if adam else TOL), name
    assert off <= (total // 10000 if adam else 0)


@pytest.mark.parametrize("case", ["seq_model", "seq_model_jax", "zero1"])
def test_mesh_steps_as_one_process(runs, case):
    """SEQ 2 x MODEL 2 (AdamW, drop path 0.2; SGD with the clip, no drop
    path) and DATA 2 x MODEL 2 under ZeRO-1 with GRAD_ACCUM 2, each on four
    processes, against one process on the same global batches: the losses
    and errors, every parameter (gathered to its full shape), the
    optimizer's state in the one-process form, the generator and the eval
    probabilities, within 1e-5; every rank holds the same."""
    one = runs["one"][case]
    adam = case != "seq_model_jax"
    for rank in runs["mesh"]:
        got = rank[case]
        for a, b in zip(got["stats"], one["stats"]):
            assert sorted(a) == sorted(b)
            for k in a:
                assert abs(a[k] - b[k]) <= TOL, k
        _params_close(got["params"], one["params"], adam)
        ga, oa = got["optimizer"]["state"], one["optimizer"]["state"]
        assert sorted(ga) == sorted(oa)
        for i in oa:
            for k, v in oa[i].items():
                assert torch.allclose(ga[i][k].float(), v.float(), atol=TOL), k
        assert torch.equal(got["generator"], one["generator"])
        assert torch.allclose(got["probs"], one["probs"], atol=TOL)
    first = runs["mesh"][0][case]["params"]
    for rank in runs["mesh"][1:]:
        for k, v in first.items():
            assert torch.equal(rank[case]["params"][k], v), k


def test_seq_model_steps_as_jax_mesh(runs):
    """SEQ 2 x MODEL 2 on four processes against JAX's
    ``make_supervised_train_step`` and eval step on a (1, 2, 2) mesh from
    the same parameters (SGD with the global-norm clip, no drop path):
    each loss within 1e-5 and every parameter within 1e-6
    (``test_torch_port_train.py``'s tolerances), the probabilities within
    1e-6."""
    got, ref = runs["mesh"][0]["seq_model_jax"], runs["jax"]
    for a, b in zip(got["stats"], ref["losses"]):
        assert abs(a["loss"] - b) <= 1e-5
    for name, w in ref["params"].items():
        assert (got["params"][name] - w).abs().max() <= 1e-6, name
    np.testing.assert_allclose(got["probs"].numpy(), ref["probs"], atol=1e-6)


def test_mesh_halves_the_split_leaves_and_the_moments(runs):
    """Per rank at MODEL 2 the split leaves' bytes are halved; under
    ZeRO-1 over DATA 2 the moments are those of half of each group's
    (model-rank) parameters, up to the padding of a group to an even
    length."""
    model = build_model(sc.tiny_cfg(), device="cpu")
    full = {n: p.numel() * 4 for n, p in model.named_parameters()}
    split = sum(b for n, b in full.items()
                if tensor.param_dim(n, (model.get_parameter(n).shape), 2)
                is not None)
    whole = sum(full.values())
    for rank in runs["mesh"]:
        assert rank["seq_model"]["bytes"]["param_bytes"] == whole - split // 2
        local = rank["zero1"]["bytes"]["param_bytes"]
        groups = len(rank["zero1"]["optimizer"]["param_groups"])
        moments = rank["zero1"]["bytes"]["optimizer_bytes"]
        # two moments of half the parameters, a step count and at most one
        # padding element a group
        assert local <= moments <= local + groups * (4 + 2 * 4)
        assert rank["seq_model"]["bytes"]["optimizer_bytes"] >= 2 * local


def test_zero1_checkpoint_resumes_in_one_process(runs):
    """The train checkpoint the four processes write (DATA 2 x MODEL 2,
    ZeRO-1) holds the bridge's full names and shapes and the one-process
    optimizer's state: it loads into a one-process state, whose weights,
    moments, step and generator are the one-process run's."""
    from focus_tpu_torch.engine.trainer import build_supervised_state
    from focus_tpu_torch.utils import checkpoint as cu

    path = runs["mesh"][0]["zero1"]["checkpoint"]
    assert path and os.path.exists(path)
    assert all(r["zero1"]["checkpoint"] is None for r in runs["mesh"][1:])
    cfg = sc.tiny_cfg(accum=2)
    model = build_model(cfg, device="cpu")
    state = build_supervised_state(cfg, model, 2)
    assert cu.load_train_state(path, state) == 1
    one = runs["one"]["zero1"]
    _params_close({n: p.detach() for n, p in model.named_parameters()},
                  one["params"], adam=True)
    got = state.optimizer.state_dict()["state"]
    for i, st in one["optimizer"]["state"].items():
        for k, v in st.items():
            assert torch.allclose(got[i][k].float(), v.float(), atol=TOL)
    assert state.step == 2
    assert torch.equal(state.generator.get_state(), one["generator"])


# ---- kernels 1 and 7 over a window of query frames --------------------------

WINDOW_CORE = (4, 12, 4)  # F, N, heads


@functools.lru_cache(maxsize=None)
def _window_case():
    """The whole core's inputs (F = 4, N = 12, 4 heads), an output
    gradient, and JAX's ``_xla_reference`` output and ``jax.vjp`` on
    them."""
    F, N, heads = WINDOW_CORE
    args = core_inputs(F=F, N=N, seed=2)
    B, S, C = args[0].shape
    scale = (C // heads) ** -0.5
    dout = np.random.RandomState(6).randn(B, S, C).astype(np.float32)

    def grads(a, d):
        out, vjp = jax.vjp(lambda *x: jtb._xla_reference(*x, scale, heads),
                           *a)
        return out, vjp(d)

    jout, jgrads = jax.jit(grads)([jnp.asarray(a) for a in args],
                                  jnp.asarray(dout))
    return args, dout, scale, np.asarray(jout), [np.asarray(g)
                                                 for g in jgrads]


@pytest.mark.parametrize("seq", [2, 4])
def test_window_rows_equal_the_whole_core(seq):
    """The plain core over each window of F / SEQ query frames (F = 4,
    N = 12) equals those rows of the whole core, and of JAX's
    ``_xla_reference``; the windows' gradients, summed, are the whole
    core's and ``jax.vjp``'s (atol 1e-4, the JAX kernel test's), dq row by
    row; the float32 plain backward (``trajectory_core_backward_reference``
    with ``f0``) gives the same window gradients."""
    F, N, heads = WINDOW_CORE
    args, dout, scale, jout, jgrads = _window_case()
    B, S, C = args[0].shape
    whole = ttb.trajectory_core_reference(*map(torch.from_numpy, args),
                                          scale, heads)
    n = F // seq
    summed = [0.0] * 6
    for w in range(seq):
        rows = slice(w * n * N, (w + 1) * n * N)
        targs = [torch.from_numpy(a).clone() for a in args]
        targs[0] = targs[0][:, rows].contiguous()
        for t in targs:
            t.requires_grad_(True)
        out = ttb.fused_trajectory_core(*targs, scale, heads, f0=w * n)
        np.testing.assert_allclose(out.detach().numpy(),
                                   whole[:, rows].numpy(), atol=1e-6)
        np.testing.assert_allclose(out.detach().numpy(),
                                   np.asarray(jout)[:, rows], atol=1e-5)
        d = torch.from_numpy(dout[:, rows])
        out.backward(d)
        ref = ttb.trajectory_core_backward_reference(
            *[t.detach() for t in targs], d, scale, heads, f0=w * n)
        np.testing.assert_allclose(targs[0].grad.numpy(),
                                   np.asarray(jgrads[0])[:, rows], atol=1e-4)
        for i, (t, r) in enumerate(zip(targs[1:6], ref[1:6])):
            g = t.grad if t.grad is not None else torch.zeros_like(t)
            np.testing.assert_allclose(g.numpy(), r.numpy(), atol=1e-5)
            summed[i] = summed[i] + g.numpy()
    for i, g in enumerate(summed):
        np.testing.assert_allclose(g, np.asarray(jgrads[i + 1]), atol=1e-4)


def test_window_plan_and_refusals():
    """The launch plan takes a window (S = F' N, F' <= F); a window outside
    the F frames or of part of a frame is refused before any launch, as is
    a window under the forward versions 3, 5, 6 and 7; the window's C
    entry points take f0 as their last int."""
    plan = ttb.trajectory_core_plan(8, 4 * 196, 8, 196, 12)
    assert plan["rows"] == 8 * 4 * 196
    with pytest.raises(ValueError):
        ttb.trajectory_core_plan(8, 9 * 196, 8, 196, 12)
    q = torch.zeros(1, 2 * 4, 128, dtype=torch.bfloat16)
    kf = torch.zeros(1, 4, 4, 128, dtype=torch.bfloat16)
    w, b = torch.zeros(128, 128, dtype=torch.bfloat16), torch.zeros(
        128, dtype=torch.bfloat16)
    for f0 in (3, -1):
        with pytest.raises(ValueError, match="bad shapes"):
            ttb._check_operands(q, kf, kf, w, b, w, 2, f0=f0)
    ttb._check_operands(q, kf, kf, w, b, w, 2, f0=2)
    with pytest.raises(ValueError, match="bad shapes"):
        ttb._check_operands(q[:, :5].contiguous(), kf, kf, w, b, w, 2)
    for version in (3, 5, 6, 7):
        with pytest.raises(NotImplementedError, match="window"):
            ttb.check_window_version(version, q, kf, 2)
    ttb.check_window_version(3, torch.zeros(1, 16, 128), kf, 0)
    for source, symbol in (("trajectory_block.cu", "traj_core_window_bf16"),
                           ("trajectory_block_bwd.cu",
                            "traj_core_bwd_window_bf16")):
        with open(os.path.join(PKG, "csrc", source)) as f:
            text = f.read()
        m = re.search(rf'extern "C" int {symbol}\(([^)]*)\)', text)
        params = [p.strip() for p in m.group(1).split(",")]
        assert params[-3:] == ["int f0", "float scale", "void* stream"]


# ---- remat ------------------------------------------------------------------

def _remat_cfg(remat, scan=True):
    cfg = sc.tiny_cfg(drop_path=0.2)
    cfg.MF.DEPTH, cfg.ORVIT.LAYERS = 12, [1, 6, 10]  # the flagship's layout
    cfg.TPU.REMAT, cfg.TPU.SCAN_LAYERS = remat, scan
    return cfg


def _grads(cfg, monkeypatch):
    """Loss, every gradient, the generator's state after and the
    trajectory-core calls of one train forward and backward."""
    from focus_tpu_torch.models.losses import get_loss_func

    calls = []
    core = motionformer.fused_trajectory_core

    def counted(*a, **k):
        calls.append(1)
        return core(*a, **k)

    monkeypatch.setattr(motionformer, "fused_trajectory_core", counted)
    model = build_model(cfg, device="cpu", seed=0).train()
    gen = torch.Generator().manual_seed(5)
    video, labels, boxes = sc.batch(cfg, 3)
    logits = model(video, {"orvit_bboxes": boxes}, train=True, generator=gen)
    loss = get_loss_func(cfg)(logits, labels)
    loss.backward()
    return (loss.item(), {n: p.grad for n, p in model.named_parameters()},
            gen.get_state(), len(calls))


def test_remat_equals_no_remat(monkeypatch):
    """TPU.REMAT with drop path 0.2 on the flagship's layout (12 blocks,
    ORViT at 1, 6, 10): the same loss, every gradient and the generator's
    state after the step as without it, bit for bit on the CPU; the core
    runs 12 + 7 times (blocks 2-5 and 7-9 recomputed), and 12 without."""
    plain = _grads(_remat_cfg(False), monkeypatch)
    remat = _grads(_remat_cfg(True), monkeypatch)
    assert remat[0] == plain[0]
    for name, g in plain[1].items():  # proj_kv's bias takes none
        assert (remat[1][name] is None if g is None
                else torch.equal(remat[1][name], g)), name
    assert torch.equal(remat[2], plain[2])
    assert (plain[3], remat[3]) == (12, 19)


def test_remat_blocks_are_jax_scanned_segments():
    """The recomputed blocks are those of the JAX model's scanned stacks
    (``blocks_{a}_{b}`` with b > a) under TPU.SCAN_LAYERS, and none
    without it."""
    from focus_tpu.models.build import build_model as jax_build_model

    for scan in (True, False):
        cfg = _remat_cfg(True, scan)
        jcfg = jax_cfg(cfg)
        video, _, boxes = sc.batch(cfg, 0)
        shapes = jax.eval_shape(
            lambda v, b: jax_build_model(jcfg).init(
                jax.random.PRNGKey(0), v, {"orvit_bboxes": b}),
            jnp.asarray(video.numpy()), jnp.asarray(boxes.numpy()))
        want = set()
        for name in shapes["params"]:
            m = re.fullmatch(r"blocks_(\d+)_(\d+)", name)
            if m:
                want.update(range(int(m.group(1)), int(m.group(2)) + 1))
        assert motionformer.remat_blocks(cfg) == frozenset(want)
        assert want == ({2, 3, 4, 5, 7, 8, 9} if scan else set())


# ---- the refusals -----------------------------------------------------------

@pytest.mark.parametrize("opts,error,match", [
    ({"TPU.MESH.SEQ": 2, "TPU.MESH.PIPE": 2}, ValueError,
     "sequence and pipeline"),
    ({"TPU.MESH.SEQ": 2}, ValueError, "not divisible by model axis 1 x seq "
     "axis 2"),
    ({"TPU.MESH.MODEL": 2, "MODEL.MODEL_NAME": "MViT"}, NotImplementedError,
     "MViT"),
    ({"TPU.MESH.SEQ": 2, "MODEL.MODEL_NAME": "SlowFast"},
     NotImplementedError, "SlowFast"),
    ({"TPU.MESH.MODEL": 2, "TPU.MOE.NUM_EXPERTS": 4}, NotImplementedError,
     "TPU.MOE.NUM_EXPERTS 4"),
    ({"TPU.MESH.MODEL": 2, "TPU.INT8_SERVING": True}, NotImplementedError,
     "TPU.INT8_SERVING"),
    ({"TPU.MESH.SEQ": 4}, ValueError, "does not divide MF.TEMPORAL"),
])
def test_mesh_refusals_before_anything_is_built(opts, error, match):
    """What the JAX package's ``build_mesh`` refuses and what the port does
    not run raises from ``check_mesh`` (the model builder's first step) on
    one process."""
    cfg = sc.tiny_cfg()
    for key, value in opts.items():
        *path, name = key.split(".")
        node = cfg
        for part in path:
            node = getattr(node, part)
        setattr(node, name, value)
    with pytest.raises(error, match=match):
        tmesh.check_mesh(cfg)
    with pytest.raises(error, match=match):
        build_model(cfg, device="cpu")
