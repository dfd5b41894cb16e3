"""The port's pipeline and expert parallelism on the CPU
(``focus_tpu_torch/parallel/``, ``models/motionformer.py``,
``models/moe.py``, ``models/optimizer.py``), float32, on the MoE yaml's
tiny model (D=24, 2 heads, F=2, 2 experts over 4 blocks, 2 microbatches):

- the placement: every parameter on the pipe stage and expert shard that
  JAX's ``state_shardings`` gives its path at PIPE 2 x EXPERT 2, and no
  other;
- one spawn of four gloo processes (``tools.run_net.launch_job`` running
  ``tests/torch_port_pp_ep_scenarios.run_all``) while this process computes
  the one-process and JAX references (each JAX mesh step in a thread of its
  own): PIPE 2 x EXPERT 2, DATA 2 x PIPE 2
  (one microbatch, which JAX's grouping of the load-balance term spreads
  over both data ranks) and the MoE model on the data axis alone (DATA 4)
  against JAX's ``make_supervised_train_step`` on the (1, 2, 1, 1, 2), (2,
  2, 1, 1, 1) and (4, 1, 1, 1, 1) meshes of four virtual devices, and
  against the port's one-process (pipelined) model; DATA 2 x EXPERT 2
  under ZeRO-1 and two accumulation microbatches against one process, and
  its checkpoint resumed in one process;
- on one process: drop path 0.2 and remat under the pipelined model
  against PIPE 1 and no remat, the ORViT-MF segments against the JAX
  package's, and the refusals.

Drop path is off against JAX: the two packages draw their masks apart.
Each test runs at one torch thread."""

import functools
import os
import socket
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from focus_tpu_torch.config import get_cfg
from focus_tpu_torch.models.build import build_model
from focus_tpu_torch.parallel import mesh as tmesh
from focus_tpu_torch.parallel import pipeline, tensor
from focus_tpu_torch.tools.run_net import launch_job
from focus_tpu_torch.utils.weights import jax_params_to_state_dict

from tests import torch_port_pp_ep_scenarios as sc
from tests.test_torch_port_train import jax_cfg

TOL = 1e-5
LR_SUM = 2 * 5e-5  # the two steps' LR (the yaml's base LR in epoch 0)


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


def _whole(cfg, seed=0):
    """``cfg``'s model built whole in this process (every stage and
    expert)."""
    with tmesh.single_process_mesh():
        return build_model(cfg, device="cpu", seed=seed)


@functools.lru_cache(maxsize=None)
def _init():
    """The port's seeded init of the tiny model (a full state dict) and
    the same weights as JAX params in the scanned layout, carried over by
    the JAX package's own importer onto the model's ``eval_shape`` (no
    init compile)."""
    from focus_tpu.models.build import build_model as jax_build_model
    from focus_tpu.utils.torch_import import import_torch_params

    cfg = sc.tiny_cfg()
    init = tensor.full_state_dict(_whole(cfg))
    jmodel = jax_build_model(jax_cfg(cfg))
    video, _, _ = sc.batch(cfg, 0)
    shapes = jax.eval_shape(lambda: jmodel.init(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
        jnp.asarray(video.numpy()[:1]), {}))["params"]
    template = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype),
                                      shapes)
    params, _ = import_torch_params({k: v.numpy() for k, v in init.items()},
                                    template, allow_missing=False)
    return init, params


# ---- the placement ----------------------------------------------------------

def _split_dims(t):
    """The dims along which ``t`` is not constant."""
    return [d for d in range(t.ndim)
            if (t - t.narrow(d, 0, 1)).abs().max() > 0]


def test_placement_matches_state_shardings():
    """A probe leaf that counts 1, 2 along the pipe axis of its JAX spec
    (``state_shardings`` on a (1, 2, 1, 1, 2) mesh, the pipelined layout)
    and 100, 200 along the expert axis, carried through the bridge: a
    port block holds the stage its probe names (``pipeline.stage_of``,
    none for a replicated leaf) and a leaf varies along the dim
    ``expert_dim`` splits, for every parameter; every block is a stage
    block and the four expert leaves of each are split."""
    from focus_tpu.parallel import mesh as jmesh
    from focus_tpu.parallel import pipeline as jpipe

    _, params = _init()
    cfg = sc.tiny_cfg(pipe=2, expert=2)
    jcfg = jax_cfg(cfg)
    jcfg.NUM_GPUS = 4
    piped = jpipe.to_pipelined(params, stages=2)
    specs = jmesh.state_shardings(
        jmesh.build_mesh(jcfg, devices=jax.devices()[:4]), piped)

    def probe(leaf, sharding):
        out = np.zeros(leaf.shape, np.float32)
        for axis, scale in (("pipe", 1), ("expert", 100)):
            dims = [i for i, a in enumerate(sharding.spec) if a == axis]
            if dims:
                shape = [1] * leaf.ndim
                shape[dims[0]] = leaf.shape[dims[0]]
                out += scale * (np.arange(leaf.shape[dims[0]]).reshape(shape)
                                + 1)
        return out

    probes = jax_params_to_state_dict(jax.tree_util.tree_map(
        probe, piped, specs))
    model = _whole(cfg)
    segs = pipeline.segments(cfg)
    assert segs == [(0, 4)]
    staged = split = 0
    for name, p in model.named_parameters():
        t = probes[name]
        stage = int(t.min().item()) % 100 - 1
        block = pipeline.block_of(name)
        want = None if block is None else pipeline.stage_of(segs, 2, block)
        assert (None if stage < 0 else stage) == want, name
        ed = tensor.expert_dim(name, p.shape, 2)
        assert _split_dims(t) == ([] if ed is None else [ed]), name
        staged += want is not None
        split += ed is not None
    assert split == 4 * 4
    assert staged == sum(1 for n, _ in model.named_parameters()
                         if n.startswith("blocks."))


# ---- the mesh: one spawn of four processes ----------------------------------

def _jax_mesh_run(kw, params):
    """JAX's supervised train step (AdamW) on a mesh of four virtual
    devices with ``tiny_cfg(**kw)``'s axes (DATA the rest), from ``params``
    (converted to the pipelined layout under PIPE): each step's stats and
    the parameters after."""
    from focus_tpu.engine.trainer import _no_wd_paths
    from focus_tpu.engine.trainer import make_supervised_train_step as jmake
    from focus_tpu.models import losses as jlosses
    from focus_tpu.models import optimizer as joptim
    from focus_tpu.models.build import build_model as jax_build_model
    from focus_tpu.parallel import mesh as jmesh
    from focus_tpu.parallel import pipeline as jpipe
    from focus_tpu.parallel.train_state import TrainState

    cfg = sc.tiny_cfg(**kw)
    jcfg = jax_cfg(cfg)
    jcfg.NUM_GPUS = 4
    if kw.get("pipe", 1) > 1:
        params = jpipe.to_pipelined(params, stages=kw["pipe"])
    mesh = jmesh.build_mesh(jcfg, devices=jax.devices()[:4])
    tx = joptim.construct_optimizer(params, jcfg, 2,
                                    no_weight_decay_paths=_no_wd_paths(jcfg))
    state = TrainState.create(params, tx)
    sharding = jmesh.state_shardings(mesh, state)
    state = jax.device_put(state, sharding)
    step = jmake(jax_build_model(jcfg), jcfg, mesh,
                 jlosses.get_loss_func(jcfg), state_sharding=sharding)
    stats = []
    for seed in sc.SEEDS:
        video, labels, _ = sc.batch(cfg, seed)
        sharded = jmesh.shard_batch(mesh, (
            video.numpy(), labels.numpy().astype(np.int32), {}))
        state, st = step(state, *sharded, jax.random.PRNGKey(0))
        stats.append({k: float(v) for k, v in st.items()})
    return {"stats": stats, "mesh": dict(mesh.shape),
            "params": jax_params_to_state_dict(jax.device_get(state.params))}


JAX_CASES = ("pp_ep", "dp_pp", "dp_moe")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    out = str(tmp_path_factory.mktemp("pp_ep"))
    init, params = _init()
    torch.save(init, os.path.join(out, "jax_init.pt"))
    cfg = get_cfg()
    cfg.NUM_GPUS, cfg.DIST_BACKEND, cfg.OUTPUT_DIR = 4, "gloo", out
    failed, jax_side = [], {}
    kwargs = {name: kw for name, kw, _, _ in sc.SCENARIOS}

    def spawn():
        try:
            launch_job(cfg, f"tcp://localhost:{_free_port()}", sc.run_all,
                       "cpu")
        except Exception as e:  # noqa: BLE001 (raised in the tests below)
            failed.append(e)

    def jax_ref(name):  # XLA's compiles run beside the port's work
        try:
            jax_side[name] = _jax_mesh_run(kwargs[name], params)
        except Exception as e:  # noqa: BLE001 (raised in the tests below)
            failed.append(e)

    workers = [threading.Thread(target=spawn)] + [
        threading.Thread(target=jax_ref, args=(name,)) for name in JAX_CASES]
    for t in workers:
        t.start()
    try:
        one = {name: sc.run_steps(sc.tiny_cfg(**kw), init if from_jax
                                  else None)
               for name, kw, from_jax, _ in sc.SCENARIOS}
        # the reference that plays DATA 2 too: microbatches of a mesh
        # rank's rows
        one["dp_pp_virtual"] = sc.run_steps(
            sc.tiny_cfg(**kwargs["dp_pp"]), init, virtual=2)
    finally:
        for t in workers:
            t.join()
        torch.set_num_threads(threads)
    if failed:
        raise failed[0]
    mesh_ranks = [torch.load(os.path.join(out, f"rank{r}.pt"),
                             weights_only=False) for r in range(4)]
    return {"one": one, "mesh": mesh_ranks, "jax": jax_side, "init": init}


def _params_close(got, want):
    """Every parameter within TOL, at most 1 element in 10^4 past it
    (Adam divides each gradient element by its own magnitude: an element
    whose gradient is rounding alone may step apart;
    test_torch_port_train's rule) and none by more than the two steps'
    LR."""
    off = total = 0
    for name, w in want.items():
        diff = (got[name] - w).abs()
        off, total = off + int((diff > TOL).sum()), total + diff.numel()
        assert diff.max() <= LR_SUM, name
    assert off <= total // 10000


@pytest.mark.parametrize("case", [name for name, _, _, _ in sc.SCENARIOS])
def test_mesh_steps_as_one_process(runs, case):
    """PIPE 2 x EXPERT 2, DATA 2 x PIPE 2, DATA 4 and DATA 2 x EXPERT 2
    (ZeRO-1, GRAD_ACCUM 2), each on four processes, against the one-process
    model (pipelined where the mesh has a pipe axis) on the same global
    batches: the loss, moe_aux and errors within 1e-5, every parameter
    (gathered to its full shape and every stage's) as ``_params_close``
    holds them, the optimizer's state in the one-process form within 1e-5,
    the generator, the global norm of the last reduced gradients (the
    clip's: a stage leaf's squares summed over the pipe line, an expert
    leaf's over the expert line, a replicated one counted once) within
    1e-5 relative and the eval probabilities; every rank holds the same (a
    replicated leaf's update is the same on every pipe and expert rank)."""
    one = runs["one"][case]
    for rank in runs["mesh"]:
        got = rank[case]
        for a, b in zip(got["stats"], one["stats"]):
            assert sorted(a) == sorted(b)
            for k in a:
                assert abs(a[k] - b[k]) <= TOL, k
        assert sorted(got["params"]) == sorted(one["params"])
        _params_close(got["params"], one["params"])
        ga, oa = got["optimizer"]["state"], one["optimizer"]["state"]
        assert sorted(ga) == sorted(oa)
        assert [g["params"] for g in got["optimizer"]["param_groups"]] == [
            g["params"] for g in one["optimizer"]["param_groups"]]
        for i in oa:
            for k, v in oa[i].items():
                assert torch.allclose(ga[i][k].float(), v.float(), atol=TOL), k
        assert torch.equal(got["generator"], one["generator"])
        assert abs(got["grad_norm"] - one["grad_norm"]) <= TOL * one[
            "grad_norm"]
        assert torch.allclose(got["probs"], one["probs"], atol=TOL)
    first = runs["mesh"][0][case]["params"]
    for rank in runs["mesh"][1:]:
        for k, v in first.items():
            assert torch.equal(rank[case]["params"][k], v), k


def test_mesh_steps_as_the_reference_playing_its_data_ranks(runs):
    """DATA 2 x PIPE 2 on four processes against one process that plays
    both data ranks (``single_process_mesh(2)``: its batch cut into the
    two ranks' microbatches, one JAX microbatch over both): each step's
    stats within 1e-5, every parameter as ``_params_close`` holds them,
    the generator, the reference's aux the plain one-process model's."""
    ref, plain = runs["one"]["dp_pp_virtual"], runs["one"]["dp_pp"]
    got = runs["mesh"][0]["dp_pp"]
    for a, b, c in zip(got["stats"], ref["stats"], plain["stats"]):
        for k in a:
            assert abs(a[k] - b[k]) <= TOL, k
        assert abs(b["moe_aux"] - c["moe_aux"]) <= 1e-6
    _params_close(got["params"], ref["params"])
    assert torch.equal(got["generator"], ref["generator"])


@pytest.mark.parametrize("case", JAX_CASES)
def test_mesh_steps_as_jax_mesh(runs, case):
    """On four processes against JAX's ``make_supervised_train_step`` on
    the same mesh of four virtual devices, from the same parameters and
    batches: each step's loss within 1e-5 and moe_aux within 1e-6, then
    every parameter as ``test_torch_port_moe.py`` holds them (1e-6, at
    most 1 element in 10^4 past it, none by more than the sum of the
    LRs)."""
    ref = runs["jax"][case]
    want = {"pp_ep": {"data": 1, "pipe": 2, "expert": 2},
            "dp_pp": {"data": 2, "pipe": 2, "expert": 1},
            "dp_moe": {"data": 4, "pipe": 1, "expert": 1}}[case]
    assert {k: ref["mesh"][k] for k in want} == want
    got = runs["mesh"][0][case]
    for a, b in zip(got["stats"], ref["stats"]):
        assert abs(a["loss"] - b["loss"]) <= 1e-5
        assert abs(a["moe_aux"] - b["moe_aux"]) <= 1e-6
    off = total = 0
    for name, w in ref["params"].items():
        diff = (got["params"][name] - w).abs()
        off, total = off + int((diff > 1e-6).sum()), total + diff.numel()
        assert diff.max() <= LR_SUM, name
    assert off <= total // 10000


def test_mesh_cuts_the_stage_and_expert_bytes(runs):
    """Per rank at PIPE 2 x EXPERT 2 the parameter bytes are the whole
    model's less half of the stage blocks' and a quarter more of the
    expert leaves' (half of each stage's experts); under ZeRO-1 over DATA
    2 x EXPERT 2 the moments are those of half of each group's (expert
    rank's) parameters, up to a group's padding."""
    model = _whole(sc.tiny_cfg())
    full = {n: p.numel() * 4 for n, p in model.named_parameters()}
    blocks = sum(b for n, b in full.items() if n.startswith("blocks."))
    experts = sum(b for n, b in full.items()
                  if tensor.expert_dim(n, model.get_parameter(n).shape, 2)
                  is not None)
    whole = sum(full.values())
    for rank in runs["mesh"]:
        got = rank["pp_ep"]["bytes"]
        assert got["param_bytes"] == whole - blocks // 2 - experts // 4
        assert got["optimizer_bytes"] >= 2 * got["param_bytes"]
        local = rank["dp_ep"]["bytes"]["param_bytes"]
        assert local == whole - experts // 2
        groups = len(rank["dp_ep"]["optimizer"]["param_groups"])
        moments = rank["dp_ep"]["bytes"]["optimizer_bytes"]
        assert local <= moments <= local + groups * (4 + 2 * 4)


def test_zero1_expert_checkpoint_resumes_in_one_process(runs):
    """The train checkpoint the four processes write (DATA 2 x EXPERT 2,
    ZeRO-1) holds the bridge's full names and shapes and the one-process
    optimizer's state: it loads into a one-process state, whose weights,
    moments, step and generator are the one-process run's."""
    from focus_tpu_torch.engine.trainer import build_supervised_state
    from focus_tpu_torch.utils import checkpoint as cu

    path = runs["mesh"][0]["dp_ep"]["checkpoint"]
    assert path and os.path.exists(path)
    assert all(r["dp_ep"]["checkpoint"] is None for r in runs["mesh"][1:])
    cfg = sc.tiny_cfg(expert=2, zero1=True, accum=2)
    model = _whole(cfg)
    with tmesh.single_process_mesh():
        state = build_supervised_state(cfg, model, 2)
    assert cu.load_train_state(path, state) == 1
    one = runs["one"]["dp_ep"]
    _params_close({n: p.detach() for n, p in model.named_parameters()},
                  one["params"])
    got = state.optimizer.state_dict()["state"]
    for i, st in one["optimizer"]["state"].items():
        for k, v in st.items():
            assert torch.allclose(got[i][k].float(), v.float(), atol=TOL), k
    assert state.step == 2
    assert torch.equal(state.generator.get_state(), one["generator"])


# ---- one process --------------------------------------------------------------

def _train_forward(cfg, video, labels, remat=False, seed=0):
    """One train-mode forward and backward of ``cfg``'s whole model from
    the seeded init (drop path drawn from a generator seeded 1): the
    loss, every gradient and the generator's state after."""
    from focus_tpu_torch.models.losses import get_loss_func

    cfg = cfg.clone()
    cfg.TPU.REMAT = remat
    model = _whole(cfg, seed)
    gen = torch.Generator().manual_seed(1)
    logits = model(video, train=True, generator=gen)
    loss = get_loss_func(cfg)(logits, labels)
    loss.backward()
    return loss.detach(), {n: p.grad for n, p in model.named_parameters()}, \
        gen.get_state()


@pytest.mark.parametrize("remat", [False, True])
def test_pipelined_drop_path_and_remat_as_plain(remat):
    """Drop path 0.2 on the pipelined model (PIPE 2, 2 microbatches, in
    one process; ``remat`` also under TPU.REMAT) against PIPE 1 without
    remat, on the tiny model without experts (the pipeline regroups the
    MoE load-balance term): the loss and every gradient within 1e-6, the
    generator's state equal."""
    base = sc.tiny_cfg(drop_path=0.2)
    base.TPU.MOE.NUM_EXPERTS = 0
    video, labels, _ = sc.batch(base, 3)
    piped = base.clone()
    piped.TPU.MESH.PIPE = 2
    loss0, grads0, gen0 = _train_forward(base, video, labels)
    loss1, grads1, gen1 = _train_forward(piped, video, labels, remat)
    assert abs(loss0 - loss1) <= 1e-6
    for name, g in grads0.items():
        if g is None:  # proj_kv's bias: the fused core reads no bias of it
            assert grads1[name] is None, name
            continue
        assert torch.allclose(grads1[name], g, atol=1e-6), name
    assert torch.equal(gen0, gen1)


def test_orvit_mf_segments_match_jax():
    """The tiny ORViT-MF of depth 6 with ORViT at block 1 under PIPE 2:
    the JAX model pipelines ``blocks_2_5`` alone (its ``eval_shape``'s
    params), the port's segments are [(2, 6)] and its one-process
    pipelined eval forward equals its PIPE 1 forward within 1e-6
    (microbatching changes no prediction)."""
    from focus_tpu.models.build import build_model as jax_build_model

    cfg = sc.tiny_cfg(pipe=2, orvit=True)
    video, _, boxes = sc.batch(cfg, 3)
    jmodel = jax_build_model(jax_cfg(cfg))
    shapes = jax.eval_shape(lambda: jmodel.init(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
        jnp.asarray(video.numpy()), {"orvit_bboxes": jnp.asarray(
            boxes.numpy())}))["params"]
    piped = sorted(k for k, v in shapes.items()
                   if isinstance(v, dict) and "ticks" in v)
    assert piped == ["blocks_2_5"]
    assert pipeline.segments(cfg) == [(2, 6)]
    plain = cfg.clone()
    plain.TPU.MESH.PIPE = 1
    meta = {"orvit_bboxes": boxes}
    with torch.no_grad():
        want = build_model(plain, device="cpu")(video, meta)
        got = _whole(cfg)(video, meta)
    assert torch.allclose(got, want, atol=1e-6)


@pytest.mark.parametrize("opts,error,match", [
    ({"TPU.MESH.PIPE": 2, "ORVIT.LAYERS": [1], "MF.DEPTH": 3}, ValueError,
     "nothing would be pipelined"),
    ({"TPU.MESH.PIPE": 2, "TPU.MESH.MODEL": 2}, NotImplementedError,
     "TPU.MESH.PIPE 2 with TPU.MESH.MODEL 2"),
    ({"TPU.MESH.EXPERT": 2, "MODEL.MODEL_NAME": "MViT"},
     NotImplementedError, "MViT"),
    ({"TPU.MESH.PIPE": 2, "TPU.MESH.PIPE_MICROBATCHES": 3}, ValueError,
     "batch 4 not divisible by 3 pipeline microbatches"),
    ({"TPU.MESH.PIPE": 2, "TRAIN.BATCH_SIZE": 2}, ValueError,
     "batch 2 not divisible by TPU.MESH.DATA 4 x TPU.MESH.PIPE_MICROBATCHES"
     " 2"),
])
def test_refusals_before_anything_is_built(opts, error, match):
    """Defect 3 (PIPE 2 where no run of trajectory blocks divides by it),
    PIPE with MODEL, EXPERT on MViT and the microbatch refusals (JAX's,
    where M does not divide the batch, and the port's, where DATA x M does
    not: a world of 8 at PIPE 2) raise from ``check_mesh``, the model
    builder's first step."""
    cfg = sc.tiny_cfg()
    for key, value in opts.items():
        *path, name = key.split(".")
        node = cfg
        for part in path:
            node = getattr(node, part)
        setattr(node, name, value)
    world = 8 if "TRAIN.BATCH_SIZE" in opts else 4
    with pytest.raises(error, match=match):
        tmesh.check_mesh(cfg, world=world)
    if world == 4:
        with pytest.raises(error, match=match):
            _whole(cfg)
