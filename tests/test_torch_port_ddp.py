"""The port's data parallelism on the CPU: two gloo processes, spawned by
``tools.run_net.launch_job``, each on its slice of the global batch,
against one process on the whole of it (``tests/torch_port_ddp_scenarios.py``
runs the same scenarios in both), and the two-process flagship step
against the JAX package's step on the global batch.

- the tiny flagship's step with mixup / CutMix, stochastic depth and
  TPU.GRAD_ACCUM 2, two steps: float32, losses and parameters within 1e-5;
- the same step without mixup, from the JAX parameters, under
  ``test_torch_port_train.py``'s Nesterov SGD with a global-norm clip,
  against JAX's ``make_supervised_train_step`` at that file's tolerances
  for it (losses 1e-5, parameters 1e-6);
- a tiny Slow R50 under ``batchnorm`` (global batch 4) and
  ``sub_batchnorm`` at NUM_SPLITS 2 (global batch 6, so each process's 3
  rows fall in the splits unevenly): losses, parameters and running
  statistics within 1e-5;
- STEVE's slot step (res18 CNN, the decoder's dropout on): stats within
  1e-6 relative, parameters within 1e-5; its segmentation eval over a
  padded last batch: FG-ARI and mBO within 1e-9;
- the multi-view test: every clip counted once, the meter's predictions
  within 1e-6 and its stats equal; rank 0 alone writes the results;
- preemption: process 1 signals, both stop at the same iteration, rank 0
  writes one checkpoint, and one process resumes it.

The whole set runs once in a module fixture (the processes' start-up is
most of it), while this process computes the one-process and JAX
references.
"""

import os
import pickle
import socket
import threading

import numpy as np
import pytest
import torch

from focus_tpu_torch.config import get_cfg
from focus_tpu_torch.tools.run_net import launch_job
from tests import torch_port_ddp_scenarios as sc

TOL = 1e-5


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _jax_flagship(out_dir):
    """The JAX tiny flagship (the scenarios' config without mixup) and
    its initial parameters, also written as the port's state dict for the
    processes."""
    import jax
    import jax.numpy as jnp

    from focus_tpu.models.build import build_model as jax_build_model
    from focus_tpu.models.build import init_model
    from focus_tpu_torch.entry import example_inputs
    from focus_tpu_torch.utils.weights import jax_params_to_state_dict
    from tests.test_torch_port_train import jax_cfg

    cfg = sc.flagship_cfg(mixup=False)
    cfg.NUM_GPUS = 1
    jcfg = jax_cfg(cfg)
    video, _, boxes = example_inputs(cfg, 2, 0, "cpu", labels=True)
    jmodel = jax_build_model(jcfg)
    params = jax.device_get(init_model(
        jmodel, jcfg, (jnp.asarray(video.numpy()),
                       {"orvit_bboxes": jnp.asarray(boxes.numpy())}),
        rng=jax.random.PRNGKey(0))["params"])
    init = jax_params_to_state_dict(params)
    torch.save(init, os.path.join(out_dir, "jax_init.pt"))
    return {"cfg": cfg, "jcfg": jcfg, "jmodel": jmodel, "params": params,
            "init": init}


def _jax_steps(js, steps=2):
    """JAX's ``make_supervised_train_step`` on the scenarios' global
    batches: each step's loss and the parameters after."""
    import jax
    import jax.numpy as jnp

    from focus_tpu.engine.trainer import _no_wd_paths
    from focus_tpu.engine.trainer import make_supervised_train_step as jmake
    from focus_tpu.models import losses as jlosses
    from focus_tpu.models import optimizer as joptim
    from focus_tpu.parallel import mesh as mesh_lib
    from focus_tpu.parallel.train_state import TrainState
    from focus_tpu_torch.entry import example_inputs
    from focus_tpu_torch.utils.weights import jax_params_to_state_dict

    jcfg = js["jcfg"]
    tx = joptim.construct_optimizer(js["params"], jcfg, 2,
                                    no_weight_decay_paths=_no_wd_paths(jcfg))
    mesh = mesh_lib.build_mesh(jcfg)
    # placed as the step places its output state, so that the second step
    # reuses the first one's compile
    jstate = jax.device_put(TrainState.create(js["params"], tx),
                            mesh_lib.replicated(mesh))
    jstep = jmake(js["jmodel"], jcfg, mesh, jlosses.get_loss_func(jcfg))
    losses = []
    for i in range(steps):
        video, labels, boxes = example_inputs(js["cfg"], sc.GLOBAL_BATCH,
                                              3 + i, "cpu", labels=True)
        jstate, jstats = jstep(
            jstate, jnp.asarray(video.numpy()),
            jnp.asarray(labels.numpy().astype(np.int32)),
            {"orvit_bboxes": jnp.asarray(boxes.numpy())},
            jax.random.PRNGKey(0))
        losses.append(float(jstats["loss"]))
    return {"losses": losses,
            "params": jax_params_to_state_dict(jax.device_get(jstate.params))}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    out = str(tmp_path_factory.mktemp("ddp"))
    jax_side = _jax_flagship(out)
    cfg = get_cfg()
    cfg.NUM_GPUS, cfg.DIST_BACKEND, cfg.OUTPUT_DIR = 2, "gloo", out
    failed, jax_steps = [], {}

    def spawn():
        try:
            launch_job(cfg, f"tcp://localhost:{_free_port()}", sc.run_all,
                       "cpu")
        except Exception as e:  # noqa: BLE001 (raised in the test below)
            failed.append(e)

    def jax_ref():  # XLA's compile runs beside the port's work
        try:
            jax_steps.update(_jax_steps(jax_side))
        except Exception as e:  # noqa: BLE001 (raised in the test below)
            failed.append(e)

    threads_ = [threading.Thread(target=f) for f in (spawn, jax_ref)]
    for t in threads_:
        t.start()
    try:
        one = {
            "flagship": sc.flagship_steps(),
            "flagship_jax": sc.flagship_steps(mixup=False,
                                              init=jax_side["init"]),
            "batchnorm": sc.resnet_steps("batchnorm"),
            "sub_batchnorm": sc.resnet_steps("sub_batchnorm", batch=6),
            "steve": sc.steve_steps(),
            "slot_eval": sc.slot_eval_run(os.path.join(out, "one_slot")),
            "test": sc.multi_view_test(os.path.join(out, "one_test")),
        }
    finally:
        for t in threads_:
            t.join()
        torch.set_num_threads(threads)
    if failed:
        raise failed[0]
    two = [torch.load(os.path.join(out, f"rank{r}.pt"), weights_only=False)
           for r in range(2)]
    return {"out": out, "one": one, "two": two, "jax_steps": jax_steps}


def _close(a, b, tol=TOL, rel=False):
    for k in a:
        x, y = np.asarray(a[k], np.float64), np.asarray(b[k], np.float64)
        scale = np.maximum(np.abs(y), 1.0) if rel else 1.0
        assert np.all(np.abs(x - y) <= tol * scale), (k, x, y)


@pytest.mark.parametrize("case", ["flagship", "batchnorm", "sub_batchnorm",
                                  "steve"])
def test_two_processes_step_as_one(runs, case):
    """Each process's stats and parameters (BatchNorm's running statistics
    among them) equal one process's on the global batch, and the two
    processes hold the same state."""
    one, (r0, r1) = runs["one"][case], runs["two"]
    assert r0["world"] == r1["world"] == 2
    a, b, c = one, r0[case], r1[case]
    key = "stats" if "stats" in a else "losses"
    rel = case == "steve"  # its losses are sums over pixels, ~4e3
    for x, y, z in zip(a[key], b[key], c[key]):
        x, y, z = (v if isinstance(v, dict) else {"loss": v} for v in (x, y, z))
        _close(y, x, 1e-6 if rel else TOL, rel)
        assert y == z
    assert sorted(a["params"]) == sorted(b["params"])
    _close(b["params"], a["params"])
    for k in a["params"]:
        assert torch.equal(b["params"][k], c["params"][k]), k
    # the flagship has no BatchNorm; the others' statistics were compared
    assert any("running_mean" in k for k in a["params"]) == (
        case != "flagship")


def test_two_processes_step_as_jax(runs):
    """The two-process flagship step (TPU.GRAD_ACCUM 2: each process's
    rows a::2, the JAX step's global microbatches; the gradient averaged
    over the processes before the clip) against JAX's
    ``make_supervised_train_step`` on the global batch, two steps."""
    two, ref = runs["two"][0]["flagship_jax"], runs["jax_steps"]
    for stats, loss in zip(two["stats"], ref["losses"]):
        np.testing.assert_allclose(stats["loss"], loss, atol=1e-5)
    assert sorted(ref["params"]) == sorted(two["params"])
    for name, p in two["params"].items():
        np.testing.assert_allclose(p.numpy(), ref["params"][name].numpy(),
                                   atol=1e-6, err_msg=name)
    # and the one-process port from the same weights agrees
    _close(two["params"], runs["one"]["flagship_jax"]["params"])


def test_two_process_test_counts_every_clip_once(runs):
    """The multi-view test at global batch 6 over 16 clips (the last batch
    4 real rows and 2 repeats, 3 on each process): each video's one clip
    counted once, the predictions and stats one process's; the results
    file is rank 0's alone."""
    one = runs["one"]["test"]
    for r in runs["two"]:
        t = r["test"]
        assert t["counts"].tolist() == [1] * 16
        assert t["stats"] == one["stats"]
        np.testing.assert_allclose(t["preds"], one["preds"], atol=1e-6)
        assert np.array_equal(t["labels"], one["labels"])
    with open(os.path.join(runs["out"], "test", "results.pkl"), "rb") as f:
        preds, labels = pickle.load(f)
    np.testing.assert_allclose(preds, one["preds"], atol=1e-6)


def test_two_process_slot_eval_scores_every_clip_once(runs):
    """STEVE's segmentation eval at global batch 6 over 16 clips: each
    batch's FG-ARI and mBO (the slot noise drawn for the batch's clips that
    are not repeats, each process keeping its rows'), the results and the
    clips equal one process's within 1e-9."""
    one = runs["one"]["slot_eval"]
    for r in runs["two"]:
        got = r["slot_eval"]
        assert got["clips"] == one["clips"] == 16
        _close({k: got[k] for k in ("fg_aris", "mbos")},
               {k: one[k] for k in ("fg_aris", "mbos")}, 1e-9)
        _close(got["results"], one["results"], 1e-9)


def test_preemption_agrees_across_processes(runs):
    """Process 1 asks for preemption after step 3 (polled every 2): both
    stop after step 4 and exit 0, rank 0 writes the in-progress epoch's
    one checkpoint, and one process resumes it at step 4."""
    from focus_tpu_torch.engine import trainer
    from focus_tpu_torch.utils import checkpoint as cu

    for r in runs["two"]:
        assert r["preempt"] == {"exit": 0, "step": 4}
    job = os.path.join(runs["out"], "preempt")
    files = sorted(os.listdir(os.path.join(job, "checkpoints")))
    assert files == ["checkpoint_epoch_00000.pyth"]
    cfg = sc.mf_cfg(job)
    cfg.TEST.ENABLE = False
    cfg.TRAIN.AUTO_RESUME = True
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        run = trainer.run_train(cfg, device="cpu")
    finally:
        torch.set_num_threads(threads)
    assert run.checkpoint["kind"] == "resume" and run.start_epoch == 0
    assert run.state.step == 4 + 8
    assert cu.get_last_checkpoint(job).endswith("checkpoint_epoch_00001.pyth")


def test_launch_job_counts_the_devices_there_are():
    """``NUM_GPUS`` processes a host, no more than the devices there are:
    on the CPU one under NCCL (no CPU collectives) and any number under
    gloo; on CUDA the cards present, one where there is none (which then
    raises where it runs). One process in all is a direct call."""
    from focus_tpu_torch.parallel import mesh

    cfg = get_cfg()
    cfg.NUM_GPUS = 4
    assert mesh.local_processes(cfg, "cpu") == 1  # DIST_BACKEND nccl
    cfg.DIST_BACKEND = "gloo"
    assert mesh.local_processes(cfg, "cpu") == 4
    cfg.NUM_GPUS = 0
    assert mesh.local_processes(cfg, "cpu") == 1
    cfg.NUM_GPUS = 8
    have = torch.cuda.device_count()
    assert mesh.local_processes(cfg, "cuda") == max(min(8, have), 1)
    cfg.NUM_GPUS, cfg.DIST_BACKEND = 3, "nccl"
    assert launch_job(cfg, None, lambda c, device: (c.NUM_GPUS, device),
                      "cpu") == (3, "cpu")
    # without a process group every collective leaves its tensor as it is
    t = torch.arange(6.0).view(3, 2)
    assert not mesh.is_distributed() and mesh.world_size() == 1
    assert mesh.all_gather_tiled(t) is t and mesh.all_reduce_sum(t) is t
    assert mesh.all_reduce_(t) is t and mesh.any_process(True)
    assert mesh.from_mirror(t) is t
    assert mesh.batch_rows(3) == (0, 3, 3)


@pytest.mark.parametrize("draw", ["uniform", "normal", "exponential"])
def test_sharded_draws_keep_the_rows_of_the_whole_batch(draw):
    """Inside ``sharded_draws(first, rows, total)`` a draw over this
    process's rows (one a row, several a row, or a microbatch's share) is
    the matching rows of the same draw over the whole batch, and the
    generator ends where the whole draw leaves it; a draw that does not
    run over the rows is refused, unless this process holds them all."""
    from focus_tpu_torch.models import common

    fn = getattr(common, draw)
    for first, rows, total, n in ((2, 2, 6, 2), (4, 2, 6, 6), (3, 3, 6, 1)):
        g1, g2 = torch.Generator().manual_seed(7), torch.Generator()
        g2.manual_seed(7)
        whole = fn((n * total // rows, 5), g1, "cpu")
        with common.sharded_draws(first, rows, total):
            part = fn((n, 5), g2, "cpu")
        start = n * first // rows
        assert torch.equal(part, whole[start:start + n])
        assert torch.equal(fn((3,), g1, "cpu"), fn((3,), g2, "cpu"))
    with common.sharded_draws(0, 4, 8), pytest.raises(ValueError):
        fn((3, 5), torch.Generator(), "cpu")
    # one process holds the whole batch: every draw is made as outside
    with common.sharded_draws(0, 4, 4):
        part = fn((3, 5), torch.Generator().manual_seed(7), "cpu")
    assert torch.equal(part, fn((3, 5), torch.Generator().manual_seed(7),
                                "cpu"))
