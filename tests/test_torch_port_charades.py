"""The port's multi-label and image data against the JAX package's on the
CPU: ``load_image_lists``, ``Charades``, ``Imagenet`` and ``Cholec80`` on
trees written under ``tmp_path`` (bit-equal: host numpy and PIL in both
packages), the pytorchvideo aliases, ``mean_ap`` in numpy against the JAX
package's scikit-learn one and the multi-label ``TestMeter`` (within
1e-10), one SlowFast ``bce_logit`` step on multi-hot labels (float64, as
``test_torch_port_resnet_train.py`` compares SlowFast steps: the loss,
running statistics and parameters within 1e-5 of JAX's, of each tensor's
largest value), multi-label validation, which the JAX package's
``eval_epoch`` cannot run, and the Charades SlowFast yaml through
``focus_tpu_torch.tools.run_net``.

The train modes draw from an unseeded ``RandomState(None)``, as the JAX
package's do; these tests alone seed it, in both packages at once."""

import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from focus_tpu_torch.config import get_cfg
from focus_tpu_torch.datasets.build import build_dataset
from focus_tpu_torch.utils import meters, metrics
from test_torch_port_datasets import assert_same
from torch_port_trees import jax_cfg_like

Image = pytest.importorskip("PIL.Image")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEP_RTOL = 1e-5  # test_torch_port_trainer.py's step tolerance
MAP_ATOL = 1e-10


@pytest.fixture(autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


class _SeededRandomState(np.random.RandomState):
    def __init__(self, seed=None):
        super().__init__(99 if seed is None else seed)


def _jpeg(path, rs, h, w):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    Image.fromarray(rs.randint(0, 256, (h, w, 3)).astype(np.uint8)).save(
        path, quality=90)


def make_charades_tree(root, videos=3, frames=14, classes=6):
    """Charades frame JPEGs (24 x 32) and train / val frame lists: a
    header, then ``original_vido_id video_id frame_id path labels`` rows,
    each frame's labels a quoted comma list or ``""``."""
    rs = np.random.RandomState(0)
    for split in ("train", "val"):
        rows = ["original_vido_id video_id frame_id path labels"]
        for v in range(videos):
            name = f"{split}{v}"
            for f in range(frames + v):
                rel = f"{name}/{name}-{f + 1:06d}.jpg"
                _jpeg(os.path.join(root, "frames", rel), rs, 24, 32)
                labs = sorted(set(rs.randint(0, classes, rs.randint(0, 3))))
                text = '"' + ",".join(map(str, labs)) + '"' if labs else '""'
                rows.append(f"{name} {v} {f} {rel} {text}")
        with open(os.path.join(root, f"{split}.csv"), "w") as fh:
            fh.write("\n".join(rows) + "\n")


@pytest.fixture(scope="module")
def charades(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("charades"))
    make_charades_tree(root)
    return root


def charades_cfg(root):
    cfg = get_cfg()
    cfg.DATA.PATH_TO_DATA_DIR = root
    cfg.DATA.PATH_PREFIX = os.path.join(root, "frames")
    cfg.DATA.NUM_FRAMES = 8
    cfg.DATA.SAMPLING_RATE = 2
    cfg.DATA.TRAIN_JITTER_SCALES = [26, 34]
    cfg.DATA.TRAIN_CROP_SIZE = 20
    cfg.DATA.TEST_CROP_SIZE = 24
    cfg.DATA.MULTI_LABEL = True
    cfg.DATA.INV_UNIFORM_SAMPLE = True
    cfg.DATA.REVERSE_INPUT_CHANNEL = True
    cfg.MODEL.ARCH = "slowfast"
    cfg.MODEL.NUM_CLASSES = 6
    cfg.SLOWFAST.ALPHA = 4
    cfg.TEST.NUM_ENSEMBLE_VIEWS = 3
    cfg.TEST.NUM_SPATIAL_CROPS = 3
    return cfg


def test_load_image_lists_matches_jax(charades):
    from focus_tpu.datasets.charades import load_image_lists as jax_lists
    from focus_tpu_torch.datasets.charades import load_image_lists

    for split in ("train", "val"):
        csv = os.path.join(charades, f"{split}.csv")
        got = load_image_lists(csv, prefix="p")
        assert got == jax_lists(csv, prefix="p")
        assert [len(v) for v in got[0]] == [14, 15, 16]
        assert any(lab == [] for v in got[1] for lab in v)


@pytest.mark.parametrize("mode,device_preprocess", [
    ("train", True), ("val", True), ("test", True), ("train", False)])
def test_charades_items_match_jax(charades, monkeypatch, mode,
                                  device_preprocess):
    """Every ``Charades`` item bit-equal to JAX's: SlowFast pathways (BGR
    order), the inverse-uniform scale jitter, the multi-hot label over the
    sampled frames (video-level outside train), the 3 x 3 test views;
    uint8 frames, and float frames normalised on the host."""
    from focus_tpu.datasets.charades import Charades as JaxCharades
    from focus_tpu_torch.datasets.charades import Charades

    monkeypatch.setattr(np.random, "RandomState", _SeededRandomState)
    cfg = charades_cfg(charades)
    cfg.TPU.DEVICE_PREPROCESS = device_preprocess
    port, ref = Charades(cfg, mode), JaxCharades(jax_cfg_like(cfg), mode)
    assert len(port) == len(ref) == 3 * (9 if mode == "test" else 1)
    for i in range(len(port)):
        got = port[i]
        assert_same(got, ref[i])
        assert got[1].shape == (6,) and got[1].dtype == np.int32
    if mode == "test":  # a test video's views share its video-level label
        assert_same(port[0][1], port[8][1])


@pytest.mark.parametrize("mode", ["train", "val", "test"])
def test_imagenet_items_match_jax(tmp_path, monkeypatch, mode):
    """``Imagenet`` items bit-equal to JAX's: root/<split>/<class>/ images
    of three sizes, the train jitter and crop, the centre crop of val (and
    of test, which reads val)."""
    from focus_tpu.datasets.charades import Imagenet as JaxImagenet
    from focus_tpu_torch.datasets.charades import Imagenet

    monkeypatch.setattr(np.random, "RandomState", _SeededRandomState)
    rs = np.random.RandomState(1)
    for split in ("train", "val"):
        for c, (h, w) in enumerate([(30, 40), (44, 33), (36, 36)]):
            _jpeg(os.path.join(str(tmp_path), split, f"n0{c}", "a.JPEG"),
                  rs, h, w)
            _jpeg(os.path.join(str(tmp_path), split, f"n0{c}", "b.JPEG"),
                  rs, w, h)
    cfg = get_cfg()
    cfg.DATA.PATH_TO_DATA_DIR = str(tmp_path)
    cfg.DATA.TRAIN_JITTER_SCALES = [28, 36]
    cfg.DATA.TRAIN_CROP_SIZE = cfg.DATA.TEST_CROP_SIZE = 24
    port, ref = Imagenet(cfg, mode), JaxImagenet(jax_cfg_like(cfg), mode)
    assert len(port) == len(ref) == 6
    for i in range(6):
        got = port[i]
        assert_same(got, ref[i])
        assert got[0].shape == (24, 24, 3) and got[1] == i // 2


@pytest.mark.parametrize("mode", ["train", "val", "test"])
def test_cholec80_items_match_jax(tmp_path, monkeypatch, mode):
    """``Cholec80`` bit-equal to JAX's on a pickle of two videos' records
    written under ``tmp_path``: the NUM_FRAMES records from the indexed
    frame backwards, front-padded with the first of them, the last
    record's phase."""
    from focus_tpu.datasets.cholec80 import Cholec80 as JaxCholec80
    from focus_tpu_torch.datasets.cholec80 import Cholec80

    monkeypatch.setattr(np.random, "RandomState", _SeededRandomState)
    rs = np.random.RandomState(2)
    frames_root = os.path.join(str(tmp_path), "frames")
    data = {}
    for v, n in (("video01", 5), ("video02", 3)):
        data[v] = [{"Frame_id": 25 * k, "Phase_gt": (k + len(v)) % 7,
                    "unique_id": f"{v}_{k}"} for k in range(n)]
        for rec in data[v]:
            _jpeg(os.path.join(frames_root, v, f"{rec['Frame_id']}.jpg"),
                  rs, 30, 38)
    cfg = get_cfg()
    cfg.CHOLEC.PATH = str(tmp_path / "labels")
    os.makedirs(os.path.join(cfg.CHOLEC.PATH, mode))
    pkl = {"train": cfg.CHOLEC.TRAIN_PKL, "val": cfg.CHOLEC.VAL_PKL,
           "test": cfg.CHOLEC.TEST_PKL}[mode]
    with open(os.path.join(cfg.CHOLEC.PATH, mode, pkl), "wb") as f:
        pickle.dump(data, f)
    cfg.DATA.PATH_PREFIX = frames_root
    cfg.DATA.NUM_FRAMES = 4
    cfg.DATA.TRAIN_JITTER_SCALES = [30, 36]
    cfg.DATA.TRAIN_CROP_SIZE = cfg.DATA.TEST_CROP_SIZE = 28
    cfg.MODEL.ARCH = "slow"
    port, ref = Cholec80(cfg, mode), JaxCholec80(jax_cfg_like(cfg), mode)
    assert len(port) == len(ref) == 8
    for i in range(8):
        assert_same(port[i], ref[i])
    # video02's second frame: the window runs backwards from it, padded in
    # front with it, and the label is the earliest frame's (JAX's order)
    seq, paths = port.get_seq_frames(6)
    assert [r["Frame_id"] for r in seq] == [25, 25, 25, 0]
    assert port[6][1] == seq[-1]["Phase_gt"] != seq[0]["Phase_gt"]
    assert isinstance(build_dataset("cholec80", cfg, mode), Cholec80)


@pytest.mark.parametrize("name,target", [
    ("ptvkinetics", "Kinetics"), ("ptvssv2", "Ssv2"),
    ("ptvcharades", "Charades"), ("charades", "Charades"),
    ("imagenet", "Imagenet")])
def test_aliases_resolve(monkeypatch, name, target):
    """The pytorchvideo names build the native datasets, as the JAX
    registry's aliases resolve them."""
    import focus_tpu.datasets.registry_imports  # noqa: F401
    from focus_tpu.datasets.build import DATASET_REGISTRY as JAX_REGISTRY
    import focus_tpu_torch.datasets.charades  # noqa: F401 (registration)
    import focus_tpu_torch.datasets.kinetics  # noqa: F401
    import focus_tpu_torch.datasets.ssv2  # noqa: F401
    from focus_tpu_torch.datasets.build import DATASET_REGISTRY

    monkeypatch.setitem(DATASET_REGISTRY._map, target,
                        lambda cfg, split: (target, split))
    assert build_dataset(name, get_cfg(), "val") == (target, "val")
    assert JAX_REGISTRY.get(name.capitalize()).__name__ == target


# ---- mean average precision and the meters -----------------------------------

@pytest.mark.parametrize("case", ["ties", "all_negative_class", "float32",
                                  "one_clip", "no_positive"])
def test_mean_ap_matches_jax(case):
    """``metrics.mean_ap`` (numpy) within 1e-10 of the JAX package's
    (scikit-learn's ``average_precision_score``): scores rounded to ties,
    a class with no positive (dropped), float32 scores, one clip, and no
    positive at all (0.0)."""
    from focus_tpu.utils.metrics import mean_ap as jax_mean_ap

    rs = np.random.RandomState(["ties", "all_negative_class", "float32",
                                "one_clip", "no_positive"].index(case))
    n, c = (1, 5) if case == "one_clip" else (40, 9)
    scores = rs.rand(n, c)
    if case == "ties":
        scores = np.round(scores, 1)
    if case == "float32":
        scores = scores.astype(np.float32)
    labels = (rs.rand(n, c) < 0.3).astype(np.int64)
    labels[:, 0] = 1 if case == "one_clip" else labels[:, 0]
    if case == "all_negative_class":
        labels[:, 3] = 0
    if case == "no_positive":
        labels[:] = 0
    got = metrics.mean_ap(scores, labels)
    assert abs(got - jax_mean_ap(scores, labels)) <= MAP_ATOL
    assert 0.0 <= got <= 1.0
    if case == "no_positive":
        assert got == 0.0


@pytest.mark.parametrize("method", ["sum", "max"])
def test_multi_label_test_meter_matches_jax(method):
    """The multi-label ``TestMeter``: 5 videos x 6 views of sigmoid scores
    delivered out of order, with pad rows (-1) and a repeated clip; the
    video scores and labels bit-equal to JAX's, ``map`` within 1e-10."""
    from focus_tpu.utils import meters as jax_meters

    rs = np.random.RandomState(3)
    videos, views, classes = 5, 6, 11
    got = meters.TestMeter(videos, views, classes, 4, True, method)
    want = jax_meters.TestMeter(videos, views, classes, 4, True, method)
    video_labels = (rs.rand(videos, classes) < 0.3).astype(np.int32)
    order = rs.permutation(videos * views)
    for part in np.array_split(np.r_[order, order[:3]], 4):
        cid = np.r_[part, [-1, -1]]
        preds = 1 / (1 + np.exp(-rs.randn(len(cid), classes)))
        labels = video_labels[np.maximum(cid, 0) // views]
        for m in (got, want):
            m.update_stats(preds.astype(np.float32), labels, cid)
    g, w = got.finalize_metrics(), want.finalize_metrics()
    assert sorted(g) == sorted(w) == ["map", "split"]
    assert abs(g["map"] - w["map"]) <= MAP_ATOL
    np.testing.assert_array_equal(got.video_preds, want.video_preds)
    np.testing.assert_array_equal(got.video_labels, want.video_labels)
    np.testing.assert_array_equal(got.clip_count, [views] * videos)


def test_multi_label_validation_reports_map_where_jax_raises():
    """Validation on multi-hot labels: the JAX package's ``eval_epoch``
    takes top-k errors of [N, 157] labels and raises ``ValueError``; the
    port's keeps the probabilities and labels (the pad rows dropped) and
    its val stats are ``map``, the ``mean_ap`` of the same arrays."""
    from focus_tpu.engine import trainer as jax_trainer
    from focus_tpu.utils import meters as jax_meters
    from focus_tpu_torch.engine import trainer

    cfg = get_cfg()
    cfg.DATA.MULTI_LABEL = True
    cfg.MODEL.NUM_CLASSES = 157
    rs = np.random.RandomState(4)
    probs = rs.rand(8, 157).astype(np.float32)
    labels = (rs.rand(8, 157) < 0.05).astype(np.int32)
    index = np.array([0, 1, 2, 3, 4, 5, -1, -1], np.int32)  # 2 pad rows
    batches = [(probs[:4], labels[:4], index[:4], {}),
               (probs[4:], labels[4:], index[4:], {})]

    jax_meter = jax_meters.ValMeter(2, jax_cfg_like(cfg))
    with pytest.raises(ValueError, match="broadcast"):
        jax_trainer.eval_epoch(batches, None,
                               lambda state, video, meta: video, jax_meter,
                               0, jax_cfg_like(cfg))

    port_batches = [tuple(torch.from_numpy(x) for x in b[:3]) + ({},)
                    for b in batches]
    val_meter = meters.ValMeter(2, cfg)
    clips = trainer.eval_epoch(port_batches, lambda video, meta: video,
                               val_meter, 0, cfg)
    stats = trainer.val_stats(val_meter)
    assert clips == 6 and sorted(stats) == ["map"]
    want = metrics.mean_ap(probs[:6], labels[:6])
    assert stats["map"] == want and 0.0 <= want <= 1.0
    # the numpy mean_ap against scikit-learn's on these arrays
    from focus_tpu.utils.metrics import mean_ap as jax_mean_ap

    assert abs(want - jax_mean_ap(probs[:6], labels[:6])) <= MAP_ATOL


# ---- the train step and the yaml -------------------------------------------------

def test_slowfast_bce_logit_step_matches_jax():
    """One SGD step of SlowFast R50 (width 8, 8 frames, 32 px, batch 4;
    no nonlocal) under ``bce_logit`` on multi-hot labels of 7 classes
    (``DATA.MULTI_LABEL``: no top-k), in float64 from one set of weights
    and statistics: the loss, the running statistics and the parameters
    after the update within 1e-5 of JAX's (of each tensor's largest
    value)."""
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
    from focus_tpu_torch.utils.weights import jax_params_to_state_dict
    from test_torch_port_resnet import clips, jax_model, jax_variables
    from test_torch_port_resnet_train import (
        assert_tensors_close,
        port_float64,
        running_stats,
        sgd_cfg,
        slowfast_cfg,
        to_float64,
    )

    cfg = sgd_cfg(slowfast_cfg(crop=32, classes=7))
    cfg.NONLOCAL.LOCATION = [[[], []]] * 4
    cfg.DATA.MULTI_LABEL = True
    cfg.MODEL.LOSS_FUNC = "bce_logit"
    cfg.MODEL.HEAD_ACT = "sigmoid"
    jcfg = jax_cfg_like(cfg)
    xs = clips(cfg, batch=4, seed=5)
    labels = (np.random.RandomState(5).rand(4, 7) < 0.4).astype(np.int32)
    jmodel = jax_model(cfg)
    variables = to_float64(jax_variables(jmodel, [jnp.asarray(x) for x in xs]))

    model = port_float64(cfg, variables)
    state = build_supervised_state(cfg, model, 2)
    step = make_supervised_train_step(model, cfg, get_loss_func(cfg))
    state, stats = step(state, [torch.from_numpy(x).double() for x in xs],
                        torch.from_numpy(labels), {})
    assert sorted(stats) == ["loss"]

    with jax.enable_x64(True):
        jvars = jax.tree_util.tree_map(jnp.asarray, variables)
        tx = joptim.construct_optimizer(
            jvars["params"], jcfg, 2,
            no_weight_decay_paths=_no_wd_paths(jcfg))
        jstate = TrainState.create(jvars["params"], tx,
                                   batch_stats=jvars["batch_stats"])
        jstep = jmake(jmodel.clone(dtype=jnp.float64), jcfg,
                      mesh_lib.build_mesh(jcfg), jlosses.get_loss_func(jcfg))
        jstate, jstats = jstep(jstate, [jnp.asarray(x, jnp.float64)
                                        for x in xs],
                               jnp.asarray(labels), {}, jax.random.PRNGKey(0))
        host = jax.device_get(jstate)
        jloss = float(jstats["loss"])
    assert stats["loss"].item() == pytest.approx(jloss, rel=STEP_RTOL)
    assert_tensors_close(running_stats(model),
                         jax_params_to_state_dict(host.batch_stats),
                         STEP_RTOL, "running")
    assert_tensors_close({n: p.detach() for n, p in model.named_parameters()},
                         jax_params_to_state_dict(host.params), STEP_RTOL,
                         "param")


def test_charades_slowfast_yaml_runs_on_the_port(charades, tmp_path):
    """``configs/Charades/SLOWFAST_16x8_R50.yaml`` through the port's
    ``tools.run_net`` on the CPU (float32, width 8, 8 frames, 64 px, no
    caffe2 weights): multi-hot labels under ``bce_logit``, precise BN over
    one batch, validation's ``map``, then the 3 x 3 views under ``max``
    scored by ``map``."""
    from focus_tpu_torch.tools import run_net

    overrides = {
        "TPU.COMPUTE_DTYPE": "float32", "TENSORBOARD.ENABLE": "False",
        "DATA_LOADER.NUM_WORKERS": "2", "SOLVER.MAX_EPOCH": "1",
        "TRAIN.EVAL_PERIOD": "1", "TRAIN.CHECKPOINT_PERIOD": "1",
        "TRAIN.AUTO_RESUME": "False", "TRAIN.CHECKPOINT_FILE_PATH": '""',
        "LOG_PERIOD": "1", "TRAIN.METHOD": "sup", "TEST.EVAL_TASK": "ar",
        "NUM_GPUS": "1",
        "DATA.PATH_TO_DATA_DIR": charades,
        "DATA.PATH_PREFIX": os.path.join(charades, "frames"),
        "TRAIN.BATCH_SIZE": "3", "TEST.BATCH_SIZE": "8",
        "TEST.NUM_ENSEMBLE_VIEWS": "3", "DATA.NUM_FRAMES": "8",
        "DATA.TRAIN_JITTER_SCALES": "[64,80]", "DATA.TRAIN_CROP_SIZE": "64",
        "DATA.TEST_CROP_SIZE": "64", "MODEL.NUM_CLASSES": "6",
        "RESNET.WIDTH_PER_GROUP": "8", "BN.NUM_BATCHES_PRECISE": "1",
        "OUTPUT_DIR": str(tmp_path / "out")}
    argv = ["--device", "cpu", "--cfg",
            os.path.join(REPO, "configs", "Charades", "SLOWFAST_16x8_R50.yaml")]
    for k, v in overrides.items():
        argv += [k, v]
    stats = run_net.main(argv)
    assert sorted(stats) == ["map", "split"] and 0.0 <= stats["map"] <= 1.0
    assert os.listdir(tmp_path / "out" / "checkpoints") == [
        "checkpoint_epoch_00001.pyth"]
