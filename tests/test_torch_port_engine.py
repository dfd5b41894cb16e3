"""The port's multi-view test path against the JAX package's: the test
meters, the checkpoint reader and its fallback chain, the tester end to end
on the tiny HR-336 model with an EPIC-Kitchens tree and on the tiny
flagship with an SSv2 tree (both loading one ``.pyth``), and the CLI.

Tolerances: the meters' stats equal and their ensembles to 1e-12 (float64
sums of the same float32 rows); the models' outputs and ensembled
probabilities to 1e-5 (float32, the plain path in both packages)."""

import os
import pickle
from typing import Any

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from focus_tpu.utils import meters as jax_meters
from focus_tpu_torch.entry import flagship_cfg, hr_cfg
from focus_tpu_torch.models.build import build_model
from focus_tpu_torch.utils import checkpoint as cu
from focus_tpu_torch.utils import meters
from synthetic_data import make_ssv2_tree
from torch_port_trees import jax_cfg_like, make_ek_tree

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def meter_inputs(num_videos, num_clips, classes, seed=0):
    """Per-batch (preds, labels, clip ids): every clip once in shuffled
    batches of 4, two pad rows (-1) and two clips delivered twice."""
    rs = np.random.RandomState(seed)
    order = rs.permutation(num_videos * num_clips)
    ids = np.concatenate([order, [-1, order[3], -1, order[0]]])
    out = []
    for start in range(0, len(ids), 4):
        cid = ids[start:start + 4]
        vid = np.where(cid >= 0, cid // num_clips, 0)
        preds = [rs.rand(len(cid), c).astype(np.float32) for c in classes]
        labels = [(vid * 7 + k) % c for k, c in enumerate(classes)]
        out.append((preds, labels, cid.astype(np.int32)))
    return out


@pytest.mark.parametrize("method", ["sum", "max"])
def test_test_meter_matches_jax(method):
    got = meters.TestMeter(5, 6, 9, 10, False, method)
    want = jax_meters.TestMeter(5, 6, 9, 10, False, method)
    for (preds,), (labels,), cid in meter_inputs(5, 6, (9,)):
        for m in (got, want):
            m.update_stats(preds, labels, cid)
    assert got.finalize_metrics() == want.finalize_metrics()
    np.testing.assert_array_equal(got.clip_count, [6] * 5)
    np.testing.assert_array_equal(got.clip_count, want.clip_count)
    np.testing.assert_array_equal(got.video_labels, want.video_labels)
    np.testing.assert_allclose(got.video_preds, want.video_preds, rtol=0,
                               atol=1e-12)


@pytest.mark.parametrize("method", ["sum", "max"])
def test_epic_test_meter_matches_jax(method):
    got = meters.EPICTestMeter(4, 6, (97, 300), 10, method)
    want = jax_meters.EPICTestMeter(4, 6, (97, 300), 10, method)
    for preds, labels, cid in meter_inputs(4, 6, (97, 300), seed=1):
        labels = {"verb": labels[0], "noun": labels[1]}
        for m in (got, want):
            m.update_stats(tuple(preds), labels, cid)
    assert got.finalize_metrics() == want.finalize_metrics()
    np.testing.assert_array_equal(got.clip_count, [6] * 4)
    for name in ("verb_preds", "noun_preds"):
        np.testing.assert_allclose(getattr(got, name), getattr(want, name),
                                   rtol=0, atol=1e-12)
    for name in ("verb_labels", "noun_labels", "clip_count"):
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name))


def test_test_meter_label_assert_and_multi_label():
    m = meters.TestMeter(1, 2, 3, 1)
    m.update_stats(np.ones((1, 3)), np.array([1]), np.array([0]))
    with pytest.raises(AssertionError):
        m.update_stats(np.ones((1, 3)), np.array([2]), np.array([1]))
    # multi-label: [V, C] labels, and no check that the views' labels agree
    multi = meters.TestMeter(1, 2, 3, 1, multi_label=True)
    multi.update_stats(np.ones((1, 3)), np.array([[1, 0, 1]]), np.array([0]))
    multi.update_stats(np.ones((1, 3)), np.array([[0, 1, 0]]), np.array([1]))
    np.testing.assert_array_equal(multi.video_labels, [[0, 1, 0]])
    assert sorted(multi.finalize_metrics()) == ["map", "split"]


@flax.struct.dataclass
class _State:
    """The two fields of a train state that ``load_into_state`` reads."""
    params: Any
    batch_stats: Any = None


def jax_model(cfg, video, boxes, seed=0):
    """(JAX config, model, params): the params the port's seeded init,
    carried onto their ``eval_shape`` by the JAX package's importer (no
    init compile)."""
    from focus_tpu.models.build import build_model as jax_build_model
    from focus_tpu.utils.torch_import import import_torch_params

    jcfg = jax_cfg_like(cfg)
    model = jax_build_model(jcfg)
    shapes = jax.eval_shape(lambda: model.init(
        {"params": jax.random.PRNGKey(seed),
         "dropout": jax.random.PRNGKey(seed)}, jnp.asarray(video),
        {"orvit_bboxes": jnp.asarray(boxes)}))["params"]
    template = jax.tree_util.tree_map(lambda a: np.zeros(a.shape, a.dtype),
                                      shapes)
    sd = build_model(cfg, device="cpu", seed=seed).state_dict()
    params, _ = import_torch_params({k: v.numpy() for k, v in sd.items()},
                                    template, allow_missing=False)
    return jcfg, model, params


def reference_state_dict(params):
    """The JAX params under the reference's torch names and layouts (the
    inverse of ``focus_tpu.utils.torch_import``'s mapping)."""
    from focus_tpu.utils.torch_import import _flatten, flax_path_to_torch

    sd = {}
    for path, leaf in _flatten(params).items():
        name, kind = flax_path_to_torch(path)
        arr = np.asarray(leaf)
        if kind == "linear" and arr.ndim == 2:
            arr = arr.T
        elif kind == "linear" and arr.ndim == 5:  # [kt,kh,kw,I,O]
            arr = arr.transpose(4, 3, 0, 1, 2)
        sd[name] = torch.from_numpy(np.array(arr))
    return sd


def tiny_inputs(cfg, batch=2, seed=0):
    rs = np.random.RandomState(seed)
    T, crop = cfg.DATA.NUM_FRAMES, cfg.DATA.TRAIN_CROP_SIZE
    video = rs.rand(batch, T, crop, crop, 3).astype(np.float32)
    boxes = (rs.rand(batch, T, cfg.ORVIT.O, 4) * 0.5 + 0.25).astype(np.float32)
    return video, boxes


def test_reader_matches_jax_importer(tmp_path):
    """A reference-format .pyth of JAX params, with the names a user's
    checkpoint may carry (DataParallel's ``module.``, a prefix cleared by
    TRAIN.CHECKPOINT_CLEAR_NAME_PATTERN, q / k / v stored apart), loaded by
    the JAX importer and by the port: the same tiny-flagship outputs."""
    from focus_tpu.utils.torch_import import (
        import_torch_params,
        load_into_state,
        load_torch_state_dict,
    )

    cfg = flagship_cfg(tiny=True)
    cfg.TPU.SCAN_LAYERS = False
    cfg.TRAIN.CHECKPOINT_CLEAR_NAME_PATTERN = ["backbone."]
    cfg.SPLIT_QKV_CHECKPOINT = True
    video, boxes = tiny_inputs(cfg)
    jcfg, jmodel, params = jax_model(cfg, video, boxes, seed=3)
    sd = {}
    for name, t in reference_state_dict(params).items():
        if ".qkv." in name:
            for part, chunk in zip("qkv", t.chunk(3, dim=0)):
                sd[name.replace(".qkv.", f".{part}.")] = chunk.clone()
        else:
            sd[name] = t
    sd = {"module.backbone." + k: v for k, v in sd.items()}
    path = str(tmp_path / "ref.pyth")
    torch.save({"model_state": sd, "epoch": 7}, path)

    template = jax.tree_util.tree_map(np.zeros_like, params)
    state = load_into_state(path, _State(params=template), jcfg)
    apply = jax.jit(lambda p, v, b: jmodel.apply(
        {"params": p}, v, {"orvit_bboxes": b}, train=False))
    want = np.asarray(apply(state.params, jnp.asarray(video),
                            jnp.asarray(boxes)))
    model = build_model(cfg, device="cpu", seed=9)
    report = cu.load_checkpoint(path, model, cfg)
    with torch.no_grad():
        got = model(torch.from_numpy(video),
                    {"orvit_bboxes": torch.from_numpy(boxes)}).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    assert report["missing"] == [] and report["path"] == path
    assert len(report["loaded"]) == len(model.state_dict())
    # the same names left over as the JAX importer's
    from focus_tpu.utils.torch_import import (
        _copy_backbone_attn_to_orvit,
        _merge_split_qkv,
        apply_name_patterns,
    )

    jsd = apply_name_patterns(load_torch_state_dict(path), ("backbone.",))
    jsd = _copy_backbone_attn_to_orvit(_merge_split_qkv(jsd), None)
    _, jreport = import_torch_params(jsd, template)
    assert sorted(report["unused"]) == sorted(jreport["unused"])
    assert report["unused"] and all(
        ".q." in k or ".k." in k or ".v." in k or k.startswith("orvit_")
        for k in report["unused"])


def test_reader_skips_mismatches_and_keeps_missing(tmp_path):
    cfg = flagship_cfg(tiny=True)
    cfg.ORVIT.LOAD_ORVIT_ATTN_LAYERS_FROM_BB = False
    model = build_model(cfg, device="cpu", seed=1)
    other = build_model(cfg, device="cpu", seed=2)
    sd = dict(other.state_dict())
    del sd["head.bias"]
    sd["head.weight"] = torch.zeros(3, 3)
    sd["extra.weight"] = torch.zeros(2)
    path = str(tmp_path / "partial.pyth")
    torch.save({"state_dict": sd}, path)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    report = cu.load_checkpoint(path, model, cfg)
    assert sorted(report["missing"]) == ["head.bias", "head.weight"]
    assert report["unused"] == ["head.weight", "extra.weight"]
    for k, v in model.state_dict().items():
        want = before[k] if k.startswith("head.") else other.state_dict()[k]
        assert torch.equal(v, want), k


def test_inflate_and_orvit_attention_from_backbone():
    class M(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.conv = torch.nn.Conv3d(2, 3, (4, 1, 1), bias=False)
            self.orvit_blocks = torch.nn.ModuleList([torch.nn.Linear(2, 6)])

    m = M()
    w2d = torch.randn(3, 2, 1, 1)
    qkv = torch.randn(6, 2)
    sd = {"conv.weight": w2d, "blocks.0.qkv.weight": qkv}
    sd = cu.copy_backbone_attn_to_orvit(sd)
    sd["orvit_blocks.0.weight"] = sd.pop("orvit_blocks.0.qkv.weight")
    report = cu.import_state_dict(sd, m, inflate=True)
    assert sorted(report["loaded"]) == ["conv.weight", "orvit_blocks.0.weight"]
    torch.testing.assert_close(m.conv.weight, w2d[:, :, None].repeat(
        1, 1, 4, 1, 1) / 4, rtol=0, atol=0)
    assert torch.equal(m.orvit_blocks[0].weight.data, qkv)


def test_save_load_round_trip_is_bit_equal(tmp_path):
    cfg = flagship_cfg(tiny=True)
    model = build_model(cfg, device="cpu", seed=4)
    job = str(tmp_path / "job")
    path = cu.save_checkpoint(job, model, 6, cfg)
    assert path == cu.get_path_to_checkpoint(job, 6)
    assert os.listdir(os.path.dirname(path)) == [os.path.basename(path)]
    payload = torch.load(path, weights_only=False)
    assert sorted(payload) == ["cfg", "epoch", "model_state"]
    assert payload["epoch"] == 6 and "MF" in payload["cfg"]
    fresh = build_model(cfg, device="cpu", seed=5)
    report = cu.load_checkpoint(path, fresh, cfg)
    # unused: the backbone qkv also offered under orvit_ (the
    # ORVIT.LOAD_ORVIT_ATTN_LAYERS_FROM_BB default), which no block takes
    assert report["missing"] == []
    assert all(k.startswith("orvit_blocks.") for k in report["unused"])
    for (k, a), (_, b) in zip(model.state_dict().items(),
                              fresh.state_dict().items()):
        assert a.dtype == b.dtype and torch.equal(a, b), k
    assert cu.get_last_checkpoint(job) == path and cu.has_checkpoint(job)


def test_jax_and_caffe2_checkpoints_raise(tmp_path):
    from focus_tpu.utils.checkpoint import save_checkpoint as jax_save

    cfg = flagship_cfg(tiny=True)
    path = jax_save(str(tmp_path), {"w": np.zeros(3, np.float32)}, 2,
                    jax_cfg_like(cfg), async_write=False)
    model = build_model(cfg, device="cpu")
    with pytest.raises(NotImplementedError, match="JAX-package checkpoint"):
        cu.load_checkpoint(path, model, cfg)
    cfg.TEST.CHECKPOINT_FILE_PATH = path
    cfg.TEST.CHECKPOINT_TYPE = "caffe2"
    with pytest.raises(NotImplementedError, match="Caffe2"):
        cu.load_test_checkpoint(cfg, model)


@pytest.mark.parametrize("case", ["epoch_num", "test_path", "output_dir",
                                  "exp_path", "train_path", "random"])
def test_fallback_chain_matches_jax(tmp_path, monkeypatch, case):
    import focus_tpu.utils.torch_import as jax_import
    from focus_tpu.utils.checkpoint import load_test_checkpoint as jax_chain

    cfg = flagship_cfg(tiny=True)
    model = build_model(cfg, device="cpu")
    out, exp = str(tmp_path / "out"), str(tmp_path / "out" / "exp")
    cfg.OUTPUT_DIR, cfg.EXP.PATH = out, exp
    if case in ("epoch_num", "test_path", "output_dir"):
        cu.save_checkpoint(out, model, 2, cfg)
        last = cu.save_checkpoint(out, model, 5, cfg)
    exp_file = cu.save_checkpoint(exp, model, 3, cfg) if case == "exp_path" \
        else None
    test_file = cu.save_checkpoint(str(tmp_path / "t"), model, 1, cfg)
    train_file = cu.save_checkpoint(str(tmp_path / "r"), model, 1, cfg)
    if case == "epoch_num":
        cfg.TEST.TEST_EPOCH_NUM = 5
    if case in ("epoch_num", "test_path"):
        cfg.TEST.CHECKPOINT_FILE_PATH = test_file
    if case != "random":
        cfg.TRAIN.CHECKPOINT_FILE_PATH = train_file
    want = {"epoch_num": lambda: last, "test_path": lambda: test_file,
            "output_dir": lambda: last, "exp_path": lambda: exp_file,
            "train_path": lambda: train_file, "random": lambda: None}[case]()
    report = cu.load_test_checkpoint(cfg, model)
    seen = []
    monkeypatch.setattr(jax_import, "load_into_state",
                        lambda path, state, cfg: seen.append(path) or state)
    jax_chain(jax_cfg_like(cfg), "template")
    assert (report and report["path"]) == want
    assert seen == ([want] if want else [])


class _Recording:
    """Meters of the JAX tester, kept for the comparison."""
    made = []

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        _Recording.made.append(self)


def run_both(cfg, tmp_path, monkeypatch):
    """The JAX tester and the port's on ``cfg``, both loading one .pyth
    written by the port; returns (port stats, port meter, JAX stats, JAX
    meter)."""
    import focus_tpu.engine.tester as jax_tester
    import focus_tpu.native

    from focus_tpu_torch.engine import tester

    monkeypatch.setattr(focus_tpu.native, "available", lambda: False)
    monkeypatch.setattr(jax_tester, "TestMeter", type(
        "TestMeter", (_Recording, jax_meters.TestMeter), {}))
    monkeypatch.setattr(jax_meters, "EPICTestMeter", type(
        "EPICTestMeter", (_Recording, jax_meters.EPICTestMeter), {}))
    _Recording.made.clear()
    cfg.MODEL.ARCH = "slow"
    cfg.NUM_GPUS = 1
    cfg.DATA_LOADER.NUM_WORKERS = 2
    cfg.OUTPUT_DIR = str(tmp_path / "out")
    written = build_model(cfg, device="cpu", seed=11)
    cfg.TEST.CHECKPOINT_FILE_PATH = cu.save_checkpoint(
        str(tmp_path / "job"), written, 4, cfg)
    run = tester.run_test(cfg, device="cpu")
    got, meter = run.stats, run.meter
    assert run.checkpoint["missing"] == []
    import focus_tpu.engine.trainer as jtrainer

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
    jcfg.OUTPUT_DIR = str(tmp_path / "out_jax")
    want = jax_tester.test(jcfg)
    (jmeter,) = _Recording.made
    return got, meter, want, jmeter


def test_tester_matches_jax_on_hr_and_epic_kitchens(tmp_path, monkeypatch):
    """Tiny HR-336 (6 x 6 patches of 56 px at the 336 crop, 4 frames, so
    the boxes are strided 2 to the 2 temporal positions), 2 videos x 10
    views x 3 crops at batch 16: four batches, the last with 4 pad rows."""
    ann, name, visual = make_ek_tree(str(tmp_path / "ek"))
    cfg = hr_cfg(tiny=True)
    cfg.EPICKITCHENS.ANNOTATIONS_DIR = ann
    cfg.EPICKITCHENS.TEST_LIST = name
    cfg.EPICKITCHENS.VISUAL_DATA_DIR = visual
    cfg.DATA.SAMPLING_RATE = 4
    cfg.TEST.NUM_ENSEMBLE_VIEWS, cfg.TEST.NUM_SPATIAL_CROPS = 10, 3
    cfg.TEST.BATCH_SIZE = 16
    got, meter, want, jmeter = run_both(cfg, tmp_path, monkeypatch)
    assert got == want
    assert sorted(got) == ["action_top1_acc", "action_top5_acc", "noun_top1_acc",
                           "noun_top5_acc", "split", "verb_top1_acc",
                           "verb_top5_acc"]
    np.testing.assert_array_equal(meter.clip_count, [30, 30])
    for name in ("verb_preds", "noun_preds"):
        np.testing.assert_allclose(getattr(meter, name), getattr(jmeter, name),
                                   rtol=0, atol=1e-5)
    for name in ("verb_labels", "noun_labels", "clip_count"):
        np.testing.assert_array_equal(getattr(meter, name),
                                      getattr(jmeter, name))
    np.testing.assert_array_equal(meter.verb_labels, [3, 41])


def test_tester_matches_jax_on_flagship_and_ssv2(tmp_path, monkeypatch):
    """Tiny flagship, 3 SSv2 videos x 1 view x 3 crops at batch 4 (the last
    batch padded), detectron2 boxes; the results pickle as JAX writes it."""
    root = str(tmp_path / "ssv2")
    make_ssv2_tree(root, num_videos=3, num_frames=12, size=48)
    cfg = flagship_cfg(tiny=True)
    cfg.TRAIN.DATASET = cfg.TEST.DATASET = "ssv2"
    cfg.SSV2.DATA_ROOT = cfg.SSV2.SPLITS_ROOT = root
    cfg.DATA.TEST_CROP_SIZE = 224
    cfg.TEST.NUM_ENSEMBLE_VIEWS, cfg.TEST.NUM_SPATIAL_CROPS = 1, 3
    cfg.TEST.BATCH_SIZE = 4
    cfg.TEST.SAVE_RESULTS_PATH = "preds.pkl"
    got, meter, want, jmeter = run_both(cfg, tmp_path, monkeypatch)
    assert got == want and sorted(got) == ["split", "top1_acc", "top5_acc"]
    np.testing.assert_array_equal(meter.clip_count, [3, 3, 3])
    np.testing.assert_allclose(meter.video_preds, jmeter.video_preds,
                               rtol=0, atol=1e-5)
    np.testing.assert_array_equal(meter.video_labels, [0, 1, 0])
    for out in (cfg.OUTPUT_DIR, str(tmp_path / "out_jax")):
        with open(os.path.join(out, "preds.pkl"), "rb") as f:
            preds, labels = pickle.load(f)
        np.testing.assert_allclose(preds, meter.video_preds, rtol=0, atol=1e-5)
        np.testing.assert_array_equal(labels, meter.video_labels)


def test_logging_handlers_are_closed(tmp_path):
    """A second output directory closes the first's file handler;
    ``close_logging`` closes the rest, and the next setup starts anew."""
    import logging

    from focus_tpu_torch.utils import logging as lu

    root = logging.getLogger(lu.ROOT)
    try:
        lu.close_logging()
        lu.setup_logging(str(tmp_path / "a"))
        first = list(root.handlers)
        assert len(first) == 2
        lu.setup_logging(str(tmp_path / "b"))
        files = [h for h in first if isinstance(h, logging.FileHandler)]
        assert files and files[0].stream is None  # closed
        second = list(root.handlers)
        lu.close_logging()
        assert root.handlers == []
        assert all(getattr(h, "stream", None) is None for h in second
                   if isinstance(h, logging.FileHandler))
        lu.setup_logging(str(tmp_path / "b"))  # not a cached no-op
        assert len(root.handlers) == 2
    finally:
        lu.close_logging()


def test_cli_runs_the_test_path_on_the_cpu(tmp_path):
    from focus_tpu_torch.config.defaults import assert_and_infer_cfg
    from focus_tpu_torch.engine import tester
    from focus_tpu_torch.tools import run_net, test_net
    from focus_tpu_torch.utils.parser import load_config, parse_args

    yaml = os.path.join(REPO, "configs", "tests", "mf_synthetic.yaml")
    args = ["--device", "cpu", "--cfg", yaml, "--exp_name", "e",
            "OUTPUT_DIR", str(tmp_path)]
    stats = run_net.main(args + ["TRAIN.ENABLE", "False"])
    assert sorted(stats) == ["split", "top1_acc", "top5_acc"]
    assert test_net.main(args) == stats  # same seed, same random init
    cfg = assert_and_infer_cfg(load_config(parse_args(args)))
    run = tester.run_test(cfg, device="cpu")
    assert run.stats == stats and run.clips == 16 and run.batches == 2
    assert run.checkpoint is None  # random init: none found
    assert os.path.isdir(os.path.join(str(tmp_path), "e", "checkpoints"))
    with pytest.raises(ValueError, match="slot model"):
        run_net.main(args + ["TRAIN.METHOD", "slots"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            run_net.main(args[2:] + ["TRAIN.ENABLE", "False"])


@pytest.mark.parametrize("key,value,match", [
    ("TPU.MESH.PIPE", 2, "x pipe axis 2 .*TPU.MESH.PIPE 2"),
    ("DEMO.ENABLE", True, "DEMO"),
    ("TENSORBOARD.MODEL_VIS.ENABLE", True, "MODEL_VIS"),
    ("TPU.MESH.MODEL", 2, "TPU.MESH.MODEL 2"),
    ("TENSORBOARD.HISTOGRAM.ENABLE", True, "HISTOGRAM"),
    ("MODEL.LOAD_IN_PRETRAIN", "vit.pth", "LOAD_IN_PRETRAIN"),
    ("TPU.MESH.SEQ", 2, "TPU.MESH.SEQ 2"),
])
def test_unported_options_raise(tmp_path, key, value, match):
    """Raised before anything runs; a pipe, model or seq axis on one
    process meets the JAX package's divisibility refusal (ValueError), the
    rest are not run by the port (NotImplementedError)."""
    from focus_tpu_torch.tools import run_net

    yaml = os.path.join(REPO, "configs", "tests", "mf_synthetic.yaml")
    args = ["--device", "cpu", "--cfg", yaml]
    opts = ["TRAIN.ENABLE", "False", "OUTPUT_DIR", str(tmp_path), key,
            str(value)]
    if key.startswith("TENSORBOARD."):
        opts += ["TENSORBOARD.ENABLE", "True"]
    error = (ValueError if key.startswith("TPU.MESH.")
             else NotImplementedError)
    with pytest.raises(error, match=match):
        run_net.main(args + opts)
