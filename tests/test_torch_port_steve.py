"""The port's STEVE modules and the STEVE slice as a whole, on the CPU in
float32, against the JAX package on the same weights (carried across by
``utils/weights.py``) and the same numpy inputs, and against the golden
fixtures of the reference (state_dicts loaded with ``strict=True``)."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from focus_tpu.config import get_cfg as jax_get_cfg
from focus_tpu.models import common as jcommon
from focus_tpu.models.steve import dvae as jdvae
from focus_tpu.models.steve import slot_attention as jsa
from focus_tpu.models.steve import steve as jsteve
from focus_tpu_torch.config import get_cfg
from focus_tpu_torch.entry import steve_cfg, steve_entry
from focus_tpu_torch.models import common as tcommon
from focus_tpu_torch.models.build import build_model, init_weights
from focus_tpu_torch.models.steve import dvae as tdvae
from focus_tpu_torch.models.steve import steve as tsteve
from focus_tpu_torch.models.steve.slot_attention import SlotAttentionVideo
from focus_tpu_torch.utils.weights import load_jax_params, reference_state_dict

FIXDIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures")
ATOL = 2e-5  # float32 on both sides; sums taken in another order


def load_fixture(name):
    data = dict(np.load(os.path.join(FIXDIR, f"{name}.npz")))
    sd = {k[3:]: torch.from_numpy(v) for k, v in data.items()
          if k.startswith("sd/")}
    rest = {k: v for k, v in data.items() if not k.startswith("sd/")}
    return rest, sd


def random_variables(module, rs, *inputs, scale=0.2):
    """The module's variables with N(0, scale^2) leaves (so that biases and
    LayerNorm parameters are not at their trivial init), from the shapes
    alone: the init itself is traced, never run."""
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0),
                            *map(jnp.asarray, inputs))
    return jax.tree_util.tree_map(
        lambda a: (rs.randn(*a.shape) * scale).astype(np.float32), shapes)


def t2n(t):
    return t.detach().numpy()


# ---- modules against their JAX counterparts --------------------------------

@pytest.fixture(scope="module")
def decoder_pair():
    rs = np.random.RandomState(0)
    x = (rs.randn(2, 6, 32) * 0.5).astype(np.float32)
    enc = (rs.randn(2, 3, 32) * 0.5).astype(np.float32)
    jm = jcommon.TransformerDecoder(2, 32, 2)
    params = random_variables(jm, rs, x, enc)["params"]
    tm = tcommon.TransformerDecoder(2, 32, 2).eval()
    load_jax_params(tm, params)
    return jm, params, tm, x, enc


def test_transformer_decoder_full_matches_jax(decoder_pair):
    jm, params, tm, x, enc = decoder_pair
    ref = jm.apply({"params": params}, jnp.asarray(x), jnp.asarray(enc))
    with torch.no_grad():
        out = tm(torch.from_numpy(x), torch.from_numpy(enc))
    np.testing.assert_allclose(t2n(out), np.asarray(ref), atol=ATOL)


def test_transformer_decoder_project_kv_only_matches_jax(decoder_pair):
    jm, params, tm, x, enc = decoder_pair
    ref = jm.apply({"params": params}, jnp.asarray(x), jnp.asarray(enc),
                   project_kv_only=True)
    with torch.no_grad():
        out = tm(torch.from_numpy(x), torch.from_numpy(enc),
                 project_kv_only=True)
    assert len(out) == len(ref) == 2
    for (k, v), (rk, rv) in zip(out, ref):
        np.testing.assert_allclose(t2n(k), np.asarray(rk), atol=ATOL)
        np.testing.assert_allclose(t2n(v), np.asarray(rv), atol=ATOL)


@pytest.mark.parametrize("t", [0, 3])
def test_transformer_decoder_cached_matches_jax(decoder_pair, t):
    """One cached step at position t with hoisted cross K/V: the output and
    both caches (row t written, the others as they were)."""
    jm, params, tm, x, enc = decoder_pair
    rs = np.random.RandomState(1)
    B, L, h, hd = 2, 6, 2, 16
    caches = [tuple((rs.randn(B, L, h, hd) * 0.3).astype(np.float32)
                    for _ in range(2)) for _ in range(2)]
    x_t = x[:, t:t + 1]
    jc = tuple((jnp.asarray(k), jnp.asarray(v)) for k, v in caches)
    kvs = jm.apply({"params": params}, jnp.asarray(x_t), jnp.asarray(enc),
                   project_kv_only=True)
    ref, ref_caches = jm.apply({"params": params}, jnp.asarray(x_t),
                               jnp.asarray(enc), caches=jc, t=t,
                               cross_kvs=kvs)
    tc = tuple((torch.from_numpy(k.copy()), torch.from_numpy(v.copy()))
               for k, v in caches)
    with torch.no_grad():
        tkvs = tm(torch.from_numpy(x_t), torch.from_numpy(enc),
                  project_kv_only=True)
        out, new = tm(torch.from_numpy(x_t), torch.from_numpy(enc),
                      caches=tc, t=t, cross_kvs=tkvs)
    np.testing.assert_allclose(t2n(out), np.asarray(ref), atol=ATOL)
    for (k, v), (rk, rv) in zip(new, ref_caches):
        np.testing.assert_allclose(t2n(k), np.asarray(rk), atol=ATOL)
        np.testing.assert_allclose(t2n(v), np.asarray(rv), atol=ATOL)


def test_dvae_matches_jax():
    rs = np.random.RandomState(2)
    x = rs.rand(2, 16, 16, 3).astype(np.float32)
    jm = jdvae.DVAE(16, 3)
    # a scale that keeps the activations of the 1x1 stacks near 1
    params = random_variables(jm, rs, x, scale=0.1)["params"]
    tm = tdvae.DVAE(16, 3).eval()
    load_jax_params(tm, params, under=("dvae",))
    ref_logits = jm.apply({"params": params}, jnp.asarray(x),
                          method=lambda m, v: m.encoder(v))
    ref_recon = jm.apply({"params": params}, ref_logits,
                         method=lambda m, v: m.decoder(v))
    with torch.no_grad():
        logits = tm.encoder(torch.from_numpy(x))
        recon = tm.decoder(torch.from_numpy(np.array(ref_logits)))
    np.testing.assert_allclose(t2n(logits), np.asarray(ref_logits), atol=ATOL)
    np.testing.assert_allclose(t2n(recon), np.asarray(ref_recon), atol=ATOL)


def test_pixel_shuffle_matches_jax():
    x = np.random.RandomState(3).randn(2, 3, 5, 8).astype(np.float32)
    np.testing.assert_array_equal(
        t2n(tdvae.pixel_shuffle(torch.from_numpy(x), 2)),
        np.asarray(jdvae.pixel_shuffle(jnp.asarray(x), 2)))


def test_slot_attention_video_matches_jax():
    rs = np.random.RandomState(4)
    B, T, N, D, S, slot = 2, 3, 9, 12, 4, 16
    inputs = rs.randn(B, T, N, D).astype(np.float32)
    noise = rs.randn(B, S, slot).astype(np.float32)
    jm = jsa.SlotAttentionVideo(3, S, D, slot, 24, 1, 2, 0.0)
    params = random_variables(jm, rs, inputs, noise)["params"]
    tm = SlotAttentionVideo(3, S, D, slot, 24, 1, 2, 0.0).eval()
    load_jax_params(tm, params)
    ref_slots, ref_attns = jm.apply({"params": params}, jnp.asarray(inputs),
                                    jnp.asarray(noise))
    with torch.no_grad():
        slots, attns = tm(torch.from_numpy(inputs),
                          noise=torch.from_numpy(noise))
    np.testing.assert_allclose(t2n(slots), np.asarray(ref_slots), atol=ATOL)
    np.testing.assert_allclose(t2n(attns), np.asarray(ref_attns), atol=ATOL)


def test_slot_attention_draws_noise_from_generator():
    tm = SlotAttentionVideo(1, 2, 4, 4, 8).eval()
    init_weights(tm, torch.Generator().manual_seed(0))
    x = torch.randn(1, 2, 3, 4, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        a, _ = tm(x, generator=torch.Generator().manual_seed(5))
        b, _ = tm(x, generator=torch.Generator().manual_seed(5))
        c, _ = tm(x, generator=torch.Generator().manual_seed(6))
    assert torch.equal(a, b) and not torch.equal(a, c)


@pytest.mark.parametrize("img_size", [64, 16])
def test_base_cnn_matches_jax(img_size):
    rs = np.random.RandomState(5)
    side = 8  # the stride depends on img_size only
    x = rs.rand(2, side, side, 3).astype(np.float32)
    jm = jsteve.BaseCNN(img_size, 6, 10)
    params = random_variables(jm, rs, x)["params"]
    tm = tsteve.BaseCNN(img_size, 6, 10).eval()
    load_jax_params(tm, params, under=("steve_encoder", "cnn"))
    ref = jm.apply({"params": params}, jnp.asarray(x))
    with torch.no_grad():
        out = tm(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    np.testing.assert_allclose(t2n(out), np.asarray(ref), atol=ATOL)


def test_res18_stem_matches_jax():
    """Eval BatchNorm on non-trivial running statistics, and the transposed
    conv, whose kernel flax does not flip and pads by (2, 1)."""
    rs = np.random.RandomState(6)
    x = rs.rand(2, 8, 8, 3).astype(np.float32)
    jm = jsteve.Res18Stem(6, 10)
    variables = random_variables(jm, rs, x)
    params = variables["params"]
    stats = jax.tree_util.tree_map(lambda a: np.abs(a) + 0.5,
                                   variables["batch_stats"])
    tm = tsteve.Res18Stem(6, 10).eval()
    load_jax_params(tm, params, batch_stats=stats,
                    under=("steve_encoder", "cnn"))
    ref = jm.apply({"params": params, "batch_stats": stats}, jnp.asarray(x))
    with torch.no_grad():
        out = tm(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    assert out.shape == (2, 8, 8, 10)
    np.testing.assert_allclose(t2n(out), np.asarray(ref), atol=ATOL)


def test_cartesian_positional_embedding_matches_jax():
    rs = np.random.RandomState(7)
    x = rs.randn(1, 16, 16, 5).astype(np.float32)
    jm = jsteve.CartesianPositionalEmbedding(5, 16)
    params = random_variables(jm, rs, x)["params"]
    tm = tsteve.CartesianPositionalEmbedding(5, 16).eval()
    load_jax_params(tm, params)
    ref = jm.apply({"params": params}, jnp.asarray(x))
    with torch.no_grad():
        out = tm(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    np.testing.assert_allclose(t2n(out), np.asarray(ref), atol=ATOL)


# ---- golden fixtures of the reference ---------------------------------------

def test_dvae_fixture():
    d, sd = load_fixture("dvae")
    tm = tdvae.DVAE(16, 3).eval()
    tm.load_state_dict(reference_state_dict(sd), strict=True)
    with torch.no_grad():
        logits = tm.encoder(torch.from_numpy(d["x"]).permute(0, 2, 3, 1))
        recon = tm.decoder(torch.from_numpy(d["z_hard"]).permute(0, 2, 3, 1))
    np.testing.assert_allclose(t2n(logits.permute(0, 3, 1, 2)), d["logits"],
                               atol=3e-5)
    np.testing.assert_allclose(t2n(recon.permute(0, 3, 1, 2)), d["recon"],
                               atol=3e-5)


def test_slot_attention_video_fixture():
    d, sd = load_fixture("slot_attention_video")
    S, slot = d["noise"].shape[1:]
    tm = SlotAttentionVideo(2, S, d["inputs"].shape[-1], slot, 24, 1, 2,
                            0.0).eval()
    tm.load_state_dict(reference_state_dict(sd), strict=True)
    with torch.no_grad():
        slots, attns = tm(torch.from_numpy(d["inputs"]),
                          noise=torch.from_numpy(d["noise"]))
    np.testing.assert_allclose(t2n(slots), d["slots"], atol=2e-4)
    np.testing.assert_allclose(t2n(attns), d["attns"], atol=2e-4)


def test_transformer_decoder_fixture():
    d, sd = load_fixture("steve_transformer_decoder")
    tm = tcommon.TransformerDecoder(2, d["inp"].shape[-1], 2).eval()
    tm.load_state_dict(reference_state_dict(sd), strict=True)
    with torch.no_grad():
        out = tm(torch.from_numpy(d["inp"]), torch.from_numpy(d["encoder_out"]))
    np.testing.assert_allclose(t2n(out), d["out"], atol=1e-4)


def steve_full_cfg(cfg):
    """As tests/test_full_model_golden.py:test_steve_full_golden, for either
    package."""
    cfg.MODEL.MODEL_NAME = "STEVE"
    cfg.SLOTS.NUM_ITERS = 2
    cfg.SLOTS.NUM_SLOTS = 3
    cfg.SLOTS.VOCAB_SIZE = 8
    cfg.SLOTS.IMG_SIZE = 32
    cfg.SLOTS.SIZE = 32
    cfg.SLOTS.DIM = 32
    cfg.SLOTS.CNN_HID_SIZE = 16
    cfg.SLOTS.MLP_HID_SIZE = 64
    cfg.SLOTS.NUM_PREDICTOR_BLOCKS = 1
    cfg.SLOTS.NUM_PREDICTOR_HEADS = 2
    cfg.SLOTS.DECODER.NUM_BLOCKS = 2
    cfg.SLOTS.DECODER.NUM_HEADS = 2
    cfg.SLOTS.DECODER.DIM = 32
    cfg.TPU.COMPUTE_DTYPE = "float32"
    return cfg


def test_steve_full_fixture_loads_and_encodes():
    """The whole reference STEVE loads with strict=True; with the recorded
    slot noise, ``encode`` reproduces the recorded attention maps."""
    d, sd = load_fixture("steve_full")
    model = build_model(steve_full_cfg(get_cfg()), device="cpu")
    model.load_state_dict(reference_state_dict(sd), strict=True)
    video = torch.from_numpy(d["video"]).permute(0, 1, 3, 4, 2).contiguous()
    _, attns_vis, _ = model.encode(video,
                                   noise=torch.from_numpy(d["slot_noise_0"]))
    np.testing.assert_allclose(
        t2n(attns_vis.permute(0, 1, 2, 5, 3, 4)), d["attns"], atol=2e-4)


# ---- the slice as a whole ----------------------------------------------------

@pytest.fixture(scope="module")
def steve_pair():
    """The JAX STEVE at the tiny size of tests/test_steve_fused_ar.py and the
    port's on the same weights."""
    from focus_tpu.models.build import build_model as jax_build
    from focus_tpu.models.build import init_model

    jcfg = jax_get_cfg()  # tests/test_steve_fused_ar.py:tiny_steve_cfg
    jcfg.MODEL.MODEL_NAME = "STEVE"
    jcfg.MODEL.CNN_NAME = "base"
    jcfg.SLOTS.IMG_SIZE = 16
    jcfg.SLOTS.NUM_SLOTS = 3
    jcfg.SLOTS.VOCAB_SIZE = 32
    jcfg.SLOTS.DECODER.DIM = 32
    jcfg.SLOTS.DECODER.NUM_BLOCKS = 2
    jcfg.SLOTS.DECODER.NUM_HEADS = 2
    jcfg.SLOTS.DECODER.DROPOUT = 0.0
    jcfg.TPU.COMPUTE_DTYPE = "float32"
    assert dict(jcfg.SLOTS) == dict(steve_cfg(tiny=True).SLOTS)
    jmodel = jax_build(jcfg)
    rs = np.random.RandomState(0)
    video = rs.rand(2, 2, 16, 16, 3).astype(np.float32)
    variables = init_model(jmodel, jcfg, (jnp.asarray(video), 1.0, True))
    params = jax.device_get(variables["params"])
    tmodel = build_model(steve_cfg(tiny=True), device="cpu")
    load_jax_params(tmodel, params)
    return jcfg, jmodel, {"params": params}, tmodel, video


def jax_cached_ids(jmodel, variables, slots):
    def run(mdl):
        s = mdl.steve_encoder.slot_proj(jnp.asarray(slots))
        return mdl._decode_ids_cached(s, 16)

    return np.asarray(jmodel.apply(variables, method=run))


@pytest.mark.parametrize("path", ["fused_plain_version", "cached_modules",
                                  "full_oracle"])
def test_rollout_ids_match_jax_cached(steve_pair, path):
    jcfg, jmodel, variables, tmodel, _ = steve_pair
    rs = np.random.RandomState(1)
    slots = (rs.randn(4, jcfg.SLOTS.NUM_SLOTS, jcfg.SLOTS.SIZE) * 0.5).astype(
        np.float32)
    ref = jax_cached_ids(jmodel, variables, slots)
    tmodel.fused_ar_step = path == "fused_plain_version"
    try:
        ids = tmodel.decode_ids(torch.from_numpy(slots),
                                use_kv_cache=path != "full_oracle")
    finally:
        tmodel.fused_ar_step = True
    assert ids.shape == (16, 4)
    np.testing.assert_array_equal(t2n(ids), ref)


def test_use_kernels_false_runs_the_plain_version(steve_pair):
    *_, tmodel, _ = steve_pair
    slots = torch.from_numpy(
        (np.random.RandomState(2).randn(3, 3, 192) * 0.5).astype(np.float32))
    ids = tmodel.decode_ids(slots)
    tmodel.use_kernels = False
    try:
        plain = tmodel.decode_ids(slots)
    finally:
        tmodel.use_kernels = True
    assert torch.equal(ids, plain)


def test_reconstruct_autoregressive_matches_jax(steve_pair, monkeypatch):
    jcfg, jmodel, variables, tmodel, video = steve_pair
    noise = np.random.RandomState(3).randn(2, 3, 192).astype(np.float32)
    monkeypatch.setattr(jsa, "_sample_slot_noise",
                        lambda rng, shape: jnp.asarray(noise))

    def run(mdl, v):  # reconstruct_autoregressive, with its slots kept
        slots, vis, _ = mdl.encode(v)
        recon = mdl.decode(slots.reshape(4, mdl.num_slots, -1))
        return slots, vis, recon.reshape(v.shape)

    ref_slots, ref_vis, ref = jmodel.apply(
        variables, jnp.asarray(video), method=run,
        rngs={"slots": jax.random.PRNGKey(0)})
    tv = torch.from_numpy(video)
    slots, vis, _ = tmodel.encode(tv, noise=torch.from_numpy(noise))
    np.testing.assert_allclose(t2n(slots), np.asarray(ref_slots), atol=ATOL)
    np.testing.assert_allclose(t2n(vis), np.asarray(ref_vis), atol=ATOL)
    recon = tmodel.reconstruct_autoregressive(
        tv, noise=torch.from_numpy(noise))
    assert recon.shape == (2, 2, 16, 16, 3)
    np.testing.assert_allclose(t2n(recon), np.asarray(ref), atol=1e-4)


# ---- entry point, options, initialisers --------------------------------------

def test_steve_entry_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        steve_entry(tiny=True)


def test_steve_entry_on_cpu_runs_tiny_slice():
    fn, (video,) = steve_entry(device="cpu", batch=2, frames=2, tiny=True)
    assert video.shape == (2, 2, 16, 16, 3)
    recon = fn(video)
    assert recon.shape == video.shape and torch.isfinite(recon).all()
    assert recon.min() >= 0.0 and recon.max() <= 1.0
    fn.generator.manual_seed(0)
    assert torch.equal(fn(video), recon)  # the noise comes from fn.generator


def test_packed_decoder_is_cached_until_the_weights_change():
    """The fused rollout packs its weights once, and again after a load or
    an in-place update; so does the module rollout's cast copy."""
    fn, (video,) = steve_entry(device="cpu", batch=1, frames=1, tiny=True)
    model = fn.model
    slots = torch.randn(1, 3, 192, generator=torch.Generator().manual_seed(0))
    packed = model._packed_decoder(torch.float32)
    head_w = packed.head_w.clone()  # at float32 the pack aliases the weight
    ids = model.decode_ids(slots)
    assert model._packed_decoder(torch.float32) is packed
    cast = model._rollout_decoder(torch.bfloat16)
    assert model._rollout_decoder(torch.bfloat16) is cast
    assert model._rollout_decoder(torch.float32) is model.steve_decoder
    sd = {k: v.clone() for k, v in model.state_dict().items()}
    sd["steve_decoder.head.weight"] = -sd["steve_decoder.head.weight"]
    model.load_state_dict(sd, strict=True)
    repacked = model._packed_decoder(torch.float32)
    assert repacked is not packed
    assert torch.equal(repacked.head_w, -head_w)
    assert model._rollout_decoder(torch.bfloat16) is not cast
    assert not torch.equal(model.decode_ids(slots), ids)
    with torch.no_grad():
        model.steve_decoder.head.weight.neg_()
    assert torch.equal(model._packed_decoder(torch.float32).head_w, head_w)
    assert torch.equal(model.decode_ids(slots), ids)


def test_steve_options_not_ported_raise():
    fn, (video,) = steve_entry(device="cpu", batch=1, frames=1, tiny=True)
    # the training forward is ported (tests/test_torch_port_slot_train.py)
    recon, ce, mse, attns = fn.model(
        video, 1.0, True, train=True, generator=torch.Generator().manual_seed(0))
    assert recon.shape == video.shape and attns.shape[:3] == (1, 1, 3)
    assert bool(torch.isfinite(ce)) and bool(torch.isfinite(mse))
    cfg = steve_cfg(tiny=True)
    cfg.TPU.INT8_SERVING = True  # ported: the W8A8 fused step
    assert build_model(cfg, device="cpu").int8_serving
    with pytest.raises(ValueError, match="only the fused step"):
        fn.model.fused_ar_step = False
        fn.model.decode_ids(torch.zeros(1, 3, 192),
                            logits=torch.zeros(16, 1, 32))


def test_steve_initialisers():
    """The JAX package's initialisers by parameter kind."""
    cfg = steve_cfg(tiny=True)
    cfg.SLOTS.VOCAB_SIZE = 512
    cfg.MODEL.CNN_NAME = "res18"
    model = build_model(cfg, device="cpu", seed=1)
    p = dict(model.named_parameters())
    d = cfg.SLOTS.DECODER.DIM
    w_hh = p["steve_encoder.savi.gru.weight_hh"]  # [3H, H], H = 192
    torch.testing.assert_close(w_hh.t() @ w_hh, torch.eye(192), atol=1e-4,
                               rtol=0)
    assert abs(p["steve_decoder.dict.dictionary.weight"].std().item() - 1) < 0.05
    assert p["steve_decoder.pos.pe"].abs().max() <= 2.0
    assert p["steve_decoder.pos.pe"].std() > 0.5
    assert p["steve_decoder.bos"].abs().max() <= (6 / (1 + d)) ** 0.5
    q = p["steve_decoder.tf.blocks.0.self_attn.proj_q.weight"]
    o = p["steve_decoder.tf.blocks.0.self_attn.proj_o.weight"]
    xavier = (6 / (2 * d)) ** 0.5
    assert 0.9 * xavier < q.abs().max() <= xavier
    gain = (3 * cfg.SLOTS.DECODER.NUM_BLOCKS) ** -0.5
    assert 0.9 * gain * xavier < o.abs().max() <= gain * xavier
    fc1 = p["steve_decoder.tf.blocks.0.ffn.0.weight"]
    assert 0.9 * (6 / d) ** 0.5 < fc1.abs().max() <= (6 / d) ** 0.5
    assert all(p[k].abs().max() == 0 for k in p if k.endswith(".bias"))
    bn = model.steve_encoder.cnn.bn1
    assert torch.equal(bn.running_var, torch.ones(64))
    assert torch.equal(bn.weight, torch.ones(64))
