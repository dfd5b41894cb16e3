"""The W8A8 serving matrix of the port on the CPU, against the JAX package
on the same numpy inputs and weights: the dynamic W8A8 dense
(``ops/quant.py``), the tiny flagship with ``TPU.INT8_SERVING``,
``TPU.FAST_GELU`` and both, the int8 argmax rule on the golden fixtures, the
W8A8 decode step's pack and plain version against ``quantize_wstack`` and the
Pallas kernel in interpret mode, and STEVE's W8A8 rollout."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from focus_tpu.ops import quant as jquant
from focus_tpu.ops.pallas import ar_decode as jar
from focus_tpu_torch.config import get_cfg
from focus_tpu_torch.entry import flagship_cfg, steve_cfg, steve_entry
from focus_tpu_torch.models.build import build_model
from focus_tpu_torch.models.common import TransformerDecoder
from focus_tpu_torch.ops import ar_decode as tar
from focus_tpu_torch.ops import quant as tquant
from focus_tpu_torch.utils.weights import load_jax_params

from tests.test_torch_port_ar_decode import (  # noqa: F401 (fixture)
    D,
    HEADS,
    NB,
    V,
    decoder_weights,
    step_state,
)
from tests.test_torch_port_models import load, mf_full_cfg
from tests.test_torch_port_steve import steve_pair  # noqa: F401 (fixture)
from tests.test_torch_port_train import jax_cfg


def t2n(t):
    return t.detach().float().numpy()


# ---- the W8A8 dense ----------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantized_dense_matches_jax(dtype):
    """Codes and outputs against focus_tpu.ops.quant on the same inputs,
    with an all-zero row and a row holding a 1e4 outlier. The weight codes
    are equal (same float32 operations); an activation code may differ only
    at a rounding tie, and an output only where a code of its row differs,
    by at most one quantum s_x * amax_w (plus the output's rounding)."""
    rs = np.random.RandomState(0)
    x = rs.randn(6, 40, 64).astype(np.float32)
    x[0, 0] = 0.0
    x[1, 3, 5] = 1e4
    w = (rs.randn(64, 96) * 0.05).astype(np.float32)  # JAX layout [K, N]
    b = (rs.randn(96) * 0.1).astype(np.float32)
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    tdt = getattr(torch, dtype)
    xj = jnp.asarray(x).astype(jdt)
    xt = torch.from_numpy(x).to(tdt)

    jq, js = jquant.quantize_weight(jnp.asarray(w))
    tq, ts = tquant.quantize_weight(torch.from_numpy(w.T.copy()))
    np.testing.assert_array_equal(t2n(tq).T, np.asarray(jq))
    np.testing.assert_array_equal(t2n(ts), np.asarray(js)[0])

    jxq, jxs = jquant.quantize_acts(xj)
    txq, txs = tquant.quantize_acts(xt)
    np.testing.assert_array_equal(t2n(txs), np.asarray(jxs))
    differ = t2n(txq) != np.asarray(jxq)
    ratio = x.astype(np.float32) if dtype == "float32" else t2n(xt)
    ties = np.abs(np.abs(ratio / np.asarray(jxs)) % 1.0 - 0.5) < 1e-4
    assert not (differ & ~ties).any()
    assert (t2n(txq)[0, 0] == 0).all() and np.isfinite(t2n(txs)).all()

    jy = np.asarray(jquant.quantized_dense(xj, jnp.asarray(w),
                                           jnp.asarray(b)).astype(jnp.float32))
    ty = tquant.quantized_dense(xt, tq, ts, torch.from_numpy(b))
    assert ty.dtype == tdt and ty.shape == (6, 40, 96)
    assert np.isfinite(t2n(ty)).all()
    np.testing.assert_array_equal(t2n(ty)[0, 0],
                                  t2n(torch.from_numpy(b).to(tdt)))
    row_differs = differ.any(-1, keepdims=True)
    quantum = np.asarray(jxs) * np.abs(w).max(0)
    ulp = np.abs(jy) * (2.0 ** -7 if dtype == "bfloat16" else 2.0 ** -22)
    err = np.abs(t2n(ty) - jy)
    assert (err <= np.where(row_differs, quantum, 0.0) + ulp).all()


def test_quantized_linear_quantizes_once_per_weight_state():
    layer = torch.nn.Linear(16, 8)
    x = torch.randn(4, 16, generator=torch.Generator().manual_seed(0))
    y = tquant.quantized_linear(x, layer)
    codes = layer._w8a8[1][0]
    assert tquant.quantized_linear(x, layer) is not y
    assert layer._w8a8[1][0] is codes  # kept
    with torch.no_grad():
        layer.weight.mul_(2.0)  # an in-place update: quantized again
    y2 = tquant.quantized_linear(x, layer)
    assert layer._w8a8[1][0] is not codes
    torch.testing.assert_close(y2 - layer.bias, 2 * (y - layer.bias),
                               rtol=1e-5, atol=1e-5)


# ---- the tiny flagship's serving variants --------------------------------------

@pytest.fixture(scope="module")
def tiny_variants():
    """The tiny flagship (flagship_cfg(tiny=True): D=24, 3 layers, ORViT at
    [1] with the motion stream, float32) built by the JAX package, with its
    init params perturbed by N(0, 0.1^2) so that LayerNorm scales, biases
    and the class scores are not at their trivial init, and a batch."""
    from focus_tpu.models.build import build_model as jax_build_model
    from focus_tpu.models.build import init_model

    cfg = flagship_cfg(tiny=True)
    jcfg = jax_cfg(cfg)
    rs = np.random.RandomState(3)
    T, crop = cfg.DATA.NUM_FRAMES, cfg.DATA.TRAIN_CROP_SIZE
    video = rs.rand(2, T, crop, crop, 3).astype(np.float32)
    boxes = (rs.rand(2, T // 2, cfg.ORVIT.O, 4) * 0.5 + 0.25).astype(
        np.float32)
    variables = init_model(jax_build_model(jcfg), jcfg,
                           (jnp.asarray(video),
                            {"orvit_bboxes": jnp.asarray(boxes)}),
                           rng=jax.random.PRNGKey(0))
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + (rs.randn(*a.shape) * 0.1).astype(np.float32),
        jax.device_get(variables["params"]))
    return {"cfg": cfg, "params": params, "video": video, "boxes": boxes}


def _variant(tiny, fast_gelu, int8):
    from focus_tpu.models.build import build_model as jax_build_model

    cfg = tiny["cfg"].clone()
    cfg.TPU.FAST_GELU, cfg.TPU.INT8_SERVING = fast_gelu, int8
    jmodel = jax_build_model(jax_cfg(cfg))
    model = build_model(cfg, device="cpu")
    load_jax_params(model, tiny["params"])  # strict: the same param tree
    return jmodel, model


@pytest.mark.parametrize("fast_gelu,int8", [(True, False), (False, True),
                                            (True, True)],
                         ids=["fast_gelu", "int8", "fast_gelu+int8"])
def test_tiny_flagship_variant_matches_jax(tiny_variants, fast_gelu, int8):
    """Eval log-probabilities against the JAX model (its XLA path on the
    CPU, jitted) on the same weights and inputs, float32: atol 1e-5 with the
    tanh GELU alone (sums in another order; measured 4.8e-7, and the tanh
    form moves them by 4.3e-5 from the erf model); 1e-4 with int8 (the same
    codes from the same formulas, measured 4.8e-7; an activation within
    float32 noise of a rounding tie may flip its code, one quantum of one
    output; the int8 variant moves them by ~1e-2, so a wrong scale or a
    layer left out fails)."""
    jmodel, model = _variant(tiny_variants, fast_gelu, int8)
    video, boxes = tiny_variants["video"], tiny_variants["boxes"]
    ref = np.asarray(jax.jit(jmodel.apply)(
        {"params": tiny_variants["params"]}, jnp.asarray(video),
        {"orvit_bboxes": jnp.asarray(boxes)}))
    meta = {"orvit_bboxes": torch.from_numpy(boxes)}
    with torch.no_grad():
        out = t2n(model(torch.from_numpy(video), meta))
    np.testing.assert_allclose(np.log(out), np.log(ref),
                               atol=1e-4 if int8 else 1e-5)
    assert (out.argmax(-1) == ref.argmax(-1)).all()
    # the variant moves the outputs (its flags reach the layers) and stays
    # within test_int8_serving.py's bound of the erf float model
    _, plain = _variant(tiny_variants, False, False)
    with torch.no_grad():
        base = t2n(plain(torch.from_numpy(video), meta))
    assert np.abs(np.log(out) - np.log(base)).max() > (1e-3 if int8 else 1e-5)
    assert np.abs(out - base).max() < 0.05


def test_int8_serving_leaves_training_untouched(tiny_variants):
    """INT8_SERVING applies in eval only: train=True gives logits bit-equal
    to the model without it (test_int8_serving.py:125)."""
    _, q = _variant(tiny_variants, False, True)
    _, f = _variant(tiny_variants, False, False)
    video = torch.from_numpy(tiny_variants["video"])
    meta = {"orvit_bboxes": torch.from_numpy(tiny_variants["boxes"])}
    gq = torch.Generator().manual_seed(1)
    gf = torch.Generator().manual_seed(1)
    lq = q(video, meta, train=True, generator=gq)
    lf = f(video, meta, train=True, generator=gf)
    assert torch.equal(lq, lf)
    assert not any(hasattr(m, "_w8a8") for m in q.modules())


@pytest.mark.parametrize("name,orvit_layers", [
    ("motionformer_full", ()), ("orvit_mf_full", (1,))])
def test_int8_argmax_rule_on_golden_fixtures(name, orvit_layers):
    """test_int8_serving.py:162-196 on the port: with INT8_SERVING the
    executed reference's argmax is kept on every row, and max |delta| stays
    below half the reference's top-2 gap."""
    d, sd = load(name)
    cfg = mf_full_cfg(get_cfg, orvit_layers)
    cfg.TPU.INT8_SERVING = True
    model = build_model(cfg, device="cpu")
    model.load_state_dict(sd, strict=True)
    video = torch.from_numpy(d["video"].transpose(0, 2, 3, 4, 1).copy())
    meta = {"orvit_bboxes": torch.from_numpy(d["boxes"])} if "boxes" in d else {}
    with torch.no_grad():
        q = t2n(model(video, meta))
    ref = d["out"]
    assert np.isfinite(q).all()
    np.testing.assert_array_equal(q.argmax(-1), ref.argmax(-1))
    srt = np.sort(ref, axis=-1)
    gap = srt[..., -1] - srt[..., -2]
    assert (np.abs(q - ref).max(-1) < 0.5 * gap).all()


# ---- the W8A8 decode step ------------------------------------------------------

def _jax_w8a8(decoder_weights):
    (wstack, lnp, bias, flnp), packed, _ = decoder_weights
    wi8, scale = jar.quantize_wstack(wstack)
    return (wi8, scale, lnp, bias, flnp), tar.quantize_packed(packed)


def test_w8a8_pack_matches_quantize_wstack(decoder_weights):
    """Codes and scales equal to the JAX pack's after re-layout: the layer
    chunks ([in, out] there, [out, in] here), fc2's row chunks (its D-wide K
    groups), the head's column chunks and the dictionary's row chunks."""
    (wi8, scale, *_), q = _jax_w8a8(decoder_weights)
    wi8, scale = np.asarray(wi8), np.asarray(scale)[:, :, 0]
    dd = D * D
    assert q.wq.dtype == torch.int8 and q.wscale.shape == (NB, 14, D)
    for l in range(NB):
        w = q.wq[l]
        for c in range(10):
            np.testing.assert_array_equal(t2n(w[c * dd:(c + 1) * dd].view(D, D)),
                                          wi8[l, c].T)
        fc2 = w[10 * dd:].view(D, 4 * D)
        for j in range(4):
            np.testing.assert_array_equal(t2n(fc2[:, j * D:(j + 1) * D]),
                                          wi8[l, 10 + j].T)
        np.testing.assert_array_equal(t2n(q.wscale[l]), scale[l])
    nh = V // D
    for j in range(nh):
        rows = slice(j * D, (j + 1) * D)
        np.testing.assert_array_equal(t2n(q.head_q[rows]), wi8[NB, j].T)
        np.testing.assert_array_equal(t2n(q.head_s[rows]), scale[NB, j])
        np.testing.assert_array_equal(t2n(q.dict_q[rows]), wi8[NB, nh + j])
        np.testing.assert_array_equal(t2n(q.dict_s[j]), scale[NB, nh + j])


@pytest.mark.parametrize("t", [0, 4])
def test_w8a8_step_matches_pallas_interpret(decoder_weights, t):
    """The plain W8A8 step against fused_ar_step(..., wscale=...,
    interpret=True), float32, B=3, L=9. Both quantize the same values with
    the same formulas: ids equal wherever the port's top-2 margin is clear
    (> 1e-4), the next input equal where the ids are, cache row t within
    2e-5 (sums in another order; a flipped activation code at a tie would
    show here as one quantum), other rows untouched. The JAX step returns
    no logits: the port's argmax is checked against its own logits."""
    (wi8, scale, lnp, bias, flnp), q = _jax_w8a8(decoder_weights)
    B, L = 3, 9
    st = step_state(1 + t, B, L)
    nx, z, k_new, v_new = jar.fused_ar_step(
        jnp.asarray(st["x"]), t, wi8, lnp, bias, jnp.asarray(st["ckv"]),
        jnp.asarray(st["k"]), jnp.asarray(st["v"]), flnp,
        jnp.asarray(st["pos"]), heads=HEADS, nh=V // D, wscale=scale,
        interpret=True)
    kc, vc = torch.from_numpy(st["k"].copy()), torch.from_numpy(st["v"].copy())
    logits = torch.empty(B, V)
    tnx, tz, _, _ = tar.fused_ar_step(
        torch.from_numpy(st["x"]), t, q, torch.from_numpy(st["ckv"]), kc, vc,
        torch.from_numpy(st["pos"]), HEADS, logits_out=logits)
    top2 = logits.topk(2).values
    clear = t2n(top2[:, 0] - top2[:, 1]) > 1e-4
    assert clear.all()
    np.testing.assert_array_equal(t2n(tz)[clear], np.asarray(z)[clear, 0])
    np.testing.assert_array_equal(t2n(logits.argmax(-1)), t2n(tz))
    same = t2n(tz) == np.asarray(z)[:, 0]
    np.testing.assert_array_equal(t2n(tnx)[same], np.asarray(nx)[same])
    np.testing.assert_allclose(t2n(kc[:, t]), np.asarray(k_new)[:, t],
                               atol=2e-5)
    np.testing.assert_allclose(t2n(vc[:, t]), np.asarray(v_new)[:, t],
                               atol=2e-5)
    rest = [j for j in range(L) if j != t]
    np.testing.assert_array_equal(t2n(kc[:, rest]), st["k"][:, rest])


def test_w8a8_next_input_in_a_partial_dictionary_group():
    """V = 40, D = 16: the last dictionary group holds rows 32..39 only and
    its scales come from those rows. The head favours ids 36 and 37 (both in
    that group); the next input is checked against the codes and scales
    computed here by hand."""
    Dn, Vn = 16, 40
    gen = torch.Generator().manual_seed(7)
    tf = TransformerDecoder(1, Dn, HEADS).eval()
    head = torch.nn.Linear(Dn, Vn, bias=False)
    dictionary = torch.nn.Embedding(Vn, Dn)
    with torch.no_grad():
        for p in [*tf.parameters(), dictionary.weight]:
            p.copy_(torch.randn(p.shape, generator=gen) * 0.5)
        head.weight.zero_()
        head.weight[37] = 1.0
        head.weight[36] = -1.0
    q = tar.quantize_packed(tar.stack_decoder_params(tf, head, dictionary,
                                                     torch.float32))
    assert q.dict_s.shape == (3, Dn)
    rs = np.random.RandomState(2)
    B, L, t = 4, 5, 2
    x = torch.from_numpy((rs.randn(B, Dn) * 0.5).astype(np.float32))
    ckv = torch.from_numpy((rs.randn(1, 2, B, 3, Dn) * 0.5).astype(np.float32))
    k = torch.from_numpy((rs.randn(1, L, B, Dn) * 0.3).astype(np.float32))
    v = torch.from_numpy((rs.randn(1, L, B, Dn) * 0.3).astype(np.float32))
    pos = torch.from_numpy((rs.randn(L, Dn) * 0.1).astype(np.float32))
    nx, z, _, _ = tar.ar_step_reference(x, t, q, ckv, k, v, pos, HEADS)
    assert set(z.tolist()) <= {36, 37}
    dict_w = dictionary.weight.detach().numpy()
    s = np.maximum(np.abs(dict_w[32:40]).max(0), np.float32(1e-8)) / np.float32(127)
    for row, zi in enumerate(z.tolist()):
        codes = np.round(dict_w[zi] / s)
        want = ((np.float32(127) * codes).astype(np.float32)
                * np.float32(1.0 / 127.0)) * s
        np.testing.assert_array_equal(t2n(nx[row]), want.astype(np.float32))


def test_w8a8_wrapper_rules(decoder_weights):
    """The CPU takes the plain version without counting a launch; another
    device raises; the designed launch count and the workspace size."""
    _, q = _jax_w8a8(decoder_weights)
    st = {n: torch.from_numpy(a) for n, a in step_state(7, 2, 5).items()}
    before = (tar.LAUNCHES, tar.DEVICE_LAUNCHES, tar.W8A8_LAUNCHES,
              tar.W8A8_DEVICE_LAUNCHES)
    out = tar.fused_ar_step(st["x"], 2, q, st["ckv"], st["k"].clone(),
                            st["v"].clone(), st["pos"], HEADS)
    ref = tar.ar_step_reference(st["x"], 2, q, st["ckv"], st["k"].clone(),
                                st["v"].clone(), st["pos"], HEADS)
    assert all(torch.equal(a, b) for a, b in zip(out, ref))
    assert (tar.LAUNCHES, tar.DEVICE_LAUNCHES, tar.W8A8_LAUNCHES,
            tar.W8A8_DEVICE_LAUNCHES) == before
    meta = {n: a.to("meta") for n, a in st.items()}
    with pytest.raises(ValueError, match="no decode-step kernel"):
        tar.fused_ar_step(meta["x"], 2, q, meta["ckv"], meta["k"], meta["v"],
                          meta["pos"], HEADS)
    assert tar.launches_per_step(8, w8a8=True) == 115
    assert tar.launches_per_step(8) == 91
    n = tar.workspace(32, 2048, "meta", w8a8=True).numel()
    assert n == 32 * 2048 * 18 + 32 * 4 * 2048 + 32 * 16


# ---- STEVE's W8A8 rollout --------------------------------------------------------

def test_steve_w8a8_rollout_matches_jax_fused(steve_pair, monkeypatch):
    """The whole W8A8 rollout (16 steps, 4 rows) against the JAX package's
    _decode_ids_cached_fused with INT8_SERVING and its Pallas step in
    interpret mode, on the same weights and slots: the same ids."""
    from focus_tpu.models.build import build_model as jax_build

    jcfg, _, variables, _, _ = steve_pair
    jcfg = jcfg.clone()
    jcfg.TPU.INT8_SERVING = True
    jmodel = jax_build(jcfg)
    monkeypatch.setattr(jar, "INTERPRET", True)
    slots = (np.random.RandomState(1).randn(4, 3, 192) * 0.5).astype(
        np.float32)

    def run(mdl):
        return mdl._decode_ids_cached_fused(
            mdl.steve_encoder.slot_proj(jnp.asarray(slots)), 16)

    ref = np.asarray(jmodel.apply(variables, method=run))
    cfg = steve_cfg(tiny=True)
    cfg.TPU.INT8_SERVING = True
    model = build_model(cfg, device="cpu")
    load_jax_params(model, variables["params"])
    ids = model.decode_ids(torch.from_numpy(slots))
    np.testing.assert_array_equal(t2n(ids), ref)


def test_steve_w8a8_rollout_runs_on_the_cpu():
    """steve_entry(int8=True) on the CPU: the W8A8 pack is used, the result
    is deterministic, the pixels finite in [0, 1]."""
    fn, (video,) = steve_entry(device="cpu", batch=2, frames=2, tiny=True,
                               int8=True)
    assert fn.model.int8_serving
    recon = fn(video)
    assert recon.shape == video.shape and torch.isfinite(recon).all()
    assert recon.min() >= 0.0 and recon.max() <= 1.0
    assert ("packed_w8a8", torch.float32) in fn.model._rollout_cache
    fn.generator.manual_seed(0)
    assert torch.equal(fn(video), recon)


def _snap_to_int8_grid(model):
    """Write the dequantized W8A8 pack back into the decoder's weights, so
    that quantizing them again is lossless."""
    dec = model.steve_decoder
    q = model._packed_decoder(torch.float32, w8a8=True)
    D_ = model.d_model
    dd = D_ * D_
    with torch.no_grad():
        for l, blk in enumerate(dec.tf.blocks):
            w = q.wq[l].float()
            s = q.wscale[l]
            mats = [blk.self_attn.proj_q, blk.self_attn.proj_k,
                    blk.self_attn.proj_v, blk.self_attn.proj_o,
                    blk.encoder_decoder_attn.proj_q,
                    blk.encoder_decoder_attn.proj_o]
            for c, m in enumerate(mats):
                m.weight.copy_(w[c * dd:(c + 1) * dd].view(D_, D_)
                               * s[c][:, None])
            blk.ffn[0].weight.copy_(w[6 * dd:10 * dd].view(4 * D_, D_)
                                    * s[6:10].reshape(-1)[:, None])
            fc2 = w[10 * dd:].view(D_, 4, D_) * s[10:14].t()[:, :, None]
            blk.ffn[2].weight.copy_(fc2.reshape(D_, 4 * D_))
        dec.head.weight.copy_(q.head_q.float() * q.head_s[:, None])
        V_ = q.dict_q.shape[0]
        dec.dict.dictionary.weight.copy_(
            q.dict_q.float() * q.dict_s.repeat_interleave(D_, 0)[:V_])


def test_steve_w8a8_ids_agree_with_bf16_on_snapped_weights():
    """tests/test_steve_fused_ar.py:158-215 on the port's rollout: with the
    decoder's weights snapped to their own int8 grid, what is left is the
    dynamic activation quantization, so at least half of the ids agree with
    the rollout without INT8_SERVING from the same slots."""
    cfg = steve_cfg(tiny=True)
    cfg.TPU.INT8_SERVING = True
    model = build_model(cfg, device="cpu", seed=2)
    codes = model._packed_decoder(torch.float32, w8a8=True).wq
    _snap_to_int8_grid(model)
    # the snap updated the weights in place: repacked, to the same codes
    assert torch.equal(model._packed_decoder(torch.float32, w8a8=True).wq,
                       codes)
    slots = torch.randn(6, 3, 192, generator=torch.Generator().manual_seed(4))
    ids_q = model.decode_ids(slots)
    model.int8_serving = False
    ids_f = model.decode_ids(slots)
    assert (ids_q == ids_f).float().mean().item() >= 0.5
