"""The port's fused decode step on its CPU path (the plain version,
``ar_step_reference``): against the JAX package's Pallas kernel in interpret
mode on the same weights and state, against the port's own module path at
shapes the TPU kernel cannot take (V % D != 0; 40 rows with L = 257), and
the wrapper's rules."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from focus_tpu.models.common import TransformerDecoder as JaxDecoder
from focus_tpu.ops.pallas import ar_decode as jar
from focus_tpu_torch.entry import steve_cfg
from focus_tpu_torch.models.build import build_model
from focus_tpu_torch.models.common import TransformerDecoder, linear
from focus_tpu_torch.ops import ar_decode as tar
from focus_tpu_torch.utils.weights import load_jax_params

D, NB, HEADS, V, S = 32, 2, 2, 64, 3


@pytest.fixture(scope="module")
def decoder_weights():
    """A JAX TransformerDecoder's params, head and dictionary with random
    values, stacked for the Pallas kernel and packed for the port's."""
    rs = np.random.RandomState(0)
    jm = JaxDecoder(NB, D, HEADS)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 2, D)), jnp.zeros((1, S, D)))
    params = jax.tree_util.tree_map(
        lambda a: (rs.randn(*a.shape) * 0.2).astype(np.float32),
        shapes["params"])
    head_w = (rs.randn(D, V) * 0.2).astype(np.float32)  # [in, out]
    dict_w = rs.randn(V, D).astype(np.float32)
    jax_stack = jar.stack_decoder_params(
        params, NB, head_w=jnp.asarray(head_w), dict_emb=jnp.asarray(dict_w),
        dtype=jnp.float32)
    tf = TransformerDecoder(NB, D, HEADS).eval()
    load_jax_params(tf, params)
    head = torch.nn.Linear(D, V, bias=False)
    dictionary = torch.nn.Embedding(V, D)
    with torch.no_grad():
        head.weight.copy_(torch.from_numpy(head_w.T))
        dictionary.weight.copy_(torch.from_numpy(dict_w))
    packed = tar.stack_decoder_params(tf, head, dictionary, torch.float32)
    return jax_stack, packed, (tf, head, dictionary)


def step_state(seed, B, L):
    rs = np.random.RandomState(seed)
    return {
        "x": (rs.randn(B, D) * 0.5).astype(np.float32),
        "ckv": (rs.randn(NB, 2, B, S, D) * 0.5).astype(np.float32),
        "k": (rs.randn(NB, L, B, D) * 0.3).astype(np.float32),
        "v": (rs.randn(NB, L, B, D) * 0.3).astype(np.float32),
        "pos": (rs.randn(L, D) * 0.1).astype(np.float32),
    }


@pytest.mark.parametrize("t", [0, 4])
def test_reference_step_matches_pallas_interpret(decoder_weights, t):
    (wstack, lnp, bias, flnp), packed, _ = decoder_weights
    B, L = 3, 9
    st = step_state(1 + t, B, L)
    nx, z, k_new, v_new = jar.fused_ar_step(
        jnp.asarray(st["x"]), t, wstack, lnp, bias,
        jnp.asarray(st["ckv"]), jnp.asarray(st["k"]), jnp.asarray(st["v"]),
        flnp, jnp.asarray(st["pos"]), heads=HEADS, nh=V // D, interpret=True)
    kc, vc = torch.from_numpy(st["k"].copy()), torch.from_numpy(st["v"].copy())
    logits = torch.empty(B, V)
    tnx, tz, tk, tv = tar.fused_ar_step(
        torch.from_numpy(st["x"]), t, packed, torch.from_numpy(st["ckv"]), kc,
        vc, torch.from_numpy(st["pos"]), HEADS, logits_out=logits)
    assert tk is kc and tv is vc  # the caches are updated in place
    assert tz.dtype == torch.int32
    np.testing.assert_array_equal(tz.numpy(), np.asarray(z)[:, 0])
    np.testing.assert_array_equal(logits.argmax(-1).numpy(), tz.numpy())
    np.testing.assert_allclose(tnx.numpy(), np.asarray(nx), atol=2e-5)
    np.testing.assert_allclose(kc[:, t].numpy(), np.asarray(k_new)[:, t],
                               atol=2e-5)
    np.testing.assert_allclose(vc[:, t].numpy(), np.asarray(v_new)[:, t],
                               atol=2e-5)
    rest = [j for j in range(L) if j != t]
    np.testing.assert_array_equal(kc[:, rest].numpy(), st["k"][:, rest])
    np.testing.assert_array_equal(vc[:, rest].numpy(), st["v"][:, rest])


def test_rows_beyond_t_are_not_read(decoder_weights):
    _, packed, _ = decoder_weights
    B, L, t = 2, 9, 3
    st = {n: torch.from_numpy(a) for n, a in step_state(5, B, L).items()}
    args = lambda k, v: (st["x"], t, packed, st["ckv"], k, v, st["pos"], HEADS)
    nx, z, _, _ = tar.ar_step_reference(*args(st["k"].clone(), st["v"].clone()))
    k2, v2 = st["k"].clone(), st["v"].clone()
    k2[:, t + 1:] = 1e4
    v2[:, t + 1:] = -1e4
    nx2, z2, _, _ = tar.ar_step_reference(*args(k2, v2))
    assert torch.equal(nx, nx2) and torch.equal(z, z2)


def module_step(modules, x, t, ckv, k, v, pos):
    """One decode step through the port's modules: the reference for shapes
    the JAX fused step cannot take."""
    tf, head, dictionary = modules
    B, d = x.shape
    L, hd = k.shape[1], d // HEADS
    caches = tuple((k[l].transpose(0, 1).reshape(B, L, HEADS, hd).clone(),
                    v[l].transpose(0, 1).reshape(B, L, HEADS, hd).clone())
                   for l in range(k.shape[0]))
    kvs = tuple((ckv[l, 0].reshape(B, -1, HEADS, hd),
                 ckv[l, 1].reshape(B, -1, HEADS, hd))
                for l in range(k.shape[0]))
    with torch.no_grad():
        out, caches = tf(x[:, None] + pos[t], None, caches=caches, t=t,
                         cross_kvs=kvs)
        logits = linear(out, head)[:, 0]
    return logits, caches


@pytest.mark.parametrize("vocab,dim,rows,L,t", [
    (40, 16, 3, 9, 4),      # V % D != 0
    (7, 16, 3, 9, 8),       # V < D, last cache row
    (48, 16, 40, 257, 256),  # 40 rows, L = 257: the JAX fused step's cache
                             # block would leave the cache here
])
def test_reference_step_matches_module_path(vocab, dim, rows, L, t):
    rs = np.random.RandomState(vocab)
    gen = torch.Generator().manual_seed(vocab)
    tf = TransformerDecoder(1, dim, HEADS).eval()
    head = torch.nn.Linear(dim, vocab, bias=False)
    dictionary = torch.nn.Embedding(vocab, dim)
    with torch.no_grad():
        for p in [*tf.parameters(), head.weight]:
            p.copy_(torch.randn(p.shape, generator=gen) * 0.2)
    packed = tar.stack_decoder_params(tf, head, dictionary, torch.float32)
    assert packed.head_w.shape == (vocab, dim)
    x = torch.from_numpy((rs.randn(rows, dim) * 0.5).astype(np.float32))
    ckv = torch.from_numpy((rs.randn(1, 2, rows, S, dim) * 0.5).astype(np.float32))
    k = torch.from_numpy((rs.randn(1, L, rows, dim) * 0.3).astype(np.float32))
    v = torch.from_numpy((rs.randn(1, L, rows, dim) * 0.3).astype(np.float32))
    pos = torch.from_numpy((rs.randn(L, dim) * 0.1).astype(np.float32))
    ref_logits, ref_caches = module_step((tf, head, dictionary), x, t, ckv, k,
                                         v, pos)
    logits = torch.empty(rows, vocab)
    nx, z, k, v = tar.ar_step_reference(x, t, packed, ckv, k, v, pos, HEADS,
                                        logits_out=logits)
    torch.testing.assert_close(logits, ref_logits, atol=2e-5, rtol=0)
    assert torch.equal(z.long(), ref_logits.argmax(-1))
    assert torch.equal(nx, dictionary.weight[z.long()])
    torch.testing.assert_close(
        k[0, t], ref_caches[0][0][:, t].reshape(rows, dim), atol=2e-5, rtol=0)
    torch.testing.assert_close(
        v[0, t], ref_caches[0][1][:, t].reshape(rows, dim), atol=2e-5, rtol=0)


def test_argmax_takes_the_first_index_among_ties():
    tf = TransformerDecoder(1, 16, HEADS).eval()
    head = torch.nn.Linear(16, 6, bias=False)
    dictionary = torch.nn.Embedding(6, 16)
    with torch.no_grad():
        for p in tf.parameters():
            p.copy_(torch.randn(p.shape, generator=torch.Generator().manual_seed(0)) * 0.2)
        head.weight.copy_(head.weight[:1].expand(6, 16).clone())  # all tie
    packed = tar.stack_decoder_params(tf, head, dictionary, torch.float32)
    st = {n: torch.from_numpy(a) for n, a in step_state(3, 2, 4).items()}
    _, z, _, _ = tar.ar_step_reference(
        st["x"][:, :16].contiguous(), 1, packed,
        st["ckv"][:1, :, :, :, :16].contiguous(),
        st["k"][:1, :, :, :16].contiguous(),
        st["v"][:1, :, :, :16].contiguous(),
        st["pos"][:, :16].contiguous(), HEADS)
    assert z.tolist() == [0, 0]


def test_rollout_at_vocab_not_a_multiple_of_dim():
    """A whole rollout at V = 40, D = 16: the fused path's plain version and
    the module path give the same ids."""
    cfg = steve_cfg(tiny=True)
    cfg.SLOTS.VOCAB_SIZE = 40
    cfg.SLOTS.DECODER.DIM = 16
    model = build_model(cfg, device="cpu", seed=3)
    slots = torch.randn(5, 3, 192, generator=torch.Generator().manual_seed(1))
    fused = model.decode_ids(slots)
    model.fused_ar_step = False
    assert torch.equal(fused, model.decode_ids(slots))
    assert torch.equal(fused, model.decode_ids(slots, use_kv_cache=False))


def test_packing_layout_and_launch_count(decoder_weights):
    _, packed, (tf, head, _) = decoder_weights
    assert packed.wstack.shape == (NB, 14 * D * D)
    assert packed.lnp.shape == (NB, 6, D) and packed.bias.shape == (NB, 5 * D)
    assert packed.flnp.shape == (2, D)
    blk = tf.blocks[1]
    dd = D * D
    assert torch.equal(packed.wstack[1, dd:2 * dd].view(D, D),
                       blk.self_attn.proj_k.weight)
    assert torch.equal(packed.wstack[1, 10 * dd:].view(D, 4 * D),
                       blk.ffn[2].weight)
    assert torch.equal(packed.bias[1, 4 * D:], blk.ffn[2].bias)
    assert torch.equal(packed.head_w, head.weight)
    assert tar.launches_per_step(8) == 91
    assert tar.workspace(32, 2048, "meta").numel() == 32 * 2048 * 18


def test_wrapper_takes_the_plain_version_only_on_the_cpu(decoder_weights):
    _, packed, _ = decoder_weights
    st = {n: torch.from_numpy(a) for n, a in step_state(7, 2, 5).items()}
    before = tar.LAUNCHES, tar.DEVICE_LAUNCHES
    out = tar.fused_ar_step(st["x"], 2, packed, st["ckv"], st["k"].clone(),
                            st["v"].clone(), st["pos"], HEADS)
    ref = tar.ar_step_reference(st["x"], 2, packed, st["ckv"],
                                st["k"].clone(), st["v"].clone(), st["pos"],
                                HEADS)
    assert all(torch.equal(a, b) for a, b in zip(out, ref))
    # no kernel was launched
    assert (tar.LAUNCHES, tar.DEVICE_LAUNCHES) == before
    meta = {n: a.to("meta") for n, a in st.items()}
    with pytest.raises(ValueError, match="no decode-step kernel"):
        tar.fused_ar_step(meta["x"], 2, packed, meta["ckv"], meta["k"],
                          meta["v"], meta["pos"], HEADS)
