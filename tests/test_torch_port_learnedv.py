"""The port's learned-v trajectory attention (``use_original_code=False``)
on the CPU against the JAX package on the same numpy inputs: the space
stage (the plain version of kernel 8) against ``attn_ops.space_stage`` and
the Pallas kernel in interpret mode, its plain backward against ``jax.vjp``,
the module against the golden fixture and the JAX module, the block's
output and every parameter's gradient against ``jax.grad``, and the block
profiler at a tiny size."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from focus_tpu.models.motionformer import TrajectoryAttention as JaxAttention
from focus_tpu.models.motionformer import TrajectoryAttentionBlock as JaxBlock
from focus_tpu.ops import attention as jattn
from focus_tpu.ops.pallas.trajectory_attention import space_stage_fused
from focus_tpu_torch import profile_block
from focus_tpu_torch.models.motionformer import (
    TrajectoryAttention,
    TrajectoryAttentionBlock,
)
from focus_tpu_torch.ops import trajectory_attention as tta
from focus_tpu_torch.utils.weights import (
    jax_grads_to_state_dict,
    jax_params_to_state_dict,
)

FIXDIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures")


def stage_inputs(S, F, BH=4, d=8, seed=0):
    rs = np.random.RandomState(seed)
    return [rs.randn(BH, S, d).astype(np.float32) for _ in range(3)]


# ---- the space stage (kernel 8's plain version) ---------------------------

@pytest.mark.parametrize("against", ["xla", "pallas_interpret"])
@pytest.mark.parametrize("S,F", [(12, 3), (20, 4), (39, 3)])
def test_space_stage_matches_jax(S, F, against):
    """(39, 3) has N = 13 keys per frame, no multiple of 8: the Pallas
    kernel pads them to 128 and masks the pad columns. float32, atol 1e-5
    (tests/test_pallas_kernels.py:10)."""
    q, k, v = stage_inputs(S, F)
    BH, _, d = q.shape
    n = S // F
    scale = d ** -0.5
    if against == "xla":
        ref = jattn.space_stage(*map(jnp.asarray, (q, k, v)), F, scale)
    else:
        ref = space_stage_fused(jnp.asarray(q),
                                jnp.asarray(k.reshape(BH, F, n, d)),
                                jnp.asarray(v.reshape(BH, F, n, d)), scale,
                                True)
    before = tta.LAUNCHES
    out = tta.space_stage(*map(torch.from_numpy, (q, k, v)), F, scale)
    assert tta.LAUNCHES == before  # the CPU path launches nothing
    assert out.shape == (BH, S, F, d)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5)


@pytest.mark.parametrize("path", ["backward_reference", "autograd"])
def test_space_stage_backward_matches_jax_vjp(path):
    """space_stage_backward_reference (the backward of the kernel's autograd
    Function) and autograd of the plain forward, against jax.vjp of the
    Pallas stage in interpret mode (atol 1e-4, as
    tests/test_pallas_kernels.py's gradient test)."""
    S, F = 39, 3
    q, k, v = stage_inputs(S, F, seed=1)
    BH, _, d = q.shape
    n, scale = S // F, d ** -0.5
    kf, vf = k.reshape(BH, F, n, d), v.reshape(BH, F, n, d)
    g = np.random.RandomState(2).randn(BH, S, F, d).astype(np.float32)
    _, vjp = jax.vjp(lambda *a: space_stage_fused(*a, scale, True),
                     *map(jnp.asarray, (q, kf, vf)))
    ref = vjp(jnp.asarray(g))
    if path == "backward_reference":
        got = tta.space_stage_backward_reference(
            *map(torch.from_numpy, (q, kf, vf, g)), scale)
    else:
        tq, tk, tv = (torch.from_numpy(a).requires_grad_(True)
                      for a in (q, k, v))
        tta.space_stage(tq, tk, tv, F, scale).backward(torch.from_numpy(g))
        got = (tq.grad, tk.grad.reshape(BH, F, n, d),
               tv.grad.reshape(BH, F, n, d))
    for name, a, r in zip(("dq", "dk", "dv"), got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(r), atol=1e-4,
                                   err_msg=name)


# ---- the module and the block ---------------------------------------------

def test_learned_v_attention_golden():
    """The reference's executed learned-v TrajectoryAttention, its state
    dict loaded with strict=True (both halves of proj_kv are live here);
    atol 3e-5 (tests/test_golden_parity.py:52)."""
    d = dict(np.load(os.path.join(FIXDIR, "trajectory_attention_learnedv.npz")))
    sd = {k[3:]: torch.from_numpy(v) for k, v in d.items()
          if k.startswith("sd/")}
    C = d["x"].shape[-1]
    mod = TrajectoryAttention(C, int(d["num_heads"]), qkv_bias=True,
                              use_original_code=False)
    mod.load_state_dict(sd, strict=True)
    with torch.no_grad():
        out = mod(torch.from_numpy(d["x"]), tuple(int(t) for t in d["thw"]))
    np.testing.assert_allclose(out.numpy(), d["out"], atol=3e-5)


@pytest.mark.parametrize("with_cls", [True, False])
def test_learned_v_attention_matches_jax_module(with_cls):
    """The JAX module's learned-v branch and the port's on the same weights,
    carried by utils/weights.py (float32, atol 1e-5)."""
    D, heads, thw = 32, 4, (3, 2, 2)
    tokens = thw[0] * thw[1] * thw[2] + int(with_cls)
    x = np.random.RandomState(3).randn(2, tokens, D).astype(np.float32)
    jmod = JaxAttention(D, heads, qkv_bias=True, use_original_code=False)
    variables = jmod.init(jax.random.PRNGKey(1), jnp.asarray(x), thw,
                          with_cls_token=with_cls)
    ref, _ = jmod.apply(variables, jnp.asarray(x), thw,
                        with_cls_token=with_cls)
    mod = TrajectoryAttention(D, heads, qkv_bias=True,
                              use_original_code=False)
    mod.load_state_dict(jax_params_to_state_dict(variables["params"]),
                        strict=True)
    with torch.no_grad():
        out = mod(torch.from_numpy(x), thw, with_cls_token=with_cls)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5)


def test_learned_v_block_grads_match_jax():
    """A learned-v TrajectoryAttentionBlock (D=32, 4 heads, F=3) in float32:
    the output and the gradient of every parameter of
    sum(out * target) against jax.grad of the JAX block on the same
    weights (atol 1e-5 and 1e-4)."""
    D, heads, thw = 32, 4, (3, 2, 2)
    rs = np.random.RandomState(4)
    x = rs.randn(2, 1 + 12, D).astype(np.float32)
    target = rs.randn(2, 1 + 12, D).astype(np.float32)
    jblock = JaxBlock(D, heads, qkv_bias=True, use_original_code=False)
    params = jblock.init(jax.random.PRNGKey(2), jnp.asarray(x), {},
                         thw)["params"]

    def loss(p):
        out, _ = jblock.apply({"params": p}, jnp.asarray(x), {}, thw)
        return (out * jnp.asarray(target)).sum(), out

    (_, ref), jgrads = jax.value_and_grad(loss, has_aux=True)(params)
    block = TrajectoryAttentionBlock(D, heads, qkv_bias=True,
                                     use_original_code=False)
    block.load_state_dict(jax_params_to_state_dict(params), strict=True)
    out = block(torch.from_numpy(x), {}, thw, train=True)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref),
                               atol=1e-5)
    (out * torch.from_numpy(target)).sum().backward()
    ref_grads = jax_grads_to_state_dict(jgrads)
    assert set(ref_grads) == {n for n, _ in block.named_parameters()}
    for name, p in block.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), ref_grads[name].numpy(),
                                   atol=1e-4, err_msg=name)


def test_learned_v_stack_kernels_off_is_the_same_on_cpu():
    """The learned-v slice's stack on the CPU: the same output with
    use_kernels on (the plain versions, because the tensors are on the CPU)
    and off, no kernel launched."""
    model, x = profile_block.learned_v_stack(device="cpu", batch=2, tiny=True)
    before = tta.LAUNCHES
    with torch.no_grad():
        out = model(x)
        model.use_kernels = False
        plain = model(x)
    assert tta.LAUNCHES == before
    assert out.shape == x.shape and torch.isfinite(out).all()
    assert torch.equal(out, plain)


def test_profile_block_runs_on_cpu(capsys):
    rows = profile_block.main(
        list(profile_block.VARIANTS) + [
            "--device", "cpu", "--batch", "1", "--heads", "2", "--frames",
            "2", "--patches", "4", "--dim", "32", "--iters", "1"])
    assert [r["variant"] for r in rows] == list(profile_block.VARIANTS)
    assert all(r["finite"] for r in rows)
    assert all(r["ms_per_block"] == "not measured (CPU run)" for r in rows)
    printed = [json.loads(line) for line in
               capsys.readouterr().out.strip().splitlines()]
    assert printed == rows
