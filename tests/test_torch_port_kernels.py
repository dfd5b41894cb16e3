"""The port's two kernel modules, on their CPU path (the plain version),
against the JAX package on the same numpy inputs: the fused trajectory core
against ``_xla_reference`` and the Pallas v4 kernel in interpret mode, and
the patch embed against the Pallas kernel in interpret mode."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from focus_tpu.ops.pallas import trajectory_block as jtb
from focus_tpu.ops.pallas.patch_embed import patch_embed_3d as jax_patch_embed
from focus_tpu_torch.ops import patch_embed as tpe
from focus_tpu_torch.ops import trajectory_block as ttb


def core_inputs(B=2, F=3, N=12, C=16, seed=0):
    """As tests/test_fused_block.py:make_inputs, as numpy arrays."""
    rs = np.random.RandomState(seed)
    S = F * N
    return [
        (rs.randn(B, S, C) * 0.2).astype(np.float32),
        (rs.randn(B, F, N, C) * 0.2).astype(np.float32),
        (rs.randn(B, F, N, C) * 0.2).astype(np.float32),
        (rs.randn(C, C) * 0.1).astype(np.float32),
        (rs.randn(C) * 0.1).astype(np.float32),
        (rs.randn(C, C) * 0.1).astype(np.float32),
        (rs.randn(C) * 0.1).astype(np.float32),
    ]


def extreme_inputs(sign, mag, B=1, F=2, N=12, C=16, heads=4, seed=7):
    """As tests/test_fused_block.py:_extreme_inputs: stage-1 logits of
    ~sign*mag nats after the 1/sqrt(hd) scale."""
    rs = np.random.RandomState(seed)
    S = F * N
    scale = (C // heads) ** -0.5
    qdir = rs.randn(B, S, C).astype(np.float32)
    qdir /= np.linalg.norm(qdir, axis=-1, keepdims=True)
    amp = (mag / scale) ** 0.5
    q = (qdir * amp * sign).astype(np.float32)
    kf = (np.broadcast_to(qdir.reshape(B, F, N, C)[:, :1, :1], (B, F, N, C))
          * amp + rs.randn(B, F, N, C) * 0.01).astype(np.float32)
    vf = (rs.randn(B, F, N, C) * 0.2).astype(np.float32)
    wq2 = (rs.randn(C, C) * 0.1).astype(np.float32)
    bq2 = (rs.randn(C) * 0.1).astype(np.float32)
    wk2 = (rs.randn(C, C) * 0.1).astype(np.float32)
    bk2 = np.zeros((C,), np.float32)
    return [q, kf, vf, wq2, bq2, wk2, bk2], scale


def port_core(args, scale, heads):
    out = ttb.fused_trajectory_core(*map(torch.from_numpy, args), scale, heads)
    return out.numpy()


@pytest.mark.parametrize("against", ["xla_reference", "pallas_v4_interpret"])
@pytest.mark.parametrize("N", [12, 13])
def test_trajectory_core_matches_jax(against, N):
    heads = 4
    scale = (16 // heads) ** -0.5
    args = core_inputs(N=N)
    jargs = [jnp.asarray(a) for a in args]
    if against == "xla_reference":
        ref = jtb._xla_reference(*jargs, scale, heads)
    else:
        ref = jtb._fused_fwd_pallas_v4(*jargs, scale, heads, interpret=True,
                                       dense_kv=True)
    out = port_core(args, scale, heads)
    np.testing.assert_allclose(out, np.asarray(ref), atol=2e-5)


@pytest.mark.parametrize("sign,mag", [(-1.0, 25.0), (-1.0, 60.0), (1.0, 50.0)])
def test_trajectory_core_extreme_logits(sign, mag):
    """Peaked logits: the port's max-subtracted softmax stays finite and
    matches the XLA composition (the Pallas kernel clamps exp2 here, so it
    is not the reference)."""
    args, scale = extreme_inputs(sign, mag)
    ref = jtb._xla_reference(*[jnp.asarray(a) for a in args], scale, 4)
    out = port_core(args, scale, 4)
    assert np.isfinite(out).all()
    np.testing.assert_allclose(out, np.asarray(ref), atol=5e-4)


def test_trajectory_core_cpu_path_is_plain_and_not_counted():
    args = [torch.from_numpy(a) for a in core_inputs()]
    before = ttb.LAUNCHES
    out = ttb.fused_trajectory_core(*args, 0.5, 4)
    ref = ttb.trajectory_core_reference(*args, 0.5, 4)
    assert torch.equal(out, ref)
    assert ttb.LAUNCHES == before


@pytest.mark.parametrize(
    "shape,kernel",
    [
        ((2, 4, 64, 64, 3), (2, 16, 16)),   # flagship-style 16x16, kt=2
        ((1, 3, 32, 48, 3), (1, 16, 16)),   # kt=1, T not multiple of kt*2
        ((2, 2, 32, 32, 8), (2, 16, 16)),   # C already 8
    ],
)
def test_patch_embed_matches_jax_pallas(shape, kernel):
    rs = np.random.RandomState(0)
    x = rs.randn(*shape).astype(np.float32)
    kt, kh, kw = kernel
    C, dim = shape[-1], 24
    w = (rs.randn(kt, kh, kw, C, dim) * 0.05).astype(np.float32)
    b = (rs.randn(dim) * 0.1).astype(np.float32)
    ref, jthw = jax_patch_embed(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                                kernel, interpret=True)
    before = tpe.LAUNCHES
    out, thw = tpe.patch_embed_3d(torch.from_numpy(x), torch.from_numpy(w),
                                  torch.from_numpy(b), kernel)
    assert tuple(thw) == tuple(jthw)
    assert tpe.LAUNCHES == before
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-5)
