"""The trajectory core's forward versions 3, 5, 6 and 7 on the CPU: their
plain versions (step by step as the kernels compute) against the JAX
package's Pallas v3, v5, v6 and v7 kernels in interpret mode and against
``_xla_reference`` (v3 and v7 everywhere; v5 and v6 where their k2v
identity holds and where it does not), the ``FWD_VERSION`` dispatch, and
the wrappers' refusal of float32 operands on the card."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from focus_tpu.ops.pallas import trajectory_block as jtb
from focus_tpu_torch.ops import trajectory_block as ttb

from tests.test_torch_port_kernels import core_inputs, extreme_inputs

HEADS = 4
PORT = {3: ttb.trajectory_core_v3_reference,
        5: ttb.trajectory_core_v5_reference,
        6: ttb.trajectory_core_v6_reference,
        7: ttb.trajectory_core_v7_reference}
PALLAS = {3: jtb._fused_fwd_pallas, 5: jtb._fused_fwd_pallas_v5,
          6: jtb._fused_fwd_pallas_v6, 7: jtb._fused_fwd_pallas_v7}


def port(version, args, scale, heads=HEADS):
    return PORT[version](*map(torch.from_numpy, args), scale, heads).numpy()


@pytest.mark.parametrize("version", [3, 5, 6, 7])
@pytest.mark.parametrize("N", [12, 13])
def test_variant_reference_matches_pallas_interpret(version, N):
    """The plain version against the TPU kernel it follows, in interpret
    mode, on tests/test_fused_block.py:make_inputs (atol 2e-5, that test's
    tolerance); v3 under the JAX package's ``KERNEL_FLAGS``, as that test
    runs it."""
    args = core_inputs(N=N)
    scale = (16 // HEADS) ** -0.5
    ref = PALLAS[version](*map(jnp.asarray, args), scale, HEADS,
                          interpret=True)
    np.testing.assert_allclose(port(version, args, scale), np.asarray(ref),
                               atol=2e-5)


@pytest.mark.parametrize("version", [3, 5, 6, 7])
@pytest.mark.parametrize("sign,mag", [(-1.0, 25.0), (-1.0, 60.0), (1.0, 50.0)])
def test_variant_reference_extreme_logits(version, sign, mag):
    """Peaked stage-1 logits: the true per-frame max keeps the variants
    finite, and they match the max-subtracted XLA composition (atol 5e-4,
    tests/test_fused_block.py:_extreme_inputs' tolerance)."""
    args, scale = extreme_inputs(sign, mag)
    ref = jtb._xla_reference(*map(jnp.asarray, args), scale, HEADS)
    out = port(version, args, scale)
    assert np.isfinite(out).all()
    np.testing.assert_allclose(out, np.asarray(ref), atol=5e-4)


@pytest.mark.parametrize("version", [5, 6])
@pytest.mark.parametrize("heads", [1, 4])
def test_variant_k2v_identity_needs_equal_head_weights(version, heads):
    """l2_h = sum_n p_h M_h / s is q2_h . (xs_f . Wk2)_h only when every
    head's stage-1 weights are head h's: xs_f's channels of head h' carry
    head h' weights, and Wk2 mixes them into every head. With one head the
    variants are the trajectory core (atol 1e-6); with four heads and
    peaked logits they are another function, the JAX package's kernels and
    the port's plain versions alike (they agree at 2e-5)."""
    C = 16
    args = core_inputs(N=12, seed=2)
    args[0], args[1] = args[0] * 10, args[1] * 10  # peaked stage-1 weights
    scale = (C // heads) ** -0.5
    jargs = list(map(jnp.asarray, args))
    true = np.asarray(jtb._xla_reference(*jargs, scale, heads))
    pallas = np.asarray(PALLAS[version](*jargs, scale, heads,
                                        interpret=True))
    out = port(version, args, scale, heads)
    np.testing.assert_allclose(out, pallas, atol=2e-5)
    gap = np.abs(out - true).max()
    if heads == 1:
        assert gap < 1e-6
    else:
        assert gap > 1e-3 and np.abs(pallas - true).max() > 1e-3


def test_v7_reference_bf16_against_pallas_interpret():
    """In bf16 the interpret-mode v7 and v3 kernels are bit-equal (one
    rounding point for another: the two differ in arrangement alone), which
    is why v7 shares v3's plain version; that plain version, with a true
    max where the kernels clamp exp2, is within 2e-2 x max|out| of them
    (the card's KERNEL_TOL_REL; a couple of bf16 steps apart)."""
    args = core_inputs(N=13, seed=3)
    scale = (16 // HEADS) ** -0.5
    jargs = [jnp.asarray(a).astype(jnp.bfloat16) for a in args]
    v7 = np.asarray(PALLAS[7](*jargs, scale, HEADS, interpret=True)
                    .astype(jnp.float32))
    v3 = np.asarray(PALLAS[3](*jargs, scale, HEADS, interpret=True)
                    .astype(jnp.float32))
    np.testing.assert_array_equal(v7, v3)
    out = PORT[7](*[torch.from_numpy(a).bfloat16() for a in args], scale,
                  HEADS)
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(), v7,
                               atol=2e-2 * np.abs(v7).max())


@pytest.mark.parametrize("heads", [1, 4])
def test_v3_reference_is_the_trajectory_core(heads):
    """v3 computes the trajectory core's function: in float32 (where its
    rounding points round nothing) its plain version equals
    ``trajectory_core_reference`` (atol 2e-5), unlike v5 and v6."""
    args = [torch.from_numpy(a) for a in core_inputs(N=13, seed=4)]
    scale = (16 // heads) ** -0.5
    np.testing.assert_allclose(
        ttb.trajectory_core_v3_reference(*args, scale, heads).numpy(),
        ttb.trajectory_core_reference(*args, scale, heads).numpy(),
        atol=2e-5)


@pytest.mark.parametrize("version", [3, 4, 5, 6, 7])
def test_cpu_path_is_the_plain_core_at_every_version(version, monkeypatch):
    monkeypatch.setattr(ttb, "FWD_VERSION", version)
    args = [torch.from_numpy(a) for a in core_inputs()]
    before = (ttb.LAUNCHES, ttb.V3_LAUNCHES, ttb.V5_LAUNCHES,
              ttb.V6_LAUNCHES, ttb.V7_LAUNCHES)
    out = ttb.fused_trajectory_core(*args, 0.5, HEADS)
    assert torch.equal(out, ttb.trajectory_core_reference(*args, 0.5, HEADS))
    assert (ttb.LAUNCHES, ttb.V3_LAUNCHES, ttb.V5_LAUNCHES,
            ttb.V6_LAUNCHES, ttb.V7_LAUNCHES) == before


@pytest.mark.parametrize("version", [2, 8])
def test_unported_versions_raise(version, monkeypatch):
    """The check fused_trajectory_core makes on the card before any
    launch: the JAX package has no forward version 2 or 8 either."""
    monkeypatch.setattr(ttb, "FWD_VERSION", version)
    with pytest.raises(NotImplementedError,
                       match=rf"FWD_VERSION={version}: the port has the "
                             r"forward kernels \(3, 4, 5, 6, 7\)"):
        ttb.check_fwd_version()


@pytest.mark.parametrize("version", [3, 4, 5, 6, 7])
def test_ported_versions_pass_the_check(version):
    assert ttb.check_fwd_version(version) == version


@pytest.mark.parametrize("version", [3, 4, 5, 6, 7])
def test_fused_core_function_per_version(version, monkeypatch):
    """_FusedCore's control flow on the CPU, its launches replaced by the
    plain versions: the version's forward, kernel 7 from that forward's xs
    and q2 (v3, v4, v6, v7), or from xs and q2 recomputed with the version-4
    launch first (v5, which forms no xs), and the gradients of the plain
    core."""
    calls = []

    def plain(q, kf, vf, wq2, bq2, wk2, scale, heads):
        inter = {}
        ttb.trajectory_core_backward_reference(
            q, kf, vf, wq2, bq2, wk2, torch.zeros_like(bq2),
            torch.zeros_like(q), scale, heads, intermediates=inter)
        return (ttb.trajectory_core_reference(q, kf, vf, wq2, bq2, wk2, bq2,
                                              scale, heads),
                inter["xs"], inter["q2"])

    def launch(*a):
        calls.append("v4")
        return plain(*a)

    def launch_v3(*a):
        calls.append("v3")
        return plain(*a)

    def launch_v7(*a):
        calls.append("v7")
        return plain(*a)

    def launch_variant(v, *a):
        calls.append(f"v{v}")
        out, xs, q2 = plain(*a)
        return out, (xs if v == 6 else None), q2, {}

    def launch_backward(q, kf, vf, wq2, bq2, wk2, dout, xs, q2, scale, heads):
        calls.append("bwd")
        assert xs is not None and q2 is not None
        return ttb.trajectory_core_backward_reference(
            q, kf, vf, wq2, bq2, wk2, torch.zeros_like(bq2), dout, scale,
            heads)[:6]

    monkeypatch.setattr(ttb, "_launch", launch)
    monkeypatch.setattr(ttb, "_launch_v3", launch_v3)
    monkeypatch.setattr(ttb, "_launch_v7", launch_v7)
    monkeypatch.setattr(ttb, "_launch_variant", launch_variant)
    monkeypatch.setattr(ttb, "_launch_backward", launch_backward)
    args = [torch.from_numpy(a).requires_grad_(True) for a in core_inputs()]
    out = ttb._FusedCore.apply(*args, 0.5, HEADS, version)
    dout = torch.from_numpy(
        np.random.RandomState(6).randn(*out.shape).astype(np.float32))
    out.backward(dout)
    expect = {3: ["v3", "bwd"], 4: ["v4", "bwd"], 5: ["v5", "v4", "bwd"],
              6: ["v6", "bwd"], 7: ["v7", "bwd"]}
    assert calls == expect[version]
    ref = ttb.trajectory_core_backward_reference(
        *[a.detach() for a in args], dout, 0.5, HEADS)
    for a, r in zip(args, ref):
        np.testing.assert_allclose(a.grad.numpy(), r.numpy(), atol=1e-6)


class _OnCard(torch.Tensor):
    """A CPU tensor that reports a CUDA device: drives the wrappers' device
    dispatch without a card."""

    @property
    def device(self):
        return torch.device("cuda", 0)


@pytest.mark.parametrize("wrapper,version", [
    ("fused_trajectory_core", 3), ("fused_trajectory_core", 4),
    ("fused_trajectory_core", 5), ("fused_trajectory_core", 6),
    ("fused_trajectory_core", 7), ("space_stage", None)])
def test_float32_on_the_card_raises(wrapper, version, monkeypatch):
    """The kernels take bf16 alone: a CUDA call with float32 operands
    raises TypeError, naming the kernels' open float32 mode, before any
    kernel is built or launched, and never takes the plain version."""
    from focus_tpu_torch.ops import _build
    from focus_tpu_torch.ops import trajectory_attention as tta

    def no_build(*a, **k):
        raise AssertionError(f"kernel built for a float32 call: {a}")

    def no_plain(*a, **k):
        raise AssertionError("plain version taken on the card")

    monkeypatch.setattr(_build, "bind", no_build)
    if wrapper == "fused_trajectory_core":
        monkeypatch.setattr(ttb, "FWD_VERSION", version)
        monkeypatch.setattr(ttb, "trajectory_core_reference", no_plain)
        args = [torch.from_numpy(a) for a in core_inputs()]

        def call(*a):
            return ttb.fused_trajectory_core(*a, 0.5, HEADS)
    else:
        monkeypatch.setattr(tta.attn_ops, "space_stage", no_plain)
        rs = np.random.RandomState(2)
        args = [torch.from_numpy(rs.randn(4, 24, 64).astype(np.float32))
                for _ in range(3)]

        def call(*a):
            return tta.space_stage(*a, 2, 0.125)

    counts = (ttb.LAUNCHES, ttb.V3_LAUNCHES, ttb.V5_LAUNCHES,
              ttb.V6_LAUNCHES, ttb.V7_LAUNCHES, tta.LAUNCHES)
    with pytest.raises(TypeError, match="float32 mode is open"):
        call(*[a.as_subclass(_OnCard) for a in args])
    assert (ttb.LAUNCHES, ttb.V3_LAUNCHES, ttb.V5_LAUNCHES,
            ttb.V6_LAUNCHES, ttb.V7_LAUNCHES, tta.LAUNCHES) == counts
