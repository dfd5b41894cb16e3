"""Whether the port's bf16 gradient gaps are the JAX package's too.

The tiny flagship (``train_cfg(tiny=True)``) on the same weights and batch,
through the weight bridge, computed in bfloat16 and in float32 in both
packages (JAX through XLA off the TPU, the port through its plain
versions): the relative L2 gap between the bf16 and the float32 gradient of
every block's ``proj_q`` and ``proj_kv`` weight (the stage-2 projections of
the trajectory core, whose gradients sit furthest from float32 on the card)
must be no larger in the port than in JAX, up to 1.25x (the slack the card's
train gate gives the bf16 plain path) plus 1e-3."""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from focus_tpu_torch.entry import train_cfg
from focus_tpu_torch.models.build import build_model
from focus_tpu_torch.utils.weights import (
    jax_grads_to_state_dict,
    load_jax_params,
)

from tests.test_torch_port_train import jax_cfg, tiny_batch

SLACK, FLOOR = 1.25, 1e-3
DTYPES = ("float32", "bfloat16")


def _cpu_dot_lowering():
    """(mlir, dot_general_p, table) of JAX's private per-platform lowering
    table for the CPU (present in jax 0.9.0), or None where this JAX has
    no such table."""
    try:
        from jax._src.interpreters import mlir
        from jax._src.lax import lax as jlax

        table = mlir._platform_specific_lowerings["cpu"]
        table[jlax.dot_general_p]
    except (ImportError, AttributeError, KeyError):
        return None
    return mlir, jlax.dot_general_p, table


pytestmark = pytest.mark.skipif(
    _cpu_dot_lowering() is None,
    reason=f"jax {jax.__version__} has no private CPU lowering table for "
           "dot_general (jax._src.interpreters.mlir), which the bf16 dot "
           "bridge replaces")


@contextlib.contextmanager
def bf16_dots_on_cpu():
    """This CPU build of XLA lacks some BF16 x BF16 -> F32 dot thunks (the
    JAX package's own bf16 tests skip for it, tests/test_bf16_train.py).
    While this is active, a dot of two bf16 operands is lowered for the CPU
    as the same dot of their exact float32 values, accumulated in float32
    as the TPU's matrix unit accumulates bf16 products; nothing else of the
    computation changes (test_bf16_dot_bridge holds it to that), and the
    JAX package's code is untouched."""
    mlir, dot_general_p, table = _cpu_dot_lowering()
    entry = table[dot_general_p]
    f32 = np.dtype(np.float32)

    def rule(ctx, lhs, rhs, **params):
        a, b = ctx.avals_in
        if a.dtype == jnp.bfloat16 and b.dtype == jnp.bfloat16:
            fa, fb = a.update(dtype=f32), b.update(dtype=f32)
            lhs = mlir.convert_hlo(ctx, lhs, a, fa)
            rhs = mlir.convert_hlo(ctx, rhs, b, fb)
            ctx = ctx.replace(avals_in=[fa, fb])
        return entry.rule(ctx, lhs, rhs, **params)

    mlir.register_lowering(dot_general_p, rule, platform="cpu")
    try:
        yield
    finally:
        table[dot_general_p] = entry


def test_bf16_dot_bridge():
    """The bridge leaves a float32 dot's lowering as it was; a bf16 dot
    under it is the float32 dot of the operands' exact float32 values
    (float32 out, or rounded once to bf16); the original rule is back
    after it."""
    from jax import lax

    mlir, dot_general_p, table = _cpu_dot_lowering()
    entry = table[dot_general_p]
    rs = np.random.RandomState(0)
    a = rs.randn(3, 40, 96).astype(np.float32)
    b = rs.randn(3, 96, 24).astype(np.float32)
    dims = (((2,), (1,)), ((0,), (0,)))

    def jit_dot(out=None):
        """A new jitted function each call, so nothing lowered is reused."""
        def dot(x, y):
            return lax.dot_general(x, y, dims, preferred_element_type=out)
        return jax.jit(dot)

    f32_text = jit_dot().lower(a, b).as_text()
    ab, bb = jnp.asarray(a, jnp.bfloat16), jnp.asarray(b, jnp.bfloat16)
    upcast = np.asarray(jit_dot()(ab.astype(jnp.float32),
                                  bb.astype(jnp.float32)))
    with bf16_dots_on_cpu():
        assert jit_dot().lower(a, b).as_text() == f32_text
        got = np.asarray(jit_dot(jnp.float32)(ab, bb))
        got_bf16 = jit_dot()(ab, bb)
    assert table[dot_general_p] is entry
    np.testing.assert_array_equal(got, upcast)
    assert got_bf16.dtype == jnp.bfloat16
    np.testing.assert_array_equal(
        np.asarray(got_bf16.astype(jnp.float32)),
        np.asarray(jnp.asarray(upcast).astype(jnp.bfloat16)
                   .astype(jnp.float32)))


def _cfg(dtype):
    cfg = train_cfg(tiny=True)
    cfg.NUM_GPUS = 1
    cfg.TPU.COMPUTE_DTYPE = dtype
    return cfg


@pytest.fixture(scope="module")
def grads():
    """{package: {dtype: {torch name: gradient}}} of the label-smoothing
    loss of the tiny flagship's train forward, from one set of params."""
    from focus_tpu.models import losses as jlosses
    from focus_tpu.models.build import build_model as jax_build_model
    from focus_tpu.models.build import init_model
    from focus_tpu_torch.models.losses import label_smoothing_cross_entropy

    video, labels, boxes = tiny_batch(_cfg("float32"))
    jvideo, jboxes = jnp.asarray(video), {"orvit_bboxes": jnp.asarray(boxes)}
    params = None
    out = {"jax": {}, "port": {}}
    for dtype in DTYPES:
        cfg = _cfg(dtype)
        jmodel = jax_build_model(jax_cfg(cfg))
        if params is None:
            params = jax.device_get(init_model(
                jmodel, jax_cfg(cfg), (jvideo, jboxes),
                rng=jax.random.PRNGKey(0))["params"])

        def loss_fn(p, jmodel=jmodel):
            logits = jmodel.apply({"params": p}, jvideo, jboxes, train=True,
                                  rngs={"dropout": jax.random.PRNGKey(1)})
            return jlosses.label_smoothing_cross_entropy(
                logits, jnp.asarray(labels))

        with bf16_dots_on_cpu():
            jg = jax.device_get(jax.jit(jax.grad(loss_fn))(params))
        out["jax"][dtype] = jax_grads_to_state_dict(jg)

        model = build_model(cfg, device="cpu")
        load_jax_params(model, params)
        logits = model(torch.from_numpy(video),
                       {"orvit_bboxes": torch.from_numpy(boxes)}, train=True)
        label_smoothing_cross_entropy(logits,
                                      torch.from_numpy(labels)).backward()
        out["port"][dtype] = {n: p.grad for n, p in model.named_parameters()
                              if p.grad is not None}
    return out


def _gaps(g):
    """{name: relative L2 of the bf16 gradient from the float32 one} of the
    proj_q and proj_kv weights, and the names whose gradient is zero in
    both dtypes (the last block's: the classifier reads its CLS token
    alone, which never meets the stage-2 projections)."""
    names = [n for n in g["float32"]
             if n.endswith(("attn.proj_q.weight", "attn.proj_kv.weight"))]
    gaps, zero = {}, []
    for n in names:
        ref, got = g["float32"][n].double(), g["bfloat16"][n].double()
        if not ref.any() and not got.any():
            zero.append(n)
        else:
            gaps[n] = float((got - ref).norm() / ref.norm())
    return gaps, sorted(zero)


def test_port_bf16_gradient_gap_is_jax_gap(grads):
    (jax_gap, jax_zero), (port_gap, port_zero) = (_gaps(grads["jax"]),
                                                  _gaps(grads["port"]))
    assert port_zero == jax_zero == ["blocks.2.attn.proj_kv.weight",
                                     "blocks.2.attn.proj_q.weight"]
    assert sorted(port_gap) == sorted(jax_gap) and len(port_gap) == 4
    print({"jax_gap": jax_gap, "port_gap": port_gap})
    worse = {n: (port_gap[n], jax_gap[n]) for n in port_gap
             if not port_gap[n] <= SLACK * jax_gap[n] + FLOOR}
    assert not worse, f"port gap above {SLACK} x JAX's + {FLOOR}: {worse}"
    # both packages round somewhere: the gaps are no artefact of a float32
    # path taken in either
    assert all(v > 0 for v in list(jax_gap.values()) + list(port_gap.values()))

