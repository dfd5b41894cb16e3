"""Dynamic W8A8 dense layers for serving (``TPU.INT8_SERVING``).

Counterpart of ``focus_tpu/ops/quant.py``: symmetric int8 codes, one scale
per weight output channel and one per activation row, no calibration, the
parameters unchanged (float32 master weights). The same formulas:

  weights      s_w = max(amax over K / 127, 1e-8) per output channel,
               codes round(w / s_w) (half to even), clipped to +-127, from
               the float32 master weight;
  activations  the same per row, over the last dim, from the stored values
               (compute dtype);
  output       float(int32 acc) * (s_x * s_w), + bias in float32, cast to
               x's dtype.

The int8 x int8 -> int32 product is ``torch._int_mm``, as the JAX package
leaves it to XLA (``lax.dot_general``): a plain large matrix product, not a
kernel of this repository. A shape ``_int_mm`` refuses raises; there is no
other route. A layer's weight codes are made once per state of its weight
(``quantized_linear``), not once per call.
"""

import torch
from torch import nn

EPS = 1e-8


def quantize_weight(w):
    """Per-output-channel int8 codes of a ``[N, K]`` (``nn.Linear``
    layout) weight -> (codes int8 [N, K], float32 scales [N])."""
    w32 = w.float()
    s = (w32.abs().amax(dim=-1) / 127.0).clamp_min(EPS)
    q = torch.round(w32 / s[:, None]).clamp_(-127, 127).to(torch.int8)
    return q, s


def quantize_acts(x):
    """Per-row (last dim) int8 codes of activations -> (codes int8,
    float32 scales [..., 1])."""
    x32 = x.float()
    s = (x32.abs().amax(dim=-1, keepdim=True) / 127.0).clamp_min(EPS)
    q = torch.round(x32 / s).clamp_(-127, 127).to(torch.int8)
    return q, s


def quantized_dense(x, wq, s_w, bias=None):
    """y = float(int8(x) @ wq^T) * (s_x * s_w) (+ bias) at x's dtype.
    x [..., K]; wq [N, K] int8 and s_w [N] from ``quantize_weight``."""
    xq, s_x = quantize_acts(x)
    lead, K = x.shape[:-1], x.shape[-1]
    acc = torch._int_mm(xq.reshape(-1, K), wq.t())
    y = acc.reshape(*lead, -1).float() * (s_x * s_w)
    if bias is not None:
        y = y + bias.float()
    return y.to(x.dtype)


def quantized_linear(x, layer: nn.Linear):
    """``layer`` as a W8A8 dense. Its weight codes are kept on the layer with
    the weight's storage address and version counter, and made again when a
    load, an in-place update or a move changed the weight."""
    w = layer.weight
    key = (w.data_ptr(), w._version)
    hit = getattr(layer, "_w8a8", None)
    if hit is None or hit[0] != key:
        with torch.no_grad():
            hit = layer._w8a8 = (key, quantize_weight(w))
    wq, s_w = hit[1]
    return quantized_dense(x, wq, s_w, layer.bias)
