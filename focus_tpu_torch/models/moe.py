"""Switch-routed Mixture-of-Experts block MLP (counterpart of
``focus_tpu/models/moe.py``).

Top-1 routing: a float32 router (whatever the compute dtype) gives each
token's softmax over the E experts; the token goes to its argmax expert
(the first maximum on a tie) with its probability as the gate. Each sample
routes its own N tokens: an expert takes at most ``cap = ceil(N / E *
CAPACITY_FACTOR)`` of them, in token order, and the rest are dropped (the
MLP gives them zero; the block's residual carries them).

The JAX package dispatches and combines through one-hot einsums over a
``[B, N, E, cap]`` tensor. Every sum in them has exactly one non-zero term
(a slot holds at most one token, a token sits in at most one slot), so an
index copy and gather compute the same numbers bit for bit: the dispatch
copies each kept token's row to its slot ``(e, b, position)`` and leaves
empty slots zero, as ``1 * x`` plus zeros does; the combine multiplies the
slot's expert output by the gate rounded to the compute dtype, as
``combine.astype(dt)`` rounds it, and gives dropped tokens zero. The
position is the token's rank among the sample's tokens routed to its
expert (the JAX ``cumsum``), so the CLS token, first, is never dropped.
Neither the one-hot tensor nor its 2·B·N·E·cap·D multiply-adds exist here.

The experts run as one batched product over ``[E, B·cap, D]`` (``bmm``),
their bias added after the product is rounded to the compute dtype, as the
JAX einsum then ``+ bias`` rounds twice. Their parameters keep the JAX
layout and names (``experts.kernel1 [E, D, H]``, ``bias1 [E, H]``,
``kernel2 [E, H, D]``, ``bias2 [E, D]``), so the 2-D biases take weight
decay under ``SOLVER.ZERO_WD_1D_PARAM`` as the JAX optimizer gives it.
``TPU.INT8_SERVING`` leaves the experts at the compute dtype (only
attention's dense layers go W8A8).

``forward`` returns the output and the layer's Switch load-balance value
``E * sum_e mean(mask_e) * mean(prob_e)`` (means over the batch and the
tokens together), a tensor whose gradient reaches the router through the
probabilities; the gate's gradient reaches it through the combine.
"""

import math

import torch
import torch.nn.functional as F
from torch import nn

from focus_tpu_torch.models.common import dropout


class Experts(nn.Module):
    """E stacked expert FFNs: ``x [E, R, D] -> [E, R, D]``."""

    def __init__(self, num_experts, in_dim, hidden_dim, drop=0.0,
                 fast_gelu=False):
        super().__init__()
        self.drop, self.fast_gelu = float(drop), fast_gelu
        e, d, h = num_experts, in_dim, hidden_dim
        self.kernel1 = nn.Parameter(torch.empty(e, d, h))
        self.bias1 = nn.Parameter(torch.empty(e, h))
        self.kernel2 = nn.Parameter(torch.empty(e, h, d))
        self.bias2 = nn.Parameter(torch.empty(e, d))

    def forward(self, x, train=False, generator=None):
        dt = x.dtype
        y = torch.bmm(x, self.kernel1.to(dt)) + self.bias1.to(dt)[:, None]
        y = F.gelu(y, approximate="tanh" if self.fast_gelu else "none")
        y = dropout(y, self.drop, train, generator)
        return torch.bmm(y, self.kernel2.to(dt)) + self.bias2.to(dt)[:, None]


def capacity(n_tokens: int, num_experts: int, factor: float) -> int:
    """Slots an expert has for one sample's ``n_tokens``."""
    return max(int(math.ceil(n_tokens / num_experts * factor)), 1)


class MoEMlp(nn.Module):
    """Drop-in for the block ``Mlp``: ``forward(x [B, N, D], train=False,
    generator=None) -> (y [B, N, D], load-balance value)``."""

    def __init__(self, in_features, hidden_features, num_experts,
                 capacity_factor=1.25, drop=0.0, fast_gelu=False):
        super().__init__()
        self.num_experts = int(num_experts)
        self.capacity_factor = float(capacity_factor)
        self.drop = float(drop)
        self.router = nn.Linear(in_features, self.num_experts)
        self.experts = Experts(self.num_experts, in_features, hidden_features,
                               drop, fast_gelu)

    def route(self, x):
        """(probabilities [B, N, E] float32, expert [B, N], gate [B, N],
        position of each token in its expert [B, N], cap)."""
        B, N, _ = x.shape
        e = self.num_experts
        logits = F.linear(x.float(), self.router.weight.float(),
                          self.router.bias.float())
        probs = torch.softmax(logits, dim=-1)
        idx = torch.argmax(probs, dim=-1)
        gate = probs.gather(-1, idx[..., None])[..., 0]
        rank = torch.cumsum(F.one_hot(idx, e), dim=1)
        pos = rank.gather(-1, idx[..., None])[..., 0] - 1
        return probs, idx, gate, pos, capacity(N, e, self.capacity_factor)

    def forward(self, x, train=False, generator=None):
        B, N, D = x.shape
        e = self.num_experts
        probs, idx, gate, pos, cap = self.route(x)
        mask = F.one_hot(idx, e).to(probs.dtype)
        aux = e * torch.sum(mask.mean(dim=(0, 1)) * probs.mean(dim=(0, 1)))

        slots = e * B * cap
        keep = pos < cap
        sample = torch.arange(B, device=x.device)[:, None]
        slot = (idx * B + sample) * cap + pos
        slot = torch.where(keep, slot, torch.full_like(slot, slots))
        slot = slot.reshape(-1)
        # one row past the slots takes every dropped token and is cut off
        expert_in = x.new_zeros(slots + 1, D).index_copy(
            0, slot, x.reshape(B * N, D))[:slots]
        expert_out = self.experts(expert_in.reshape(e, B * cap, D), train,
                                  generator).reshape(slots, D)
        rows = torch.cat([expert_out, expert_out.new_zeros(1, D)])
        y = rows.index_select(0, slot).reshape(B, N, D)
        y = y * gate.to(x.dtype)[..., None]
        return dropout(y, self.drop, train, generator), aux
