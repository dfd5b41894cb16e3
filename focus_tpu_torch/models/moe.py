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
probabilities; the gate's gradient reaches it through the combine. With
``sums`` it returns the value's sums over the rows instead
(``LoadBalance``), which ``load_balance`` groups and reduces over the data
line: the mean of the JAX package's ``_moe_aux``.

Expert parallelism (``TPU.MESH.EXPERT``, after
``parallel/tensor.shard_model``): an expert rank holds E / EXPERT experts
(the four leaves cut on the expert dim, as ``_param_spec`` places them;
whole on every rank where EXPERT does not divide E). Every rank of the
expert line routes the same tokens (the batch is split over the data axis
alone), runs its experts on their slots and gathers every expert's output
over the line before the combine. A copy-in (identity forward, the line's
sum of the gradients backward) stands before the rank's experts, so every
expert rank's gradient into the dispatched tokens is whole; the gather's
backward keeps the rank's experts' share.
"""

import dataclasses
import math

import torch
import torch.nn.functional as F
from torch import nn

from focus_tpu_torch.models.common import dropout
from focus_tpu_torch.parallel import mesh


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


@dataclasses.dataclass
class LoadBalance:
    """The sums behind Switch load-balance values, one value a leading
    index: ``probs`` [..., E] the router's probabilities summed over a
    group's rows and tokens (in the graph), ``mask`` [..., E] the tokens
    routed to each expert, ``tokens`` [...] the group's rows x tokens. A
    layer outside a pipeline gives one group, [1, E]; a pipelined
    segment's layers give [layers, K, E] over its K local microbatches, with
    ``groups``: (each local microbatch's JAX microbatch, their count M)."""

    probs: torch.Tensor
    mask: torch.Tensor
    tokens: torch.Tensor
    groups: tuple = None


def _grouped(t, group, count):
    """``t`` [layers, K, ...] summed into the ``count`` groups ``group[k]``
    of its microbatches k, in a fixed order (the same sums on every
    rank)."""
    k_all = range(t.shape[1])
    return torch.stack([
        t[:, [k for k in k_all if group[k] == g]].sum(1)
        if g in group else torch.zeros_like(t[:, 0]) for g in range(count)],
        1)


def load_balance(records) -> torch.Tensor:
    """The load-balance term of one train-mode forward (the JAX trainer's
    ``_moe_aux``): the mean of ``E * sum_e f_e p_e`` over every MoE layer
    outside a pipeline (f, p: the means over the global batch) and every
    pipelined layer and JAX microbatch. The sums of a pipelined segment's
    local microbatches are grouped by JAX's microbatches (``groups``), then
    summed over the data line (differentiable: each data rank's
    probabilities reach the term), then multiplied."""
    values = []
    size = mesh.data_size()
    for r in records:
        probs, mask, tokens = r.probs, r.mask.float(), r.tokens.float()
        if r.groups is not None:
            probs, mask, tokens = (_grouped(t, *r.groups)
                                   for t in (probs, mask, tokens))
        if mesh.is_distributed() and size > 1:
            group = mesh.group("data")
            probs = mesh.all_reduce_sum(probs, group)
            counts = torch.cat([mask.reshape(-1), tokens.reshape(-1)])
            mesh.all_reduce_(counts, group)
            mask = counts[:mask.numel()].view_as(mask)
            tokens = counts[mask.numel():].view_as(tokens)
        n = tokens[..., None]
        e = probs.shape[-1]
        values.append((e * torch.sum(mask / n * (probs / n), dim=-1))
                      .reshape(-1))
    return torch.cat(values).mean()


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

    par, sharded = None, False

    def attach_parallel(self, par, dims):
        """Run this rank's experts where the expert axis cut them."""
        self.par = par
        self.sharded = self.experts.kernel1.shape[0] != self.num_experts

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

    def forward(self, x, train=False, generator=None, sums=False):
        """(y, the load-balance value); with ``sums``, (y,
        ``LoadBalance`` of one group)."""
        B, N, D = x.shape
        e = self.num_experts
        probs, idx, gate, pos, cap = self.route(x)
        mask = F.one_hot(idx, e).to(probs.dtype)
        if sums:
            aux = LoadBalance(probs.sum(dim=(0, 1))[None],
                              mask.sum(dim=(0, 1))[None],
                              torch.full((1,), float(B * N),
                                         device=x.device))
        else:
            aux = e * torch.sum(mask.mean(dim=(0, 1))
                                * probs.mean(dim=(0, 1)))

        slots = e * B * cap
        keep = pos < cap
        sample = torch.arange(B, device=x.device)[:, None]
        slot = (idx * B + sample) * cap + pos
        slot = torch.where(keep, slot, torch.full_like(slot, slots))
        slot = slot.reshape(-1)
        # one row past the slots takes every dropped token and is cut off
        expert_in = x.new_zeros(slots + 1, D).index_copy(
            0, slot, x.reshape(B * N, D))[:slots]
        expert_out = self._experts(expert_in.reshape(e, B * cap, D), train,
                                   generator).reshape(slots, D)
        rows = torch.cat([expert_out, expert_out.new_zeros(1, D)])
        y = rows.index_select(0, slot).reshape(B, N, D)
        y = y * gate.to(x.dtype)[..., None]
        return dropout(y, self.drop, train, generator), aux

    def _experts(self, x, train, generator):
        """Every expert's output [E, R, D]: this rank's experts on their
        slots, gathered over the expert line, where the experts are cut."""
        if not self.sharded:
            return self.experts(x, train, generator)
        from focus_tpu_torch.parallel import tensor as tp

        par = self.par
        x = tp.copy_in(x, par, par.expert_group)
        n = self.experts.kernel1.shape[0]
        own = x[par.expert_rank * n:(par.expert_rank + 1) * n]
        return tp.gather(self.experts(own, train, generator), 0, par,
                         par.expert_group)
