"""Slot attention over video (counterpart of
``focus_tpu/models/steve/slot_attention.py``; reference
``slowfast/models/STEVE/steve.py:11-105``).

The k/v projections of all frames are one matmul; the per-frame recurrence
is a Python loop (the JAX package scans it). In training the predictor
takes its dropout (``SLOTS.PREDICTOR_DROPOUT``) as the reference's does;
the JAX module calls its predictor deterministically, which is the same
at the rate 0.0 of every recipe.
"""

import torch
from torch import nn

from focus_tpu_torch.models.common import (
    LN_EPS,
    Dense,
    GRUCell,
    TransformerEncoder,
    ffn,
    layer_norm,
    linear,
    normal,
)


def sample_slot_noise(shape, generator, device):
    """Slot-initialisation noise, N(0, 1) float32 (counterpart of
    ``_sample_slot_noise``; reference steve.py:56); module-level so that
    parity tests can replay recorded noise."""
    return normal(shape, generator, device)


class SlotAttentionVideo(nn.Module):
    def __init__(self, num_iterations, num_slots, input_size, slot_size,
                 mlp_hidden_size, num_predictor_blocks=1,
                 num_predictor_heads=4, dropout=0.1, epsilon=1e-8):
        super().__init__()
        self.num_iterations, self.num_slots = num_iterations, num_slots
        self.slot_size, self.epsilon = slot_size, epsilon
        self.slot_mu = nn.Parameter(torch.empty(1, 1, slot_size))
        self.slot_log_sigma = nn.Parameter(torch.empty(1, 1, slot_size))
        self.norm_inputs = nn.LayerNorm(input_size, eps=LN_EPS)
        self.norm_slots = nn.LayerNorm(slot_size, eps=LN_EPS)
        self.norm_mlp = nn.LayerNorm(slot_size, eps=LN_EPS)
        self.project_q = Dense(slot_size, slot_size, bias=False)
        self.project_k = Dense(input_size, slot_size, bias=False)
        self.project_v = Dense(input_size, slot_size, bias=False)
        self.gru = GRUCell(slot_size, slot_size)
        self.mlp = nn.Sequential(
            Dense(slot_size, mlp_hidden_size, weight_init="kaiming"),
            nn.ReLU(),
            Dense(mlp_hidden_size, slot_size),
        )
        self.predictor = TransformerEncoder(
            num_predictor_blocks, slot_size, num_predictor_heads, dropout)

    def _corrector(self, slots, k_t, v_t):
        """One frame's corrector iterations. k_t/v_t: [B, N, slot_size]."""
        B = k_t.shape[0]
        attn_vis = None
        for i in range(self.num_iterations):
            slots_prev = slots
            q = linear(layer_norm(slots, self.norm_slots), self.project_q)
            logits = torch.einsum("bnd,bsd->bns", k_t.float(), q.float())
            attn_vis = torch.softmax(logits, dim=-1)  # slots compete
            attn = attn_vis + self.epsilon
            attn = attn / attn.sum(dim=-2, keepdim=True)  # per-slot weights
            updates = torch.einsum("bns,bnd->bsd", attn.to(v_t.dtype), v_t)
            slots = self.gru(
                updates.reshape(-1, self.slot_size),
                slots_prev.reshape(-1, self.slot_size),
            ).reshape(B, self.num_slots, self.slot_size)
            # reference quirk: the refinement MLP is skipped on the last
            # iteration
            if i < self.num_iterations - 1:
                slots = slots + ffn(layer_norm(slots, self.norm_mlp),
                                    self.mlp)
        return slots, attn_vis

    def forward(self, inputs, noise=None, generator=None, train=False):
        """inputs [B, T, N, input_size] -> (slots [B, T, S, D],
        attns [B, T, N, S] float32).

        ``noise`` is the slot-init noise [B, S, D]; when None it is drawn
        from ``generator`` (``sample_slot_noise``), as the predictor's
        dropout masks are under ``train``. A frame's emitted slots are the
        corrector's, before the predictor.
        """
        B, T = inputs.shape[:2]
        if noise is None:
            noise = sample_slot_noise((B, self.num_slots, self.slot_size),
                                      generator, inputs.device)
        slots = (self.slot_mu + torch.exp(self.slot_log_sigma) * noise).to(
            inputs.dtype)
        x = layer_norm(inputs, self.norm_inputs)
        k = linear(x, self.project_k) * (self.slot_size ** -0.5)
        v = linear(x, self.project_v)
        slots_seq, attns_seq = [], []
        for t in range(T):
            slots, attn_vis = self._corrector(slots, k[:, t], v[:, t])
            slots_seq.append(slots)
            attns_seq.append(attn_vis)
            slots = self.predictor(slots, train, generator)
        return torch.stack(slots_seq, dim=1), torch.stack(attns_seq, dim=1)
