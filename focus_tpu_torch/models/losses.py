"""Loss functions (counterpart of ``focus_tpu/models/losses.py``, reference
``slowfast/models/losses.py``).

Each loss is ``fn(logits, labels) -> scalar`` over a batch, mean-reduced.
Labels are integer class ids or soft / one-hot distributions, as each loss
takes them.
"""

import torch
import torch.nn.functional as F


def cross_entropy(logits, labels):
    if labels.ndim == logits.ndim:  # soft targets
        return soft_target_cross_entropy(logits, labels)
    return F.cross_entropy(logits, labels.long())


def bce(probs, labels):
    eps = 1e-7
    probs = probs.clamp(eps, 1 - eps)
    return -(labels * torch.log(probs)
             + (1 - labels) * torch.log(1 - probs)).mean()


def bce_logit(logits, labels):
    return F.binary_cross_entropy_with_logits(logits, labels.to(logits.dtype))


def soft_target_cross_entropy(logits, soft_targets):
    """(reference losses.py:15-36)"""
    return torch.sum(-soft_targets * F.log_softmax(logits, dim=-1),
                     dim=-1).mean()


def label_smoothing_cross_entropy(logits, labels, smoothing: float = 0.1):
    """(reference losses.py:39-59). Soft (already mixed or smoothed) labels
    pass through unchanged, so smoothing is never applied twice."""
    if labels.ndim == logits.ndim:
        return soft_target_cross_entropy(logits, labels)
    n = logits.shape[-1]
    soft = F.one_hot(labels.long(), n).to(logits.dtype)
    soft = soft * (1.0 - smoothing) + smoothing / n
    return soft_target_cross_entropy(logits, soft)


def ek_loss(preds, labels):
    """The EPIC-Kitchens verb + noun loss, summed and not averaged, as the
    reference recipe takes it (reference tools/train_net.py:93-100: loss =
    verb + noun). preds: (first, {"verb", "noun"}) from the dual-head
    model; labels: {"verb", "noun"}, each integer ids or soft targets."""
    _, out = preds
    return (cross_entropy(out["verb"], labels["verb"])
            + cross_entropy(out["noun"], labels["noun"]))


_LOSSES = {
    "cross_entropy": cross_entropy,
    "bce": bce,
    "bce_logit": bce_logit,
    "soft_cross_entropy": soft_target_cross_entropy,
    "label_smoothing_cross_entropy": label_smoothing_cross_entropy,
    "EK_loss": ek_loss,
}


def get_loss_func(cfg_or_name):
    name = (cfg_or_name if isinstance(cfg_or_name, str)
            else cfg_or_name.MODEL.LOSS_FUNC)
    if name not in _LOSSES:
        raise NotImplementedError(f"Loss {name} not supported")
    return _LOSSES[name]
