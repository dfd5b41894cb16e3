"""Metrics (counterpart of ``focus_tpu/utils/metrics.py``): top-k correct
counts, errors and accuracies, the joint verb + noun accuracy of
EPIC-Kitchens, the multi-label mean average precision (Charades), and the
slot models' segmentation scores (the adjusted Rand index and the mean
best overlap). Host numpy."""

from __future__ import annotations

import numpy as np


def topks_correct(preds, labels, ks):
    """Number of top-k correct predictions for each k. preds: [N, C],
    labels: [N]."""
    preds = np.asarray(preds)
    labels = np.asarray(labels)
    max_k = max(ks)
    # indices of the top max_k classes, best first
    top_inds = np.argsort(-preds, axis=1)[:, :max_k]
    correct = top_inds == labels[:, None]
    return [float(correct[:, :k].any(axis=1).sum()) for k in ks]


def topk_errors(preds, labels, ks):
    num = preds.shape[0]
    return [(1.0 - x / num) * 100.0 for x in topks_correct(preds, labels, ks)]


def topk_accuracies(preds, labels, ks):
    num = preds.shape[0]
    return [(x / num) * 100.0 for x in topks_correct(preds, labels, ks)]


def multitask_topk_accuracies(preds, labels, ks):
    """Joint accuracy across tasks (verb + noun): a sample counts only if
    every task is top-k correct."""
    max_k = max(ks)
    joint = None
    for pred, label in zip(preds, labels):
        top_inds = np.argsort(-np.asarray(pred), axis=1)[:, :max_k]
        correct = top_inds == np.asarray(label)[:, None]
        joint = correct if joint is None else (joint & correct)
    num = joint.shape[0]
    return [float(joint[:, :k].any(axis=1).sum()) / num * 100.0 for k in ks]


def average_precision(scores, positive):
    """Average precision of one class: the precision at each distinct
    score (tied scores form one threshold), from the highest down,
    weighted by the recall it adds; scikit-learn's
    ``average_precision_score`` of one column."""
    scores = np.asarray(scores, np.float64)
    positive = np.asarray(positive) > 0
    order = np.argsort(-scores, kind="mergesort")
    scores, positive = scores[order], positive[order]
    # the last row of each run of equal scores closes a threshold
    last = np.r_[np.diff(scores) != 0, True]
    tps = np.cumsum(positive)[last]
    seen = np.arange(1, len(scores) + 1)[last]
    precision = tps / seen
    recall = tps / tps[-1]
    return float(np.sum(np.diff(np.r_[0.0, recall]) * precision))


def mean_ap(preds, labels):
    """Mean average precision over the classes of multi-hot ``labels``
    [N, C] that have a positive (the others are dropped), of the scores
    ``preds`` [N, C]; 0.0 where no class has one."""
    preds = np.asarray(preds)
    labels = np.asarray(labels)
    keep = np.flatnonzero(labels.sum(axis=0) > 0)
    if keep.size == 0:
        return 0.0
    return float(np.mean([average_precision(preds[:, c], labels[:, c])
                          for c in keep]))


# ---- segmentation --------------------------------------------------------

def _comb2(x):
    x = x.astype(np.float64)
    return x * (x - 1.0) / 2.0


def compute_ari(table: np.ndarray) -> float:
    """Adjusted Rand Index from a contingency table [r, s]
    (reference metrics.py:10-37)."""
    a = table.sum(axis=1)
    b = table.sum(axis=0)
    n = a.sum()
    comb_a = _comb2(a).sum()
    comb_b = _comb2(b).sum()
    comb_n = _comb2(np.asarray(n))
    comb_table = _comb2(table).sum()
    if comb_b == comb_a == comb_n == comb_table:
        return 1.0
    return float(
        (comb_table - comb_a * comb_b / comb_n)
        / (0.5 * (comb_a + comb_b) - comb_a * comb_b / comb_n)
    )


def _hard_masks(pred_mask: np.ndarray) -> np.ndarray:
    """Predicted masks [B, K, D] binarised by a per-pixel argmax over K."""
    B, K, D = pred_mask.shape
    hard = np.zeros((B, K, D), dtype=bool)
    idx = np.argmax(pred_mask, axis=1)  # [B, D]
    hard[np.arange(B)[:, None], idx, np.arange(D)[None, :]] = True
    return hard


def evaluate_ari(true_mask: np.ndarray, pred_mask: np.ndarray) -> float:
    """Average ARI over a batch (reference metrics.py:59-83). true_mask:
    [B, N0, D] binary; pred_mask: [B, N1, D] soft or binary, binarised by a
    per-pixel argmax over N1. The contingency tables of all samples are one
    einsum."""
    true_mask = np.asarray(true_mask, dtype=np.float64)
    hard = _hard_masks(np.asarray(pred_mask, dtype=np.float64))
    tables = np.einsum("bnd,bkd->bnk", (true_mask != 0).astype(np.float64),
                       hard.astype(np.float64))  # [B, N0, N1]
    return float(np.mean([compute_ari(t) for t in tables]))


def evaluate_mbo(true_mask: np.ndarray, pred_mask: np.ndarray) -> float:
    """Mean Best Overlap: each ground-truth mask matched to the predicted
    mask of highest IoU, the IoUs averaged over the non-empty ground-truth
    masks (the reference leaves this a stub, metrics.py:86-102)."""
    true_mask = np.asarray(true_mask) != 0  # [B, N0, D]
    hard = _hard_masks(np.asarray(pred_mask, dtype=np.float64))
    inter = np.einsum("bnd,bkd->bnk", true_mask.astype(np.float64),
                      hard.astype(np.float64))  # [B, N0, N1]
    area_t = true_mask.sum(-1)[:, :, None]
    area_p = hard.sum(-1)[:, None, :]
    union = area_t + area_p - inter
    iou = np.where(union > 0, inter / np.maximum(union, 1), 0.0)
    best = iou.max(axis=-1)  # [B, N0]
    nonempty = area_t[:, :, 0] > 0
    if nonempty.sum() == 0:
        return 0.0
    return float(best[nonempty].mean())
