"""Classification metrics (counterpart of ``focus_tpu/utils/metrics.py``):
top-k correct counts and accuracies, and the joint verb + noun accuracy of
EPIC-Kitchens. Host numpy."""

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
