"""Evaluation metrics for the CTR examples (counterpart of
``hetu_tpu/utils/metrics.py``, copied: numpy, on host arrays; a tensor is
read with ``np.asarray`` after ``.cpu()``)."""

from __future__ import annotations

import numpy as np


def accuracy(pred, label) -> float:
    """pred: logits/probs [N, C] or binary scores [N]; label ints."""
    pred = np.asarray(pred)
    label = np.asarray(label)
    if pred.ndim > 1:
        hat = pred.argmax(-1)
    else:
        hat = (pred > 0.5).astype(label.dtype)
    return float((hat == label).mean())


def auc(scores, labels) -> float:
    """Binary ROC-AUC via the rank-sum (Mann-Whitney) statistic, matching the
    reference's AUC metric for CTR."""
    scores = np.asarray(scores, np.float64).reshape(-1)
    labels = np.asarray(labels).reshape(-1)
    pos = scores[labels == 1]
    neg = scores[labels == 0]
    if len(pos) == 0 or len(neg) == 0:
        return 0.5
    order = np.argsort(np.concatenate([pos, neg]), kind="mergesort")
    ranks = np.empty_like(order, np.float64)
    ranks[order] = np.arange(1, len(order) + 1)
    # average ranks for ties
    allv = np.concatenate([pos, neg])
    sorted_v = allv[order]
    i = 0
    while i < len(sorted_v):
        j = i
        while j + 1 < len(sorted_v) and sorted_v[j + 1] == sorted_v[i]:
            j += 1
        if j > i:
            avg = ranks[order[i:j + 1]].mean()
            ranks[order[i:j + 1]] = avg
        i = j + 1
    r_pos = ranks[:len(pos)].sum()
    n_p, n_n = len(pos), len(neg)
    return float((r_pos - n_p * (n_p + 1) / 2) / (n_p * n_n))


def precision_recall_f1(pred, label, threshold: float = 0.5):
    pred = np.asarray(pred).reshape(-1)
    label = np.asarray(label).reshape(-1)
    hat = (pred > threshold).astype(np.int64)
    tp = int(((hat == 1) & (label == 1)).sum())
    fp = int(((hat == 1) & (label == 0)).sum())
    fn = int(((hat == 0) & (label == 1)).sum())
    prec = tp / max(tp + fp, 1)
    rec = tp / max(tp + fn, 1)
    f1 = 2 * prec * rec / max(prec + rec, 1e-12)
    return prec, rec, f1


def confusion_matrix(pred, label, num_classes: int):
    pred = np.asarray(pred)
    hat = pred.argmax(-1) if pred.ndim > 1 else pred.astype(np.int64)
    label = np.asarray(label).astype(np.int64)
    cm = np.zeros((num_classes, num_classes), np.int64)
    np.add.at(cm, (label, hat), 1)
    return cm
