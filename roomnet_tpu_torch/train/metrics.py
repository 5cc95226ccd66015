"""Validation metrics: sklearn-compatible accuracy / per-class P/R/F.

Drop-in equivalents of `accuracy_score` and
`precision_recall_fscore_support` as used by the reference (train.py:146-147,
infer.py:51-52), in pure numpy so the runtime needs no sklearn. The stats
JSON schema matches all_train_stats.json exactly
({'step','accuracy','precisions','recalls','f-scores'}, train.py:149-152).

A copy of roomnet_tpu/train/metrics.py: the port imports nothing of the JAX
package.
"""

from __future__ import annotations

import numpy as np


def accuracy_score(y_true, y_pred) -> float:
    y_true = np.asarray(y_true)
    y_pred = np.asarray(y_pred)
    return float(np.mean(y_true == y_pred)) if y_true.size else 0.0


def precision_recall_fscore(y_true, y_pred, num_classes: int | None = None):
    """Per-class precision/recall/F1/support, zero_division=0 semantics.

    Matches sklearn's default `precision_recall_fscore_support` label set
    (sorted union of observed labels) when num_classes is None; pass
    num_classes to force a fixed label range 0..num_classes-1.
    """
    y_true = np.asarray(y_true, np.int64)
    y_pred = np.asarray(y_pred, np.int64)
    if num_classes is None:
        labels = np.unique(np.concatenate([y_true, y_pred]))
    else:
        labels = np.arange(num_classes)
    prec = np.zeros(len(labels))
    rec = np.zeros(len(labels))
    fsc = np.zeros(len(labels))
    supp = np.zeros(len(labels), np.int64)
    for i, c in enumerate(labels):
        tp = np.sum((y_pred == c) & (y_true == c))
        fp = np.sum((y_pred == c) & (y_true != c))
        fn = np.sum((y_pred != c) & (y_true == c))
        prec[i] = tp / (tp + fp) if (tp + fp) else 0.0
        rec[i] = tp / (tp + fn) if (tp + fn) else 0.0
        fsc[i] = (
            2 * prec[i] * rec[i] / (prec[i] + rec[i]) if (prec[i] + rec[i]) else 0.0
        )
        supp[i] = tp + fn
    return prec, rec, fsc, supp


def make_stats_entry(step: int, y_true, y_pred, num_classes: int | None = None) -> dict:
    """One all_train_stats.json entry (reference train.py:149-152 schema)."""
    acc = accuracy_score(y_true, y_pred)
    prec, rec, fsc, _ = precision_recall_fscore(y_true, y_pred, num_classes)
    return {
        "step": int(step),
        "accuracy": float(acc),
        "precisions": [float(p) for p in prec],
        "recalls": [float(r) for r in rec],
        "f-scores": [float(f) for f in fsc],
    }
