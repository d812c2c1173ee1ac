"""Frame-level anomaly metrics: AUROC / AP / MCC at 101 fixed thresholds.

Behavioral reference: the reference computes its headline numbers two ways
that must agree (SURVEY.md §5e):
  * torchmetrics with ``thresholds = [0, 0.01, ..., 1.0]`` (binned) inside
    the training engine (reference/engine_for_frame_finetuning.py:593-636),
  * sklearn exact metrics in the offline analysis
    (reference/anaysis/metrics.py:128-207).

This module implements the binned family as vectorized numpy (one sort +
cumulative counts instead of 101 full passes — O(n log n + T) vs O(n*T))
and the 'exact' mode's two sklearn scores in numpy (``roc_auc_score``,
``average_precision_score``), so the port needs no scikit-learn.  AUC-MCC — the paper's second
headline metric — is the trapezoidal area of MCC over the threshold grid
(engine:635: sklearn.auc(THRESHOLDS, mcc)).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

THRESHOLDS = np.round(np.arange(0.0, 1.001, 0.01), 2)   # 101 values


def binned_confusion_counts(probs: np.ndarray, labels: np.ndarray,
                            thresholds: np.ndarray = THRESHOLDS
                            ) -> Tuple[np.ndarray, np.ndarray,
                                       np.ndarray, np.ndarray]:
    """(tp, fp, tn, fn) per threshold, prediction rule ``prob >= t``.

    Vectorized: sort positives'/negatives' probs once, then one searchsorted
    per class over the threshold grid.
    """
    probs = np.asarray(probs, dtype=np.float64)
    labels = np.asarray(labels)
    pos = np.sort(probs[labels == 1])
    neg = np.sort(probs[labels == 0])
    n_pos, n_neg = len(pos), len(neg)
    # count of elements >= t  ==  n - first index where x >= t
    tp = n_pos - np.searchsorted(pos, thresholds, side="left")
    fp = n_neg - np.searchsorted(neg, thresholds, side="left")
    fn = n_pos - tp
    tn = n_neg - fp
    return (tp.astype(np.float64), fp.astype(np.float64),
            tn.astype(np.float64), fn.astype(np.float64))


def _safe_div(a, b):
    return np.divide(a, b, out=np.zeros_like(a, dtype=np.float64),
                     where=b != 0)


def roc_binned(probs, labels, thresholds=THRESHOLDS):
    """(fpr, tpr, thresholds) with fpr increasing (torchmetrics layout)."""
    tp, fp, tn, fn = binned_confusion_counts(probs, labels, thresholds)
    tpr = _safe_div(tp, tp + fn)
    fpr = _safe_div(fp, fp + tn)
    return fpr[::-1], tpr[::-1], thresholds[::-1]


def auroc_binned(probs, labels, thresholds=THRESHOLDS) -> float:
    fpr, tpr, _ = roc_binned(probs, labels, thresholds)
    return float(np.trapezoid(tpr, fpr))


def precision_recall_curve_binned(probs, labels, thresholds=THRESHOLDS):
    """(precision, recall, thresholds); curves get the (1, 0) endpoint
    appended, matching torchmetrics' binned PR curve."""
    tp, fp, tn, fn = binned_confusion_counts(probs, labels, thresholds)
    precision = _safe_div(tp, tp + fp)
    recall = _safe_div(tp, tp + fn)
    precision = np.concatenate([precision, [1.0]])
    recall = np.concatenate([recall, [0.0]])
    return precision, recall, thresholds


def average_precision_binned(probs, labels, thresholds=THRESHOLDS) -> float:
    precision, recall, _ = precision_recall_curve_binned(probs, labels,
                                                         thresholds)
    return float(-np.sum(np.diff(recall) * precision[:-1]))


def mcc_curve(probs, labels, thresholds=THRESHOLDS) -> np.ndarray:
    """Matthews correlation coefficient per threshold (0 where undefined,
    matching sklearn.matthews_corrcoef's zero-division behavior)."""
    tp, fp, tn, fn = binned_confusion_counts(probs, labels, thresholds)
    num = tp * tn - fp * fn
    den = np.sqrt((tp + fp) * (tp + fn) * (tn + fp) * (tn + fn))
    return _safe_div(num, den)


def auc_mcc(probs, labels, thresholds=THRESHOLDS) -> float:
    """Area under the MCC-vs-threshold curve (the paper's 'AUC-MCC')."""
    return float(np.trapezoid(mcc_curve(probs, labels, thresholds),
                              thresholds))


def risk_probs(logits_safe, logits_risk) -> np.ndarray:
    """The risk probability of each row's two logits (the softmax's second
    column), in float64."""
    logits = np.stack([np.asarray(logits_safe, np.float64),
                       np.asarray(logits_risk, np.float64)], axis=1)
    e = np.exp(logits - logits.max(axis=1, keepdims=True))
    return (e / e.sum(axis=1, keepdims=True))[:, 1]


def _check_binary(labels) -> np.ndarray:
    labels = np.asarray(labels).astype(np.int64).reshape(-1)
    if len(np.unique(labels)) != 2:
        raise ValueError("Only one class present in y_true. The score is "
                         "not defined in that case.")
    return labels


def roc_auc_score(labels, scores) -> float:
    """Exact area under the ROC curve of binary ``labels`` (0/1) against
    ``scores``: the Mann-Whitney statistic, the share of (positive,
    negative) pairs the scores order correctly, a tied pair counting one
    half (sklearn.metrics.roc_auc_score's value).  Average ranks over the
    ties give it in one sort."""
    labels = _check_binary(labels)
    scores = np.asarray(scores, np.float64).reshape(-1)
    _, inverse, counts = np.unique(scores, return_inverse=True,
                                   return_counts=True)
    # 1-based average rank of each distinct score: the ranks of a tie
    # group run from its start + 1 to its end
    ends = np.cumsum(counts).astype(np.float64)
    ranks = (ends - (counts - 1) / 2.0)[inverse]
    n_pos = float(labels.sum())
    n_neg = float(len(labels)) - n_pos
    u = ranks[labels == 1].sum() - n_pos * (n_pos + 1) / 2.0
    return float(u / (n_pos * n_neg))


def average_precision_score(labels, scores) -> float:
    """Exact average precision, sklearn.metrics.average_precision_score's
    step sum: over the distinct score thresholds, from the highest down,
    the precision at each times the recall it adds."""
    labels = np.asarray(labels).astype(np.int64).reshape(-1)
    scores = np.asarray(scores, np.float64).reshape(-1)
    order = np.argsort(scores, kind="mergesort")[::-1]
    scores, y = scores[order], labels[order].astype(np.float64)
    # the last index of each distinct score (ties share one threshold)
    last = np.r_[np.where(np.diff(scores))[0], y.size - 1]
    tps = np.cumsum(y)[last]
    fps = 1 + last - tps
    precision = np.divide(tps, tps + fps, out=np.zeros_like(tps),
                          where=(tps + fps) != 0)
    recall = (np.ones_like(tps) if tps[-1] == 0 else tps / tps[-1])
    # sklearn's curve: recall falling to its appended 0, precision to 1
    precision = np.r_[precision[::-1], 1.0]
    recall = np.r_[recall[::-1], 0.0]
    return float(-np.sum(np.diff(recall) * precision[:-1]))


@dataclasses.dataclass
class BinaryMetrics:
    """Everything calculate_metrics / calculate_MORE_metrics report."""
    acc: float
    precision: float
    recall: float
    f1: float
    confmat: List[List[float]]           # [[tn, fp], [fn, tp]]
    auroc: float
    ap: float
    mcc_auc: float
    mcc_max: float
    mcc_max_threshold: float
    mcc_05: float
    mcc_curve: np.ndarray
    precision_curve: np.ndarray
    recall_curve: np.ndarray
    roc_fpr: np.ndarray
    roc_tpr: np.ndarray
    thresholds: np.ndarray

    def scalars(self) -> Dict[str, float]:
        return {k: getattr(self, k) for k in
                ("acc", "precision", "recall", "f1", "auroc", "ap",
                 "mcc_auc", "mcc_max", "mcc_max_threshold", "mcc_05")}


def binary_metrics(probs, labels, thresholds=THRESHOLDS,
                   exact: bool = False) -> BinaryMetrics:
    """Full metric report for anomaly probabilities vs binary labels.

    exact=False: binned AUROC/AP at the fixed grid (engine parity).
    exact=True: ``roc_auc_score`` / ``average_precision_score``, sklearn's
    (anaysis/metrics.py parity) in numpy.  Threshold-indexed curves are always binned.
    """
    probs = np.asarray(probs, dtype=np.float64)
    labels = np.asarray(labels).astype(np.int64)
    tp, fp, tn, fn = binned_confusion_counts(probs, labels, thresholds)
    idx05 = int(np.argmin(np.abs(thresholds - 0.5)))

    acc_c = _safe_div(tp + tn, tp + tn + fp + fn)
    prec_c = _safe_div(tp, tp + fp)
    rec_c = _safe_div(tp, tp + fn)
    f1_c = _safe_div(2 * prec_c * rec_c, prec_c + rec_c)
    mcc_c = mcc_curve(probs, labels, thresholds)

    if exact:
        auroc = float(roc_auc_score(labels, probs))
        ap = float(average_precision_score(labels, probs))
    else:
        auroc = auroc_binned(probs, labels, thresholds)
        ap = average_precision_binned(probs, labels, thresholds)

    fpr, tpr, _ = roc_binned(probs, labels, thresholds)
    p_curve, r_curve, _ = precision_recall_curve_binned(probs, labels,
                                                        thresholds)
    mcc_max_i = int(np.argmax(mcc_c))
    return BinaryMetrics(
        acc=float(acc_c[idx05]), precision=float(prec_c[idx05]),
        recall=float(rec_c[idx05]), f1=float(f1_c[idx05]),
        confmat=[[float(tn[idx05]), float(fp[idx05])],
                 [float(fn[idx05]), float(tp[idx05])]],
        auroc=auroc, ap=ap,
        mcc_auc=float(np.trapezoid(mcc_c, thresholds)),
        mcc_max=float(mcc_c[mcc_max_i]),
        mcc_max_threshold=float(thresholds[mcc_max_i]),
        mcc_05=float(mcc_c[idx05]),
        mcc_curve=mcc_c, precision_curve=p_curve, recall_curve=r_curve,
        roc_fpr=fpr, roc_tpr=tpr, thresholds=np.asarray(thresholds))
