"""Metric figure writers: PR curve, ROC curve, confusion matrix, score
distributions.

Copy of simple_tad_tpu/eval/plots.py (numpy and matplotlib only; the port
cannot import the JAX package).  Reference: threshold_curve_plots
(dataset/vis_tools.py:10-109), plot_figures
(engine_for_frame_finetuning.py:639-659) and the eval jpg artifacts
(engine:504-519: plots/{pr,roc}.jpg).  matplotlib is imported, on its
'Agg' backend (no display), only when a figure is drawn.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np


def _plt():
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    return plt


def require_plotting() -> None:
    """Raise ImportError unless matplotlib and Pillow (which writes its
    JPEGs), the package's ``plots`` extra, import: a run that ends with
    plots checks this before its work."""
    try:
        _plt()
        import PIL  # noqa: F401
    except ImportError as e:
        raise ImportError(f"the metric plots need matplotlib and Pillow "
                          f"(the package's 'plots' extra): {e}") from e


def plot_threshold_curve(x, y, thresholds, *, x_label: str, y_label: str,
                         title: str, score: Optional[float] = None,
                         out_path: Optional[str] = None):
    """Curve with threshold annotations every ~10th point
    (vis_tools.threshold_curve_plots equivalent)."""
    plt = _plt()
    fig, ax = plt.subplots(figsize=(6, 5))
    ax.plot(x, y, "-o", markersize=2, linewidth=1.2)
    step = max(len(thresholds) // 10, 1)
    for i in range(0, len(thresholds), step):
        if i < len(x) and i < len(y):
            ax.annotate(f"{thresholds[i]:.2f}", (x[i], y[i]), fontsize=6,
                        alpha=0.7)
    ax.set_xlabel(x_label)
    ax.set_ylabel(y_label)
    ax.set_xlim(-0.02, 1.02)
    ax.set_ylim(-0.02, 1.02)
    ax.grid(alpha=0.3)
    ax.set_title(title if score is None else f"{title} (AUC {score:.4f})")
    if out_path:
        fig.savefig(out_path, dpi=120, bbox_inches="tight")
        plt.close(fig)
        return out_path
    return fig


def plot_confusion_matrix(confmat, out_path: Optional[str] = None):
    plt = _plt()
    cm = np.asarray(confmat, dtype=float)
    fig, ax = plt.subplots(figsize=(4, 4))
    im = ax.imshow(cm, cmap="Blues")
    for (i, j), v in np.ndenumerate(cm):
        ax.text(j, i, f"{int(v)}", ha="center", va="center",
                color="black" if v < cm.max() / 2 else "white")
    ax.set_xticks([0, 1], ["safe", "risk"])
    ax.set_yticks([0, 1], ["safe", "risk"])
    ax.set_xlabel("predicted")
    ax.set_ylabel("actual")
    fig.colorbar(im, shrink=0.8)
    if out_path:
        fig.savefig(out_path, dpi=120, bbox_inches="tight")
        plt.close(fig)
        return out_path
    return fig


def plot_score_distribution(probs, labels, out_path: Optional[str] = None):
    """Risk-probability histograms per class (the engine's logit
    distribution stats, engine_for_frame_finetuning.py:253-279)."""
    plt = _plt()
    probs = np.asarray(probs)
    labels = np.asarray(labels)
    fig, ax = plt.subplots(figsize=(6, 4))
    ax.hist(probs[labels == 0], bins=50, alpha=0.6, label="safe",
            density=True)
    ax.hist(probs[labels == 1], bins=50, alpha=0.6, label="risk",
            density=True)
    ax.set_xlabel("risk probability")
    ax.legend()
    ax.grid(alpha=0.3)
    if out_path:
        fig.savefig(out_path, dpi=120, bbox_inches="tight")
        plt.close(fig)
        return out_path
    return fig


def save_metric_plots(metrics, probs, labels, out_dir: str) -> Dict[str, str]:
    """Write the reference's plot set: plots/{pr,roc,confusion,dist}.jpg."""
    plots_dir = os.path.join(out_dir, "plots")
    os.makedirs(plots_dir, exist_ok=True)
    written = {}
    written["pr"] = plot_threshold_curve(
        metrics.recall_curve[:-1], metrics.precision_curve[:-1],
        metrics.thresholds, x_label="Recall", y_label="Precision",
        title="PR curve", score=metrics.ap,
        out_path=os.path.join(plots_dir, "pr.jpg"))
    written["roc"] = plot_threshold_curve(
        metrics.roc_fpr, metrics.roc_tpr, metrics.thresholds[::-1],
        x_label="FP rate", y_label="TP rate", title="ROC curve",
        score=metrics.auroc, out_path=os.path.join(plots_dir, "roc.jpg"))
    written["confusion"] = plot_confusion_matrix(
        metrics.confmat, os.path.join(plots_dir, "confusion.jpg"))
    written["dist"] = plot_score_distribution(
        probs, labels, os.path.join(plots_dir, "dist.jpg"))
    return written
