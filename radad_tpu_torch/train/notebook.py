"""Inline (notebook-facing) plotting helpers.

Counterpart: ``radad_tpu/train/notebook.py``, copied (numpy and matplotlib
on the host), with the port's ``train/metrics.py``.

The reference exposes inline matplotlib curves for its Colab notebooks
(reference pipeline.py:1160-1259: plot_training_history and the inline
ROC/DET renderer) in addition to the PNG files the ArtifactWriter saves.
These helpers return live ``matplotlib`` Figure objects so a notebook
(or any interactive shell) can display and restyle them; the
batch pipeline keeps writing files via ``radad_tpu_torch.train.artifacts``.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np


def _plt():
    import matplotlib

    if not os.environ.get("DISPLAY") and matplotlib.get_backend() == "agg":
        pass  # headless default is fine; notebooks override the backend
    import matplotlib.pyplot as plt

    return plt


def plot_training_history(metrics_csv: str):
    """Loss/accuracy/EER curves from a run's ``metrics.csv`` →
    ``matplotlib.figure.Figure`` (reference pipeline.py:1160-1216)."""
    import csv

    rows = []
    with open(metrics_csv) as f:
        for row in csv.DictReader(f):
            rows.append(row)
    if not rows:
        raise ValueError(f"no rows in {metrics_csv}")

    def col(name):
        out = []
        for r in rows:
            v = r.get(name)
            out.append(float(v) if v not in (None, "", "None") else np.nan)
        return np.asarray(out)

    epochs = col("epoch")
    plt = _plt()
    fig, axes = plt.subplots(1, 3, figsize=(15, 4))
    axes[0].plot(epochs, col("train_loss"), label="train")
    axes[0].plot(epochs, col("val_loss"), label="val")
    axes[0].set_title("Loss"), axes[0].set_xlabel("epoch"), axes[0].legend()
    axes[1].plot(epochs, col("train_acc"), label="train")
    axes[1].plot(epochs, col("val_acc"), label="val")
    axes[1].set_title("Accuracy"), axes[1].set_xlabel("epoch")
    axes[1].legend()
    axes[2].plot(epochs, col("eer_percent"), label="EER %")
    axes[2].plot(epochs, col("macro_eer_percent"), label="macro-EER %")
    axes[2].set_title("EER"), axes[2].set_xlabel("epoch"), axes[2].legend()
    fig.tight_layout()
    return fig


def plot_roc_det(scores: Sequence[float], labels: Sequence[float],
                 title: Optional[str] = None):
    """Inline ROC + DET pair from raw scores/labels →
    ``matplotlib.figure.Figure`` (reference pipeline.py:1218-1259)."""
    from radad_tpu_torch.train import metrics as M

    scores = np.asarray(scores, np.float64)
    labels = np.asarray(labels, np.float64)
    fpr, tpr, _ = M.roc_curve(scores, labels)
    auc_val = M.auc(fpr, tpr)
    fnr = 1.0 - tpr
    keep = (fpr > 0) & (fnr > 0)
    det_x = M.probit(np.clip(fpr[keep], 1e-6, 1 - 1e-6))
    det_y = M.probit(np.clip(fnr[keep], 1e-6, 1 - 1e-6))

    plt = _plt()
    fig, (ax1, ax2) = plt.subplots(1, 2, figsize=(11, 4.5))
    ax1.plot(fpr, tpr, label=f"AUC={auc_val:.4f}")
    ax1.plot([0, 1], [0, 1], "--", color="grey")
    ax1.set_xlabel("FPR"), ax1.set_ylabel("TPR"), ax1.set_title("ROC")
    ax1.legend()
    ax2.plot(det_x, det_y)
    ax2.set_xlabel("probit(FPR)"), ax2.set_ylabel("probit(FNR)")
    ax2.set_title("DET")
    if title:
        fig.suptitle(title)
    fig.tight_layout()
    return fig
