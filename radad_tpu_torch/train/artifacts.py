"""Training artifacts: metrics.csv, summary.json, ROC/DET point CSVs, plots.

Reproduces the reference's observability surface
(reference pipeline.py:583-688,916-962): a per-epoch metrics.csv
row (losses, accs, AUC/EER/macro-EER/min-tDCF, grad norms, neighbor non-zero
rate, lrs, pos_weight, epoch time), a summary.json with best-epoch trackers,
per-epoch ROC/DET point CSVs, and PNG curve plots (loss/acc + ROC + DET).
Matplotlib uses the Agg backend; plotting failures never break training
(where matplotlib is not installed the PNG writers log a warning).

Counterpart: ``radad_tpu/train/artifacts.py``, copied; it reads the port's
``train/metrics.py``.
"""

from __future__ import annotations

import csv
import json
import logging
import os
from typing import Dict, List, Optional

import numpy as np

from radad_tpu_torch.train import metrics as M

logger = logging.getLogger(__name__)


class ArtifactWriter:
    """``write=False`` keeps the rows and best trackers and writes no file
    (every rank of a mesh but rank 0)."""

    def __init__(self, data_root: str, write: bool = True):
        self.data_root = data_root
        self.write = write
        if write:
            os.makedirs(data_root, exist_ok=True)
        self.rows: List[Dict] = []
        self.best_by_val_loss = {"epoch": None, "val_loss": float("inf")}
        self.best_by_eer = {"epoch": None, "eer_percent": float("inf")}

    # -------------------------------------------------- metrics.csv
    def add_row(self, row: Dict) -> None:
        self.rows.append(row)
        if not self.write:
            return
        path = os.path.join(self.data_root, "metrics.csv")
        keys = list(self.rows[0].keys())
        for r in self.rows:
            for k in r:
                if k not in keys:
                    keys.append(k)
        with open(path, "w", newline="") as f:
            w = csv.DictWriter(f, fieldnames=keys)
            w.writeheader()
            w.writerows(self.rows)

    def track_best(self, epoch: int, val_loss: float, eer: float) -> bool:
        """Update best trackers; returns True if this epoch set a new best
        EER (used to write the ``best_model`` checkpoint — which the
        reference *expects* at predict time but never writes, main.py:96 vs
        pipeline.py:945; we fix that deliberately)."""
        if np.isfinite(val_loss) and val_loss < self.best_by_val_loss["val_loss"]:
            self.best_by_val_loss = {"epoch": epoch, "val_loss": float(val_loss)}
        is_best = np.isfinite(eer) and eer < self.best_by_eer["eer_percent"]
        if is_best:
            self.best_by_eer = {"epoch": epoch, "eer_percent": float(eer)}
        return bool(is_best)

    def save_summary(self) -> None:
        if not self.write:
            return
        summary = {
            "final_epoch": len(self.rows),
            "best_by_val_loss": self.best_by_val_loss,
            "best_by_eer": self.best_by_eer,
            "last_row": self.rows[-1] if self.rows else {},
        }
        with open(os.path.join(self.data_root, "summary.json"), "w") as f:
            json.dump(summary, f, indent=2)

    # -------------------------------------------------- curves
    def save_roc_det(self, scores: np.ndarray, labels: np.ndarray,
                     epoch: Optional[int] = None, tag: str = "") -> float:
        """Write ROC/DET point CSVs + PNGs; returns AUC."""
        fpr, tpr, thr = M.roc_curve(scores, labels)
        auc_val = M.auc(fpr, tpr)
        if not self.write:
            return auc_val
        suffix = f"_epoch{epoch}" if epoch is not None else (f"_{tag}" if tag else "")
        with open(os.path.join(self.data_root, f"roc_points{suffix}.csv"),
                  "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(["fpr", "tpr", "threshold"])
            w.writerows(zip(fpr, tpr, thr))
        det_x, det_y = M.det_curve(scores, labels)
        with open(os.path.join(self.data_root, f"det_points{suffix}.csv"),
                  "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(["probit_fpr", "probit_fnr"])
            w.writerows(zip(det_x, det_y))
        try:
            self._plot_roc_det(fpr, tpr, det_x, det_y, auc_val, suffix)
        except Exception as e:  # pragma: no cover
            logger.warning("ROC/DET plot failed: %s", e)
        return auc_val

    def _plot_roc_det(self, fpr, tpr, det_x, det_y, auc_val, suffix):
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        fig, (ax1, ax2) = plt.subplots(1, 2, figsize=(11, 4.5))
        ax1.plot(fpr, tpr, lw=1.5)
        ax1.plot([0, 1], [0, 1], "--", lw=0.8, color="gray")
        ax1.set_xlabel("FPR")
        ax1.set_ylabel("TPR")
        ax1.set_title(f"ROC (AUC={auc_val:.4f})")
        ax2.plot(det_x, det_y, lw=1.5)
        ax2.set_xlabel("probit(FPR)")
        ax2.set_ylabel("probit(FNR)")
        ax2.set_title("DET")
        fig.tight_layout()
        fig.savefig(os.path.join(self.data_root, f"roc_det{suffix}.png"),
                    dpi=110)
        plt.close(fig)

    def plot_training_curves(self) -> None:
        if not self.rows or not self.write:
            return
        try:
            import matplotlib

            matplotlib.use("Agg")
            import matplotlib.pyplot as plt

            epochs = [r["epoch"] for r in self.rows]
            fig, (ax1, ax2) = plt.subplots(1, 2, figsize=(11, 4.5))
            ax1.plot(epochs, [r.get("train_loss") for r in self.rows],
                     label="train")
            if any(r.get("val_loss") is not None for r in self.rows):
                ax1.plot(epochs, [r.get("val_loss") for r in self.rows],
                         label="val")
            ax1.set_xlabel("epoch")
            ax1.set_ylabel("loss")
            ax1.legend()
            ax2.plot(epochs, [r.get("train_acc") for r in self.rows],
                     label="train")
            if any(r.get("val_acc") is not None for r in self.rows):
                ax2.plot(epochs, [r.get("val_acc") for r in self.rows],
                         label="val")
            ax2.set_xlabel("epoch")
            ax2.set_ylabel("accuracy")
            ax2.legend()
            fig.tight_layout()
            fig.savefig(os.path.join(self.data_root, "training_curves.png"),
                        dpi=110)
            plt.close(fig)
        except Exception as e:  # pragma: no cover
            logger.warning("training-curve plot failed: %s", e)


class WandbShim:
    """Optional wandb logging (reference pipeline.py:29-52,329-389); degrades
    to a no-op when wandb is missing or offline (this env has no egress)."""

    def __init__(self, enabled: bool):
        self.run = None
        if not enabled:
            return
        try:
            import wandb

            self.run = wandb.init(project="radad-tpu",
                                  mode=self._resolve_mode())
        except Exception as e:
            logger.warning("wandb disabled: %s", e)

    @staticmethod
    def _resolve_mode() -> str:
        """Resolve the wandb mode like the reference resolves its API key
        (pipeline.py:29-52: Colab secret / ``WANDB_API_KEY`` env → online
        run). Explicit ``WANDB_MODE`` wins; otherwise a configured API key
        (env var or ~/.netrc login) selects online; the fallback is
        offline so a no-egress host still records runs locally."""
        explicit = os.environ.get("WANDB_MODE")
        if explicit:
            return explicit
        if os.environ.get("WANDB_API_KEY"):
            return "online"
        try:
            import netrc

            auth = netrc.netrc().authenticators("api.wandb.ai")
            if auth is not None:
                return "online"
        except Exception:
            pass
        return "offline"

    @property
    def active(self) -> bool:
        return self.run is not None

    def log(self, data: Dict) -> None:
        if self.run is not None:
            try:
                self.run.log(data)
            except Exception:  # pragma: no cover
                pass

    def histogram(self, counts, edges):
        """Wrap a precomputed (counts, bin_edges) pair as a wandb.Histogram
        — the in-graph analogue of ``wandb.watch(model, log='gradients')``
        (reference pipeline.py:334-340): histograms are computed on device
        inside the train step, so watching adds no extra host transfer of
        the raw gradients."""
        if self.run is None:
            return None
        try:
            import wandb

            return wandb.Histogram(np_histogram=(list(counts), list(edges)))
        except Exception:  # pragma: no cover
            return None

    def log_artifact(self, path: str, name: str, kind: str = "model"
                     ) -> None:
        """Upload a file as a wandb Artifact (reference pipeline.py:884-896
        logs the trained model + curve PNGs as artifacts). No-op when wandb
        is absent/offline or the file is missing."""
        if self.run is None or not os.path.exists(path):
            return
        try:
            import wandb

            art = wandb.Artifact(name, type=kind)
            art.add_file(path)
            self.run.log_artifact(art)
        except Exception:  # pragma: no cover
            pass

    def finish(self) -> None:
        if self.run is not None:
            try:
                self.run.finish()
            except Exception:  # pragma: no cover
                pass


def plot_history(data_root: str, show: bool = False):
    """Notebook-facing curve helper: render the reference's four inline
    training curves (loss, accuracy, EER, AUC vs epoch — the
    plot-in-notebook block at reference pipeline.py:1160-1259) from
    a run's ``metrics.csv``. Returns the matplotlib Figure (and calls
    ``plt.show()`` when ``show=True``, the notebook mode); the per-epoch
    PNG artifacts under ``data_root`` carry the same information for
    non-notebook runs."""
    import csv

    # No matplotlib.use() here: forcing Agg would break the inline backend
    # of the very notebook sessions this helper targets; headless
    # processes fall back to Agg on their own.
    import matplotlib.pyplot as plt

    path = os.path.join(data_root, "metrics.csv")
    with open(path) as f:
        rows = [r for r in csv.DictReader(f) if r.get("epoch")]

    def col(name):
        out = []
        for r in rows:
            v = r.get(name)
            try:
                out.append(float(v))
            except (TypeError, ValueError):
                out.append(float("nan"))
        return out

    epochs = col("epoch")
    panels = [
        ("loss", [("train_loss", "train"), ("val_loss", "val")]),
        ("accuracy", [("train_acc", "train"), ("val_acc", "val")]),
        ("EER (%)", [("eer_percent", "val"),
                     ("macro_eer_percent", "macro")]),
        ("AUC", [("auc", "val")]),
    ]
    fig, axes = plt.subplots(2, 2, figsize=(11, 8))
    for ax, (ylabel, series) in zip(axes.flat, panels):
        for key, label in series:
            ys = col(key)
            if any(y == y for y in ys):  # any non-NaN
                ax.plot(epochs, ys, marker="o", ms=3, label=label)
        ax.set_xlabel("epoch")
        ax.set_ylabel(ylabel)
        ax.grid(alpha=0.3)
        ax.legend()
    fig.tight_layout()
    if show:  # pragma: no cover - notebook path
        plt.show()
    return fig
