"""Detection metrics: EER, macro-EER, ROC/AUC, DET coordinates, min t-DCF.

Counterpart: ``radad_tpu/train/metrics.py``, copied (numpy and scipy
only). ``auc`` takes ``np.trapz`` where numpy predates ``np.trapezoid``.

Dependency-free numpy implementations matching the reference's definitions
(reference pipeline.py:151-326):

  * EER via a threshold sweep over [-inf, unique(scores), +inf], taking the
    threshold minimizing |FNR - FPR| and averaging the two rates;
  * macro-EER = mean of per-group EERs over groups containing both classes;
  * ROC by sorted cumulative counts with (0,0)/(1,1) endpoints, AUC by
    trapezoid;
  * DET axes via the normal-deviate (probit) transform;
  * normalized min t-DCF for a CM preceding an ASV system, with the 10-param
    cost model; NaN when the ASV operating point isn't configured (the
    reference never configures it either, BASELINE.md).

Label convention is the codebase's single source of truth: SPOOF = 1
(positive), and scores are spoof logits (higher ⇒ more likely spoof).
EER is invariant under jointly flipping labels and score direction, so these
numbers are directly comparable to the reference's.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np


def compute_eer(scores: np.ndarray, labels: np.ndarray
                ) -> Tuple[float, float]:
    """→ (EER %, threshold at the EER point)."""
    scores = np.asarray(scores, dtype=np.float64)
    labels = np.asarray(labels, dtype=np.int32)
    pos = np.sort(scores[labels == 1])
    neg = np.sort(scores[labels == 0])
    if len(pos) == 0 or len(neg) == 0:
        return float("nan"), float("nan")
    thrs = np.r_[-np.inf, np.unique(scores), np.inf]
    fnr = np.searchsorted(pos, thrs, side="left") / len(pos)
    fpr = (len(neg) - np.searchsorted(neg, thrs, side="left")) / len(neg)
    k = int(np.argmin(np.abs(fnr - fpr)))
    return float((fnr[k] + fpr[k]) / 2.0 * 100.0), float(thrs[k])


def compute_macro_eer(scores: np.ndarray, labels: np.ndarray,
                      groups: Sequence[str]) -> float:
    """Mean EER across groups (speakers) that contain both classes."""
    scores = np.asarray(scores)
    labels = np.asarray(labels)
    groups = np.asarray(groups)
    eers = []
    for g in np.unique(groups):
        m = groups == g
        y, s = labels[m], scores[m]
        if (y == 1).any() and (y == 0).any():
            eer, _ = compute_eer(s, y)
            if np.isfinite(eer):
                eers.append(eer)
    return float(np.mean(eers)) if eers else float("nan")


def roc_curve(scores: np.ndarray, labels: np.ndarray
              ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """→ (fpr, tpr, thresholds); positive class is label 1."""
    scores = np.asarray(scores, dtype=np.float64)
    labels = np.asarray(labels, dtype=np.int32)
    order = np.argsort(-scores)
    s, y = scores[order], labels[order]
    n_pos = int((y == 1).sum())
    n_neg = int((y == 0).sum())
    if n_pos == 0 or n_neg == 0:
        return (np.array([0.0, 1.0]), np.array([0.0, 1.0]),
                np.array([np.inf, -np.inf]))
    tps = np.cumsum(y == 1)
    fps = np.cumsum(y == 0)
    distinct = np.r_[s[1:] != s[:-1], True]  # last point of each score run
    tpr = np.r_[0.0, tps[distinct] / n_pos, 1.0]
    fpr = np.r_[0.0, fps[distinct] / n_neg, 1.0]
    thr = np.r_[s[0] + 1e-6, s[distinct], s[-1] - 1e-6]
    return fpr, tpr, thr


def auc(fpr: np.ndarray, tpr: np.ndarray) -> float:
    trapezoid = getattr(np, "trapezoid", None) or np.trapz
    return float(trapezoid(tpr, fpr))


def probit(x: np.ndarray) -> np.ndarray:
    """Inverse normal CDF for DET plot axes (scipy when present)."""
    try:
        from scipy.stats import norm

        return norm.ppf(np.clip(x, 1e-9, 1 - 1e-9))
    except Exception:
        from scipy.special import erfinv  # pragma: no cover

        x = np.clip(x, 1e-9, 1 - 1e-9)
        return np.sqrt(2.0) * erfinv(2.0 * x - 1.0)


def det_curve(scores: np.ndarray, labels: np.ndarray
              ) -> Tuple[np.ndarray, np.ndarray]:
    """→ (probit(FPR), probit(FNR)) over the ROC sweep."""
    fpr, tpr, _ = roc_curve(scores, labels)
    fnr = 1.0 - tpr
    return probit(fpr), probit(fnr)


REQUIRED_ASV_KEYS = frozenset({
    "P_miss_asv", "P_fa_asv", "P_fa_spoof_asv", "C_miss_asv", "C_fa_asv",
    "C_miss_cm", "C_fa_cm", "pi_tar", "pi_non", "pi_spoof",
})


def compute_min_tdcf(cm_scores: np.ndarray, labels: np.ndarray,
                     asv_params: Optional[Dict[str, float]]
                     ) -> Tuple[float, float]:
    """Normalized minimum tandem detection cost (t-DCF) of the CM.

    ``labels``: 1 = spoof; ``cm_scores``: higher ⇒ spoof. The cost model
    treats "miss" as rejecting a bona-fide trial and "fa" as accepting a
    spoof, so the sweep internally uses bona-fide-positive scores
    (= negated spoof scores).
    """
    if asv_params is None or any(k not in asv_params
                                 for k in REQUIRED_ASV_KEYS):
        return float("nan"), float("nan")
    p = {k: float(asv_params[k]) for k in REQUIRED_ASV_KEYS}
    c_def = min(p["C_miss_asv"] * p["pi_tar"], p["C_fa_asv"] * p["pi_non"])
    if c_def <= 0:
        return float("nan"), float("nan")

    bona = np.sort(-np.asarray(cm_scores, np.float64)[np.asarray(labels) == 0])
    spoof = np.sort(-np.asarray(cm_scores, np.float64)[np.asarray(labels) == 1])
    if len(bona) == 0 or len(spoof) == 0:
        return float("nan"), float("nan")
    thrs = np.r_[-np.inf, np.unique(np.r_[bona, spoof]), np.inf]
    p_miss_cm = np.searchsorted(bona, thrs, side="left") / len(bona)
    p_fa_cm = (len(spoof) - np.searchsorted(spoof, thrs, side="left")) / len(spoof)

    # Official ASVspoof t-DCF: the CM false-accept term scales with
    # Pfa_cm (spoof accepted by the CM). The reference uses (1 - Pmiss_cm)
    # there (pipeline.py:321) — a bona-fide-distribution quantity that makes
    # the cost insensitive to CM quality at the optimum; corrected here.
    tdcf = (p["C_miss_asv"] * p["pi_tar"] * p["P_miss_asv"]
            + p["C_fa_asv"] * p["pi_non"] * p["P_fa_asv"]
            + p["C_fa_cm"] * p["pi_spoof"] * p_fa_cm * p["P_fa_spoof_asv"]
            + p["C_miss_cm"] * p["pi_tar"] * p_miss_cm) / c_def
    k = int(np.argmin(tdcf))
    return float(tdcf[k]), float(-thrs[k])


def recall_at_k(retrieved: np.ndarray, exact: np.ndarray) -> float:
    """Fraction of exact top-k neighbors recovered, averaged over queries —
    the BASELINE.json parity metric for approximate/sharded index modes."""
    retrieved = np.asarray(retrieved)
    exact = np.asarray(exact)
    k = exact.shape[1]
    hits = [len(set(r) & set(e)) / k for r, e in zip(retrieved, exact)]
    return float(np.mean(hits))
