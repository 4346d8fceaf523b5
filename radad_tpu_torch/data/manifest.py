"""Dataset manifest: meta.csv parsing, label normalization, stratified splits.

Counterpart: ``radad_tpu/data/manifest.py``, copied (the port imports
nothing of ``radad_tpu``). ``file_id`` must stay bit-identical to the JAX
package's: the index stores it per row for self-exclusion, and either
package loads the other's index files. pandas and scikit-learn are
imported only by ``load_manifests``.

Host-side (pure Python/pandas) counterpart of the reference's ``AudioDataset``
(``reference/dataset.py:12-136``). Behavior parity:

  * label strings normalize to SPOOF=1 / BONAFIDE=0 with the same accepted
    synonym sets (dataset.py:28-29,36-44), failing fast on unknown strings;
  * class-balanced ``data_fraction`` subsampling per label group with the
    config seed (dataset.py:66-74);
  * stratified train/val split via sklearn ``train_test_split`` with the same
    seed, so the split is bit-identical to the reference's (dataset.py:77-93);
  * relative paths resolve against the data dir (dataset.py:102-105) and
    ``speaker`` column becomes per-item metadata (dataset.py:112-113).

Unlike the reference's map-style torch dataset, this is a plain immutable
record batch; device placement happens later in the loader.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import zlib
from typing import Dict, List

import numpy as np

logger = logging.getLogger(__name__)

SPOOF_VALUES = {
    "spoof", "fake", "synthetic", "spoofed", "tts", "vc",
    "voice-conversion", "voice conversion",
}
BONA_VALUES = {
    "bona-fide", "bonafide", "genuine", "real", "authentic", "bona fide",
}


def normalize_label(s: str) -> int:
    """SPOOF=1 (positive class), BONAFIDE=0; raises on unknown strings."""
    s = str(s).strip().lower()
    if s in SPOOF_VALUES:
        return 1
    if s in BONA_VALUES:
        return 0
    raise ValueError(f"Unknown label string: {s!r}")


def file_id(path: str) -> int:
    """Stable 31-bit id for a file, keyed on basename.

    The reference excludes self-matches during retrieval by comparing file
    *basenames* (pipeline.py:494-501). We store this id per DB row so the
    exclusion can run on-device as an integer mask instead of a host-side
    string filter.
    """
    return zlib.crc32(os.path.basename(path).encode("utf-8")) & 0x7FFFFFFF


@dataclasses.dataclass(frozen=True)
class Manifest:
    """One split of the dataset: parallel per-item arrays."""

    paths: tuple  # absolute audio paths
    labels: np.ndarray  # float32 [N], 1.0=spoof 0.0=bonafide
    speakers: tuple  # speaker ids as strings ("" when absent)
    ids: np.ndarray  # int32 [N] stable basename ids

    def __len__(self) -> int:
        return len(self.paths)

    @property
    def basenames(self) -> List[str]:
        return [os.path.basename(p) for p in self.paths]

    def pos_weight(self, clip: tuple = (0.1, 10.0)) -> float:
        """BCE positive-class weight, matching pipeline.py:133-149:
        (num_neg + 1) / (num_pos + 1), clipped to [0.1, 10]."""
        pos = float(np.sum(self.labels == 1.0))
        neg = float(np.sum(self.labels == 0.0))
        w = (neg + 1.0) / (pos + 1.0)
        return float(np.clip(w, clip[0], clip[1]))

    def class_counts(self) -> Dict[str, int]:
        return {
            "spoof": int(np.sum(self.labels == 1.0)),
            "bonafide": int(np.sum(self.labels == 0.0)),
        }

    def subset(self, indices) -> "Manifest":
        """Row subset in the given order (used by the incremental DB
        update to embed only clips not already in the index)."""
        idx = np.asarray(indices, np.int64)
        return Manifest(
            paths=tuple(self.paths[int(i)] for i in idx),
            labels=self.labels[idx],
            speakers=tuple(self.speakers[int(i)] for i in idx),
            ids=self.ids[idx])


def _subsample_balanced(df, fraction: float, seed: int):
    """Class-balanced subsample: per label group, round(len*frac) rows, min 1."""
    np.random.seed(seed)
    parts = []
    for _, g in df.groupby("y", group_keys=False, sort=True):
        n = max(1, int(round(len(g) * fraction)))
        parts.append(g.sample(n, random_state=seed))
    import pandas as pd

    out = pd.concat(parts).reset_index(drop=True)
    logger.info("Applied data fraction %.1f%% -> %d samples", fraction * 100, len(out))
    return out


def load_manifests(
    data_path: str,
    *,
    data_fraction: float = 1.0,
    train_split: float = 0.8,
    seed: int = 42,
    split: bool = True,
    meta_name: str = "meta.csv",
) -> Dict[str, Manifest]:
    """Read ``meta.csv`` and return {'train': ..., 'val': ...} manifests.

    With ``split=False``, returns a single {'all': ...} manifest of every row
    (the reference's ``split_data=False`` mode, dataset.py:77).
    """
    metadata_file = os.path.join(data_path, meta_name)
    if not os.path.exists(metadata_file):
        raise FileNotFoundError(f"Metadata file not found: {metadata_file}")

    import pandas as pd

    df = pd.read_csv(metadata_file)
    file_col = "file" if "file" in df.columns else "path"
    label_col = "label"
    df["y"] = df[label_col].astype(str).str.strip().str.lower().map(normalize_label)
    if not set(df["y"].unique().tolist()) <= {0, 1}:
        raise AssertionError(f"Unexpected numeric labels: {df['y'].unique().tolist()}")

    if data_fraction < 1.0:
        df = _subsample_balanced(df, float(data_fraction), seed)

    def build(frame) -> Manifest:
        paths = tuple(
            p if os.path.isabs(p) else os.path.join(data_path, p)
            for p in frame[file_col].astype(str)
        )
        labels = frame["y"].to_numpy(dtype=np.float32)
        if "speaker" in frame.columns:
            speakers = tuple(str(s) for s in frame["speaker"])
        else:
            speakers = tuple("" for _ in paths)
        ids = np.asarray([file_id(p) for p in paths], dtype=np.int32)
        return Manifest(paths=paths, labels=labels, speakers=speakers, ids=ids)

    if not split:
        return {"all": build(df.reset_index(drop=True))}

    from sklearn.model_selection import train_test_split

    X = df[[file_col] + [c for c in df.columns if c not in (file_col, label_col, "y")]]
    y = df["y"]
    X_train, X_val, y_train, y_val = train_test_split(
        X, y,
        train_size=train_split,
        test_size=1.0 - train_split,
        random_state=seed,
        stratify=y,
    )
    train_df = pd.concat([X_train, y_train], axis=1).reset_index(drop=True)
    val_df = pd.concat([X_val, y_val], axis=1).reset_index(drop=True)
    logger.info("TRAIN split: %d samples; VAL split: %d samples", len(train_df), len(val_df))
    return {"train": build(train_df), "val": build(val_df)}


def validate_no_leakage(train: Manifest, val: Manifest) -> None:
    """Raise if any file basename appears in both splits (pipeline.py:1105-1110)."""
    overlap = set(train.basenames) & set(val.basenames)
    if overlap:
        raise ValueError(
            f"Data leakage: {len(overlap)} files shared between train and val, "
            f"e.g. {sorted(overlap)[:5]}"
        )
