"""The index rows and the training rows, made on the device from the seed.

Serving: the reference's embeddings of the DB clips first (so a catalog
pick finds its own row and must exclude it), then one block of 32 tight
clusters of 32 near-duplicates (0.05 of the per-dimension spread), then
wider perturbations (0.5 of it) of random DB clips up to the index size.

Training: clusters of six rows around centres drawn around 1 with unit
spread, each centre with a label drawn at the spoof share; every row is its
centre plus unit noise times its own scale, drawn from 0.1-0.6, and takes
its centre's label. A row's five nearest rows are its cluster's other five,
far nearer than any other cluster's, so the k-th and (k+1)-th neighbors of
a training query are never tied within float32's rounding (a float32
search would be free to return either, and the reference could not follow
it).
"""

from __future__ import annotations

from typing import List, Tuple

import torch

from harness.common import sub_seed


def serving_rows(anchors: torch.Tensor, anchor_names: List[str],
                 anchor_labels: List[float], n_rows: int, seed: int
                 ) -> Tuple[torch.Tensor, torch.Tensor, List[str]]:
    """→ (rows [n_rows, D] float32, labels [n_rows], names)."""
    dev = anchors.device
    g = torch.Generator(device=dev).manual_seed(sub_seed(seed, "rows"))
    real = anchors.float()
    n, d = real.shape
    std = real.std(0, keepdim=True)
    m = 32 if n_rows - n >= 2048 else 4  # 4 x 4 in the CPU tests' index
    centers = real[torch.randint(0, n, (m,), generator=g, device=dev)]
    block = centers.repeat_interleave(m, 0) + 0.05 * std * torch.randn(
        (m * m, d), generator=g, device=dev)
    rest = n_rows - n - block.shape[0]
    base = real[torch.randint(0, n, (rest,), generator=g, device=dev)]
    wide = base + 0.5 * std * torch.randn((rest, d), generator=g, device=dev)
    rows = torch.cat([real, block, wide])
    pad_labels = (torch.rand((n_rows - n,), generator=g, device=dev)
                  > 0.5).float()
    labels = torch.cat([torch.as_tensor(anchor_labels, device=dev).float(),
                        pad_labels])
    names = list(anchor_names) + [f"pad_{i:06d}.wav"
                                  for i in range(n_rows - n)]
    return rows, labels, names


CLUSTER = 6  # rows a training cluster: a row and its five nearest


def train_rows(n_rows: int, dim: int, spoof_share: float, seed: int,
               device) -> Tuple[torch.Tensor, torch.Tensor]:
    """→ (rows [n_rows, dim] float32, labels [n_rows] float32)."""
    g = torch.Generator(device=device).manual_seed(sub_seed(seed, "train"))
    n_clusters = -(-n_rows // CLUSTER)
    centers = 1.0 + torch.randn((n_clusters, dim), generator=g, device=device)
    spoof = (torch.rand((n_clusters,), generator=g, device=device)
             < spoof_share).float()
    pick = torch.arange(n_rows, device=device) // CLUSTER
    scale = 0.1 + 0.5 * torch.rand((n_rows, 1), generator=g, device=device)
    rows = centers[pick] + scale * torch.randn((n_rows, dim), generator=g,
                                               device=device)
    return rows, spoof[pick]
