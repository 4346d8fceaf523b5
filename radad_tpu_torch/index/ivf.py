"""K-means coarse quantizer: the codebook of SQ8's residual encoding (and of
the IVF index mode, a later slice of the port).

Counterpart: ``radad_tpu/index/ivf.py`` (``_lloyd``, ``kmeans``). Lloyd's
algorithm runs on the index's device with JAX's arithmetic: the expanded
distances ``|x|^2 - 2 x.c + |c|^2`` in f32 (TF32 off, as the port's entry
points set it), ``argmin`` keeping the lower cell on ties, cell sums as a
one-hot product, and an empty cell keeping its centroid. ``balance > 0``
runs JAX's split-refinement rounds on the host with the same numpy
generator.

The initial rows differ from JAX's: ``jax.random.choice(PRNGKey(seed),
...)`` cannot be reproduced without JAX, so the port draws them from a
seeded CPU ``torch.Generator`` with the same rule (distinct rows unless
``nlist > n``). Parity with JAX is held on ``_lloyd`` from the same initial
centroids, and on the codebook that SQ8's index files carry across.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


def _lloyd(x: torch.Tensor, cents: torch.Tensor, nlist: int, iters: int
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``iters`` Lloyd steps from ``cents`` → (centroids [nlist, D], the
    final nearest-centroid assignment [N] int32). Empty cells keep their
    previous centroid."""
    x = x.float()
    xsq = x.square().sum(-1, keepdim=True)

    def assign_to(c):
        d2 = xsq - 2.0 * (x @ c.t()) + c.square().sum(-1)[None, :]
        return d2.argmin(-1)  # the first (lowest) cell among equal values

    for _ in range(iters):
        one_hot = torch.nn.functional.one_hot(assign_to(cents),
                                              nlist).to(x.dtype)
        sums = one_hot.t() @ x  # [nlist, D]
        counts = one_hot.sum(0)[:, None]  # [nlist, 1]
        cents = torch.where(counts > 0, sums / counts.clamp_min(1.0), cents)
    return cents, assign_to(cents).to(torch.int32)


def kmeans(x: torch.Tensor, nlist: int, iters: int = 25, seed: int = 0,
           balance: float = 0.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """K-means on ``x [N, D]`` (on any device) → (centroids [nlist, D],
    assignments [N] int32), deterministic for ``seed``.

    ``iters`` defaults to FAISS's ``ClusteringParameters.niter`` (25).
    ``balance > 0`` then runs JAX's split-refinement rounds: per round, up
    to nlist / 8 of the largest cells are split (the centroid duplicated
    with a ± perturbation, replacing one of the smallest cells' centroids)
    wherever the large cell holds more than ``max(1.25, 1 + balance)`` ×
    its partner, then 6 Lloyd steps; at most 10 rounds, ending early when
    no split fires."""
    n, d = x.shape
    g = torch.Generator().manual_seed(seed)
    if nlist > n:
        init_idx = torch.randint(0, n, (nlist,), generator=g)
    else:
        init_idx = torch.randperm(n, generator=g)[:nlist]
    cents, assign = _lloyd(x, x[init_idx.to(x.device)].float(), nlist, iters)
    if balance <= 0.0:
        return cents, assign

    ratio = max(1.25, 1.0 + float(balance))
    m = max(1, nlist // 8)
    host_rng = np.random.default_rng(seed)
    for _ in range(10):
        counts = np.bincount(assign.cpu().numpy(), minlength=nlist
                             ).astype(np.float64)
        order = np.argsort(-counts)
        cn = cents.cpu().numpy().copy()
        changed = 0
        for b, s in zip(order[:m], order[::-1][:m]):
            if counts[b] > ratio * max(counts[s], 1.0):
                eps = 1e-3 * float(np.abs(cn[b]).mean())
                dirn = host_rng.standard_normal(d).astype(cn.dtype)
                dirn /= max(float(np.linalg.norm(dirn)), 1e-12)
                cn[s] = cn[b] + eps * dirn
                cn[b] = cn[b] - eps * dirn
                changed += 1
        if not changed:
            break
        cents, assign = _lloyd(x, torch.as_tensor(cn, device=x.device),
                               nlist, 6)
    return cents, assign
