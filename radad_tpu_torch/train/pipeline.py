"""DetectionPipeline: DB build, training, evaluation, predict.

Counterpart: ``radad_tpu/train/pipeline.py`` (``make_embed_fn``,
``grid_cover_samples``, ``retrieve_on_device``, ``make_step_fns``,
``DetectionPipeline``'s ``build_vector_database``, ``train``,
``evaluate_with_scores``, ``evaluate``, ``load_vector_database``,
``predict``, ``predict_batch``, ``save_models``, ``load_models``,
``print_dataset_statistics``), with the SQ8 index
(``index/quantized.py``: ``vector_db_index_type="SQ8"``, plain, residual
or int4-refined; ``retrieve_on_device_sq8`` in serving and in the train
step) and the IVF index (``retrieve_on_device_ivf_gather_chunked`` on the
predict paths; see ``_retrieve``).

On a mesh (``DetectionPipeline(mesh=parallel.make_mesh(...))``) the
pipeline runs SPMD, one process a rank, every rank called with the same
arguments: the DB rows split over 'index' (each rank keeps its block on its
device; the whole index stays on the host for saves and adds), batches
over 'data' (each rank embeds, retrieves and steps on its slice), the
search is ``parallel/sharded_index.py`` (no accelerator arrays, as JAX's
``build_accel = mesh is None``), the train step is the global batch's
(``make_step_fns(mesh=...)``), and every rank returns the full results.
Rank 0 alone writes files.

A predict call runs embed (segment → encoder → TPP → mean over windows)
→ flat search → neighbor gather (``ops.gather.gather_rows``) → fusion
model. With ``use_mixed_precision`` the encoder and the fusion model
compute in bf16; the clip embeddings leave the encoder as f32, so the
index, the search and its certificate are the f32 ones. The search is the certified route, or with
``DetectionPipeline(use_pallas=True)`` the ``flat_topk`` scan + exact
re-rank; the JAX package's ``retrieve_on_device`` pins ``use_pallas=False``,
so there only ``FlatIndex.search`` reaches its kernel. JAX compiles that into one program with ``lax.cond`` for the
retry of rows whose neighbors were all excluded; here it runs eagerly and
the retry is a host branch on one bool.

A train step (``make_step_fns``) retrieves inside the step, as JAX does:
the same search with one exclusion set per batch, under ``no_grad`` (the
neighbors are constants of the loss; the encoder is frozen), then the
fusion model's training forward, the masked pos-weighted BCE, backward,
and the per-group clip + Adam of ``train/optim.py``. The step runs eagerly;
JAX jits it. The certificate is a host branch on one bool a step, and
``FlatIndex.fallbacks`` counts the batches that took the full f32 scan.
The frozen encoder embeds each manifest once (``_embeddings_any``), and
batches are row gathers from that device-resident matrix.

Checkpoints are the port's own format, ``<data_root>/models/
<prefix>_radad.pt`` (``train/checkpoint.py``: model, optimizer state,
step, config JSON): the JAX format pickles a jax treedef.
``models/convert.py`` loads JAX weights and optimizer state.
"""

from __future__ import annotations

import json
import logging
import os
import time
from typing import Callable, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from radad_tpu_torch.config import Config
from radad_tpu_torch.data.audio import load_audio
from radad_tpu_torch.data.loader import iterate_batches
from radad_tpu_torch.data.manifest import (Manifest, file_id,
                                           validate_no_leakage)
from radad_tpu_torch.index.flat import FlatIndex, _search_device
from radad_tpu_torch.index.ivf_gather import (ivf_gather_search,
                                              ivf_gather_search_chunked)
from radad_tpu_torch.index.quantized import (QuantizedIndex,
                                             retrieve_on_device_sq8)
from radad_tpu_torch.models.encoder import FrozenEncoder, build_encoder
from radad_tpu_torch.models.fusion import build_radad_model
from radad_tpu_torch.ops.gather import gather_rows
from radad_tpu_torch.ops.segmenter import segment_audio
from radad_tpu_torch.ops.tpp import temporal_pyramid_pool, tpp_output_dim
from radad_tpu_torch.parallel.mesh import (DATA_AXIS, INDEX_AXIS,
                                           all_reduce_sum, batch_sharding,
                                           index_sharding)
from radad_tpu_torch.parallel.sharded_index import (
    SQ8_SHARD_ROWS, build_sharded_chunk_tables, gather_budget, pad_rows,
    shard_capacity, sharded_retrieve, sharded_retrieve_ivf_gather,
    sharded_retrieve_sq8)
from radad_tpu_torch.train import metrics as M
from radad_tpu_torch.train.artifacts import ArtifactWriter, WandbShim
from radad_tpu_torch.train.checkpoint import (checkpoint_path,
                                              load_checkpoint,
                                              save_checkpoint)
from radad_tpu_torch.train.optim import (GroupAdam, group_of,
                                         pos_weighted_bce)
from radad_tpu_torch.utils.device import resolve_device
from radad_tpu_torch.utils.profiling import annotate

logger = logging.getLogger(__name__)


def make_embed_fn(encoder: FrozenEncoder, config: Config):
    """Clip embedding: audio ``[B, clip]`` → TPP vectors ``[B, D]`` f32.

    ``lengths [B]`` (long-audio mode, config.max_duration): true sample
    counts; window i counts iff ``i * hop < length`` and the embedding is
    the mean over counted windows. ``lengths=None``: every window counts
    (reference pipeline.py:409-412)."""

    @torch.inference_mode()
    def embed(audio: torch.Tensor,
              lengths: Optional[torch.Tensor] = None) -> torch.Tensor:
        segs = segment_audio(audio, config.segment_samples,
                             config.hop_samples)  # [B, S, L]
        feats = encoder.segment_features(segs)  # [B, S, T, D]
        tpp = temporal_pyramid_pool(feats, config.tpp_levels,
                                    config.tpp_pooling_type)  # [B, S, 7D]
        if lengths is None:
            return tpp.mean(1).float()
        s = tpp.shape[1]
        n_valid = ((lengths.long() + config.hop_samples - 1)
                   // config.hop_samples).clamp(1, s)  # [B]
        mask = (torch.arange(s, device=tpp.device)[None, :]
                < n_valid[:, None])
        num = (tpp * mask[..., None].to(tpp.dtype)).sum(1)
        return (num / n_valid[:, None].to(num.dtype)).float()

    return embed


def grid_cover_samples(samples: int, segment_samples: int,
                       hop_samples: int) -> int:
    """Smallest padded length whose window grid covers every window that
    touches the first ``samples`` real samples."""
    n_win = max(1, -(-samples // hop_samples))
    return (n_win - 1) * hop_samples + segment_samples


def retrieve_on_device(tpp, vectors, labels, ids, exclude_ids, *, k, metric,
                       n_valid, xsq, scan_bf16, resid_bf16=None,
                       exclude_mode="batch", use_pallas=False):
    """Search (certified, or ``flat_topk`` + re-rank with ``use_pallas``) +
    neighbor/label gather. → (neighbors [B, k, D] f32, labels [B, k],
    dists [B, k], idx [B, k], fell_back). Missing neighbors are zero
    vectors with label 0 and index -1 (reference pipeline.py:511-515)."""
    q = tpp
    if metric == "COSINE":
        q = q / q.norm(dim=-1, keepdim=True).clamp_min(1e-12)
    dists, idx, fell_back = _search_device(
        q, vectors, ids, exclude_ids, k, metric=metric, n_valid=n_valid,
        xsq=xsq, scan_bf16=scan_bf16, resid_bf16=resid_bf16,
        exclude_mode=exclude_mode, use_pallas=use_pallas)
    safe = idx.clamp_min(0).to(torch.int32)
    d = vectors.shape[-1]
    neighbors = gather_rows(vectors, safe.reshape(-1)).float()
    neighbors = neighbors.reshape(idx.shape + (d,))
    ok = idx >= 0
    neighbors = torch.where(ok[..., None], neighbors,
                            torch.zeros_like(neighbors))
    nlabels = torch.where(ok, labels[safe.long()], torch.zeros_like(dists))
    return neighbors, nlabels, dists, idx, fell_back


def retrieve_on_device_ivf_gather(tpp, vectors, xsq, labels, ids,
                                  exclude_ids, centroids, table, overflow,
                                  *, k, nprobe, exclude_mode="batch"):
    """Gather-probed IVF retrieval over the span table
    (``index/ivf_gather.py``): ``retrieve_on_device``'s output contract
    (missing neighbors are zero vectors with label 0, distance +inf and
    index -1), reading only the probed cells' rows."""
    dists, idx = ivf_gather_search(
        tpp, vectors, xsq, ids, exclude_ids, centroids, table, overflow, k,
        nprobe=nprobe, exclude_mode=exclude_mode)
    return _gathered_to_neighbors(vectors, labels, dists, idx)


def retrieve_on_device_ivf_gather_chunked(
        tpp, vectors, xsq, labels, ids, exclude_ids, centroids, chunk_rows,
        cell_chunks, cells, *, k, nprobe, budget, n_valid,
        exclude_mode="batch"):
    """The same over the chunk table, with the dense masked probed scan
    when the probed cells exceed ``budget`` chunks. → (neighbors, nlabels,
    dists, idx, fell_back)."""
    dists, idx, fell_back = ivf_gather_search_chunked(
        tpp, vectors, xsq, ids, exclude_ids, centroids, chunk_rows,
        cell_chunks, cells, k, nprobe=nprobe, budget=budget,
        n_valid=n_valid, exclude_mode=exclude_mode)
    return _gathered_to_neighbors(vectors, labels, dists, idx) + (fell_back,)


def _gathered_to_neighbors(vectors, labels, dists, idx):
    """Neighbor rows and labels of ``idx`` by ``index_select`` (JAX's XLA
    take on this route, not the ``gather_rows`` kernel). → (neighbors
    [B, k, D] f32, labels [B, k], dists, idx)."""
    safe = idx.clamp_min(0).long()
    neighbors = vectors.index_select(0, safe.reshape(-1)).float().reshape(
        idx.shape + (vectors.shape[-1],))
    ok = idx >= 0
    neighbors = torch.where(ok[..., None], neighbors,
                            torch.zeros_like(neighbors))
    nlabels = torch.where(ok, labels[safe], torch.zeros_like(dists))
    return neighbors, nlabels, dists, idx


ACC_KEYS = ("loss_sum", "correct", "count", "nnz_sum", "gn_proj_sum",
            "gn_fuse_sum", "gn_det_sum", "batches")


def new_accumulators(device) -> Dict[str, torch.Tensor]:
    """An epoch's metric sums, 0-d tensors on ``device`` that the steps add
    to in place; read once an epoch."""
    return {k: torch.zeros((), device=device) for k in ACC_KEYS}


class StepFns(NamedTuple):
    """The train/eval step math of ``make_step_fns``. ``fetch`` retrieves,
    ``update`` (= ``forward_backward`` then ``apply``) trains on given
    neighbors, ``train_step`` is ``fetch`` then ``update``."""
    fetch: Callable
    forward_backward: Callable
    apply: Callable
    update: Callable
    train_step: Callable
    eval_step: Callable


def make_step_fns(model, opt: GroupAdam, retrieve, *, watch_grads=False,
                  grad_checkpoint=False, ablate_retrieval=False,
                  ablate_query=False, mesh=None) -> StepFns:
    """Train and eval steps over an injected ``retrieve(tpp, exclude_ids)``
    → (neighbors, nlabels, ...) (reference ``make_step_fns``,
    pipeline.py:215-346). The model's parameters and ``opt``'s state are
    updated in place; ``model`` is put in training mode for the forward
    and back in eval mode after it. Makes the parameters trainable.

    ``mesh`` (``parallel.mesh.Mesh``): each rank steps on its slice of the
    batch and the step is the global batch's, as GSPMD makes JAX's step on
    a mesh: the loss is divided by the global valid count, BatchNorm takes
    the global batch's statistics, the gradients are summed over 'data'
    before the clip and Adam (every rank then applies the same update),
    and the metrics are the global batch's."""
    model.requires_grad_(True)
    params = dict(model.named_parameters())
    stats_sum = None
    if mesh is not None:
        def stats_sum(t):
            return all_reduce_sum(mesh, t, DATA_AXIS)

    @torch.no_grad()
    def fetch(tpp, exclude_ids):
        neighbors, nlabels = retrieve(tpp, exclude_ids)[:2]
        if ablate_retrieval:
            # config.ablate_retrieval: neighbors zeroed, same shapes
            neighbors = torch.zeros_like(neighbors)
            nlabels = torch.zeros_like(nlabels)
        return neighbors.nan_to_num(), nlabels  # pipeline.py:801-803

    def model_tpp(tpp):
        # config.ablate_query: the model sees a zeroed query vector while
        # retrieval still uses the real one
        return torch.zeros_like(tpp) if ablate_query else tpp

    def forward_backward(neighbors, tpp, labels, valid, pos_weight,
                         generator=None):
        """Training forward over all B rows (pad rows included, as in JAX:
        they enter BatchNorm's batch statistics, and only the loss masks
        them), masked BCE, gradients. → (loss, logits, {name: grad})."""
        tpp_m = model_tpp(tpp)
        count = (None if mesh is None
                 else mesh.all_reduce(valid.float().sum(), DATA_AXIS))
        model.train()
        try:
            with torch.enable_grad():
                if grad_checkpoint:
                    # the rematerialized forward draws the same dropout
                    # masks: it starts from the same generator state
                    start = (None if generator is None
                             else generator.get_state())

                    def fwd(n, t):
                        if start is not None:
                            generator.set_state(start)
                        return model(n, t, generator, stats_sum)

                    logits = torch.utils.checkpoint.checkpoint(
                        fwd, neighbors, tpp_m, use_reentrant=False)
                else:
                    logits = model(neighbors, tpp_m, generator, stats_sum)
                loss = pos_weighted_bce(logits, labels, pos_weight, valid,
                                        count)
                grads = torch.autograd.grad(loss, list(params.values()))
        finally:
            model.eval()
        return loss.detach(), logits.detach(), dict(zip(params, grads))

    def apply(acc, neighbors, labels, valid, loss, logits, grads):
        """Per-group clip + decay + Adam, BatchNorm running statistics,
        the epoch sums. → per-batch metrics (device tensors). On a mesh
        the gradients are first summed over 'data' (one all-reduce), and
        ``loss`` (the rank's share) and the sums become the global
        batch's (one more)."""
        if mesh is not None:
            names = list(grads)
            flat = mesh.all_reduce(
                torch.cat([grads[n].reshape(-1) for n in names]), DATA_AXIS)
            grads = {n: g.view_as(grads[n]) for n, g in zip(
                names, flat.split([grads[n].numel() for n in names]))}
        gnorms = opt.step(params, grads)  # the pre-clip group norms
        model.detection_model.commit_batch_stats()
        vmask = valid.float()
        nv = vmask.sum()
        correct = (((logits > 0).float() == labels).float() * vmask).sum()
        nnz = (neighbors.abs().sum(-1) > 0).float()
        if mesh is None:
            nnz = nnz.mean()
        else:
            loss, nv, correct, nnz_sum, nnz_n = mesh.all_reduce(torch.stack(
                [loss, nv, correct, nnz.sum(),
                 torch.tensor(float(nnz.numel()), device=nv.device)]),
                DATA_AXIS).unbind()
            nnz = nnz_sum / nnz_n
        for key, val in (("loss_sum", loss * nv), ("correct", correct),
                         ("count", nv), ("nnz_sum", nnz),
                         ("gn_proj_sum", gnorms["projection_layer"]),
                         ("gn_fuse_sum", gnorms["fuse"]),
                         ("gn_det_sum", gnorms["detection_model"]),
                         ("batches", 1.0)):
            acc[key] += val
        batch_metrics = {"loss": loss, "acc": correct / nv.clamp_min(1.0),
                         "gn_proj": gnorms["projection_layer"],
                         "gn_fuse": gnorms["fuse"],
                         "gn_det": gnorms["detection_model"]}
        if watch_grads:
            # wandb.watch-equivalent histograms, 64 bins a group
            for group, sub in (("projection_layer", "proj"),
                               ("fuse", "fuse"),
                               ("detection_model", "det")):
                flat = torch.cat([g.reshape(-1) for n, g in grads.items()
                                  if group_of(n) == group])
                lo, hi = float(flat.min()), float(flat.max())
                if lo == hi:  # jnp.histogram widens an empty range
                    lo, hi = lo - 0.5, hi + 0.5
                batch_metrics[f"hist_counts_{sub}"] = torch.histc(
                    flat, bins=64, min=lo, max=hi)
                batch_metrics[f"hist_edges_{sub}"] = torch.linspace(
                    lo, hi, 65)
        return batch_metrics

    def update(acc, neighbors, tpp, labels, valid, pos_weight,
               generator=None):
        loss, logits, grads = forward_backward(neighbors, tpp, labels,
                                               valid, pos_weight, generator)
        return apply(acc, neighbors, labels, valid, loss, logits, grads)

    def train_step(acc, tpp, labels, exclude_ids, valid, pos_weight,
                   generator=None):
        neighbors, _ = fetch(tpp, exclude_ids)
        return update(acc, neighbors, tpp, labels, valid, pos_weight,
                      generator)

    @torch.no_grad()
    def eval_step(tpp, exclude_ids):
        neighbors, nlabels = fetch(tpp, exclude_ids)
        model.eval()
        return model(neighbors, model_tpp(tpp)), nlabels

    return StepFns(fetch, forward_backward, apply, update, train_step,
                   eval_step)


def _move_index(index, device) -> None:
    """Every tensor of ``index`` (a ``FlatIndex`` or ``QuantizedIndex``) to
    ``device``, which becomes the index's."""
    device = torch.device(device)
    for name, val in list(vars(index).items()):
        if isinstance(val, torch.Tensor):
            setattr(index, name, val.to(device))
    index.device = device


class DetectionPipeline:
    """Encoder → TPP → index → fusion model: DB build, training,
    evaluation and serving."""

    def __init__(self, config: Config, *,
                 encoder: Optional[FrozenEncoder] = None,
                 use_pallas: bool = False, device="cuda", mesh=None):
        """``use_pallas``: search with the ``flat_topk`` kernel + exact
        re-rank instead of the certified route (``FlatIndex``; the SQ8
        index has no such route and ignores it). ``mesh``
        (``parallel.make_mesh``): SPMD over the mesh (module docstring);
        the rank's device is ``mesh.device``, which replaces ``device``."""
        self.mesh = mesh
        self.device = resolve_device(device if mesh is None else mesh.device)
        # rank 0 of a mesh alone writes files and prints
        self.lead = mesh is None or mesh.rank == 0
        self.config = config
        self.use_pallas = use_pallas
        self.is_quantized = config.vector_db_index_type.upper() == "SQ8"
        self.encoder = (encoder if encoder is not None
                        else build_encoder(config, device=self.device))
        self.tpp_dim = tpp_output_dim(config.tpp_levels,
                                      self.encoder.feature_dim)
        self.model = build_radad_model(config, self.tpp_dim).to(self.device)
        self.index = self._make_index()
        self.step = 0
        self._embed = make_embed_fn(self.encoder, config)
        self.writer = ArtifactWriter(config.data_root, write=self.lead)
        self.wandb = WandbShim(config.usewandb and self.lead)
        # per-group state made by _ensure_model_state or load_models
        self.opt = GroupAdam(config.learning_rate, config.weight_decay)
        # dropout's draws: one seeded generator a rank
        self.generator = torch.Generator(device=self.device).manual_seed(
            config.random_seed + (0 if mesh is None else mesh.rank))
        # on a mesh: this rank's block of the index (_place_index_on_mesh)
        # and the sharded gather-probed IVF's chunk tables
        self._shard: Optional[Dict[str, torch.Tensor]] = None
        self._mesh_ivf: Optional[dict] = None
        self._steps_fns: Optional[StepFns] = None
        # frozen-encoder embeddings, (hash(paths), len) -> [N, D] on the
        # device (config.cache_embeddings)
        self._embedding_cache: Dict[Tuple, torch.Tensor] = {}

    def _make_index(self):
        cfg = self.config
        accel = self.mesh is None  # a mesh searches the canonical arrays
        if self.is_quantized:
            if self.mesh is not None and cfg.sq8_refine_bits:
                raise ValueError(
                    "sq8_refine_bits is a single-chip capacity-mode "
                    "feature; the mesh-sharded SQ8 path consumes the "
                    "canonical int8 arrays only")
            # JAX: an L2 QuantizedIndex, build_accel without a mesh
            return QuantizedIndex(
                self.tpp_dim, "L2", build_accel=accel,
                residual_nlist=cfg.sq8_residual_nlist,
                kmeans_iters=cfg.vector_db_kmeans_iters,
                refine_bits=cfg.sq8_refine_bits,
                rerank_depth=cfg.sq8_rerank_depth, device=self.device)
        return FlatIndex(self.tpp_dim, cfg.vector_db_index_type,
                         nlist=cfg.vector_db_nlist,
                         nprobe=cfg.vector_db_nprobe,
                         kmeans_iters=cfg.vector_db_kmeans_iters,
                         ivf_balance=cfg.vector_db_ivf_balance,
                         ivf_retrain_on_add=cfg.vector_db_ivf_retrain_on_add,
                         use_float16=cfg.use_float16,
                         add_batch_size=cfg.vector_add_batch_size,
                         use_pallas=self.use_pallas, build_accel=accel,
                         device=self.device)

    def _grid_pad(self) -> Optional[int]:
        cfg = self.config
        if cfg.max_duration is None:
            return None
        return grid_cover_samples(cfg.analysis_samples, cfg.segment_samples,
                                  cfg.hop_samples)

    # ------------------------------------------------------------------
    def get_embeddings(self, manifest: Manifest) -> torch.Tensor:
        """TPP embeddings ``[N, D]`` for every clip of a manifest, in
        manifest order, on the pipeline's device; on a mesh on the host,
        every rank the whole matrix (JAX ``_embeddings_any``,
        pipeline.py:879-948). With ``config.shard_db_build`` (None: on for
        a mesh of CUDA devices, off on the CPU) each batch that divides
        the 'data' axis is embedded a slice a rank and all-gathered."""
        cfg, mesh = self.config, self.mesh
        shard = cfg.shard_db_build
        if shard is None:
            shard = mesh is not None and mesh.device.type != "cpu"
        data_div = mesh.data if mesh is not None and shard else 0
        chunks = []
        for batch in iterate_batches(
                manifest, cfg.db_batch_size, sample_rate=cfg.sample_rate,
                duration=cfg.analysis_duration, shuffle=False,
                prefetch=cfg.host_prefetch, pad_to=self._grid_pad()):
            audio = torch.as_tensor(batch.audio, device=self.device)
            lengths = (torch.as_tensor(batch.lengths, device=self.device)
                       if cfg.max_duration else None)
            if data_div and audio.shape[0] % data_div == 0:
                emb = mesh.all_gather(self._embed(
                    batch_sharding(mesh, audio),
                    None if lengths is None
                    else batch_sharding(mesh, lengths)), DATA_AXIS)
                emb = emb.flatten(0, 1)
            else:
                emb = self._embed(audio, lengths)
            chunks.append(emb[: batch.num_valid])
        out = (torch.cat(chunks) if chunks
               else torch.zeros((0, self.tpp_dim), device=self.device))
        return out if mesh is None else out.cpu()

    def _embeddings_any(self, manifest: Manifest) -> torch.Tensor:
        """``get_embeddings``, cached per manifest when
        ``config.cache_embeddings`` (the encoder is frozen, so these are
        constants of the run; JAX ``_embeddings_any``, pipeline.py:879).
        The train split's matrix is both the DB and the training queries."""
        key = (hash(manifest.paths), len(manifest))
        cached = self._embedding_cache.get(key)
        if cached is not None:
            return cached
        emb = self.get_embeddings(manifest)
        if self.config.cache_embeddings:
            self._embedding_cache[key] = emb
        return emb

    def _query_batches(self, manifest: Manifest, batch_size: int, *,
                       shuffle: bool, seed: int = 0):
        """Yield fixed-size device batches ``(tpp [B, D], labels [B],
        ids [B] int32, valid [B] bool)`` over the manifest once, in
        manifest order or shuffled by ``np.random.default_rng(seed)``; the
        last batch is padded with rows of id -1 and ``valid=False``.

        Cached mode gathers the rows from the device-resident embedding
        matrix (``index_select``) and zeroes the pad rows; no-cache mode
        decodes and embeds every batch (the reference's per-epoch encoder
        forward, pipeline.py:794-796)."""
        cfg, dev = self.config, self.device
        # on a mesh: this rank's rows of each batch
        local = slice(None) if self.mesh is None else \
            self._data_slice(batch_size)
        if not cfg.cache_embeddings:
            for batch in iterate_batches(
                    manifest, batch_size, sample_rate=cfg.sample_rate,
                    duration=cfg.analysis_duration, shuffle=shuffle,
                    seed=seed, prefetch=cfg.host_prefetch,
                    pad_to=self._grid_pad()):
                lengths = (torch.as_tensor(batch.lengths[local], device=dev)
                           if cfg.max_duration else None)
                tpp = self._embed(
                    torch.as_tensor(batch.audio[local], device=dev),
                    lengths).clone()  # not an inference tensor
                yield (tpp, torch.as_tensor(batch.labels[local], device=dev),
                       torch.as_tensor(batch.ids[local], device=dev),
                       torch.as_tensor(batch.valid[local], device=dev))
            return
        emb = self._embeddings_any(manifest)
        n = len(manifest)
        order = np.arange(n)
        if shuffle:
            np.random.default_rng(seed).shuffle(order)
        for i in range(0, n, batch_size):
            chunk = order[i:i + batch_size]
            rows = np.zeros((batch_size,), np.int64)
            rows[:len(chunk)] = chunk
            labels = np.zeros((batch_size,), np.float32)
            labels[:len(chunk)] = manifest.labels[chunk]
            ids = np.full((batch_size,), -1, np.int32)
            ids[:len(chunk)] = manifest.ids[chunk]
            valid = np.zeros((batch_size,), bool)
            valid[:len(chunk)] = True
            valid_t = torch.as_tensor(valid[local], device=dev)
            tpp = (emb.index_select(0, torch.as_tensor(
                rows[local], device=emb.device)).to(dev)
                   * valid_t[:, None].to(emb.dtype))
            yield (tpp, torch.as_tensor(labels[local], device=dev),
                   torch.as_tensor(ids[local], device=dev), valid_t)

    def build_vector_database(self, train_manifest: Manifest,
                              save: bool = True) -> None:
        """Embed the training set and install it as the reference DB
        (reference pipeline.py:416-447). The DB is saved synchronously:
        JAX saves it in a background thread, which only hides its slow
        device-to-host pull."""
        t0 = time.time()
        vectors = self._embeddings_any(train_manifest)
        speakers = [{"speaker_id": s} for s in train_manifest.speakers]
        self._add_rows(vectors, train_manifest, speakers, save)
        logger.info("Vector DB built: %d vectors in %.1fs",
                    self.index.ntotal, time.time() - t0)

    def _add_rows(self, vectors, manifest: Manifest, speakers,
                  save: bool) -> None:
        """Add rows to the index; on a mesh every rank adds the same rows
        on its device, rank 0 saves (then a barrier), and each rank keeps
        its block (``_place_index_on_mesh``)."""
        if self.mesh is not None:
            _move_index(self.index, self.device)
        self.index.add(vectors, manifest.labels.tolist(),
                       list(manifest.paths), metadata=speakers,
                       ids=manifest.ids.tolist())
        if save and self.lead:
            self.index.save(self.config.vector_db_path)
        if save and self.mesh is not None:
            self.mesh.barrier()
        self._place_index_on_mesh()

    def update_vector_database(self, manifest: Manifest, *,
                               append: bool = True,
                               save: bool = True) -> int:
        """Build, or extend with the clips not yet indexed (by basename).
        Returns the number of rows added."""
        if not append:
            self.index = self._make_index()
            self.build_vector_database(manifest, save=save)
            return self.index.ntotal
        if self.index.ntotal == 0 and os.path.exists(os.path.join(
                self.config.vector_db_path, self._meta_name)):
            self.load_vector_database()
        existing = {os.path.basename(p) for p in self.index.paths}
        new_idx = [i for i, b in enumerate(manifest.basenames)
                   if b not in existing]
        if not new_idx:
            return 0
        sub = manifest.subset(new_idx)
        self._add_rows(self.get_embeddings(sub), sub,
                       [{"speaker_id": s} for s in sub.speakers], save)
        return len(sub)

    def _place_index_on_mesh(self) -> None:
        """On a mesh: this rank's row block of the index on its device (JAX
        ``_place_index_on_mesh``, pipeline.py:444-475), the capacity padded
        by ``shard_capacity`` to a multiple of ``SQ8_SHARD_ROWS`` x the
        'index' axis (padding rows have id -1); the IVF and
        residual-SQ8 centroids whole; IVF's per-shard chunk tables
        (``_build_mesh_ivf_tables``). The whole index then moves to the
        host, where it serves saves and later adds, never a search."""
        if self.mesh is None or self.index.ntotal == 0:
            return
        ix, mesh = self.index, self.mesh
        cap = shard_capacity(ix.ids.shape[0], mesh.index, SQ8_SHARD_ROWS)

        def block(t, fill=0):
            return index_sharding(mesh, pad_rows(t, cap, fill)).to(
                self.device, copy=True)

        if self.is_quantized:
            sh = dict(codes=block(ix.codes), scales=block(ix.scales),
                      norm_sq=block(ix.norm_sq))
        else:
            sh = dict(vectors=block(ix.vectors), norms_sq=block(ix.norms_sq))
        sh.update(labels=block(ix.labels), ids=block(ix.ids, -1))
        self._mesh_ivf = None
        if ix.centroids is not None:  # IVF, or residual SQ8
            sh.update(centroids=ix.centroids.to(self.device, copy=True),
                      cells=block(ix.cells))
            if not self.is_quantized:
                cells = np.zeros((cap,), np.int32)
                cells[: ix.n] = ix.cells[: ix.n].cpu().numpy()
                self._build_mesh_ivf_tables(cells)
        self._shard = sh
        _move_index(ix, "cpu")

    def _build_mesh_ivf_tables(self, cells: np.ndarray) -> None:
        """The sharded gather-probed IVF search's chunk tables (JAX
        ``_build_mesh_ivf_tables``, pipeline.py:477-501), built on the host
        from the capacity-padded cells; this rank keeps its shard's, and
        every shard's statistics for the one budget all ranks share."""
        mesh = self.mesh
        chunk_rows, cell_chunks, n_valid_shard, stats = (
            build_sharded_chunk_tables(cells, self.index.n,
                                       int(self.index.centroids.shape[0]),
                                       mesh.index))
        self._mesh_ivf = {
            "chunk_rows": index_sharding(
                mesh, torch.as_tensor(chunk_rows)).to(self.device),
            "cell_chunks": index_sharding(
                mesh, torch.as_tensor(cell_chunks)).to(self.device),
            "n_valid_shard": int(n_valid_shard[mesh.coord(INDEX_AXIS)]),
            "stats": stats,
            "budgets": {},  # nprobe -> the budget (JAX _mesh_gather_budget)
        }

    def _mesh_gather_budget(self, nprobe: int) -> int:
        budgets = self._mesh_ivf["budgets"]
        if nprobe not in budgets:
            budgets[nprobe] = gather_budget(self._mesh_ivf["stats"], nprobe)
        return budgets[nprobe]

    # ------------------------------------------------------------------
    @property
    def _meta_name(self) -> str:
        return "sq8_meta.json" if self.is_quantized else "index_meta.json"

    def _retrieve(self, tpp, exclude, exclude_mode,
                  prefer_ivf_gather: bool = False):
        """Search + neighbors by index kind → (neighbors, nlabels, dists,
        idx).

        IVF, as the JAX package's single-device dispatch
        (``radad_tpu/train/pipeline.py:660-689``): the predict paths
        (``prefer_ivf_gather``) take the chunked gather route when
        2 B budget chunk < n; everything else (train, eval, larger predict
        batches) takes ``retrieve_on_device`` without the centroids, the
        certified search over every row, unprobed. On a mesh:
        ``_retrieve_mesh``."""
        if self.mesh is not None:
            return self._retrieve_mesh(tpp, exclude, exclude_mode,
                                       prefer_ivf_gather)
        ix = self.index
        if self.is_quantized:
            out = retrieve_on_device_sq8(
                tpp, ix.codes, ix.scales, ix.norm_sq, ix.labels, ix.ids,
                exclude, k=self.config.top_k, metric=ix.metric,
                n_valid=ix.ntotal, accel=ix.build_accel,
                exclude_mode=exclude_mode, centroids=ix.centroids,
                cells=ix.cells, codes2=ix.codes2, scales2=ix.scales2,
                rerank_depth=ix.rerank_depth)
            ix.count_search()
            return out
        if (prefer_ivf_gather and ix.metric == "IVF"
                and ix.ivf_chunk_rows is not None):
            nprobe = min(ix.nprobe, ix.ivf_cell_chunks.shape[0])
            budget = ix.chunk_budget(nprobe)
            if 2 * tpp.shape[0] * budget * ix.ivf_chunk_rows.shape[1] \
                    < ix.ntotal:
                out = retrieve_on_device_ivf_gather_chunked(
                    tpp, ix.vectors, ix.norms_sq, ix.labels, ix.ids,
                    exclude, ix.centroids, ix.ivf_chunk_rows,
                    ix.ivf_cell_chunks, ix.cells, k=self.config.top_k,
                    nprobe=nprobe, budget=budget, n_valid=ix.ntotal,
                    exclude_mode=exclude_mode)
                ix.count_gather_search(out[4])
                return out[:4]
        out = retrieve_on_device(
            tpp, ix.vectors, ix.labels, ix.ids, exclude, k=self.config.top_k,
            metric=ix.metric, n_valid=ix.ntotal, xsq=ix.norms_sq,
            scan_bf16=ix.scan_bf16, resid_bf16=ix.resid_bf16,
            exclude_mode=exclude_mode, use_pallas=ix.use_pallas)
        ix.count_search(out[4])
        return out[:4]

    def _retrieve_mesh(self, tpp, exclude, exclude_mode,
                       prefer_ivf_gather: bool):
        """The sharded search on this rank's slice of the batch (JAX
        ``_retrieve``'s mesh branch, pipeline.py:596-655): SQ8 plain or
        residual; flat; IVF with its probe mask at the index's nprobe (on a
        mesh train and eval probe too, unlike the single-device
        dispatch's unprobed search); IVF's gather route on the predict
        paths where 2 b budget chunk < the rows of a shard."""
        ix, sh, mesh, k = self.index, self._shard, self.mesh, \
            self.config.top_k
        if self.is_quantized:
            ret = sharded_retrieve_sq8(
                mesh, tpp, sh["codes"], sh["scales"], sh["norm_sq"],
                sh["labels"], sh["ids"], exclude, k=k, metric="L2",
                centroids=sh.get("centroids"), cells=sh.get("cells"),
                exclude_mode=exclude_mode)
            ix.count_search()
            return ret
        cents = sh.get("centroids")
        if prefer_ivf_gather and self._mesh_ivf is not None:
            tables = self._mesh_ivf
            nprobe = min(ix.nprobe, cents.shape[0])
            budget = self._mesh_gather_budget(nprobe)
            if (2 * tpp.shape[0] * budget * tables["chunk_rows"].shape[1]
                    < sh["vectors"].shape[0]):
                ret, scanned = sharded_retrieve_ivf_gather(
                    mesh, tpp, sh["vectors"], sh["labels"], sh["ids"],
                    exclude, cents, sh["cells"], tables["chunk_rows"],
                    tables["cell_chunks"], tables["n_valid_shard"], k=k,
                    nprobe=nprobe, budget=budget, exclude_mode=exclude_mode,
                    xsq=sh["norms_sq"])
                ix.count_gather_search(scanned)
                return ret
        ret = sharded_retrieve(
            mesh, tpp, sh["vectors"], sh["labels"], sh["ids"],
            sh["ids"] >= 0, exclude, k=k,
            metric="L2" if ix.metric == "IVF" else ix.metric,
            centroids=cents, cells=sh.get("cells"),
            nprobe=ix.nprobe if cents is not None else 32,
            exclude_mode=exclude_mode, xsq=sh["norms_sq"])
        ix.count_search(False)
        return ret

    @torch.inference_mode()
    def _predict_tensors(self, waves: np.ndarray, exclude: List[int],
                         lengths: Optional[List[int]], exclude_mode: str):
        """Embed → retrieve (with the per-row unexcluded retry) → model.
        → (logits, nlabels, dists, idx) tensors on the device.

        On a mesh the batch is padded to a multiple of the 'data' axis
        (``_pad_serving_batch``), each rank runs its slice, the retry is
        taken when any row of the global batch needs it (one all-reduce
        over 'data': a rank that skipped the retry's collectives would
        hang the others), and the results are all-gathered over 'data'."""
        dev, k = self.device, self.config.top_k
        true_b = len(exclude)
        if self.mesh is not None:
            waves, exclude, lengths = self._pad_serving_batch(
                waves, exclude, lengths)
            local = self._data_slice(len(exclude))
            waves, exclude = waves[local], exclude[local]
            lengths = None if lengths is None else lengths[local]
        audio = torch.as_tensor(waves, device=dev)
        lens = (None if lengths is None
                else torch.as_tensor(lengths, device=dev))
        with annotate("radad.embed"):
            tpp = self._embed(audio, lens)
        b = tpp.shape[0]
        if self.index.ntotal == 0:
            logger.warning("predict called with an empty vector DB")
            neighbors = torch.zeros((b, k, self.tpp_dim), device=dev)
            nlabels = torch.zeros((b, k), device=dev)
            dists = torch.full((b, k), float("nan"), device=dev)
            idx = torch.full((b, k), -1, dtype=torch.int32, device=dev)
        else:
            ex = torch.as_tensor(np.asarray(exclude, np.int32), device=dev)
            with annotate("radad.search"):
                neighbors, nlabels, dists, idx = self._retrieve(
                    tpp, ex, exclude_mode, prefer_ivf_gather=True)
                # rows whose neighbors were all excluded retry without
                # exclusion, each on its own (reference
                # pipeline.py:1051-1054)
                wiped = ~(idx >= 0).any(-1)  # [B]
                retry = wiped.any()
                if self.mesh is not None:
                    retry = self.mesh.all_reduce(retry.int(), DATA_AXIS) > 0
                if bool(retry):
                    second = self._retrieve(tpp, torch.full_like(ex, -2),
                                            exclude_mode,
                                            prefer_ivf_gather=True)
                    row = wiped[:, None]
                    neighbors = torch.where(row[..., None], second[0],
                                            neighbors)
                    nlabels = torch.where(row, second[1], nlabels)
                    dists = torch.where(row, second[2], dists)
                    idx = torch.where(row, second[3], idx)
        with annotate("radad.model"):
            logits = self.model(neighbors.nan_to_num(), tpp)
        if self.mesh is None:
            return logits, nlabels, dists, idx
        return tuple(self.mesh.all_gather(t, DATA_AXIS).flatten(0, 1)[:true_b]
                     for t in (logits, nlabels, dists, idx))

    def _data_slice(self, b: int) -> slice:
        """This rank's rows of a batch of ``b`` split over 'data'; a batch
        that does not divide the axis raises, as JAX's ``device_put`` of
        it does."""
        if b % self.mesh.data:
            raise ValueError(f"batch size {b} is not divisible by the mesh "
                             f"'data' axis ({self.mesh.data})")
        step = b // self.mesh.data
        lo = self.mesh.coord(DATA_AXIS) * step
        return slice(lo, lo + step)

    def _pad_serving_batch(self, waves: np.ndarray, exclude: List[int],
                           lengths: Optional[List[int]]):
        """A serving batch padded to a multiple of the 'data' axis with
        zero audio, the -2 no-exclusion sentinel and length 1 (JAX
        ``_pad_serving_batch``, pipeline.py:773-797); the caller slices the
        results back."""
        pad = -len(exclude) % self.mesh.data
        if not pad:
            return waves, exclude, lengths
        waves = np.pad(np.asarray(waves), ((0, pad), (0, 0)))
        lengths = None if lengths is None else list(lengths) + [1] * pad
        return waves, list(exclude) + [-2] * pad, lengths

    def _payload(self, logit: float, idx_row, nlab_row, dist_row) -> Dict:
        prob = float(1.0 / (1.0 + np.exp(-np.float64(logit))))
        retrieved = []
        for j, ii in enumerate(idx_row):
            if ii < 0:
                retrieved.append({"file": "", "path": "", "label": 0.0,
                                  "distance": float("nan")})
            else:
                p = self.index.paths[int(ii)]
                retrieved.append({"file": os.path.basename(p), "path": p,
                                  "label": float(nlab_row[j]),
                                  "distance": float(dist_row[j])})
        return {
            "prediction": "spoof" if prob >= 0.5 else "bona-fide",
            "probability_spoof": prob,
            "probability": prob,
            "logit": float(logit),
            "retrieved_labels": [r["label"] for r in retrieved],
            "retrieved_files": [r["file"] for r in retrieved],
            "retrieved": retrieved,
        }

    def predict(self, audio_path: str,
                max_duration: Optional[float] = None) -> Dict:
        """Single-clip inference (reference pipeline.py:1038-1103) with
        batch-global exclusion of the clip's own file. ``max_duration``
        lifts the 3 s truncation: the clip pads to a multiple of the 3 s
        clip and the TPP mean counts only windows touching real audio."""
        cfg = self.config
        if max_duration is None:
            max_duration = cfg.max_duration
        lengths = None
        if max_duration is None:
            wave = load_audio(audio_path, sample_rate=cfg.sample_rate,
                              duration=cfg.clip_duration)
        else:
            wave = load_audio(audio_path, sample_rate=cfg.sample_rate,
                              duration=max_duration, pad=False)
            bucket = cfg.clip_samples
            true_len = max(len(wave), 1)
            target = grid_cover_samples(
                max(bucket, -(-len(wave) // bucket) * bucket),
                cfg.segment_samples, cfg.hop_samples)
            wave = np.pad(wave, (0, target - len(wave)))
            lengths = [true_len]
        logits, nlabels, dists, idx = self._predict_tensors(
            wave[None], [file_id(audio_path)], lengths, "batch")
        return self._payload(float(logits[0]), idx[0].tolist(),
                             nlabels[0].tolist(), dists[0].tolist())

    def predict_batch(self, audio_paths: List[str]) -> List[Dict]:
        """One device pass for many clips, per-row self exclusion
        (independent requests must not exclude each other's files). Each
        payload carries ``stage_ms``: host decode, device work (from the
        upload through the blocking reads of the results: the search's
        certificate and retry checks and the four copies to the host),
        payload assembly, batch size. The three stages run inside the spans
        ``radad.decode``, ``radad.device`` and ``radad.payload``
        (``utils.profiling.annotate``)."""
        cfg = self.config
        t0 = time.perf_counter()
        lengths = None
        with annotate("radad.decode"):
            if cfg.max_duration is None:
                waves = np.stack([
                    load_audio(p, sample_rate=cfg.sample_rate,
                               duration=cfg.clip_duration)
                    for p in audio_paths])
            else:
                raw = [load_audio(p, sample_rate=cfg.sample_rate,
                                  duration=cfg.max_duration, pad=False)
                       for p in audio_paths]
                waves = np.zeros((len(raw), self._grid_pad()), np.float32)
                for row, w in enumerate(raw):
                    waves[row, :len(w)] = w
                lengths = [max(min(len(w), cfg.analysis_samples), 1)
                           for w in raw]
            exclude = [file_id(p) for p in audio_paths]
        t_decode = time.perf_counter()
        with annotate("radad.device"):
            logits, nlabels, dists, idx = self._predict_tensors(
                waves, exclude, lengths, "self")
            logits_l, idx_l = logits.tolist(), idx.tolist()
            nlab_l, dist_l = nlabels.tolist(), dists.tolist()
        t_device = time.perf_counter()
        with annotate("radad.payload"):
            out = [self._payload(logits_l[r], idx_l[r], nlab_l[r],
                                 dist_l[r])
                   for r in range(len(audio_paths))]
            t_payload = time.perf_counter()
            stage_ms = {"decode": round((t_decode - t0) * 1e3, 2),
                        "device": round((t_device - t_decode) * 1e3, 2),
                        "payload": round((t_payload - t_device) * 1e3, 2),
                        "batch": len(audio_paths)}
            for o in out:
                o["stage_ms"] = dict(stage_ms)
        return out

    # ------------------------------------------------------------------
    def _ensure_model_state(self) -> None:
        """Fresh optimizer state when none was made or loaded."""
        if self.opt.state is None:
            self.opt.init(dict(self.model.named_parameters()))

    def _build_steps(self, ablate_query: Optional[bool] = None) -> None:
        """Train/eval steps over the pipeline's retrieval with one
        exclusion set per batch. ``ablate_query`` overrides
        ``config.ablate_query`` (the freeze_query_epochs curriculum
        rebuilds the steps at the stage boundary)."""
        cfg = self.config
        self._steps_fns = make_step_fns(
            self.model, self.opt,
            lambda tpp, exclude: self._retrieve(tpp, exclude, "batch"),
            # gradient histograms only when wandb is live
            watch_grads=self.wandb.active,
            grad_checkpoint=cfg.use_gradient_checkpointing,
            ablate_retrieval=cfg.ablate_retrieval,
            ablate_query=(cfg.ablate_query if ablate_query is None
                          else ablate_query), mesh=self.mesh)

    def _steps(self) -> StepFns:
        if self._steps_fns is None:
            self._ensure_model_state()
            self._build_steps()
        return self._steps_fns

    def train(self, train_manifest: Manifest,
              val_manifest: Optional[Manifest] = None) -> Dict:
        """``config.num_epochs`` epochs of shuffled train steps, each
        followed by validation when ``val_manifest`` is given: metrics.csv,
        ROC/DET points, summary.json, ``best_model`` on each new best EER,
        early stopping, ``final_model`` at the end (reference
        pipeline.py:760-947). Returns the last metrics row."""
        cfg = self.config
        if val_manifest is not None and cfg.prevent_data_leakage:
            validate_no_leakage(train_manifest, val_manifest)
        if self.index.ntotal == 0:
            self.build_vector_database(train_manifest)
        self._ensure_model_state()
        if cfg.freeze_query_epochs > 0:
            # curriculum stage 1: neighbors only (query path zeroed)
            self._build_steps(ablate_query=True)
        steps = self._steps()

        pos_weight = train_manifest.pos_weight()
        logger.info("Using pos_weight=%.3f for BCE", pos_weight)
        self.wandb.log({"config/pos_weight": pos_weight})
        # early stopping after `patience` validated epochs without a new
        # best EER (config.early_stopping_patience)
        epochs_since_best = 0

        for epoch in range(cfg.num_epochs):
            if (cfg.freeze_query_epochs > 0
                    and epoch == cfg.freeze_query_epochs):
                logger.info("Curriculum: unfreezing the query path at "
                            "epoch %d (joint training)", epoch + 1)
                self._build_steps()
                steps = self._steps_fns
                epochs_since_best = 0
                # stage-1 bests were measured with the query zeroed and
                # are not comparable to joint EERs
                self.writer.best_by_eer = {"epoch": None,
                                           "eer_percent": float("inf")}
                self.writer.best_by_val_loss = {"epoch": None,
                                                "val_loss": float("inf")}
            t_epoch = time.time()
            acc = new_accumulators(self.device)
            for tpp, labels, ids, valid in self._query_batches(
                    train_manifest, cfg.batch_size, shuffle=True,
                    seed=cfg.random_seed + epoch):
                bm = steps.train_step(acc, tpp, labels, ids, valid,
                                      pos_weight, self.generator)
                self.step += 1
                if self.wandb.active:
                    self._log_batch(bm, epoch)
            # one device-to-host read of the epoch's sums
            accs = dict(zip(ACC_KEYS, torch.stack(
                [acc[k] for k in ACC_KEYS]).tolist()))
            count = max(accs["count"], 1.0)
            batches = max(accs["batches"], 1.0)
            train_loss = accs["loss_sum"] / count
            train_acc = accs["correct"] / count

            # metrics.csv row with the reference's column set
            # (pipeline.py:916-941)
            row = {
                "epoch": epoch + 1,
                "train_loss": train_loss, "train_acc": train_acc,
                "val_loss": None, "val_acc": None, "auc": None,
                "eer_percent": None, "pooled_eer_percent": None,
                "macro_eer_percent": None,
                "eer_threshold": None, "min_tDCF": None,
                "min_tDCF_threshold": None,
                "avg_nnz_neighbor_rate": accs["nnz_sum"] / batches,
                "avg_grad_norm_projection": accs["gn_proj_sum"] / batches,
                "avg_grad_norm_fuse": accs["gn_fuse_sum"] / batches,
                "avg_grad_norm_detection": accs["gn_det_sum"] / batches,
                "lr_projection": cfg.learning_rate,
                "lr_fuse": cfg.learning_rate,
                "lr_detection": cfg.learning_rate,
                "pos_weight": pos_weight,
                "epoch_time_sec": None,
                "top_k": cfg.top_k, "batch_size": cfg.batch_size,
            }

            if val_manifest is not None:
                val_loss, val_acc, scores, labels, speakers = \
                    self.evaluate_with_scores(val_manifest)
                eer, eer_thr = M.compute_eer(scores, labels)
                macro = M.compute_macro_eer(scores, labels, speakers)
                tdcf, tdcf_thr = M.compute_min_tdcf(
                    scores, labels, cfg.asv_params_dict())
                auc_val = self.writer.save_roc_det(scores, labels,
                                                   epoch=epoch + 1)
                is_best = self.writer.track_best(epoch + 1, val_loss, eer)
                if is_best:
                    self.save_models("best_model")
                row.update(val_loss=val_loss, val_acc=val_acc, auc=auc_val,
                           eer_percent=eer, pooled_eer_percent=eer,
                           macro_eer_percent=macro,
                           eer_threshold=eer_thr,
                           min_tDCF=tdcf if np.isfinite(tdcf) else None,
                           min_tDCF_threshold=(tdcf_thr if np.isfinite(tdcf)
                                               else None))
                self._print(f"Epoch {epoch + 1}: Train Loss: {train_loss:.4f}, "
                      f"Train Acc: {train_acc:.4f}, Val Loss: {val_loss:.4f}, "
                      f"Val Acc: {val_acc:.4f} | AUC: {auc_val:.4f}, "
                      f"EER: {eer:.2f}% (thr={eer_thr:.4f}), "
                      f"Macro EER: {macro:.2f}%")
            else:
                self._print(f"Epoch {epoch + 1}: Train {train_loss:.4f}"
                      f"/{train_acc:.4f}")

            row["epoch_time_sec"] = time.time() - t_epoch
            self.writer.add_row(row)
            self.writer.plot_training_curves()
            self.wandb.log({f"epoch/{k}": v for k, v in row.items()
                            if v is not None})
            if val_manifest is not None and cfg.early_stopping_patience > 0:
                epochs_since_best = 0 if is_best else epochs_since_best + 1
                if epoch + 1 <= cfg.freeze_query_epochs:
                    # never early-stop inside curriculum stage 1
                    epochs_since_best = 0
                if epochs_since_best >= cfg.early_stopping_patience:
                    logger.info(
                        "Early stopping at epoch %d: no EER improvement "
                        "for %d epochs", epoch + 1,
                        cfg.early_stopping_patience)
                    break

        self.save_models("final_model")
        self.writer.save_summary()
        # wandb artifacts (reference pipeline.py:884-896)
        root = cfg.data_root
        self.wandb.log_artifact(checkpoint_path(root, "final_model"),
                                "final_model", "model")
        self.wandb.log_artifact(os.path.join(root, "training_curves.png"),
                                "training_curves", "plot")
        self.wandb.log_artifact(os.path.join(root, "metrics.csv"),
                                "metrics", "metrics")
        self.wandb.finish()
        return self.writer.rows[-1] if self.writer.rows else {}

    def _log_batch(self, bm: Dict[str, torch.Tensor], epoch: int) -> None:
        """Per-batch wandb row (reference pipeline.py:845-855); the only
        per-step host reads, made only while wandb is active."""
        log = {"batch/train_loss": float(bm["loss"]),
               "batch/train_acc": float(bm["acc"]),
               "batch/grad_norm_projection": float(bm["gn_proj"]),
               "batch/grad_norm_fuse": float(bm["gn_fuse"]),
               "batch/grad_norm_detection": float(bm["gn_det"]),
               "batch/step": self.step, "batch/epoch": epoch + 1}
        if self.step % 100 == 0:  # wandb.watch log_freq
            for sub in ("proj", "fuse", "det"):
                h = self.wandb.histogram(
                    bm[f"hist_counts_{sub}"].cpu().numpy(),
                    bm[f"hist_edges_{sub}"].cpu().numpy())
                if h is not None:
                    log[f"gradients/{sub}"] = h
        self.wandb.log(log)

    def evaluate_with_scores(self, manifest: Manifest
                             ) -> Tuple[float, float, np.ndarray, np.ndarray,
                                        List[str]]:
        """→ (val_loss, val_acc, spoof-logit scores, labels, speakers)
        over the valid rows (reference pipeline.py:691-756)."""
        cfg = self.config
        steps = self._steps()
        pos_weight = manifest.pos_weight()
        logit_chunks, label_chunks, valid_chunks = [], [], []
        for tpp, blabels, bids, bvalid in self._query_batches(
                manifest, cfg.eval_batch_size, shuffle=False):
            logits, _ = steps.eval_step(tpp, bids)
            logit_chunks.append(logits)
            label_chunks.append(blabels)
            valid_chunks.append(bvalid)
        # [batches, rows]; on a mesh [batches, ranks of 'data', rows] once
        # gathered: every rank scores the whole manifest, in its order
        out = [torch.stack(c) for c in (valid_chunks, logit_chunks,
                                        label_chunks)]
        if self.mesh is not None:
            out = [self.mesh.all_gather(t, DATA_AXIS).transpose(0, 1)
                   for t in out]
        valid, logits, labels = (t.reshape(-1).cpu().numpy() for t in out)
        logits, labels = logits[valid], labels[valid]
        val_loss = float(pos_weighted_bce(torch.as_tensor(logits),
                                          torch.as_tensor(labels),
                                          pos_weight))
        val_acc = float(np.mean((logits > 0) == (labels > 0.5)))
        return (val_loss, val_acc, logits.astype(np.float64),
                labels.astype(np.int32), list(manifest.speakers))

    def evaluate(self, manifest: Manifest) -> Dict:
        """Full evaluation with metrics and artifacts (reference
        pipeline.py:964-1036)."""
        val_loss, val_acc, scores, labels, speakers = \
            self.evaluate_with_scores(manifest)
        eer, eer_thr = M.compute_eer(scores, labels)
        macro = M.compute_macro_eer(scores, labels, speakers)
        tdcf, tdcf_thr = M.compute_min_tdcf(scores, labels,
                                            self.config.asv_params_dict())
        auc_val = self.writer.save_roc_det(scores, labels, tag="eval")
        results = {
            "loss": val_loss, "accuracy": val_acc, "auc": auc_val,
            "eer_percent": eer, "eer_threshold": eer_thr,
            "macro_eer_percent": macro,
            "min_tDCF": tdcf, "min_tDCF_threshold": tdcf_thr,
            "num_samples": int(len(labels)),
        }
        # the reference's eval-row column set (pipeline.py:1008-1034):
        # train-only columns present but None, the eval batch size
        self.writer.add_row({
            "epoch": "eval", "train_loss": None, "train_acc": None,
            "val_loss": val_loss, "val_acc": val_acc,
            "auc": auc_val if np.isfinite(auc_val) else None,
            "eer_percent": eer if np.isfinite(eer) else None,
            "pooled_eer_percent": eer if np.isfinite(eer) else None,
            "macro_eer_percent": macro if np.isfinite(macro) else None,
            "eer_threshold": eer_thr if np.isfinite(eer) else None,
            "min_tDCF": tdcf if np.isfinite(tdcf) else None,
            "min_tDCF_threshold": tdcf_thr if np.isfinite(tdcf) else None,
            "avg_nnz_neighbor_rate": None,
            "avg_grad_norm_projection": None, "avg_grad_norm_fuse": None,
            "avg_grad_norm_detection": None, "lr_projection": None,
            "lr_fuse": None, "lr_detection": None, "pos_weight": None,
            "epoch_time_sec": None, "top_k": int(self.config.top_k),
            "batch_size": int(self.config.eval_batch_size),
        })
        self.wandb.log({
            "eval/loss": val_loss, "eval/acc": val_acc,
            "eval/auc": auc_val, "eval/eer_percent": eer,
            "eval/macro_eer_percent": macro, "eval/eer_threshold": eer_thr,
            "eval/min_tDCF": tdcf if np.isfinite(tdcf) else None,
            "eval/min_tDCF_threshold":
                tdcf_thr if np.isfinite(tdcf) else None,
        })
        logger.info("Evaluation: %s", results)
        return results

    # ------------------------------------------------------------------
    def save_models(self, prefix: str) -> str:
        """Model, optimizer state, step and config to
        ``<data_root>/models/<prefix>_radad.pt``. Returns the path."""
        self._ensure_model_state()
        path = checkpoint_path(self.config.data_root, prefix)
        if self.lead:  # on a mesh rank 0 writes, then a barrier
            save_checkpoint(self.config.data_root, prefix, {
                "model": self.model.state_dict(),
                "optimizer": self.opt.state_dict(),
                "step": self.step,
                "config_json": self.config.to_json()})
        if self.mesh is not None:
            self.mesh.barrier()
        return path

    def load_models(self, prefix: str) -> bool:
        """Load a checkpoint of :meth:`save_models`. One without optimizer
        state (written before the port saved it) loads for serving, and the
        optimizer starts fresh."""
        state = load_checkpoint(self.config.data_root, prefix)
        path = checkpoint_path(self.config.data_root, prefix)
        if state is None:
            logger.warning("checkpoint %s not found", path)
            return False
        self.model.load_state_dict(state["model"])
        if state["optimizer"] is None:
            logger.warning("checkpoint %s holds no optimizer state; the "
                           "optimizer starts fresh", path)
            self.opt.state = None
        else:
            self.opt.load_state_dict(state["optimizer"], device=self.device)
        self.step = int(state["step"])
        return True

    def load_vector_database(self) -> bool:
        path = self.config.vector_db_path
        meta_path = os.path.join(path, self._meta_name)
        if not os.path.exists(meta_path):
            logger.warning("no saved vector DB at %s", path)
            return False
        with open(meta_path) as f:
            saved_dim = json.load(f).get("dimension")
        if saved_dim is not None and saved_dim != self.tpp_dim:
            raise ValueError(
                f"saved vector DB at {path} has dimension {saved_dim}, but "
                f"the configured encoder produces {self.tpp_dim}-d "
                f"embeddings; rebuild the DB or use the encoder it was "
                f"built with")
        accel = self.mesh is None  # as _make_index
        if self.is_quantized:
            self.index = QuantizedIndex.load(path, build_accel=accel,
                                             device=self.device)
            if self.mesh is not None and self.index.refine_bits:
                # the mesh's SQ8 search reads no int4 level: refined norms
                # beside int8-only dots would bias every distance
                raise ValueError(
                    "loaded SQ8 index has refine_bits=%d but refinement "
                    "is a single-chip capacity-mode feature — rebuild "
                    "without refinement for mesh serving"
                    % self.index.refine_bits)
            # a serving knob, not stored with the index
            self.index.rerank_depth = self.config.sq8_rerank_depth
        else:
            self.index = FlatIndex.load(path, use_pallas=self.use_pallas,
                                        build_accel=accel,
                                        device=self.device)
        self._place_index_on_mesh()
        return True

    def _print(self, text: str) -> None:
        """``print`` on rank 0 of a mesh (and without a mesh)."""
        if self.lead:
            print(text)


def print_dataset_statistics(manifests: Dict[str, Manifest]) -> None:
    """Split-stats printer (reference pipeline.py:1136-1158)."""
    for name, m in manifests.items():
        counts = m.class_counts()
        total = len(m)
        bona_pct = 100.0 * counts["bonafide"] / max(total, 1)
        print(f"{name.upper()} set — total {total}, spoof(1) "
              f"{counts['spoof']}, bona-fide(0) {counts['bonafide']} "
              f"({bona_pct:.2f}% bona-fide), speakers "
              f"{len(set(m.speakers))}")
