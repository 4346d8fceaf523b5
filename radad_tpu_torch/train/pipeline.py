"""DetectionPipeline, serving subset: DB build, predict, predict_batch.

Counterpart: ``radad_tpu/train/pipeline.py`` (``make_embed_fn``,
``grid_cover_samples``, ``retrieve_on_device``, ``DetectionPipeline``'s
``build_vector_database``, ``load_vector_database``, ``predict``,
``predict_batch``, ``save_models``, ``load_models``). Training, evaluation
and meshes come in later slices.

A predict call runs embed (segment → encoder → TPP → mean over windows)
→ flat search → neighbor gather (``ops.gather.gather_rows``) → fusion
model. The search is the certified route, or with
``DetectionPipeline(use_pallas=True)`` the ``flat_topk`` scan + exact
re-rank; the JAX package's ``retrieve_on_device`` pins ``use_pallas=False``,
so there only ``FlatIndex.search`` reaches its kernel. JAX compiles that into one program with ``lax.cond`` for the
retry of rows whose neighbors were all excluded; here it runs eagerly and
the retry is a host branch on one bool.

Checkpoints are the port's own format, ``<data_root>/models/
<prefix>_radad.pt`` (a state dict, the step and the config JSON): the JAX
format pickles a jax treedef. ``models/convert.py`` loads JAX weights.
"""

from __future__ import annotations

import json
import logging
import os
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from radad_tpu_torch.config import Config
from radad_tpu_torch.data.audio import load_audio
from radad_tpu_torch.data.loader import iterate_batches
from radad_tpu_torch.data.manifest import Manifest, file_id
from radad_tpu_torch.index.flat import FlatIndex, _search_device
from radad_tpu_torch.models.encoder import FrozenEncoder, build_encoder
from radad_tpu_torch.models.fusion import build_radad_model
from radad_tpu_torch.ops.gather import gather_rows
from radad_tpu_torch.ops.segmenter import segment_audio
from radad_tpu_torch.ops.tpp import temporal_pyramid_pool, tpp_output_dim
from radad_tpu_torch.utils.device import resolve_device

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


class DetectionPipeline:
    """Encoder → TPP → index → fusion model, for serving."""

    def __init__(self, config: Config, *,
                 encoder: Optional[FrozenEncoder] = None,
                 use_pallas: bool = False, device="cuda"):
        """``use_pallas``: search with the ``flat_topk`` kernel + exact
        re-rank instead of the certified route (``FlatIndex``)."""
        self.device = resolve_device(device)
        metric = config.vector_db_index_type.upper()
        if metric in ("SQ8", "IVF"):
            raise NotImplementedError(f"{metric} index: not yet ported")
        self.config = config
        self.use_pallas = use_pallas
        self.encoder = (encoder if encoder is not None
                        else build_encoder(config, device=self.device))
        self.tpp_dim = tpp_output_dim(config.tpp_levels,
                                      self.encoder.feature_dim)
        self.model = build_radad_model(config, self.tpp_dim).to(self.device)
        self.index = self._make_index()
        self.step = 0
        self._embed = make_embed_fn(self.encoder, config)

    def _make_index(self) -> FlatIndex:
        cfg = self.config
        return FlatIndex(self.tpp_dim, cfg.vector_db_index_type,
                         use_float16=cfg.use_float16,
                         add_batch_size=cfg.vector_add_batch_size,
                         use_pallas=self.use_pallas, device=self.device)

    def _grid_pad(self) -> Optional[int]:
        cfg = self.config
        if cfg.max_duration is None:
            return None
        return grid_cover_samples(cfg.analysis_samples, cfg.segment_samples,
                                  cfg.hop_samples)

    # ------------------------------------------------------------------
    def get_embeddings(self, manifest: Manifest) -> torch.Tensor:
        """TPP embeddings ``[N, D]`` (on the pipeline's device) for every
        clip of a manifest, in manifest order."""
        cfg = self.config
        chunks = []
        for batch in iterate_batches(
                manifest, cfg.db_batch_size, sample_rate=cfg.sample_rate,
                duration=cfg.analysis_duration, shuffle=False,
                prefetch=cfg.host_prefetch, pad_to=self._grid_pad()):
            audio = torch.as_tensor(batch.audio, device=self.device)
            lengths = (torch.as_tensor(batch.lengths, device=self.device)
                       if cfg.max_duration else None)
            chunks.append(self._embed(audio, lengths)[: batch.num_valid])
        if not chunks:
            return torch.zeros((0, self.tpp_dim), device=self.device)
        return torch.cat(chunks)

    def build_vector_database(self, train_manifest: Manifest,
                              save: bool = True) -> None:
        """Embed the training set and install it as the reference DB
        (reference pipeline.py:416-447)."""
        t0 = time.time()
        vectors = self.get_embeddings(train_manifest)
        speakers = [{"speaker_id": s} for s in train_manifest.speakers]
        self.index.add(vectors, train_manifest.labels.tolist(),
                       list(train_manifest.paths), metadata=speakers,
                       ids=train_manifest.ids.tolist())
        if save:
            self.index.save(self.config.vector_db_path)
        logger.info("Vector DB built: %d vectors in %.1fs",
                    self.index.ntotal, time.time() - t0)

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
                self.config.vector_db_path, "index_meta.json")):
            self.load_vector_database()
        existing = {os.path.basename(p) for p in self.index.paths}
        new_idx = [i for i, b in enumerate(manifest.basenames)
                   if b not in existing]
        if not new_idx:
            return 0
        sub = manifest.subset(new_idx)
        self.index.add(self.get_embeddings(sub), sub.labels.tolist(),
                       list(sub.paths),
                       metadata=[{"speaker_id": s} for s in sub.speakers],
                       ids=sub.ids.tolist())
        if save:
            self.index.save(self.config.vector_db_path)
        return len(sub)

    # ------------------------------------------------------------------
    def _retrieve(self, tpp, exclude, exclude_mode):
        ix = self.index
        out = retrieve_on_device(
            tpp, ix.vectors, ix.labels, ix.ids, exclude, k=self.config.top_k,
            metric=ix.metric, n_valid=ix.ntotal, xsq=ix.norms_sq,
            scan_bf16=ix.scan_bf16, resid_bf16=ix.resid_bf16,
            exclude_mode=exclude_mode, use_pallas=ix.use_pallas)
        ix.count_search(out[4])
        return out[:4]

    @torch.inference_mode()
    def _predict_tensors(self, waves: np.ndarray, exclude: List[int],
                         lengths: Optional[List[int]], exclude_mode: str):
        """Embed → retrieve (with the per-row unexcluded retry) → model.
        → (logits, nlabels, dists, idx) tensors on the device."""
        dev, k = self.device, self.config.top_k
        audio = torch.as_tensor(waves, device=dev)
        lens = (None if lengths is None
                else torch.as_tensor(lengths, device=dev))
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
            neighbors, nlabels, dists, idx = self._retrieve(tpp, ex,
                                                            exclude_mode)
            # rows whose neighbors were all excluded retry without
            # exclusion, each on its own (reference pipeline.py:1051-1054)
            wiped = ~(idx >= 0).any(-1)  # [B]
            if bool(wiped.any()):
                second = self._retrieve(tpp, torch.full_like(ex, -2),
                                        exclude_mode)
                row = wiped[:, None]
                neighbors = torch.where(row[..., None], second[0], neighbors)
                nlabels = torch.where(row, second[1], nlabels)
                dists = torch.where(row, second[2], dists)
                idx = torch.where(row, second[3], idx)
        logits = self.model(neighbors.nan_to_num(), tpp)
        return logits, nlabels, dists, idx

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
        payload carries ``stage_ms``: host decode, device work including
        the result copy, payload assembly, batch size."""
        cfg = self.config
        t0 = time.perf_counter()
        lengths = None
        if cfg.max_duration is None:
            waves = np.stack([
                load_audio(p, sample_rate=cfg.sample_rate,
                           duration=cfg.clip_duration) for p in audio_paths])
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
        logits, nlabels, dists, idx = self._predict_tensors(
            waves, exclude, lengths, "self")
        logits_l, idx_l = logits.tolist(), idx.tolist()
        nlab_l, dist_l = nlabels.tolist(), dists.tolist()
        t_device = time.perf_counter()
        out = [self._payload(logits_l[r], idx_l[r], nlab_l[r], dist_l[r])
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
    def _ckpt_path(self, prefix: str) -> str:
        return os.path.join(self.config.data_root, "models",
                            f"{prefix}_radad.pt")

    def save_models(self, prefix: str) -> str:
        path = self._ckpt_path(prefix)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        state = {k: v.cpu() for k, v in self.model.state_dict().items()}
        torch.save({"model": state, "step": self.step,
                    "config_json": self.config.to_json()}, path)
        return path

    def load_models(self, prefix: str) -> bool:
        path = self._ckpt_path(prefix)
        if not os.path.exists(path):
            logger.warning("checkpoint %s not found", path)
            return False
        state = torch.load(path, map_location="cpu", weights_only=True)
        self.model.load_state_dict(state["model"])
        self.step = int(state["step"])
        return True

    def load_vector_database(self) -> bool:
        path = self.config.vector_db_path
        meta_path = os.path.join(path, "index_meta.json")
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
        self.index = FlatIndex.load(path, use_pallas=self.index.use_pallas,
                                    device=self.device)
        return True
