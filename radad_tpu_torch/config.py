"""Typed, frozen configuration: a copy of ``radad_tpu/config.py``.

Counterpart: ``radad_tpu/config.py``. The port keeps its own copy (it
imports nothing of ``radad_tpu``) with the same field names and defaults,
so a config written by either package loads in the other. Fields for
parts not ported yet (IVF, SQ8, Whisper, WavLM, meshes, training) are kept
for that reason; the code that reads them raises "not yet ported".
Placement is not a config field: the port's entry points take a
``device`` argument.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Mapping, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class Config:
    # --- Data paths (reference config.py:23-26) ---
    data_root: str = "data"
    train_data_path: str = "data/audio"
    test_data_path: str = "data/audio"
    vector_db_path: str = "data/vector_db"

    # --- Data loading and splitting (reference config.py:29-34) ---
    data_fraction: float = 1.0
    train_split: float = 0.8
    random_seed: int = 42
    prevent_data_leakage: bool = True

    # --- Audio processing (reference config.py:37-39) ---
    sample_rate: int = 16000
    clip_duration: float = 3.0  # hard truncation used by the loader (dataset.py:143)
    segment_length: float = 2.0
    segment_overlap: float = 0.5
    # Long-audio mode (no reference counterpart — the reference hard-
    # truncates every clip to clip_duration, dataset.py:143-148, losing
    # everything past 3 s). When set, DB build / training / evaluation
    # analyze each clip up to max_duration seconds: batches pad to a fixed
    # window-grid length (static shapes, one compile) and each clip's TPP
    # embedding is the mean over only its VALID windows — the
    # ceil(true_length / hop) windows that contain real audio, the last
    # zero-padded past the clip end exactly like the reference's tail
    # windows (segmenter.py:33-38) — so pure-padding windows never dilute
    # the embedding and the count is invariant to the padded batch length.
    # Also tightens sub-clip_duration clips: a 1 s clip contributes 1
    # window instead of the reference's 2 (the second being pure padding).
    # None = reference parity.
    max_duration: Optional[float] = None

    # --- Encoders (reference config.py:42-45) ---
    # {"wav2vec2", "whisper", "wavlm"} (reference factory, pipeline.py:54-65)
    # + "hubert" (TPU-build extension: identical architecture family to
    # wav2vec2 — HF HubertModel state dicts are key-identical — so it runs
    # on the same JAX module with its own checkpoint, torch-parity tested).
    feature_extractor_type: str = "wav2vec2"
    wav2vec2_model_name: str = "facebook/wav2vec2-base-960h"
    whisper_model_name: str = "openai/whisper-base"
    wavlm_model_name: str = "microsoft/wavlm-base"
    hubert_model_name: str = "facebook/hubert-base-ls960"
    wav2vec2_layers_to_use: Tuple[int, ...] = (-4, -3, -2, -1)
    # Whisper pads every segment to 30 s before the mel transform (HF
    # WhisperFeatureExtractor behavior the reference inherits,
    # feature_extractor.py:94-99) — ~15x wasted encoder FLOPs on 2 s
    # windows. None = run only the real frames (TPU-fast mode, different
    # embeddings; opt-in).
    whisper_pad_seconds: Optional[float] = 30.0
    # Per-segment zero-mean/unit-variance input normalization for the
    # waveform encoders (wav2vec2/wavlm/hubert). The reference inherits
    # this from each HF checkpoint's processor (``do_normalize`` in
    # preprocessor_config.json, applied by Wav2Vec2Processor /
    # AutoFeatureExtractor — feature_extractor.py:14,27-30,152-154):
    # False for wav2vec2-base-960h / wavlm-base, True for the lv60/xlsr/
    # large families. None = auto: read do_normalize from the
    # preprocessor_config.json beside the local checkpoint when loading
    # pretrained weights, else False. Whisper is mel-based and unaffected.
    input_normalize: Optional[bool] = None

    # --- Temporal Pyramid Pooling (reference config.py:48-49) ---
    tpp_levels: Tuple[int, ...] = (1, 2, 4)
    tpp_pooling_type: str = "max"  # {"max", "avg"}

    # --- Vector database (reference config.py:52-56, :73-76) ---
    vector_db_index_type: str = "L2"  # {"L2", "IP", "COSINE", "IVF"}
    vector_db_nprobe: int = 32  # later-wins value of the duplicate assignment
    vector_db_nlist: int = 4096
    # Lloyd iterations for IVF centroid training (FAISS
    # ClusteringParameters.niter default = 25, which the reference's
    # IndexIVFFlat.train inherits, vector_database.py:122-130).
    vector_db_kmeans_iters: int = 25
    # Split-refinement strength for IVF centroid training (0.0 = plain
    # Lloyd = FAISS parity; ~1.0 balances cell sizes, which the
    # gather-probed serving path's latency scales with — see
    # index.ivf.kmeans and docs/PERFORMANCE.md).
    vector_db_ivf_balance: float = 0.0
    # True (default): every index add() retrains the IVF coarse quantizer
    # on the merged set. False: FAISS parity — train once, later adds only
    # assign new rows to the existing cells (O(new); the right setting for
    # incremental serving ingestion via --mode build_db at capacity scale).
    vector_db_ivf_retrain_on_add: bool = True
    vector_add_batch_size: int = 10000
    # SQ8 residual encoding (index_type="SQ8"): int8 codes of x − c_cell
    # against a coarse k-means codebook of this size (0 = plain per-row
    # SQ8, the FAISS flat-SQ8 analogue). On clustered embeddings the
    # residual range is the within-cluster spread, so recall vs the f32
    # oracle recovers at unchanged scan cost — index/quantized.py.
    sq8_residual_nlist: int = 0
    # int4 refinement level for SQ8 (0 = off, 4 = store a packed second
    # residual level at +0.5 B/dim → ~12-bit reconstruction fidelity,
    # used by the rerank/neighbor fetch in index.search()/predict; the
    # int8 scan is unchanged). Single-chip capacity-mode feature (the
    # mesh SQ8 path consumes the canonical int8 arrays only).
    sq8_refine_bits: int = 0
    # Fallback-rerank candidate depth for SQ8 (None = max(4k, 32)).
    # Deeper candidates matter at capacity scale where int8 scan noise
    # can push a true neighbor past rank 32.
    sq8_rerank_depth: Optional[int] = None
    top_k: int = 5

    # --- Projection layer (reference config.py:59-60, :80) ---
    projection_hidden_dim: int = 256
    projection_output_dim: int = 128
    projection_dropout: float = 0.1

    # --- Detection model (reference config.py:63, :82-86) ---
    detection_hidden_dims: Tuple[int, ...] = (64, 32)
    detection_dropout: float = 0.1  # later-wins value of the duplicate assignment
    use_batch_norm: bool = True
    use_layer_norm: bool = False

    # --- Training (reference config.py:67-71) ---
    batch_size: int = 128
    eval_batch_size: int = 256
    db_batch_size: int = 64
    learning_rate: float = 1e-3
    weight_decay: float = 1e-5
    num_epochs: int = 5
    early_stopping_patience: int = 5

    # --- Misc flags carried over (reference config.py:73-92) ---
    use_mixed_precision: bool = False
    # Wired: rematerializes the fusion-model forward in backward
    # (jax.checkpoint in train.pipeline._build_steps), the XLA analogue of
    # the reference's per-block torch checkpointing (projection.py:114-117,
    # detection_model.py:79-91).
    use_gradient_checkpointing: bool = False
    # NO-OPS BY DESIGN on TPU, kept for config-surface parity: the
    # reference flags switch fused-vs-Sequential module construction with
    # identical math (projection.py:29-53, detection_model.py:79-91); under
    # XLA every step is jit-compiled and operator fusion is automatic, so
    # there is nothing to toggle. Accepted and ignored.
    fuse_attention_ops: bool = True
    fuse_activations: bool = True
    # NO-OP BY DESIGN: torch.compile parity flag (detection_model.py:37-39).
    # JAX traces and compiles every step unconditionally — compilation
    # cannot be turned off, so the flag is accepted and ignored.
    compile_model: bool = False
    use_float16: bool = False
    usewandb: bool = False

    # --- TPU-native knobs (no reference counterpart) ---
    # The encoder is frozen, so every clip's TPP embedding is a constant of
    # the run; the reference still recomputes the full encoder forward every
    # epoch for every batch (pipeline.py:794-796 — its dominant cost,
    # SURVEY.md §3 hot loops). With this flag the pipeline embeds each
    # manifest once, reuses the train-set embeddings as both the vector DB
    # and the training queries, and caches eval-set embeddings across
    # epochs. Numerically identical (same floats), orders of magnitude
    # faster per epoch. Set False to force reference-style recompute.
    cache_embeddings: bool = True
    # ABLATION switch (no reference counterpart): zero the retrieved
    # neighbor vectors/labels in train and eval steps. Used to measure how
    # much the retrieval-augmentation path contributes to detection
    # quality (a nonzero EER delta vs the default proves the retrieval
    # machinery is load-bearing, not a pass-through).
    ablate_retrieval: bool = False
    # DIAGNOSTIC switch (no reference counterpart, dual of
    # ablate_retrieval): the fusion model sees a ZEROED query TPP vector
    # while retrieval still runs on the real one — a neighbors-only
    # classifier. If it reaches the query+neighbor linear probe's EER,
    # the fusion architecture can extract the neighbor signal (a joint
    # null is an optimization failure); if it plateaus, the projection
    # layer itself cannot (architecture capacity limit).
    ablate_query: bool = False
    # CURRICULUM (no reference counterpart): train the first N epochs
    # with the query path zeroed (ablate_query semantics) so the
    # neighbor-path gradient isn't drowned by the stronger query
    # gradient early, then switch to joint training. 0 = off.
    freeze_query_epochs: int = 0
    # Shard DB-build embed batches over the mesh 'data' axis so the
    # dominant multi-chip phase scales. None = auto: on for meshes of real
    # accelerators, off for cpu-platform (virtual test) meshes where the
    # SPMD encoder compile costs minutes and the single physical CPU gains
    # nothing. True/False force either way (tests force True to pin
    # sharded-embed parity).
    shard_db_build: Optional[bool] = None
    compute_dtype: str = "bfloat16"  # encoder/matmul compute dtype on TPU
    param_dtype: str = "float32"
    index_shards: int = 1  # mesh size along the 'index' axis for the sharded DB
    data_shards: int = 1  # mesh size along the 'data' (batch) axis
    host_prefetch: int = 2  # host->device prefetch depth in the data loader

    # --- min t-DCF ASV operating point (reference config.py:94-106, optional) ---
    asv_params: Optional[Tuple[Tuple[str, float], ...]] = None

    # ------------------------------------------------------------------
    def replace(self, **kwargs: Any) -> "Config":
        """Return a new Config with the given fields replaced.

        Like the reference's ``Config.update`` (config.py:109-115), raises on
        unknown keys — but returns a new frozen instance instead of mutating.
        """
        names = {f.name for f in dataclasses.fields(self)}
        for key in kwargs:
            if key not in names:
                raise ValueError(f"Invalid configuration parameter: {key}")
        return dataclasses.replace(self, **kwargs)

    # Convenience derived values ---------------------------------------
    @property
    def clip_samples(self) -> int:
        return int(self.clip_duration * self.sample_rate)

    @property
    def segment_samples(self) -> int:
        return int(self.segment_length * self.sample_rate)

    @property
    def hop_samples(self) -> int:
        return int(self.segment_samples * (1 - self.segment_overlap))

    @property
    def analysis_duration(self) -> float:
        """Seconds of audio actually analyzed per clip (max_duration when
        the long-audio mode is on, clip_duration otherwise)."""
        return self.max_duration if self.max_duration else self.clip_duration

    @property
    def analysis_samples(self) -> int:
        return int(self.analysis_duration * self.sample_rate)

    @property
    def num_segments(self) -> int:
        """Segments per clip under the fixed 3 s truncation (always 2 by default)."""
        n = self.clip_samples
        return max(1, (n - self.segment_samples) // self.hop_samples + 1)

    def asv_params_dict(self) -> Optional[Mapping[str, float]]:
        if self.asv_params is None:
            return None
        return dict(self.asv_params)

    # Serialization ----------------------------------------------------
    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2, sort_keys=True)

    @classmethod
    def from_json(cls, text: str) -> "Config":
        raw = json.loads(text)
        # JSON round-trips tuples as lists; coerce back for hashability.
        for key in ("wav2vec2_layers_to_use", "tpp_levels", "detection_hidden_dims"):
            if key in raw and isinstance(raw[key], list):
                raw[key] = tuple(raw[key])
        if raw.get("asv_params") is not None:
            raw["asv_params"] = tuple((str(k), float(v)) for k, v in raw["asv_params"])
        return cls().replace(**raw)
