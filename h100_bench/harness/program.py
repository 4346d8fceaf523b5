"""The system under test: ``radad_tpu_torch``'s pipeline, built from a
configuration file and the harness's weights, and the harness's spans
around the calls into its layers.

This is the only harness module that imports the program.
"""

from __future__ import annotations

import contextlib
import importlib
import os
import time
from typing import Dict, List, Optional

import torch

from harness import common


def _tuples(fields: dict) -> dict:
    """A configuration's fields with each list as a tuple, as the program's
    configs hold them."""
    return {k: (tuple(v) if isinstance(v, list) else v)
            for k, v in fields.items()}


def port_encoder(config: dict):
    """The port's (architecture config class, model class) of the
    configuration's encoder, as its encoder file's ``PORT`` names them:
    ``(module of radad_tpu_torch.models, config class, model class)``.
    Raises ``FileNotFoundError`` where there is no encoder file, and
    ``ValueError``, naming the encoder file, where ``PORT`` is missing or
    malformed, the module or either class is missing, or the model class
    is not an ``nn.Module``."""
    enc = common.encoder(config)
    port = getattr(enc, "PORT", None)
    if not (isinstance(port, tuple) and len(port) == 3
            and all(isinstance(s, str) and s.isidentifier() for s in port)):
        raise ValueError(f"{enc.__file__}: PORT is {port!r}, not (module, "
                         f"config class, model class) of "
                         f"radad_tpu_torch.models")
    module, config_class, model_class = port
    name = f"radad_tpu_torch.models.{module}"
    try:
        models = importlib.import_module(name)
    except ModuleNotFoundError as e:
        if e.name != name:
            raise
        raise ValueError(f"{enc.__file__}: PORT names {name}, which the "
                         f"port does not have") from None
    config_cls, model_cls = (getattr(models, c, None) for c in port[1:])
    for c, cls in ((config_class, config_cls), (model_class, model_cls)):
        if not isinstance(cls, type):
            raise ValueError(f"{enc.__file__}: PORT names {name}.{c}, "
                             f"which is no class of the port")
    if not issubclass(model_cls, torch.nn.Module):
        raise ValueError(f"{enc.__file__}: PORT's model class {name}."
                         f"{model_class} is not an nn.Module")
    return config_cls, model_cls


def program_config(config: dict, data_root: str, seed: int):
    from radad_tpu_torch.config import Config

    return Config().replace(
        data_root=data_root, vector_db_path=os.path.join(data_root, "vdb"),
        train_data_path=data_root, test_data_path=data_root,
        random_seed=int(seed), **_tuples(config["pipeline"]))


def build_pipeline(config: dict, enc_w: Dict[str, torch.Tensor],
                   fus_w: Dict[str, torch.Tensor], device: str,
                   data_root: str, seed: int):
    """A ``DetectionPipeline`` with the given encoder and fusion weights
    (loaded strictly: every name and shape must match)."""
    from radad_tpu_torch.models.encoder import FrozenEncoder
    from radad_tpu_torch.train.pipeline import DetectionPipeline
    from radad_tpu_torch.utils.device import compute_dtype

    cfg = program_config(config, data_root, seed)
    config_class, model_class = port_encoder(config)
    with torch.device(device):
        arch_cfg = config_class(**_tuples(config["architecture"]))
        model = model_class(arch_cfg)
    model.load_state_dict(enc_w, strict=True)
    encoder = FrozenEncoder(
        name=config["encoder"], model_name=config["model_name"],
        arch_cfg=arch_cfg, model=model.eval(), pretrained=False,
        layers_to_use=cfg.wav2vec2_layers_to_use,
        input_normalize=bool(cfg.input_normalize),
        compute_dtype=compute_dtype(cfg),
        whisper_pad_seconds=cfg.whisper_pad_seconds)
    pipe = DetectionPipeline(cfg, encoder=encoder, device=device)
    pipe.model.load_state_dict(fus_w, strict=True)
    return pipe


def predict_batcher(pipe, max_batch: int, linger_ms: float):
    from radad_tpu_torch.serve.app import PredictBatcher

    return PredictBatcher(pipe, max_batch=max_batch, linger_ms=linger_ms)


class Instrument:
    """Wraps the pipeline instance's ``predict_batch``, ``_predict_tensors``,
    ``_embed``, ``_retrieve`` and the fusion model's ``forward``: each call
    of ``predict_batch`` is recorded (host clock, batch, payloads, the
    embeddings ``_embed`` returned), and with ``ranges`` each call runs
    inside a ``torch.profiler.record_function`` range named
    ``predict_batch:<B>``, ``device_path``, ``embed:<B>``, ``search`` or
    ``model``. ``on_call`` runs before each ``predict_batch``, on its
    thread (the profiler is started and stopped there). The embeddings are
    kept of every ``keep_every``-th call from ``keep_from`` on (the calls
    the check samples), so that holding them does not grow the peak."""

    def __init__(self, pipe, ranges: bool = False, on_call=None,
                 keep_every: int = 1, keep_from: int = 0):
        self.pipe = pipe
        self.ranges = ranges
        self.on_call = on_call
        self.keep = (keep_every, keep_from % keep_every)
        self.calls: List[dict] = []
        self.current: Optional[dict] = None
        self.of_result: Dict[int, tuple] = {}  # id(payload) -> (call, row)
        self._wrap(pipe, "predict_batch", self._predict_batch)
        self._wrap(pipe, "_predict_tensors", self._ranged("device_path"))
        self._wrap(pipe, "_embed", self._embed)
        self._wrap(pipe, "_retrieve", self._ranged("search"))
        self._wrap(pipe.model, "forward", self._ranged("model"))

    @staticmethod
    def _wrap(obj, name, make):
        setattr(obj, name, make(getattr(obj, name)))

    def _range(self, name):
        if not self.ranges:
            return contextlib.nullcontext()
        return torch.profiler.record_function(name)

    def _ranged(self, name):
        def make(fn):
            def call(*a, **kw):
                with self._range(name):
                    return fn(*a, **kw)
            return call
        return make

    def _predict_batch(self, fn):
        def call(paths):
            if self.on_call is not None:
                self.on_call()
            rec = {"t0": time.perf_counter(), "paths": list(paths),
                   "batch": len(paths), "tpp": None}
            self.current = rec
            with self._range(f"predict_batch:{len(paths)}"):
                out = fn(paths)
            rec["t1"] = time.perf_counter()
            rec["out"] = out
            idx = len(self.calls)
            self.calls.append(rec)
            for row, r in enumerate(out):
                self.of_result[id(r)] = (idx, row)
            self.current = None
            return out
        return call

    def _embed(self, fn):
        def call(audio, lengths=None):
            with self._range(f"embed:{audio.shape[0]}"):
                out = fn(audio, lengths)
            every, first = self.keep
            if (self.current is not None
                    and len(self.calls) % every == first):
                self.current["tpp"] = out
            return out
        return call

    def reset(self):
        self.calls.clear()
        self.of_result.clear()
        ix = self.pipe.index
        ix.searches = 0
        ix.fallbacks = 0


def warm_full_scan(pipe, sizes):
    """Run the certified search's fallback, the exact float32 scan, once at
    each query count in ``sizes``, so that a fallback inside the window
    finds its GEMM already set up."""
    from radad_tpu_torch.index.flat import _full_scan

    ix = pipe.index
    n = ix.vectors.shape[0]
    for b in sizes:
        q = ix.vectors[:b].float()
        mask = torch.zeros((b, n), dtype=torch.bool, device=q.device)
        _full_scan(q, ix.vectors, ix.norms_sq, mask, pipe.config.top_k,
                   larger_better=False)


def train_manifest(names: List[str], labels, speakers: int = 8):
    """A ``Manifest`` over clip names (no files: the rows come from the
    embedding cache)."""
    import numpy as np

    from radad_tpu_torch.data.manifest import Manifest, file_id

    return Manifest(paths=tuple(names),
                    labels=np.asarray(labels, np.float32),
                    speakers=tuple(f"spk{i % speakers}"
                                   for i in range(len(names))),
                    ids=np.asarray([file_id(p) for p in names], np.int32))


def install_embeddings(pipe, manifest, rows: torch.Tensor) -> None:
    """Hand the pipeline precomputed embeddings of ``manifest``: its
    embedding cache, which the frozen encoder's output fills, keyed as
    ``_embeddings_any`` keys it."""
    pipe._embedding_cache[(hash(manifest.paths), len(manifest))] = rows


def new_accumulators(device):
    from radad_tpu_torch.train.pipeline import new_accumulators as new

    return new(device)


def acc_keys():
    from radad_tpu_torch.train.pipeline import ACC_KEYS

    return ACC_KEYS
