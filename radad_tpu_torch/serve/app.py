"""Web app of the port: catalog, upload/record, predict, neighbors.

Counterpart: ``radad_tpu/serve/app.py``, copied with the port's
``DetectionPipeline`` behind it and its own copy of ``static/`` and
``templates/``. Same HTTP surface as the reference Flask app: ``GET /``,
``GET /api/list``, ``GET /audio/<file>``, ``GET /api/dbinfo``,
``POST /api/predict`` (multipart ``file`` upload or catalog ``filename``),
on the stdlib ``ThreadingHTTPServer``. Concurrent predict requests are
micro-batched into one ``predict_batch`` call (``PredictBatcher``).

Run: ``python -m radad_tpu_torch.serve.app --data_path <dir> --data_root
<dir>`` (``--device cpu`` to serve without a GPU).
"""

from __future__ import annotations

import argparse
import json
import logging
import math
import mimetypes
import os
import re
import subprocess
import threading
import uuid
import wave
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, Optional, Tuple

logger = logging.getLogger(__name__)

ALLOWED_EXT = {".wav", ".mp3", ".flac", ".ogg", ".m4a", ".webm"}
MAX_CONTENT_LENGTH = 50 * 1024 * 1024
_DUR_CACHE: Dict[str, float] = {}

STATIC_DIR = os.path.join(os.path.dirname(__file__), "static")
TEMPLATE_DIR = os.path.join(os.path.dirname(__file__), "templates")


class PredictBatcher:
    """Micro-batching front for concurrent /api/predict requests.

    The reference serves predictions strictly one-at-a-time (Flask dev
    server + a single-clip predict). Here concurrent requests enqueue and a
    worker coalesces them (up to ``max_batch``, lingering ``linger_ms`` for
    stragglers) into ONE device pass via ``pipeline.predict_batch``;
    batch sizes bucket to powers of two (kept from the JAX package, where
    each size compiles once).
    """

    BUCKETS = (1, 2, 4, 8, 16)

    def __init__(self, pipeline, max_batch: int = 16,
                 linger_ms: float = 20.0):
        import queue as _queue

        self.pipeline = pipeline
        self.max_batch = max_batch
        self.linger = linger_ms / 1000.0
        self._q: "_queue.Queue" = _queue.Queue()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def predict(self, path: str) -> dict:
        import concurrent.futures as _f
        import time as _time

        fut: "_f.Future" = _f.Future()
        self._q.put((path, fut, _time.perf_counter()))
        return fut.result(timeout=600)

    def close(self) -> None:
        """Stop the worker thread after the requests queued so far; it then
        drops its reference to the pipeline."""
        self._q.put(None)
        self._thread.join(timeout=600)

    def _bucket(self, n: int) -> int:
        for b in self.BUCKETS:
            if n <= b:
                return b
        return self.BUCKETS[-1]

    def _run(self):
        import queue as _queue
        import time as _time

        while True:
            item = self._q.get()
            if item is None:  # close()
                self.pipeline = None
                return
            batch = [item]
            # Adaptive linger: drain whatever already queued while the
            # previous device call was in flight (free coalescing), but
            # only wait the linger window for stragglers when this batch
            # is already >1 — a solo request fires immediately, so
            # sequential clients never pay the linger; bursts still
            # coalesce because later requests arrive while the device is
            # busy.
            while len(batch) < self.max_batch:
                try:
                    item = self._q.get_nowait()
                except _queue.Empty:
                    break
                if item is None:
                    self._q.put(None)  # close() after this batch
                    break
                batch.append(item)
            if 1 < len(batch) < self.max_batch:
                deadline = _time.time() + self.linger
                while len(batch) < self.max_batch:
                    remaining = deadline - _time.time()
                    if remaining <= 0:
                        break
                    try:
                        item = self._q.get(timeout=remaining)
                    except _queue.Empty:
                        break
                    if item is None:
                        self._q.put(None)
                        break
                    batch.append(item)
            paths = [p for p, _, _ in batch]
            bucket = self._bucket(len(paths))
            padded = paths + [paths[-1]] * (bucket - len(paths))
            t_start = _time.perf_counter()
            try:
                results = self.pipeline.predict_batch(padded)
                for (p, f, tq), r in zip(batch, results):
                    # per-request batcher wait: linger + any in-flight
                    # device call ahead of this batch
                    r.setdefault("stage_ms", {})["queue"] = round(
                        (t_start - tq) * 1e3, 2)
                    if not f.cancelled():
                        f.set_result(r)
            except Exception as e:  # pragma: no cover
                for _, f, _ in batch:
                    if not f.cancelled():
                        f.set_exception(e)


class AppState:
    """Pipeline + catalog state shared across request threads."""

    def __init__(self, config, pipeline, audio_dir: str, upload_dir: str):
        self.config = config
        self.pipeline = pipeline
        self.pipeline_error: Optional[str] = None
        self.audio_dir = audio_dir
        self.upload_dir = upload_dir
        os.makedirs(upload_dir, exist_ok=True)
        self.batcher = (PredictBatcher(pipeline)
                        if pipeline is not None else None)
        self._meta_rows = self._read_meta()

    # -------------------------------------------------- catalog
    def _read_meta(self):
        meta_csv = os.path.join(self.audio_dir, "meta.csv")
        rows = []
        if os.path.exists(meta_csv):
            import csv as _csv

            with open(meta_csv) as f:
                for r in _csv.DictReader(f):
                    low = {k.lower(): v for k, v in r.items()}
                    rows.append({
                        "file": low.get("file", low.get("path", "")),
                        "speaker": low.get("speaker", "unknown"),
                        "label": low.get("label", "unknown"),
                    })
        else:
            for f in sorted(os.listdir(self.audio_dir)):
                if os.path.splitext(f)[1].lower() in ALLOWED_EXT:
                    rows.append({"file": f, "speaker": "unknown",
                                 "label": "unknown"})
        return rows

    def catalog(self):
        items = []
        for r in self._meta_rows:
            fname = os.path.basename(r["file"])
            path = os.path.join(self.audio_dir, fname)
            if not os.path.exists(path):
                continue
            dur = wav_duration(path)
            items.append({
                "file": fname,
                "speaker": str(r["speaker"]),
                "label": label_to_str(r["label"]),
                "duration_sec": dur,
                "duration": fmt_duration(dur),
                "url": f"/audio/{fname}",
            })

        def key(x):
            base = os.path.splitext(x["file"])[0]
            return (0, int(base)) if base.isdigit() else (1, base)

        items.sort(key=key, reverse=True)
        return items

    def meta_for(self, fname: str) -> Dict[str, str]:
        for r in self._meta_rows:
            if os.path.basename(r["file"]) == fname:
                return r
        return {"speaker": "unknown", "label": "unknown"}


def label_to_str(y) -> str:
    s = str(y).strip().lower()
    if s in ("1", "1.0", "spoof", "fake", "synthetic"):
        return "spoof"
    if s in ("0", "0.0", "bona-fide", "bonafide", "genuine", "real"):
        return "bona-fide"
    return s


def wav_duration(path: str) -> float:
    if path in _DUR_CACHE:
        return _DUR_CACHE[path]
    dur = 0.0
    try:
        with wave.open(path, "rb") as w:
            dur = w.getnframes() / max(w.getframerate(), 1)
    except Exception:
        try:
            from radad_tpu_torch.data.audio import load_audio

            audio = load_audio(path, sample_rate=16000, duration=None)
            dur = len(audio) / 16000.0
        except Exception:
            dur = 0.0
    _DUR_CACHE[path] = float(dur)
    return float(dur)


def fmt_duration(seconds: float) -> str:
    if not math.isfinite(seconds):
        return "00:00"
    m, s = divmod(int(round(seconds)), 60)
    return f"{m:02d}:{s:02d}"


def secure_filename(name: str) -> str:
    name = os.path.basename(name or "")
    name = re.sub(r"[^A-Za-z0-9_.-]", "_", name)
    return name or f"upload_{uuid.uuid4().hex}.wav"


def ensure_wav(path_in: str, upload_dir: str, sample_rate: int) -> str:
    """Transcode non-wav uploads via ffmpeg when available
    (app.py:188-210)."""
    if os.path.splitext(path_in)[1].lower() == ".wav":
        return path_in
    try:  # maybe the decoder stack can read it anyway
        from radad_tpu_torch.data.audio import load_audio

        if float(abs(load_audio(path_in, sample_rate=sample_rate,
                                duration=0.25)).sum()) > 0:
            return path_in
    except Exception:
        pass
    path_out = os.path.join(upload_dir, f"conv_{uuid.uuid4().hex}.wav")
    cmd = ["ffmpeg", "-y", "-i", path_in, "-ac", "1", "-ar",
           str(sample_rate), path_out]
    try:
        subprocess.run(cmd, check=True, stdout=subprocess.PIPE,
                       stderr=subprocess.PIPE)
        return path_out
    except FileNotFoundError:
        raise RuntimeError(
            "cannot decode this format (ffmpeg not available); upload WAV")
    except Exception as e:
        raise RuntimeError(f"ffmpeg transcode failed: {e}")


# ----------------------------------------------------------------------
def parse_multipart(body: bytes, content_type: str) -> Dict[str, Tuple[str, bytes]]:
    """Minimal multipart/form-data parser → {field: (filename, data)}."""
    m = re.search(r'boundary="?([^";]+)"?', content_type)
    if not m:
        return {}
    boundary = ("--" + m.group(1)).encode()
    fields: Dict[str, Tuple[str, bytes]] = {}
    for part in body.split(boundary):
        part = part.strip(b"\r\n")
        if not part or part == b"--":
            continue
        if b"\r\n\r\n" not in part:
            continue
        head, data = part.split(b"\r\n\r\n", 1)
        head_text = head.decode("utf-8", "replace")
        name_m = re.search(r'name="([^"]*)"', head_text)
        if not name_m:
            continue
        fname_m = re.search(r'filename="([^"]*)"', head_text)
        fields[name_m.group(1)] = (
            fname_m.group(1) if fname_m else "", data)
    return fields


class Handler(BaseHTTPRequestHandler):
    state: AppState = None  # injected by serve()

    # -------------------------------------------------- helpers
    def _json(self, obj, status: int = 200):
        payload = json.dumps(obj).encode()
        self.send_response(status)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(payload)))
        self.end_headers()
        self.wfile.write(payload)

    def _file(self, path: str, status: int = 200):
        if not os.path.exists(path):
            return self._json({"ok": False, "error": "not found"}, 404)
        ctype = mimetypes.guess_type(path)[0] or "application/octet-stream"
        with open(path, "rb") as f:
            data = f.read()
        self.send_response(status)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def log_message(self, fmt, *args):  # route through logging
        logger.info("%s - %s", self.address_string(), fmt % args)

    # -------------------------------------------------- GET
    def do_GET(self):
        st = self.state
        path = self.path.split("?")[0]
        if path == "/" or path == "/index.html":
            return self._file(os.path.join(TEMPLATE_DIR, "index.html"))
        if path.startswith("/static/"):
            return self._file(os.path.join(STATIC_DIR,
                                           os.path.basename(path)))
        if path == "/api/list":
            return self._json({"items": st.catalog()})
        if path == "/api/dbinfo":
            idx = st.pipeline.index if st.pipeline else None
            vdb_path = st.config.vector_db_path
            prefix = ("sq8" if st.config.vector_db_index_type.upper()
                      == "SQ8" else "index")
            return self._json({
                "vector_db_path": vdb_path,
                "index_file_exists": os.path.exists(
                    os.path.join(vdb_path, f"{prefix}_arrays.npz")),
                "metadata_file_exists": os.path.exists(
                    os.path.join(vdb_path, f"{prefix}_meta.json")),
                "has_index": idx is not None and idx.ntotal > 0,
                "ntotal": idx.ntotal if idx else 0,
                "sample_vector_files": [
                    os.path.basename(p) for p in (idx.paths[:5] if idx else [])],
            })
        if path.startswith("/audio/"):
            fname = os.path.basename(path[len("/audio/"):])
            for d in (st.audio_dir, st.upload_dir):
                p = os.path.join(d, fname)
                if os.path.exists(p):
                    return self._file(p)
            return self._json({"ok": False, "error": "Audio not found"}, 404)
        return self._json({"ok": False, "error": "not found"}, 404)

    # -------------------------------------------------- POST
    def do_POST(self):
        import time as _time

        t0 = _time.perf_counter()
        st = self.state
        if self.path.split("?")[0] != "/api/predict":
            return self._json({"ok": False, "error": "not found"}, 404)
        if st.pipeline is None:
            return self._json(
                {"ok": False,
                 "error": f"Model not loaded: {st.pipeline_error}"}, 500)
        length = int(self.headers.get("Content-Length", 0))
        if length > MAX_CONTENT_LENGTH:
            return self._json({"ok": False, "error": "payload too large"}, 413)
        body = self.rfile.read(length)
        fields = parse_multipart(body,
                                 self.headers.get("Content-Type", ""))

        src_path, used_existing = None, False
        if "filename" in fields and fields["filename"][1].strip():
            fname = os.path.basename(
                fields["filename"][1].decode("utf-8", "replace").strip())
            candidate = os.path.join(st.audio_dir, fname)
            if not os.path.exists(candidate):
                return self._json(
                    {"ok": False, "error": f"File not found: {fname}"}, 400)
            src_path, used_existing = candidate, True
        if "file" in fields and fields["file"][0]:
            fname = secure_filename(fields["file"][0])
            if os.path.splitext(fname)[1].lower() not in ALLOWED_EXT:
                fname = os.path.splitext(fname)[0] + ".wav"
            src_path = os.path.join(st.upload_dir, fname)
            with open(src_path, "wb") as f:
                f.write(fields["file"][1])
            used_existing = False
        if not src_path:
            return self._json(
                {"ok": False, "error": "Provide either an uploaded file or "
                                       "choose an existing filename."}, 400)

        try:
            t_parse = _time.perf_counter()
            usable = ensure_wav(src_path, st.upload_dir,
                                st.config.sample_rate)
            t_wav = _time.perf_counter()
            result = st.batcher.predict(usable)
            t_pred = _time.perf_counter()
            neighbors = []
            for r in result.get("retrieved", []):
                fname = os.path.basename(r.get("file") or r.get("path") or "")
                if not fname:
                    continue
                meta = st.meta_for(fname)
                apath = os.path.join(st.audio_dir, fname)
                dur = wav_duration(apath) if os.path.exists(apath) else 0.0
                dist = r.get("distance")
                neighbors.append({
                    "file": fname,
                    "speaker": str(meta.get("speaker", "unknown")),
                    "label": label_to_str(meta.get("label",
                                                   r.get("label", "unknown"))),
                    "duration": fmt_duration(dur),
                    "duration_sec": float(dur),
                    "distance": None if (dist is None or
                                         (isinstance(dist, float)
                                          and math.isnan(dist)))
                    else float(dist),
                    "url": f"/audio/{fname}" if os.path.exists(apath) else "",
                })
            # Per-stage latency breakdown (ms): HTTP parse+save, wav
            # probe/transcode, batcher (queue + decode + device +
            # payload from the pipeline), neighbor enrichment. Sums to
            # ~the client-observed latency minus network; a p50
            # regression at 1M rows is attributable to a stage.
            t_enrich = _time.perf_counter()
            timings = {"parse": round((t_parse - t0) * 1e3, 2),
                       "ensure_wav": round((t_wav - t_parse) * 1e3, 2),
                       "predict": round((t_pred - t_wav) * 1e3, 2),
                       "enrich": round((t_enrich - t_pred) * 1e3, 2)}
            timings.update(result.get("stage_ms", {}))
            return self._json({
                "ok": True,
                "source": {
                    "used_existing": used_existing,
                    "path": src_path if used_existing
                    else os.path.basename(src_path),
                },
                "prediction": result.get("prediction"),
                "probability": float(result.get("probability", 0.0)),
                "probability_spoof": float(
                    result.get("probability_spoof", 0.0)),
                "neighbors": neighbors,
                "timings_ms": timings,
            })
        except Exception as e:
            logger.exception("predict failed")
            return self._json(
                {"ok": False, "error": f"{type(e).__name__}: {e}"}, 500)


def load_pipeline(config, model_prefix: str = "final_model",
                  device="cuda", nprobe: int = None):
    """Startup model+index load (reference app.py:47-83). ``nprobe``
    overrides the probe count saved with an IVF index for this server's
    lifetime (the reference sets ``index.nprobe`` per search,
    vector_database.py:175-179)."""
    from radad_tpu_torch.train.pipeline import DetectionPipeline

    pipe = DetectionPipeline(config, device=device)
    if not pipe.load_models(model_prefix):
        if not pipe.load_models("best_model"):
            raise RuntimeError("no trained checkpoint found")
    if not pipe.load_vector_database():
        raise RuntimeError("no saved vector database found")
    if nprobe is not None:
        pipe.index.nprobe = int(nprobe)
    return pipe


def serve(config, *, host: str = "0.0.0.0", port: int = 5000,
          pipeline=None, model_prefix: str = "final_model", device="cuda",
          nprobe: int = None):
    """Build the server (``serve_forever`` is the caller's). Without a
    ``pipeline`` it loads one on ``device`` (``nprobe``: see
    ``load_pipeline``); a load failure is reported by ``/api/predict`` as
    HTTP 500."""
    audio_dir = config.train_data_path
    upload_dir = os.path.join(config.data_root, "uploads")
    err = None
    if pipeline is None:
        from radad_tpu_torch.utils.device import resolve_device

        resolve_device(device)  # no GPU: fail at startup, not per request
        try:
            pipeline = load_pipeline(config, model_prefix, device=device,
                                     nprobe=nprobe)
        except Exception as e:
            logger.error("pipeline load failed: %s", e)
            pipeline, err = None, str(e)
    state = AppState(config, pipeline, audio_dir, upload_dir)
    state.pipeline_error = err
    Handler.state = state

    class _Server(ThreadingHTTPServer):
        # socketserver's default listen backlog is 5: under ≥16 concurrent
        # clients the SYN queue overflows and connects get RST while the
        # micro-batcher is mid-device-call (found by
        # experiments/serve_load_test.py at the 1M-row scale).
        request_queue_size = 128
        daemon_threads = True

        def server_close(self):
            """Close the socket, stop the micro-batcher and release the
            pipeline (a served pipeline's device memory is freed once the
            caller drops it too)."""
            super().server_close()
            if state.batcher is not None:
                state.batcher.close()
            state.pipeline = None
            if Handler.state is state:
                Handler.state = None

    httpd = _Server((host, port), Handler)
    logger.info("serving on http://%s:%d (audio dir: %s)", host, port,
                audio_dir)
    return httpd


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="RADAD demo web app (PyTorch/CUDA port)")
    p.add_argument("--data_path", type=str, required=True)
    p.add_argument("--data_root", type=str, default="data")
    p.add_argument("--host", type=str, default="0.0.0.0")
    p.add_argument("--port", type=int, default=5000)
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default) or cpu")
    p.add_argument("--model_prefix", type=str, default="final_model")
    p.add_argument("--feature_extractor", type=str, default="wav2vec2")
    p.add_argument("--max_duration", type=float, default=None,
                   help="Analyze uploads/recordings up to this many seconds "
                        "(long-audio mode) instead of the 3 s truncation")
    p.add_argument("--mixed_precision", action="store_true",
                   help="Encoder and fusion model forward in bfloat16; clip "
                        "embeddings stay f32 after TPP so retrieval "
                        "semantics are unchanged")
    p.add_argument("--model_name", type=str, default=None,
                   help="HF model id overriding the encoder family's "
                        "default size")
    p.add_argument("--whisper_fast", action="store_true",
                   help="whisper: encode real frames only instead of the "
                        "reference's 30 s padding (must match how the "
                        "vector DB was built)")
    p.add_argument("--index_type", type=str, default="L2",
                   help="SQ8 for a saved SQ8 vector DB (its residual and "
                        "refine settings are read from sq8_meta.json); any "
                        "other DB's type (L2, IP, COSINE, IVF) is read from "
                        "index_meta.json")
    p.add_argument("--nprobe", type=int, default=None,
                   help="IVF cells probed per query (serving-time override "
                        "of the value saved with the index; the reference "
                        "sets index.nprobe per search, "
                        "vector_database.py:175-179)")
    return p


def config_from_args(args):
    from radad_tpu_torch.config import Config

    over = {}
    if args.model_name is not None:
        over[f"{args.feature_extractor.lower()}_model_name"] = args.model_name
    if args.whisper_fast:
        over["whisper_pad_seconds"] = None
    if args.nprobe is not None:
        over["vector_db_nprobe"] = args.nprobe
    return Config().replace(
        train_data_path=args.data_path, test_data_path=args.data_path,
        data_root=args.data_root,
        vector_db_path=os.path.join(args.data_root, "vector_db"),
        feature_extractor_type=args.feature_extractor,
        max_duration=args.max_duration,
        use_mixed_precision=args.mixed_precision,
        vector_db_index_type=args.index_type.upper(),
        use_batch_norm=False, use_layer_norm=True, **over)


def main(argv=None):
    logging.basicConfig(level=logging.INFO)
    args = build_parser().parse_args(argv)
    httpd = serve(config_from_args(args), host=args.host, port=args.port,
                  model_prefix=args.model_prefix, device=args.device,
                  nprobe=args.nprobe)
    httpd.serve_forever()


if __name__ == "__main__":
    main()
