"""What every part of the harness shares: where things are, how a file is
found by its name, the run's record, seeds, percentiles and the guard
against JAX."""

from __future__ import annotations

import functools
import hashlib
import importlib.util
import json
import math
import os
import sys
import tempfile
import zlib
from dataclasses import dataclass, field
from typing import Any, Dict, List, Tuple

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO_DIR = os.path.dirname(BENCH_DIR)
# caches of anything the program compiles, at fixed paths in the checkout
CACHE_DIR = os.path.join(BENCH_DIR, ".cache")
# the encoder files; a test points it at a directory of its own
ENCODERS_DIR = os.path.join(BENCH_DIR, "encoders")
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "radad_tpu")


def load_json(path: str) -> Any:
    with open(path) as f:
        return json.load(f)


def benchmark() -> dict:
    return load_json(os.path.join(REPO_DIR, "BENCHMARK.json"))


def load_config(name: str) -> dict:
    return load_json(os.path.join(BENCH_DIR, "configs", f"{name}.json"))


def load_traffic(name: str) -> dict:
    return load_json(os.path.join(BENCH_DIR, "traffic", f"{name}.json"))


def _load_file(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod
    spec.loader.exec_module(mod)
    return mod


def _module_name(kind: str, name: str) -> str:
    return f"h100_bench_{kind}_{name.replace('.', '_').replace('-', '_')}"


def load_module(kind: str, name: str):
    """``<kind>/<name>.py`` of the harness: a driver or a metric."""
    return _load_file(os.path.join(BENCH_DIR, kind, f"{name}.py"),
                      _module_name(kind, name))


def encoder(config: dict):
    """The configuration's encoder file, ``encoders/<encoder>.py``, loaded
    once a process. It exports:

    - ``weights(arch)``: the ``(name, shape, init)`` list that
      ``harness/weights.py::make`` draws, in the order it draws them;
    - ``features(p, arch, pipe, segments, kinds)``: the plain forward,
      windows ``[N, L]`` → features ``[N, T, D]`` in float32, each product
      rounded as ``kinds`` says ("encoder", and "mel" where there is one);
    - ``segment_flops(arch, pipe)``: the operations of one window;
    - ``attention(arch, pipe)``: (frames, heads, head width) of one
      window's attention;
    - ``width(arch)``: the width of a frame's features;
    - ``TINY``: the CPU cut of the tests, as overrides of
      ``"architecture"`` and ``"pipeline"``.
    - ``PORT``: ``(module of radad_tpu_torch.models, config class, model
      class)``, names only, which ``harness/program.py::port_encoder``
      resolves; the file imports nothing of the program.

    Raises ``FileNotFoundError``, naming the file, where there is none."""
    name = config["encoder"]
    path = os.path.join(ENCODERS_DIR, f"{name}.py")
    if not os.path.isfile(path):
        raise FileNotFoundError(
            f"configuration {config.get('name')!r}: no encoder file {path}")
    return _load_encoder(path, name)


@functools.lru_cache(maxsize=None)
def _load_encoder(path: str, name: str):
    return _load_file(path, _module_name("encoders", name))


def sub_seed(seed: int, tag: str) -> int:
    """A 63-bit seed for one use of the run's seed."""
    h = hashlib.sha256(f"{int(seed)}:{tag}".encode()).digest()
    return int.from_bytes(h[:8], "little") >> 1


def file_id(name: str) -> int:
    """The 31-bit id of a clip's basename (crc32), the key by which a
    query excludes its own file."""
    return zlib.crc32(os.path.basename(name).encode("utf-8")) & 0x7FFFFFFF


def nearest_rank(values: List[float], q: float) -> float:
    """The q-quantile of every value by nearest rank: the ceil(q n)-th
    smallest."""
    s = sorted(values)
    return float(s[max(0, math.ceil(q * len(s)) - 1)])


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's,
    compared whole."""
    return sorted({m.split(".", 1)[0] for m in list(sys.modules)
                   if m.split(".", 1)[0] in FORBIDDEN})


def scratch_dir(tag: str) -> str:
    """A fresh directory under TMPDIR for this run's data."""
    return tempfile.mkdtemp(prefix=f"h100_bench_{tag}_")


@dataclass
class Run:
    """One run of one cell: its inputs, and what the driver records for
    the metrics and the check."""

    cell: dict
    config: dict
    traffic: dict
    seed: int
    seconds: float
    trace: bool
    device: str
    t_start: float  # host clock at process start
    chips: int = 1
    e2e: Dict[str, float] = field(default_factory=dict)
    counters: Dict[str, float] = field(default_factory=dict)
    spans: Dict[str, List[float]] = field(default_factory=dict)
    trace_summary: Any = None
    attempted: int = 0
    failed: int = 0
    memory_peak_bytes: int = 0
    checks: List[Tuple[str, float, float]] = field(default_factory=list)
    notes: List[str] = field(default_factory=list)

    @property
    def correct(self) -> bool:
        return (self.failed == 0 and bool(self.checks)
                and all(v <= lim for _, v, lim in self.checks))

    def note(self, text: str) -> None:
        print(text, file=sys.stderr, flush=True)
        self.notes.append(text)
