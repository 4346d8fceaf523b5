"""What every part of the harness shares: where things are, the run's
record, seeds, percentiles and the guard against JAX."""

from __future__ import annotations

import hashlib
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
