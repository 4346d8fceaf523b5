"""Atomic file writes for persistence paths.

Counterpart: ``radad_tpu/utils/atomic_io.py``, copied.

Index/checkpoint saves can run in background threads (daemon — killed at
interpreter exit) or be interrupted mid-write; a truncated
``index_arrays.npz`` beside an intact, older ``index_meta.json`` is the
worst failure mode because the next load() *succeeds* on mismatched
state. Writing to a same-directory temp file and ``os.replace``-ing it
into place makes each file either the complete old version or the
complete new one (atomic on POSIX within one filesystem).
"""

from __future__ import annotations

import json
import os
import pickle
import tempfile
from typing import Any, Dict

import numpy as np


def _umask() -> int:
    cur = os.umask(0)
    os.umask(cur)
    return cur


def _replace_into(path: str, write_fn) -> None:
    d = os.path.dirname(os.path.abspath(path)) or "."
    fd, tmp = tempfile.mkstemp(dir=d, prefix=os.path.basename(path) + ".tmp.")
    try:
        with os.fdopen(fd, "wb") as f:
            write_fn(f)
        # mkstemp creates 0600; restore normal create-mode semantics
        # (umask-masked 0666) so saved indexes stay readable as before
        os.chmod(tmp, 0o666 & ~_umask())
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def atomic_savez(path: str, **arrays: np.ndarray) -> None:
    """``np.savez(path, **arrays)`` via temp-file + rename."""
    _replace_into(path, lambda f: np.savez(f, **arrays))


def atomic_json_dump(obj: Any, path: str) -> None:
    _replace_into(path, lambda f: f.write(
        json.dumps(obj).encode("utf-8")))


def atomic_pickle_dump(obj: Dict, path: str) -> None:
    _replace_into(path, lambda f: pickle.dump(obj, f))
