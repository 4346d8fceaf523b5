"""Numerical-safety utilities: NaN guards and checked execution.

Counterpart: ``radad_tpu/utils/debug.py`` (the reference's host-side NaN
checks on embeddings and retrieved vectors, pipeline.py:799-803):

  * ``assert_finite`` / ``checked`` — inside ``checked(fn)`` each
    ``assert_finite`` records a device-side flag without a host sync, and
    ``checked`` reads all of them in one host read at the end, as
    checkify's single ``err.throw()`` does;
  * ``nan_debug`` — a scope that raises at the first operation whose
    floating output holds a NaN (``jax_debug_nans``), with autograd's
    anomaly detection for the backward;
  * ``sanitize`` — ``nan_to_num`` with the reference's replace-with-zeros
    policy (pipeline.py:802-803).
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import List, Optional, Tuple

import torch
from torch.overrides import TorchFunctionMode

# (name, device bool "all finite") of each assert_finite inside checked()
_FLAGS: contextvars.ContextVar[Optional[List[Tuple[str, torch.Tensor]]]] = \
    contextvars.ContextVar("radad_finite_flags", default=None)


def sanitize(x: torch.Tensor) -> torch.Tensor:
    """Replace NaN/±inf with zeros (reference policy for retrieved
    neighbor vectors)."""
    return torch.nan_to_num(x, nan=0.0, posinf=0.0, neginf=0.0)


def _raise_non_finite(name: str) -> None:
    # checkify's error is a ValueError with this text
    raise ValueError(f"non-finite values in {name}")


def assert_finite(x: torch.Tensor, name: str = "tensor") -> None:
    """Finite check of ``x``. Inside ``checked(fn)`` it records a device
    flag and reads nothing back; outside it reads the flag at once and
    raises ``ValueError("non-finite values in <name>")``, as checkify's
    ``check`` raises outside ``checkify``."""
    ok = torch.isfinite(x).all()
    flags = _FLAGS.get()
    if flags is not None:
        flags.append((name, ok))
    elif not bool(ok):
        _raise_non_finite(name)


def checked(fn):
    """Wrap a function so its ``assert_finite`` checks raise on the host
    after it returns: one host read for all of them, and the first failed
    check's name in the error."""

    def run(*args, **kwargs):
        flags: List[Tuple[str, torch.Tensor]] = []
        token = _FLAGS.set(flags)
        try:
            out = fn(*args, **kwargs)
        finally:
            _FLAGS.reset(token)
        if flags:
            ok = torch.stack([f for _, f in flags]).cpu().tolist()
            for (name, _), fine in zip(flags, ok):
                if not fine:
                    _raise_non_finite(name)
        return out

    return run


def _tensors(out):
    if isinstance(out, torch.Tensor):
        yield out
    elif isinstance(out, (tuple, list)):
        for o in out:
            yield from _tensors(o)


class _NanTrap(TorchFunctionMode):
    """Checks every floating tensor an operation returns for NaN (a host
    sync after each operation)."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in _tensors(out):
            if t.is_floating_point() and bool(torch.isnan(t).any()):
                name = getattr(func, "__name__", repr(func))
                raise FloatingPointError(
                    f"invalid value (nan) encountered in {name}")
        return out


@contextlib.contextmanager
def nan_debug():
    """Raise ``FloatingPointError`` at the first torch operation inside the
    scope whose floating output holds a NaN, naming it, and run autograd's
    anomaly detection for the backward (the counterpart of
    ``jax_debug_nans``). Each operation then waits for its result on the
    host: a debugging tool, as JAX's flag is."""
    with torch.autograd.detect_anomaly(check_nan=True), _NanTrap():
        yield
