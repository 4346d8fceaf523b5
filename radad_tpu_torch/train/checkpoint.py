"""Checkpoint / resume: model + optimizer state + step + config.

Counterpart: ``radad_tpu/train/checkpoint.py``, which writes {params,
opt_state, step, config_json} as an npz with a pickled jax treedef. The
port writes its own format, one ``torch.save`` file at
``<data_root>/models/<prefix>_radad.pt``:

    {"model": state dict (parameters and BatchNorm buffers),
     "optimizer": GroupAdam state ({group: {count, mu, nu}}) or None,
     "step": int, "config_json": str}

A JAX checkpoint crosses through ``models/convert.py`` (``fusion_from_flax``
and ``adam_state_from_optax``). Files written before the optimizer state
was saved have no ``"optimizer"`` key; they load with ``None`` there.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Optional

import torch


def checkpoint_path(data_root: str, prefix: str) -> str:
    return os.path.join(data_root, "models", f"{prefix}_radad.pt")


def _cpu(tree):
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    if isinstance(tree, dict):
        return {k: _cpu(v) for k, v in tree.items()}
    return tree


def save_checkpoint(data_root: str, prefix: str,
                    state: Dict[str, Any]) -> str:
    """``state`` = {"model", "optimizer", "step", "config_json"}; tensors
    are moved to the CPU. Written to a temporary file and renamed into
    place. Returns the path."""
    path = checkpoint_path(data_root, prefix)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = path + ".tmp"
    torch.save({"model": _cpu(state["model"]),
                "optimizer": _cpu(state.get("optimizer")),
                "step": int(state.get("step", 0)),
                "config_json": state.get("config_json", "{}")}, tmp)
    os.replace(tmp, path)
    return path


def load_checkpoint(data_root: str, prefix: str) -> Optional[Dict[str, Any]]:
    """The saved dict with CPU tensors (``"optimizer"`` None when the file
    has none), or None when there is no file."""
    path = checkpoint_path(data_root, prefix)
    if not os.path.exists(path):
        return None
    state = torch.load(path, map_location="cpu", weights_only=True)
    state.setdefault("optimizer", None)
    return state
