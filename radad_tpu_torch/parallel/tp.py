"""Tensor-parallel sharding of the frozen encoder's parameters.

Counterpart: ``radad_tpu/parallel/tp.py`` (``encoder_param_specs``,
``shard_encoder_params``). JAX annotates the stacked parameter tree with
shardings and lets GSPMD partition the products and insert the
collectives; the port applies the same name rules to its per-layer
parameters (torch's ``[out, in]`` layout, ``models/wav2vec2.py``) and runs
the split explicitly (``models/encoder_common.py``):

* ``qw``, ``kw``, ``vw`` and ``w1`` split their output rows (heads, the
  FFN's hidden columns); ``qb``, ``kb``, ``vb`` and ``b1`` split with them;
* ``ow`` and ``w2`` split their input columns; each is followed by one
  all-reduce over the axis group, then ``ob`` / ``b2`` added once;
* everything else (norms, convolutions, embeddings, the gates of WavLM)
  replicates.

Each rank then runs H / S heads (``fused_mha`` under
``RADAD_FUSED_ATTENTION=1`` on CUDA). The axis is the mesh's 'index' axis
by default, as in JAX: the DB shards and the encoder shards live on the
same ranks, active in different phases.
"""

from __future__ import annotations

import copy
from typing import Dict

from torch import nn

from radad_tpu_torch.parallel.mesh import INDEX_AXIS, Mesh

_OUT_ROWS = ("qw", "kw", "vw", "w1")  # [out, in]: split dim 0
_OUT_BIAS = ("qb", "kb", "vb", "b1")
_IN_COLS = ("ow", "w2")  # [out, in]: split dim 1 (row parallel)


def encoder_param_specs(model: nn.Module,
                        axis: str = INDEX_AXIS) -> Dict[str, tuple]:
    """``{parameter name: spec}`` for a wav2vec2 / WavLM / Whisper encoder:
    ``(axis, None)`` splits dim 0, ``(axis,)`` a bias, ``(None, axis)``
    dim 1, ``()`` replicates (JAX's ``PartitionSpec``s on the port's
    layout)."""
    specs = {}
    for name, _ in model.named_parameters():
        parts = name.split(".")
        last = parts[-1]
        spec = ()
        if parts[0] == "layers":
            if last in _OUT_ROWS:
                spec = (axis, None)
            elif last in _OUT_BIAS:
                spec = (axis,)
            elif last in _IN_COLS:
                spec = (None, axis)
        specs[name] = spec
    return specs


def shard_encoder_params(model: nn.Module, mesh: Mesh,
                         axis: str = INDEX_AXIS) -> nn.Module:
    """A copy of ``model`` holding this rank's shard of every split
    parameter (``encoder_param_specs``) and ``tp = (mesh, axis)``, which
    the encoders' layers read. Raises where the axis size does not divide
    the heads or a split dimension."""
    s, i = mesh.shape[axis], mesh.coord(axis)
    heads = model.cfg.num_attention_heads
    if heads % s:
        raise ValueError(f"{s} tensor-parallel shards do not divide "
                         f"{heads} attention heads")
    out = copy.deepcopy(model)
    for name, spec in encoder_param_specs(model, axis).items():
        if not spec:
            continue
        p = out.get_parameter(name)
        dim = spec.index(axis)
        if p.shape[dim] % s:
            raise ValueError(f"{name}: dimension {dim} ({p.shape[dim]}) is "
                             f"not divisible by {s} shards")
        step = p.shape[dim] // s
        p.data = p.data.narrow(dim, i * step, step).clone()
    out.tp = (mesh, axis)
    return out
