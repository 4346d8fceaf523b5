"""Seeded random weights at the published widths, made on the device in
one draw, under the names both the program and the reference load.

The scales are the port's own random init, so the activations stay finite
through every layer. An encoder's names, shapes and scales are its encoder
file's ``weights`` (``encoders/<name>.py``): convolutions uniform with the
variance of normal / sqrt(fan_in); linear weights and biases uniform
+-1/sqrt(fan_in); norms at 1 and 0; some biases 0 and fixed tables, as the
file gives them. The fusion model: Xavier-uniform weights and zero biases
in the projection, He-uniform in the detection head, +-1/sqrt(fan_in) in
the fuse layer.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

from harness.common import encoder, sub_seed
from reference.encoders import Spec


def fusion_spec(d: int, hidden: int = 256, out: int = 128,
                det: Tuple[int, ...] = (64, 32)) -> Spec:
    pl = "projection_layer"
    spec: Spec = []

    def dense(name, fin, fout, bound, bias_bound="zeros"):
        spec.append((f"{name}.weight", (fout, fin), bound))
        spec.append((f"{name}.bias", (fout,), bias_bound))

    def xavier(fin, fout):
        return math.sqrt(6.0 / (fin + fout))

    dense(f"{pl}.attention_score", d, hidden, xavier(d, hidden))
    dense(f"{pl}.attention_final", hidden, 1, xavier(hidden, 1))
    dense(f"{pl}.cst_hidden", d, hidden, xavier(d, hidden))
    dense(f"{pl}.cst_output", hidden, d, xavier(hidden, d))
    dense(f"{pl}.weight_sum", d, hidden, xavier(d, hidden))
    spec += [(f"{pl}.normalization.weight", (hidden,), "ones"),
             (f"{pl}.normalization.bias", (hidden,), "zeros")]
    dense(f"{pl}.unified_embedding", hidden, out, xavier(hidden, out))
    dense("fuse", d + out, out, 1 / math.sqrt(d + out),
          1 / math.sqrt(d + out))
    dims = (out,) + tuple(det) + (1,)
    for i in range(len(dims) - 1):
        dense(f"detection_model.linears.{i}", dims[i], dims[i + 1],
              math.sqrt(6.0 / dims[i]))
    for i, h in enumerate(det):
        spec += [(f"detection_model.norms.{i}.weight", (h,), "ones"),
                 (f"detection_model.norms.{i}.bias", (h,), "zeros")]
    return spec


def make(spec: Spec, seed: int, device) -> Dict[str, torch.Tensor]:
    """float32 tensors of ``spec``: one uniform draw on ``device`` from
    ``seed`` for every random leaf, then each leaf's slice scaled."""
    n = sum(math.prod(s) for _, s, b in spec if isinstance(b, float))
    g = torch.Generator(device=device).manual_seed(seed)
    draw = torch.rand((n,), generator=g, device=device) * 2.0 - 1.0
    out, off = {}, 0
    for name, shape, b in spec:
        if isinstance(b, float):
            k = math.prod(shape)
            out[name] = draw[off:off + k].view(shape) * b
            off += k
        elif isinstance(b, torch.Tensor):
            out[name] = b.to(device)
        else:
            out[name] = (torch.ones if b == "ones" else torch.zeros)(
                shape, device=device)
    return out


def encoder_weights(config: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    spec = encoder(config).weights(config["architecture"])
    return make(spec, sub_seed(seed, "encoder"), device)


def fusion_weights(config: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    p = config["pipeline"]
    spec = fusion_spec(tpp_dim(config), p["projection_hidden_dim"],
                       p["projection_output_dim"],
                       tuple(p["detection_hidden_dims"]))
    return make(spec, sub_seed(seed, "fusion"), device)


def tpp_dim(config: dict) -> int:
    width = encoder(config).width(config["architecture"])
    return sum(config["pipeline"]["tpp_levels"]) * width
