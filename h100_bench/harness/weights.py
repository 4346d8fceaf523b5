"""Seeded random weights at the published widths, made on the device in
one draw, under the names both the program and the reference load.

Scales (the port's own random init, so the activations stay finite through
every layer): convolutions uniform with the variance of normal /
sqrt(fan_in); linear weights and biases uniform +-1/sqrt(fan_in); norms at
1 and 0; the positional convolution's bias 0; Whisper's convolution biases
0 and its sinusoid table. The fusion model: Xavier-uniform weights and zero
biases in the projection, He-uniform in the detection head, +-1/sqrt(fan_in)
in the fuse layer.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

from harness.common import sub_seed
from reference.encoders import sinusoids

Spec = List[Tuple[str, tuple, object]]  # (name, shape, bound | "ones" | "zeros" | tensor)


def _wav2vec2(arch: dict) -> Spec:
    spec: Spec = []
    cin = 1
    for i, (c, k) in enumerate(zip(arch["conv_dim"], arch["conv_kernel"])):
        spec.append((f"conv_layers.{i}.kernel", (c, cin, k),
                     math.sqrt(3.0 / (k * cin))))
        if i == 0:
            spec += [("conv_layers.0.norm_scale", (c,), "ones"),
                     ("conv_layers.0.norm_bias", (c,), "zeros")]
        cin = c
    d, f, g = (arch["hidden_size"], arch["intermediate_size"],
               arch["num_conv_pos_embedding_groups"])
    k = arch["num_conv_pos_embeddings"]
    spec += [("feat_proj.ln_scale", (cin,), "ones"),
             ("feat_proj.ln_bias", (cin,), "zeros"),
             ("feat_proj.kernel", (d, cin), 1 / math.sqrt(cin)),
             ("feat_proj.bias", (d,), 1 / math.sqrt(cin)),
             ("pos_conv.kernel", (d, d // g, k), math.sqrt(3.0 * g / (k * d))),
             ("pos_conv.bias", (d,), "zeros"),
             ("encoder_ln.scale", (d,), "ones"),
             ("encoder_ln.bias", (d,), "zeros")]
    for i in range(arch["num_hidden_layers"]):
        spec += _layer(f"layers.{i}", d, f, key_bias=True)
    return spec


def _layer(pre: str, d: int, f: int, key_bias: bool) -> Spec:
    b = 1 / math.sqrt(d)
    names = ["qw", "qb", "kw"] + (["kb"] if key_bias else []) + [
        "vw", "vb", "ow", "ob"]
    spec: Spec = [(f"{pre}.attn.{n}", (d, d) if n.endswith("w") else (d,), b)
                  for n in names]
    for ln in ("ln1", "ln2"):
        spec += [(f"{pre}.{ln}.scale", (d,), "ones"),
                 (f"{pre}.{ln}.bias", (d,), "zeros")]
    spec += [(f"{pre}.ffn.w1", (f, d), b), (f"{pre}.ffn.b1", (f,), b),
             (f"{pre}.ffn.w2", (d, f), 1 / math.sqrt(f)),
             (f"{pre}.ffn.b2", (d,), 1 / math.sqrt(f))]
    return spec


def _whisper(arch: dict) -> Spec:
    d, f, m = arch["d_model"], arch["ffn_dim"], arch["num_mel_bins"]
    spec: Spec = [("conv1.kernel", (d, m, 3), 1 / math.sqrt(3 * m)),
                  ("conv1.bias", (d,), "zeros"),
                  ("conv2.kernel", (d, d, 3), 1 / math.sqrt(3 * d)),
                  ("conv2.bias", (d,), "zeros"),
                  ("pos_embed", (arch["max_source_positions"], d),
                   sinusoids(arch["max_source_positions"], d)),
                  ("final_ln.scale", (d,), "ones"),
                  ("final_ln.bias", (d,), "zeros")]
    for i in range(arch["num_hidden_layers"]):
        spec += _layer(f"layers.{i}", d, f, key_bias=False)
    return spec


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
    spec = (_wav2vec2 if config["encoder"] == "wav2vec2" else _whisper)(
        config["architecture"])
    return make(spec, sub_seed(seed, "encoder"), device)


def fusion_weights(config: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    p = config["pipeline"]
    spec = fusion_spec(tpp_dim(config), p["projection_hidden_dim"],
                       p["projection_output_dim"],
                       tuple(p["detection_hidden_dims"]))
    return make(spec, sub_seed(seed, "fusion"), device)


def tpp_dim(config: dict) -> int:
    arch = config["architecture"]
    width = arch.get("hidden_size", arch.get("d_model"))
    return sum(config["pipeline"]["tpp_levels"]) * width
