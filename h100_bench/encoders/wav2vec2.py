"""wav2vec2 base (facebook/wav2vec2-base-960h): 7 strided convolutions of
512 channels (group norm over time on the first, GELU after each), LN and
a linear projection to 768, a grouped positional convolution (128 taps,
16 groups, one trailing frame dropped, GELU) added to it, the encoder LN,
then 12 post-LN layers (12 heads, FFN 3,072, exact GELU). The features
are the mean of the hidden states that ``wav2vec2_layers_to_use`` names
(the last four).

The encoder file of ``"encoder": "wav2vec2"``: its weights, plain forward,
operations, attention shape, frame width, CPU cut and the port's classes,
as ``harness/common.py::encoder`` lists them.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from reference import encoders as RE
from reference import precision as P

# the port's module of radad_tpu_torch.models, config class and model class
PORT = ("wav2vec2", "Wav2Vec2Config", "Wav2Vec2Model")

TINY = {"architecture": dict(
    hidden_size=32, num_hidden_layers=2, num_attention_heads=4,
    intermediate_size=64, conv_dim=[16] * 7, num_conv_pos_embeddings=16,
    num_conv_pos_embedding_groups=4), "pipeline": {}}


def weights(arch: dict) -> RE.Spec:
    spec: RE.Spec = []
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
        spec += RE.layer_spec(f"layers.{i}", d, f, key_bias=True)
    return spec


def features(p, arch: dict, pipe: dict, segments: torch.Tensor,
             kinds) -> torch.Tensor:
    """``segments [N, L]`` → features ``[N, T, D]`` (float32)."""
    if arch["feat_extract_norm"] != "group" or arch["do_stable_layer_norm"]:
        raise ValueError("the reference is written for the base models")
    kind = kinds.get("encoder", "exact")
    eps = arch["layer_norm_eps"]
    x = segments.float()
    if pipe["input_normalize"]:  # zero mean, unit variance a window (eps 1e-7)
        mean = x.mean(-1, keepdim=True)
        var = (x - mean).square().mean(-1, keepdim=True)
        x = (x - mean) / torch.sqrt(var + 1e-7)
    x = x[:, None, :]
    for i, stride in enumerate(arch["conv_stride"]):
        x = P.conv1d(x, p[f"conv_layers.{i}.kernel"],
                     p.get(f"conv_layers.{i}.bias"), stride, 0, 1, kind)
        if i == 0:
            x = F.group_norm(x, x.shape[1], p["conv_layers.0.norm_scale"],
                             p["conv_layers.0.norm_bias"], 1e-5)
        x = F.gelu(x)
    x = x.transpose(1, 2)
    x = F.layer_norm(x, (x.shape[-1],), p["feat_proj.ln_scale"],
                     p["feat_proj.ln_bias"], eps)
    x = P.linear(x, p["feat_proj.kernel"], p["feat_proj.bias"], kind)
    k = arch["num_conv_pos_embeddings"]
    pos = P.conv1d(x.transpose(1, 2), p["pos_conv.kernel"],
                   p["pos_conv.bias"], 1, k // 2,
                   arch["num_conv_pos_embedding_groups"], kind)
    if k % 2 == 0:
        pos = pos[:, :, :-1]
    x = x + F.gelu(pos.transpose(1, 2))
    x = RE.ln(x, p, "encoder_ln", eps)
    heads = arch["num_attention_heads"]
    hidden = [x]
    for i in range(arch["num_hidden_layers"]):
        pre = f"layers.{i}"
        x = RE.ln(x + RE.attention(x, p, f"{pre}.attn", heads, kind), p,
                  f"{pre}.ln1", eps)
        x = RE.ln(x + RE.ffn(x, p, f"{pre}.ffn", kind), p, f"{pre}.ln2",
                  eps)
        hidden.append(x)
    n = len(hidden)
    return torch.stack([hidden[i % n]
                        for i in pipe["wav2vec2_layers_to_use"]]).mean(0)


def _frames(arch: dict, pipe: dict) -> int:
    n = int(pipe["segment_length"] * pipe["sample_rate"])
    for k, s in zip(arch["conv_kernel"], arch["conv_stride"]):
        n = RE.conv_out(n, k, s)
    return n


def segment_flops(arch: dict, pipe: dict) -> float:
    flops, n, cin = 0.0, int(pipe["segment_length"] * pipe["sample_rate"]), 1
    for c, k, s in zip(arch["conv_dim"], arch["conv_kernel"],
                       arch["conv_stride"]):
        n = RE.conv_out(n, k, s)
        flops += 2.0 * n * c * cin * k
        cin = c
    d, f = arch["hidden_size"], arch["intermediate_size"]
    g, kp = arch["num_conv_pos_embedding_groups"], arch["num_conv_pos_embeddings"]
    flops += 2.0 * n * cin * d  # feature projection
    flops += 2.0 * n * d * (d // g) * kp  # positional convolution
    return flops + arch["num_hidden_layers"] * RE.layer_flops(n, d, f)


def attention(arch: dict, pipe: dict):
    h = arch["num_attention_heads"]
    return _frames(arch, pipe), h, arch["hidden_size"] // h


def width(arch: dict) -> int:
    return arch["hidden_size"]
