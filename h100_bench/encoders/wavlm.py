"""WavLM large (microsoft/wavlm-large; arXiv:2110.13900): 7 strided
convolutions of 512 channels, each with a bias and followed by a LayerNorm
over channels and GELU; LN and a linear projection to 1,024; a grouped
positional convolution (128 taps, 16 groups, one trailing frame dropped,
GELU) added to it; 24 pre-LN layers (16 heads of 64, FFN 4,096, exact
GELU) whose attention logits carry the gated relative position bias; the
encoder LN after the last layer. The features are the last hidden state,
as the reference's WavLM extractor returns it.

The gated relative position bias (HF ``WavLMAttention``):

  pos[h, i, j] = rel_attn_embed[bucket(j - i), h]     T5 bidirectional buckets
  g            = Linear(64 → 8)(LN1(x) split per head) per token and head
  a, b         = sigmoid(g viewed [..., 2, 4] summed over the last axis)
  gate[t, h]   = a (b gru_rel_pos_const[h] - 1) + 2
  logits       = (q 64^-0.5) kᵀ + gate[i, h] pos[h, i, j]

Departures from HF's ``WavLMModel``, none of which changes the forward in
eval mode: the positional convolution's kernel is a plain tensor (HF keeps
it weight-normed as g and v; ``hf_convert.convert_wavlm`` materializes g v
/ |v|); the position bias is built once a forward from ``rel_attn_embed``
held outside the layers (HF keeps it in layer 0's attention and passes the
ungated bias on); no dropout, masking or attention mask (every window is
whole); q, k, v are three products (HF concatenates their biases for
``multi_head_attention_forward``); the input normalization of HF's
processor is applied here when ``input_normalize`` says so.

``kinds["rel_bias"] == "off"`` drops ``gate · pos`` from the logits: the
control that shows the comparison sees the mechanism.

The encoder file of ``"encoder": "wavlm"``: its weights, plain forward,
operations, attention shape, frame width, CPU cut and the port's classes,
as ``harness/common.py::encoder`` lists them. Names and shapes are those of
``radad_tpu_torch``'s ``WavLMModel`` state dict.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from reference import encoders as RE
from reference import precision as P

GATE_OUT = 8  # the gate's projection: two groups of 4, summed

# the port's module of radad_tpu_torch.models, config class and model class
PORT = ("wavlm", "WavLMConfig", "WavLMModel")

TINY = {"architecture": dict(
    hidden_size=32, num_hidden_layers=2, num_attention_heads=4,
    intermediate_size=64, conv_dim=[16] * 7, num_conv_pos_embeddings=16,
    num_conv_pos_embedding_groups=4), "pipeline": {}}


def weights(arch: dict) -> RE.Spec:
    """Convolutions uniform with the variance of normal / sqrt(fan_in),
    their biases uniform +-1/sqrt(fan_in) (``nn.Conv1d``'s); the gate's
    linear +-1/sqrt(head width), its constants 1; ``rel_attn_embed``
    uniform +-sqrt(3), unit variance as ``nn.Embedding``'s init."""
    spec: RE.Spec = []
    cin = 1
    for i, (c, k) in enumerate(zip(arch["conv_dim"], arch["conv_kernel"])):
        pre = f"conv_layers.{i}"
        spec.append((f"{pre}.kernel", (c, cin, k), math.sqrt(3.0 / (k * cin))))
        if arch["conv_bias"]:
            spec.append((f"{pre}.bias", (c,), 1 / math.sqrt(k * cin)))
        spec += [(f"{pre}.norm_scale", (c,), "ones"),
                 (f"{pre}.norm_bias", (c,), "zeros")]
        cin = c
    d, f, g = (arch["hidden_size"], arch["intermediate_size"],
               arch["num_conv_pos_embedding_groups"])
    k, h = arch["num_conv_pos_embeddings"], arch["num_attention_heads"]
    spec += [("feat_proj.ln_scale", (cin,), "ones"),
             ("feat_proj.ln_bias", (cin,), "zeros"),
             ("feat_proj.kernel", (d, cin), 1 / math.sqrt(cin)),
             ("feat_proj.bias", (d,), 1 / math.sqrt(cin)),
             ("pos_conv.kernel", (d, d // g, k), math.sqrt(3.0 * g / (k * d))),
             ("pos_conv.bias", (d,), math.sqrt(g / (k * d))),
             ("encoder_ln.scale", (d,), "ones"),
             ("encoder_ln.bias", (d,), "zeros")]
    hd = d // h
    for i in range(arch["num_hidden_layers"]):
        spec += RE.layer_spec(f"layers.{i}", d, f, key_bias=True)
        spec += [(f"layers.{i}.gate.w", (GATE_OUT, hd), 1 / math.sqrt(hd)),
                 (f"layers.{i}.gate.b", (GATE_OUT,), 1 / math.sqrt(hd)),
                 (f"layers.{i}.gate.const", (h,), "ones")]
    spec.append(("rel_attn_embed", (arch["num_buckets"], h), math.sqrt(3.0)))
    return spec


def buckets(t: int, num_buckets: int, max_distance: int) -> torch.Tensor:
    """T5's bidirectional bucket of ``j - i`` for query ``i`` and key ``j``,
    ``[T, T]`` int64: half the buckets for keys after the query; within a
    half, distances under a quarter of the buckets exact, the rest
    log-spaced up to ``max_distance`` (float32 logs, as HF's)."""
    half = num_buckets // 2
    pos = torch.arange(t)
    rel = pos[None, :] - pos[:, None]
    out = (rel > 0).long() * half
    dist = rel.abs()
    exact = half // 2
    far = (torch.log(dist.clamp_min(1).float() / exact)
           / math.log(max_distance / exact) * (half - exact))
    far = torch.clamp((exact + far).long(), max=half - 1)
    return out + torch.where(dist < exact, dist, far)


def gate(x, p, pre: str, heads: int, kind: str):
    """The layer's gate ``[B, H, T]`` from its attention input
    ``x [B, T, D]``."""
    b, t, d = x.shape
    g = P.linear(x.reshape(b, t, heads, d // heads), p[f"{pre}.gate.w"],
                 p[f"{pre}.gate.b"], kind)  # [B, T, H, 8]
    a, c = torch.sigmoid(g.reshape(b, t, heads, 2, 4).sum(-1)).unbind(-1)
    return (a * (c * p[f"{pre}.gate.const"] - 1.0) + 2.0).transpose(1, 2)


def self_attention(x, p, pre: str, heads: int, kind: str, pos):
    """Self-attention over ``x [B, T, D]`` with the gated bias ``gate · pos``
    added to the logits (``pos [H, T, T]``, or None for none)."""
    b, t, d = x.shape
    hd = d // heads
    q = P.linear(x, p[f"{pre}.attn.qw"], p[f"{pre}.attn.qb"], kind)
    q = q * hd ** -0.5
    k = P.linear(x, p[f"{pre}.attn.kw"], p[f"{pre}.attn.kb"], kind)
    v = P.linear(x, p[f"{pre}.attn.vw"], p[f"{pre}.attn.vb"], kind)

    def split(z):
        return z.reshape(b, t, heads, hd).transpose(1, 2)

    logits = P.matmul(split(q), split(k).transpose(-1, -2), kind)
    if pos is not None:
        logits = logits + gate(x, p, pre, heads, kind)[..., None] * pos
    w = torch.softmax(logits, dim=-1)
    ctx = P.matmul(w, split(v), kind).transpose(1, 2).reshape(b, t, d)
    return P.linear(ctx, p[f"{pre}.attn.ow"], p[f"{pre}.attn.ob"], kind)


def features(p, arch: dict, pipe: dict, segments: torch.Tensor,
             kinds) -> torch.Tensor:
    """``segments [N, L]`` → the last hidden state ``[N, T, D]``
    (float32)."""
    if (arch["feat_extract_norm"] != "layer"
            or not arch["do_stable_layer_norm"]):
        raise ValueError("the reference is written for the large model: "
                         "layer-norm front end, pre-LN layers")
    kind = kinds.get("encoder", "exact")
    eps = arch["layer_norm_eps"]
    x = segments.float()
    if pipe["input_normalize"]:  # zero mean, unit variance a window (eps 1e-7)
        mean = x.mean(-1, keepdim=True)
        var = (x - mean).square().mean(-1, keepdim=True)
        x = (x - mean) / torch.sqrt(var + 1e-7)
    x = x[:, None, :]
    for i, stride in enumerate(arch["conv_stride"]):
        pre = f"conv_layers.{i}"
        x = P.conv1d(x, p[f"{pre}.kernel"], p.get(f"{pre}.bias"), stride, 0,
                     1, kind).transpose(1, 2)
        x = F.layer_norm(x, (x.shape[-1],), p[f"{pre}.norm_scale"],
                         p[f"{pre}.norm_bias"], 1e-5)
        x = F.gelu(x).transpose(1, 2)
    x = x.transpose(1, 2)
    x = F.layer_norm(x, (x.shape[-1],), p["feat_proj.ln_scale"],
                     p["feat_proj.ln_bias"], eps)
    x = P.linear(x, p["feat_proj.kernel"], p["feat_proj.bias"], kind)
    k = arch["num_conv_pos_embeddings"]
    pos_emb = P.conv1d(x.transpose(1, 2), p["pos_conv.kernel"],
                       p["pos_conv.bias"], 1, k // 2,
                       arch["num_conv_pos_embedding_groups"], kind)
    if k % 2 == 0:
        pos_emb = pos_emb[:, :, :-1]
    x = x + F.gelu(pos_emb.transpose(1, 2))
    heads, t = arch["num_attention_heads"], x.shape[1]
    pos = None
    if kinds.get("rel_bias", "on") != "off":
        idx = buckets(t, arch["num_buckets"], arch["max_bucket_distance"])
        pos = p["rel_attn_embed"][idx.to(x.device)].permute(2, 0, 1)
    for i in range(arch["num_hidden_layers"]):
        pre = f"layers.{i}"
        x = x + self_attention(RE.ln(x, p, f"{pre}.ln1", eps), p, pre, heads,
                               kind, pos)
        x = x + RE.ffn(RE.ln(x, p, f"{pre}.ln2", eps), p, f"{pre}.ffn", kind)
    return RE.ln(x, p, "encoder_ln", eps)


def _frames(arch: dict, pipe: dict) -> int:
    n = int(pipe["segment_length"] * pipe["sample_rate"])
    for k, s in zip(arch["conv_kernel"], arch["conv_stride"]):
        n = RE.conv_out(n, k, s)
    return n


def segment_flops(arch: dict, pipe: dict) -> float:
    """The convolutions, the feature projection, the positional
    convolution, and per layer its products and the gate's projection
    (2 T H head-width 8)."""
    flops, n, cin = 0.0, int(pipe["segment_length"] * pipe["sample_rate"]), 1
    for c, k, s in zip(arch["conv_dim"], arch["conv_kernel"],
                       arch["conv_stride"]):
        n = RE.conv_out(n, k, s)
        flops += 2.0 * n * c * cin * k
        cin = c
    d, f = arch["hidden_size"], arch["intermediate_size"]
    g = arch["num_conv_pos_embedding_groups"]
    kp = arch["num_conv_pos_embeddings"]
    flops += 2.0 * n * cin * d  # feature projection
    flops += 2.0 * n * d * (d // g) * kp  # positional convolution
    gate_flops = 2.0 * n * d * GATE_OUT  # H heads of d / H columns
    return flops + arch["num_hidden_layers"] * (RE.layer_flops(n, d, f)
                                                + gate_flops)


def attention(arch: dict, pipe: dict):
    h = arch["num_attention_heads"]
    return _frames(arch, pipe), h, arch["hidden_size"] // h


def width(arch: dict) -> int:
    return arch["hidden_size"]
