"""Wav2Vec2 encoder as a frozen PyTorch module.

Counterpart: ``radad_tpu/models/wav2vec2.py``. Raw waveform → 7-layer
strided conv feature encoder → feature projection → convolutional
positional embedding → transformer. ``extract_features`` means hidden
layers (-4..-1), as the reference does (feature_extractor.py:32-41).

Base models (``feat_extract_norm="group"``): group norm on the first conv
layer, post-LN layers after the encoder LN. Large lv60/xlsr/HuBERT-large
models (``feat_extract_norm="layer"``, ``do_stable_layer_norm=True``): an LN
over channels after every conv (with conv bias), pre-LN layers, and the
encoder LN after the stack.

Parameters keep the JAX pytree's names (``conv_layers[i].kernel``,
``feat_proj``, ``pos_conv``, ``encoder_ln``, ``layers[i].attn.qw`` ...) in
PyTorch layouts; the JAX package stacks the layers on one axis for
``lax.scan``, here they are a ``ModuleList`` run in a loop.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch
from torch import nn

from radad_tpu_torch.models import encoder_common as C
from radad_tpu_torch.utils.profiling import annotate


@dataclasses.dataclass(frozen=True)
class Wav2Vec2Config:
    """Architecture hyperparameters; defaults = facebook/wav2vec2-base-960h."""

    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    conv_dim: Tuple[int, ...] = (512, 512, 512, 512, 512, 512, 512)
    conv_kernel: Tuple[int, ...] = (10, 3, 3, 3, 3, 2, 2)
    conv_stride: Tuple[int, ...] = (5, 2, 2, 2, 2, 2, 2)
    conv_bias: bool = False
    feat_extract_norm: str = "group"  # "group" (base) or "layer" (large)
    num_conv_pos_embeddings: int = 128
    num_conv_pos_embedding_groups: int = 16
    layer_norm_eps: float = 1e-5
    do_stable_layer_norm: bool = False  # base models are post-LN

    @property
    def feature_dim(self) -> int:
        return self.hidden_size

    def frames_for_samples(self, n: int) -> int:
        for k, s in zip(self.conv_kernel, self.conv_stride):
            n = C.conv_output_length(n, k, s)
        return n


def _param(*shape) -> nn.Parameter:
    return nn.Parameter(torch.zeros(shape), requires_grad=False)


def _ln(d: int) -> nn.ParameterDict:
    return nn.ParameterDict({
        "scale": nn.Parameter(torch.ones(d), requires_grad=False),
        "bias": _param(d)})


class Wav2Vec2Model(nn.Module):
    """Frozen parameters of one wav2vec2 encoder (zeros until initialized
    by ``init_params`` or filled by a converter)."""

    def __init__(self, cfg: Wav2Vec2Config):
        super().__init__()
        if cfg.feat_extract_norm not in ("group", "layer"):
            raise ValueError(f"feat_extract_norm must be 'group' or 'layer', "
                             f"got {cfg.feat_extract_norm!r}")
        self.cfg = cfg
        self.conv_layers = nn.ModuleList()
        in_dim = 1
        for i, (out_dim, k) in enumerate(zip(cfg.conv_dim, cfg.conv_kernel)):
            layer = nn.ParameterDict({"kernel": _param(out_dim, in_dim, k)})
            if cfg.conv_bias:
                layer["bias"] = _param(out_dim)
            if i == 0 or cfg.feat_extract_norm == "layer":
                layer["norm_scale"] = nn.Parameter(torch.ones(out_dim),
                                                   requires_grad=False)
                layer["norm_bias"] = _param(out_dim)
            self.conv_layers.append(layer)
            in_dim = out_dim
        d, c = cfg.hidden_size, cfg.conv_dim[-1]
        self.feat_proj = nn.ParameterDict({
            "ln_scale": nn.Parameter(torch.ones(c), requires_grad=False),
            "ln_bias": _param(c), "kernel": _param(d, c), "bias": _param(d)})
        g = cfg.num_conv_pos_embedding_groups
        self.pos_conv = nn.ParameterDict({
            "kernel": _param(d, d // g, cfg.num_conv_pos_embeddings),
            "bias": _param(d)})
        self.encoder_ln = _ln(d)
        f = cfg.intermediate_size
        self.layers = nn.ModuleList(nn.ModuleDict({
            "attn": nn.ParameterDict({
                name: _param(d, d) if name.endswith("w") else _param(d)
                for name in ("qw", "qb", "kw", "kb", "vw", "vb", "ow", "ob")}),
            "ln1": _ln(d),
            "ffn": nn.ParameterDict({"w1": _param(f, d), "b1": _param(f),
                                     "w2": _param(d, f), "b2": _param(d)}),
            "ln2": _ln(d),
        }) for _ in range(cfg.num_hidden_layers))


def feature_encoder(model: Wav2Vec2Model, waveform: torch.Tensor
                    ) -> torch.Tensor:
    """Strided conv stack: ``[B, T_samples]`` → ``[B, T_frames, C]``.
    First layer group-normed ("group") or every layer LN'd over channels
    ("layer": ``conv1d_ln_gelu``, one kernel a layer in bf16 on the card),
    GELU after every conv, no padding. In a trace, one
    ``radad.encoder.frontend`` span."""
    cfg = model.cfg
    x = waveform[:, None, :]  # [B, 1, T]
    with annotate("radad.encoder.frontend"):
        for i, layer in enumerate(model.conv_layers):
            conv = (layer["kernel"], layer.get("bias"), cfg.conv_stride[i])
            if "norm_scale" not in layer:
                x = C.conv1d_gelu(x, *conv, 0)
            elif cfg.feat_extract_norm == "layer":
                x = C.conv1d_ln_gelu(x, *conv, layer["norm_scale"],
                                     layer["norm_bias"])
            else:  # one step a line, so each frees the last
                x = C.conv1d(x, *conv, 0)
                x = C.instance_norm_channels(x, layer["norm_scale"],
                                             layer["norm_bias"])
                x = C.gelu_bias(x)
        return x.transpose(1, 2)


def positional_conv(model: Wav2Vec2Model, x: torch.Tensor) -> torch.Tensor:
    """Grouped conv positional embedding on ``[B, T, D]``: padding k//2,
    GELU, one trailing frame dropped for even k (the GELU is elementwise:
    taken on the whole conv output, which is contiguous, it gives the
    trimmed frames' bits)."""
    cfg = model.cfg
    k = cfg.num_conv_pos_embeddings
    out = C.conv1d_gelu(x.transpose(1, 2), model.pos_conv["kernel"],
                        model.pos_conv["bias"], stride=1, padding=k // 2,
                        groups=cfg.num_conv_pos_embedding_groups)
    if k % 2 == 0:
        out = out[:, :, :-1]
    return out.transpose(1, 2)


def embed_frames(model: Wav2Vec2Model, waveform: torch.Tensor,
                 dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Conv stack → feature projection (LN → linear) → + positional conv:
    the transformer's input ``[B, T_frames, D]`` before any encoder LN, in
    ``dtype`` (the waveform is rounded to it first, as JAX's ``encode``)."""
    feats = feature_encoder(model, waveform.to(dtype))
    fp = model.feat_proj
    x = C.layer_norm(feats, fp["ln_scale"], fp["ln_bias"],
                     model.cfg.layer_norm_eps)
    x = C.linear(x, fp["kernel"], fp["bias"])
    return x + positional_conv(model, x)


def encode(model: Wav2Vec2Model, waveform: torch.Tensor,
           dtype: torch.dtype = torch.float32) -> list:
    """Full forward in ``dtype``: ``[B, T_samples]`` → hidden states, a list
    of L+1 ``[B, T_frames, D]`` in HF's ordering: entry i < L is layer i's
    input (entry 0 after the encoder LN in base models), entry L the last
    layer's output (after the encoder LN in stable-LN models)."""
    cfg = model.cfg
    eps, heads = cfg.layer_norm_eps, cfg.num_attention_heads
    x = embed_frames(model, waveform, dtype)
    enc_ln = model.encoder_ln
    if not cfg.do_stable_layer_norm:
        x = C.layer_norm(x, enc_ln["scale"], enc_ln["bias"], eps)
    layer_fn = C.pre_ln_layer if cfg.do_stable_layer_norm else C.post_ln_layer
    hidden = [x]
    tp = getattr(model, "tp", None)  # parallel/tp.py's shard
    for layer in model.layers:
        x = layer_fn(x, layer, heads, eps, tp=tp)
        hidden.append(x)
    if cfg.do_stable_layer_norm:
        hidden[-1] = C.layer_norm(x, enc_ln["scale"], enc_ln["bias"], eps)
    return hidden


def extract_features(model: Wav2Vec2Model, waveform: torch.Tensor,
                     layers_to_use=(-4, -3, -2, -1),
                     dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Mean over the selected hidden-state layers → ``[B, T_frames, D]``
    f32 (reference feature_extractor.py:32-41). In bf16 the mean sums in
    f32, rounds to bf16 and then goes to f32, as ``jnp.mean`` of bf16
    hidden states followed by ``astype(f32)``."""
    hs = encode(model, waveform, dtype)
    n = len(hs)
    picked = torch.stack([hs[i % n] for i in layers_to_use])
    return picked.mean(0).float()


@torch.no_grad()
def init_params(model: Wav2Vec2Model, generator: torch.Generator
                ) -> Wav2Vec2Model:
    """Seeded random init with the JAX package's scales (normal /
    sqrt(fan_in) for convs, uniform ±1/sqrt(fan_in) for linears; the
    numbers differ from JAX's, whose generator differs)."""
    def normal_(p, fan_in):
        p.copy_(torch.randn(p.shape, generator=generator) / fan_in ** 0.5)

    def uniform_(p, fan_in):
        bound = 1.0 / fan_in ** 0.5
        p.copy_(torch.empty(p.shape).uniform_(-bound, bound,
                                              generator=generator))

    cfg = model.cfg
    for layer in model.conv_layers:
        _, cin, k = layer["kernel"].shape
        normal_(layer["kernel"], k * cin)
    uniform_(model.feat_proj["kernel"], cfg.conv_dim[-1])
    uniform_(model.feat_proj["bias"], cfg.conv_dim[-1])
    d = cfg.hidden_size
    normal_(model.pos_conv["kernel"], cfg.num_conv_pos_embeddings * d
            / cfg.num_conv_pos_embedding_groups)
    for layer in model.layers:
        for name, p in layer["attn"].items():
            uniform_(p, d)
        ffn = layer["ffn"]
        uniform_(ffn["w1"], d)
        uniform_(ffn["b1"], d)
        uniform_(ffn["w2"], cfg.intermediate_size)
        uniform_(ffn["b2"], cfg.intermediate_size)
    return model
