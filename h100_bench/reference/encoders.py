"""What every encoder file (``encoders/<name>.py``) shares, and the clip
embedding built on an encoder file's plain forward.

Shared: the layer norm, the attention and the FFN of a transformer layer,
a layer's weight names and scales (``layer_spec``), its operations
(``layer_flops``) and a convolution's output length.

A clip is cut into 2 s windows at a 1 s hop; each window's features are
pooled by TPP over levels (1, 2, 4) with max (bin i of n over T frames
covers [floor(i T / n), ceil((i + 1) T / n))), and the clip's embedding is
the mean over its windows.

Parameters come as a mapping of names to tensors (the names of the
encoder file's ``weights``, drawn by ``harness/weights.py``). Every product
goes through ``precision``: ``kind`` picks its rounding, so the same code
is the reference (``"exact"``, float32 with TF32 off) and its controls.
"""

from __future__ import annotations

import math
from typing import List, Mapping, Sequence, Tuple

import torch
import torch.nn.functional as F

from reference import precision as P

Spec = List[Tuple[str, tuple, object]]  # (name, shape, bound | "ones" | "zeros" | tensor)


def ln(x, p, name, eps):
    return F.layer_norm(x, (x.shape[-1],), p[f"{name}.scale"],
                        p[f"{name}.bias"], eps)


def attention(x, p, pre: str, heads: int, kind: str):
    b, t, d = x.shape
    hd = d // heads
    q = P.linear(x, p[f"{pre}.qw"], p[f"{pre}.qb"], kind) * hd ** -0.5
    k = P.linear(x, p[f"{pre}.kw"], p.get(f"{pre}.kb"), kind)
    v = P.linear(x, p[f"{pre}.vw"], p[f"{pre}.vb"], kind)

    def split(z):
        return z.reshape(b, t, heads, hd).transpose(1, 2)

    logits = P.matmul(split(q), split(k).transpose(-1, -2), kind)
    w = torch.softmax(logits, dim=-1)
    ctx = P.matmul(w, split(v), kind).transpose(1, 2).reshape(b, t, d)
    return P.linear(ctx, p[f"{pre}.ow"], p[f"{pre}.ob"], kind)


def ffn(x, p, pre: str, kind: str):
    h = F.gelu(P.linear(x, p[f"{pre}.w1"], p[f"{pre}.b1"], kind))
    return P.linear(h, p[f"{pre}.w2"], p[f"{pre}.b2"], kind)


def layer_spec(pre: str, d: int, f: int, key_bias: bool) -> Spec:
    b = 1 / math.sqrt(d)
    names = ["qw", "qb", "kw"] + (["kb"] if key_bias else []) + [
        "vw", "vb", "ow", "ob"]
    spec: Spec = [(f"{pre}.attn.{n}", (d, d) if n.endswith("w") else (d,), b)
                  for n in names]
    for norm in ("ln1", "ln2"):
        spec += [(f"{pre}.{norm}.scale", (d,), "ones"),
                 (f"{pre}.{norm}.bias", (d,), "zeros")]
    spec += [(f"{pre}.ffn.w1", (f, d), b), (f"{pre}.ffn.b1", (f,), b),
             (f"{pre}.ffn.w2", (d, f), 1 / math.sqrt(f)),
             (f"{pre}.ffn.b2", (d,), 1 / math.sqrt(f))]
    return spec


def conv_out(n: int, k: int, s: int, pad: int = 0) -> int:
    return (n + 2 * pad - k) // s + 1


def layer_flops(t: int, d: int, f: int) -> float:
    """One transformer layer over ``t`` frames: q, k, v, o; the FFN; the
    logits and the weighted sum (a multiply-add counts as 2)."""
    return 2.0 * t * (4 * d * d + 2 * d * f) + 4.0 * t * t * d


def tpp(features: torch.Tensor, levels: Sequence[int]) -> torch.Tensor:
    """Max pyramid pooling ``[..., T, D]`` → ``[..., sum(levels) D]``."""
    t = features.shape[-2]
    outs = []
    for level in levels:
        for i in range(level):
            lo, hi = math.floor(i * t / level), math.ceil((i + 1) * t / level)
            outs.append(features[..., lo:hi, :].amax(-2))
    return torch.cat(outs, -1)


def windows(audio: torch.Tensor, seg: int, hop: int) -> torch.Tensor:
    """``audio [B, N]`` → ``[B, S, seg]``, zero past the end."""
    n = audio.shape[-1]
    s = max(1, (n - seg) // hop + 1)
    if (s - 1) * hop + seg > n:
        audio = F.pad(audio, (0, (s - 1) * hop + seg - n))
    return torch.stack([audio[:, i * hop:i * hop + seg] for i in range(s)],
                       1)


def clip_embeddings(encoder, p, config: dict, audio: torch.Tensor, *,
                    kinds: Mapping[str, str] = None,
                    block: int = 16) -> torch.Tensor:
    """Clip embeddings ``[B, D_tpp]`` (float32) of ``audio [B, N]``, the
    encoder file ``encoder``'s ``features`` run ``block`` windows at a
    time. ``kinds``: the rounding of each stage ("encoder", "mel"),
    "exact" where absent."""
    kinds = dict(kinds or {})
    arch, pipe = config["architecture"], config["pipeline"]
    sr = pipe["sample_rate"]
    seg = int(pipe["segment_length"] * sr)
    hop = int(seg * (1 - pipe["segment_overlap"]))
    wins = windows(audio.float(), seg, hop)
    b, s = wins.shape[:2]
    flat = wins.reshape(b * s, seg)
    out = []
    for lo in range(0, flat.shape[0], block):
        feats = encoder.features(p, arch, pipe, flat[lo:lo + block], kinds)
        out.append(tpp(feats, pipe["tpp_levels"]))
    return torch.cat(out).reshape(b, s, -1).mean(1)
