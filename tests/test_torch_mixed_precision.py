"""The port's mixed-precision mode (``use_mixed_precision``: the encoders
and the fusion model compute in bf16, parameters f32) against the JAX
package's, on the CPU, with the same seeded numpy inputs and weights
(``models/convert.py``).

JAX runs op by op here (``jax.disable_jit``): every bf16 op then rounds
its result as the JAX source writes it, and those are the rounding points
the port mirrors. Compiled, XLA on the CPU drops the bf16 rounding of a
value whose next use upcasts it to f32 (it keeps excess precision): the
q·kᵀ logits of ``mha_reference`` come out in f32, and a residual sum
entering a LayerNorm is not rounded. The compiled encoder's features lie
0.50 % (relative) from the op-by-op ones, against 1.03 % between bf16 and
f32 (``test_compiled_jax_keeps_excess_precision``).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radad_tpu.models import encoder_common as JC
from radad_tpu.models import wav2vec2 as jw
from radad_tpu.models import wavlm as jl
from radad_tpu.models.encoder import FrozenEncoder as JEnc
from radad_tpu.ops import attention as JA
from radad_tpu_torch.models import encoder_common as TC
from radad_tpu_torch.models import wav2vec2 as tw
from radad_tpu_torch.models import wavlm as tl
from radad_tpu_torch.models.convert import (encoder_from_jax,
                                            fusion_from_flax, wavlm_from_jax)
from radad_tpu_torch.models.encoder import FrozenEncoder as TEnc
from radad_tpu_torch.ops import attention as TA

from test_torch_encoder import TINY

BF16 = jnp.bfloat16
ULP = 2.0 ** -7  # bf16's spacing in [1, 2): one step is <= ULP * |x|


def _np32(x) -> np.ndarray:
    """A JAX or torch array as f32 numpy."""
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _rel(a, b) -> float:
    """Relative Frobenius distance of ``a`` from ``b``."""
    a, b = _np32(a).astype(np.float64), _np32(b).astype(np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _within_steps(got, want, share: float = 1e-3, atol: float = 0.0):
    """``got`` equal to ``want`` but for at most ``share`` of the entries,
    each within one bf16 step of ``want`` (plus ``atol``)."""
    got, want = _np32(got), _np32(want)
    diff = np.abs(got - want)
    assert (diff <= ULP * np.abs(want) + atol).all(), float(diff.max())
    assert np.mean(diff > 0) <= share, float(np.mean(diff > 0))


# ------------------------------------------------------------ per function
def _fn_pair(name, rng):
    """(JAX result, port result, the bf16 input) of one encoder function on
    the same bf16 inputs and f32 parameters; conv and norm layouts
    converted."""
    x = (2.0 * rng.standard_normal((3, 40, 16)) + 0.5).astype(np.float32)
    w = rng.standard_normal((16, 24)).astype(np.float32) / 4
    bias = rng.standard_normal(24).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, 16).astype(np.float32)
    shift = rng.standard_normal(16).astype(np.float32)
    kern = rng.standard_normal((5, 4, 24)).astype(np.float32) / 4  # [K,Cin/g,O]
    xj, xt = jnp.asarray(x, BF16), torch.as_tensor(x).bfloat16()
    ncl = xt.transpose(1, 2)  # the port's conv layout [B, C, T]
    if name == "gelu":
        return JC.gelu(xj), TC.gelu(xt), xt
    if name == "linear":
        return (JC.linear(xj, jnp.asarray(w), jnp.asarray(bias)),
                TC.linear(xt, torch.as_tensor(w.T.copy()),
                          torch.as_tensor(bias)), xt)
    if name == "conv1d":  # 4 groups, strided, padded: the positional conv's
        # grouping and the front end's stride
        return (JC.conv1d(xj, jnp.asarray(kern), jnp.asarray(bias), stride=2,
                          padding=2, groups=4),
                TC.conv1d(ncl, torch.as_tensor(kern.transpose(2, 1, 0).copy()),
                          torch.as_tensor(bias), 2, 2, groups=4
                          ).transpose(1, 2), xt)
    if name == "instance_norm_channels":
        return (JC.instance_norm_channels(xj, jnp.asarray(scale),
                                          jnp.asarray(shift)),
                TC.instance_norm_channels(ncl, torch.as_tensor(scale),
                                          torch.as_tensor(shift)
                                          ).transpose(1, 2), xt)
    if name == "layer_norm":
        return (JC.layer_norm(xj, jnp.asarray(scale), jnp.asarray(shift)),
                TC.layer_norm(xt, torch.as_tensor(scale),
                              torch.as_tensor(shift)), xt)
    raise ValueError(name)


@pytest.mark.parametrize("name", ["gelu", "linear", "conv1d",
                                  "instance_norm_channels", "layer_norm"])
def test_encoder_function_rounds_as_jax(name, rng):
    """Each function in bf16 against JAX's: bf16 out, equal entries but for
    at most 0.1 % within one bf16 step (f32 sums in another order decide a
    rounding tie; measured: all equal). GELU is the tanh form (exact GELU
    differs on many entries: the control), linear and conv round the
    product before the bias."""
    with jax.disable_jit():
        want, got, x = _fn_pair(name, rng)
    assert got.dtype == torch.bfloat16 and want.dtype == BF16
    _within_steps(got, want)
    if name == "gelu":
        exact = torch.nn.functional.gelu(x.float()).bfloat16()
        assert np.mean(_np32(exact) != _np32(want)) > 0.01


def _attn_inputs(rng, b, t, h, hd, bias):
    d = h * hd
    q, k, v = (rng.standard_normal((b, t, d)).astype(np.float32)
               for _ in range(3))
    q *= hd ** -0.5
    extra = {}
    if bias:
        extra = dict(gate=(1.0 + 2.0 * rng.random((b, t, h))).astype(
            np.float32), pos_bias=rng.standard_normal((h, t, t)).astype(
            np.float32))
    return (q, k, v), extra


@pytest.mark.parametrize("bias", [False, True])
def test_mha_reference_bf16_logits_match_jax(bias, rng):
    """mha_reference in bf16: the q·kᵀ logits rounded to bf16, then f32 for
    the bias and the softmax, weights in bf16, p·v in f32, bf16 out —
    within one bf16 step of JAX's on 0.1 % of the entries at most. The
    same function with f32 logits (the compiled-XLA form, the control)
    differs on many more."""
    (q, k, v), extra = _attn_inputs(rng, 2, 99, 4, 16, bias)
    jin = [jnp.asarray(a, BF16) for a in (q, k, v)]
    tin = [torch.as_tensor(a).bfloat16() for a in (q, k, v)]
    jex = {n: jnp.asarray(a, BF16) for n, a in extra.items()}
    tex = {n: torch.as_tensor(a).bfloat16() for n, a in extra.items()}
    with jax.disable_jit():
        want = JA.mha_reference(*jin, 4, **jex)
    got = TA.mha_reference(*tin, 4, **tex)
    assert got.dtype == torch.bfloat16
    _within_steps(got, want)
    f32_logits = TA.fused_mha_plain(*tin, 4, **tex)
    assert np.mean(_np32(f32_logits) != _np32(want)) > 0.05


@pytest.mark.parametrize("bias", [False, True])
@pytest.mark.parametrize("t,hd", [(99, 64), (600, 16), (99, 80)])
def test_fused_mha_bf16_matches_pallas_interpret(t, hd, bias, rng):
    """The port's fused_mha on bf16 CPU tensors (its plain version) against
    JAX's Pallas fused_mha in interpret mode on the same bf16 inputs: f32
    logits from the bf16 operands, normalized weights in bf16, p·v in f32.
    Equal but on 1 % of the entries at most, each within one bf16 step
    plus 4e-3: the two f32 softmaxes round differently and may put a
    weight on the other side of a bf16 rounding tie (one step of a weight
    of ~0.25 times |v| ~ 2), and f32 sums in another order move an output
    near 0 by many of its own steps. No launch."""
    (q, k, v), extra = _attn_inputs(rng, 2, t, 2, hd, bias)
    want = JA.fused_mha(*(jnp.asarray(a, BF16) for a in (q, k, v)), 2,
                        interpret=True,
                        **{n: jnp.asarray(a, BF16) for n, a in extra.items()})
    before = TA.fused_mha.launches
    got = TA.fused_mha(*(torch.as_tensor(a).bfloat16() for a in (q, k, v)),
                       2, **{n: torch.as_tensor(a).bfloat16()
                             for n, a in extra.items()})
    assert TA.fused_mha.launches == before and got.dtype == torch.bfloat16
    _within_steps(got, want, share=0.01, atol=4e-3)
    with pytest.raises(TypeError):  # a dtype mix raises, on the CPU too
        TA.fused_mha(torch.as_tensor(q).bfloat16(), torch.as_tensor(k),
                     torch.as_tensor(v).bfloat16(), 2)


def test_wavlm_gate_matches_jax(rng):
    """The WavLM gate in bf16 (linear, sum, sigmoid, gru_rel_pos_const cast
    to bf16): equal to JAX's but on 5 % of the entries at most, each within
    one bf16 step (XLA's and torch's f32 sigmoids round apart, and the bf16
    rounding of a sigmoid near a tie follows them; measured 3.8 %)."""
    b, t, h, hd = 2, 30, 4, 16
    x = rng.standard_normal((b, t, h * hd)).astype(np.float32)
    w = (rng.standard_normal((hd, 8)) / 4).astype(np.float32)
    bb = rng.standard_normal(8).astype(np.float32)
    const = rng.uniform(0.5, 2.0, h).astype(np.float32)
    with jax.disable_jit():
        want = jl._gated_bias_factors(
            jnp.asarray(x, BF16), {"gate_w": jnp.asarray(w),
                                   "gate_b": jnp.asarray(bb),
                                   "gate_const": jnp.asarray(const)}, h)
    got = tl.gated_bias_factors(
        torch.as_tensor(x).bfloat16(),
        {"w": torch.as_tensor(w.T.copy()), "b": torch.as_tensor(bb),
         "const": torch.as_tensor(const)}, h)
    assert got.dtype == torch.bfloat16
    _within_steps(got, want, share=0.05)


# ------------------------------------------------------------ whole encoders
_VARIANTS = {
    "wav2vec2": ("wav2vec2", {}),
    "wavlm": ("wavlm", {}),
    # the stable-layer-norm large layout (pre-LN, LN after every conv)
    "wav2vec2_stable": ("wav2vec2", dict(feat_extract_norm="layer",
                                         conv_bias=True,
                                         do_stable_layer_norm=True)),
}


def _encoder_features(variant, dtypes=("f32", "bf16"), jit=False):
    """Features of one seeded tiny encoder, the same weights in both
    packages, on 4 seeded one-second windows: {"jax_f32", "jax_bf16",
    "port_bf16", ...} for the dtypes asked. JAX runs op by op unless
    ``jit``."""
    kind, over = _VARIANTS[variant]
    arch = dict(TINY, **over)
    if kind == "wavlm":
        jcls, tcls, init, conv = (jl.WavLMConfig, tl.WavLMConfig,
                                  jl.init_params, wavlm_from_jax)
    else:
        jcls, tcls, init, conv = (jw.Wav2Vec2Config, tw.Wav2Vec2Config,
                                  jw.init_params, encoder_from_jax)
    params = init(jax.random.PRNGKey(3), jcls(**arch))
    model = conv(jax.tree_util.tree_map(np.asarray, params), tcls(**arch))
    segs = (0.3 * np.random.default_rng(5).standard_normal(
        (4, 16000))).astype(np.float32)
    out = {}
    for dt in dtypes:
        jdt, tdt = ((jnp.float32, torch.float32) if dt == "f32"
                    else (BF16, torch.bfloat16))
        jenc = JEnc(name=kind, model_name="tiny", arch_cfg=jcls(**arch),
                    params=params, pretrained=False, layers_to_use=(-2, -1),
                    compute_dtype=jdt)
        tenc = TEnc(name=kind, model_name="tiny", arch_cfg=tcls(**arch),
                    model=model, pretrained=False, layers_to_use=(-2, -1),
                    compute_dtype=tdt)
        if jit:
            out[f"jax_{dt}"] = jenc.segment_features(params, jnp.asarray(segs))
        else:
            with jax.disable_jit():
                out[f"jax_{dt}"] = jenc.segment_features(params,
                                                         jnp.asarray(segs))
        out[f"port_{dt}"] = tenc.segment_features(torch.as_tensor(segs))
    return out


@pytest.mark.parametrize("variant", sorted(_VARIANTS))
def test_encoder_bf16_rounds_where_jax_rounds(variant):
    """The port's bf16 features lie within half of JAX's bf16-to-f32
    distance of JAX's bf16 features (relative Frobenius norms), so the port
    rounds where JAX rounds; f32 features within 1e-5 relative. Features
    come out f32 in both. Measured ratio (JAX's bf16-to-f32 distance ~1 %):
    wav2vec2 0.0 (equal features), wavlm 0.139 (the sigmoid of the gate
    rounds apart on ~4 % of its entries), wav2vec2_stable 0.218."""
    out = _encoder_features(variant)
    assert out["port_bf16"].dtype == torch.float32
    assert _rel(out["port_f32"], out["jax_f32"]) < 1e-5
    noise = _rel(out["jax_bf16"], out["jax_f32"])
    ratio = _rel(out["port_bf16"], out["jax_bf16"]) / noise
    assert ratio <= 0.5, (variant, ratio, noise)


@pytest.mark.parametrize("control,least", [("exact_gelu", 0.5),
                                           ("f32_logits", 0.1)])
def test_encoder_ratio_control_fails(control, least, monkeypatch):
    """The check bites: the port with exact GELU in bf16 misses it on the
    wav2vec2 encoder (measured ratio 1.02, from 0.0). f32 logits in
    mha_reference move the ratio from 0.0 to 0.27 (above 0.1 held here),
    still inside 0.5: the logits' rounding is the smaller of the two."""
    if control == "exact_gelu":
        monkeypatch.setattr(TC, "gelu", lambda x: torch.nn.functional.gelu(x))
    else:
        monkeypatch.setattr(TC, "mha_reference",
                            lambda q, k, v, h, **kw: TA.fused_mha_plain(
                                q, k, v, h, **kw))
    out = _encoder_features("wav2vec2")
    ratio = (_rel(out["port_bf16"], out["jax_bf16"])
             / _rel(out["jax_bf16"], out["jax_f32"]))
    assert ratio > least, (control, ratio)


def test_compiled_jax_keeps_excess_precision():
    """Compiled, JAX's bf16 encoder lies off its op-by-op bf16 form (0.50 %
    relative, measured, against 1.03 % from bf16 to f32): XLA skips the
    bf16 rounding of values that are upcast next. The port stays with the
    op-by-op form (the JAX source's rounding points)."""
    eager = _encoder_features("wav2vec2", ("bf16",))
    jitted = _encoder_features("wav2vec2", ("f32", "bf16"), jit=True)
    noise = _rel(jitted["jax_bf16"], jitted["jax_f32"])
    assert 0 < _rel(jitted["jax_bf16"], eager["jax_bf16"]) < noise
    assert _rel(eager["port_bf16"], eager["jax_bf16"]) < _rel(
        eager["port_bf16"], jitted["jax_bf16"])


# ------------------------------------------------------------- fusion model
def _bf16_models(d, **over):
    """A flax RADADModel and the port's, both in bf16 (f32 parameters, the
    same seeded values), dropout 0."""
    from test_torch_train import NO_DROPOUT, _models

    return _models(d, use_mixed_precision=True, compute_dtype="bfloat16",
                   **NO_DROPOUT, **over)


@pytest.mark.parametrize("mode,batch_norm", [("eval", False), ("eval", True),
                                             ("train", True),
                                             ("train", False)])
def test_fusion_model_bf16_matches_flax(mode, batch_norm, rng):
    """The fusion model in bf16, eval and training forward (dropout 0; the
    batch's statistics in training mode, its last 2 rows pad rows): f32
    logits within 4e-3 (1 + |logit|) of flax's, half a bf16 step at 1 (f32
    softmax and norm sums round apart and may move a bf16 rounding;
    measured: equal, and 4.6e-4 with BatchNorm in eval mode); BatchNorm's
    committed running statistics within 1e-2 (1 + |x|)."""
    b, k, d = 8, 5, 24
    over = dict(use_batch_norm=batch_norm, use_layer_norm=not batch_norm)
    jmodel, variables, tmodel = _bf16_models(d, **over)
    neighbors = rng.standard_normal((b, k, d)).astype(np.float32)
    tpp = rng.standard_normal((b, d)).astype(np.float32)
    tpp[6:] = 0.0
    train = mode == "train"
    with jax.disable_jit():
        out = jmodel.apply(variables, jnp.asarray(neighbors),
                           jnp.asarray(tpp), deterministic=not train,
                           use_running_average=not train,
                           mutable=["batch_stats"] if train else False)
    want, upd = out if train else (out, None)
    if train:
        tmodel.train()
    got = tmodel(torch.as_tensor(neighbors), torch.as_tensor(tpp))
    assert got.dtype == torch.float32 and want.dtype == jnp.float32
    err = np.abs(got.detach().numpy() - np.asarray(want))
    assert (err <= 4e-3 * (1 + np.abs(np.asarray(want)))).all(), err.max()
    if train and batch_norm:
        tmodel.detection_model.commit_batch_stats()
        stats = upd["batch_stats"]["detection_model"]
        for i, bn in enumerate(tmodel.detection_model.norms):
            for key, buf in (("mean", bn.running_mean),
                             ("var", bn.running_var)):
                ref = np.asarray(stats[f"norm_{i}"][key])
                assert (np.abs(buf.numpy() - ref)
                        <= 1e-2 * (1 + np.abs(ref))).all(), (i, key)


# --------------------------------------------------------------- pipelines
MIXED = dict(use_mixed_precision=True, compute_dtype="bfloat16")


@pytest.fixture(scope="module")
def bf16_pair(tmp_path_factory, synthetic_dataset):
    """A JAX pipeline and a port pipeline in bf16 with the same tiny
    wav2vec2 and fusion weights, each with its DB built from the same
    training split (JAX op by op)."""
    from radad_tpu.config import Config as JConfig
    from radad_tpu.data.manifest import load_manifests
    from radad_tpu.train.pipeline import DetectionPipeline as JPipe
    from radad_tpu_torch.config import Config as TConfig
    from radad_tpu_torch.train.pipeline import DetectionPipeline as TPipe

    from test_torch_pipeline import _cfg_kwargs

    params = jw.init_params(jax.random.PRNGKey(0), jw.Wav2Vec2Config(**TINY))
    jenc = JEnc(name="wav2vec2", model_name="tiny",
                arch_cfg=jw.Wav2Vec2Config(**TINY), params=params,
                pretrained=False, layers_to_use=(-2, -1), compute_dtype=BF16)
    tenc = TEnc(name="wav2vec2", model_name="tiny",
                arch_cfg=tw.Wav2Vec2Config(**TINY),
                model=encoder_from_jax(jax.tree_util.tree_map(
                    np.asarray, params), tw.Wav2Vec2Config(**TINY)),
                pretrained=False, layers_to_use=(-2, -1),
                compute_dtype=torch.bfloat16)
    splits = load_manifests(synthetic_dataset)
    jroot = str(tmp_path_factory.mktemp("jax_bf16"))
    troot = str(tmp_path_factory.mktemp("torch_bf16"))
    with jax.disable_jit():
        jpipe = JPipe(JConfig().replace(**_cfg_kwargs(jroot), **MIXED),
                      encoder=jenc)
        jpipe._ensure_model_state()
        jpipe.build_vector_database(splits["train"])
    tpipe = TPipe(TConfig().replace(**_cfg_kwargs(troot), **MIXED),
                  encoder=tenc, device="cpu")
    fusion_from_flax(tpipe.model, jax.tree_util.tree_map(
        np.asarray, jpipe.variables))
    tpipe.build_vector_database(splits["train"])
    return jpipe, tpipe, splits


def test_predict_batch_bf16_matches_jax(bf16_pair):
    """bf16 predict_batch on the CPU against JAX's bf16 pipeline: the DB
    embeddings (f32 after TPP) within 5e-3 relative (measured 1.9e-3, a
    fifth of bf16's distance from f32), the same neighbor ids, their
    distances within 1e-2 relative (measured 2.5e-3, from the embeddings'
    own deviation), logits within two bf16 steps, 2^-6 (1 + |logit|) (the last Dense
    rounds the logit to bf16; measured one step). The index and the search
    are the f32 ones; the certified search did not fall back."""
    jpipe, tpipe, splits = bf16_pair
    jv = np.asarray(jpipe.index.vectors)[: jpipe.index.ntotal]
    tv = tpipe.index.vectors[: tpipe.index.ntotal].numpy()
    assert tv.dtype == np.float32
    assert np.linalg.norm(tv - jv) <= 5e-3 * np.linalg.norm(jv)
    paths = list(splits["val"].paths[:5]) + list(splits["train"].paths[:3])
    with jax.disable_jit():
        jout = jpipe.predict_batch(paths)
    tout = tpipe.predict_batch(paths)
    for path, j, t in zip(paths, jout, tout):
        assert t["retrieved_files"] == j["retrieved_files"], path
        assert abs(t["logit"] - j["logit"]) <= 2.0 ** -6 * (
            1 + abs(j["logit"])), path
        np.testing.assert_allclose(
            [r["distance"] for r in t["retrieved"]],
            [r["distance"] for r in j["retrieved"]], rtol=1e-2)
        assert os.path.basename(path) not in t["retrieved_files"]
    assert tpipe.index.fallbacks == 0
    assert tpipe.encoder.compute_dtype == torch.bfloat16
    assert tpipe.model.compute_dtype == torch.bfloat16


def test_train_steps_bf16_match_jax(rng):
    """3 bf16 train steps against JAX's make_step_fns (op by op; dropout 0,
    BatchNorm, pad rows, batch exclusion), each from JAX's state: loss
    within 2e-3 and per-group gradient norms within 1e-2 relative
    (measured 2.2e-3: bf16 activations, and f32 sums that round apart move
    a bf16 rounding here and there, forward and backward), gradients and
    Adam moments within 5e-2 of their group's largest value (measured
    4.0e-2, the projection layer's score path), parameters within 1e-6 +
    1e-5 |p| except the coordinates on Adam's near-zero rule (moments that
    disagree by more than 0.1 %: up to 2 lr), at most 5 % of them
    (measured 3.9 %: mostly the biases of layers a norm follows, whose
    exact gradient is 0, so bf16 rounding is all of it)."""
    from radad_tpu.train.pipeline import ACC_KEYS
    from radad_tpu_torch.models.convert import adam_state_from_optax
    from radad_tpu_torch.train.pipeline import new_accumulators

    from test_torch_train import _batch, _flat, _np, _step_setup

    jside, tside, rows = _step_setup(rng, **MIXED)
    steps, tmodel, topt = tside["steps"], tside["model"], tside["opt"]
    assert tmodel.compute_dtype == torch.bfloat16
    jvars, jstate = jside["variables"], jside["opt_state"]
    jacc = {key: jnp.float32(0.0) for key in ACC_KEYS}
    tacc = new_accumulators("cpu")
    off = total = 0
    for step in range(3):
        tpp, labels, ids, valid = _batch(rng, rows)
        t = [torch.as_tensor(a) for a in (tpp, labels, ids, valid)]
        neighbors, _ = steps.fetch(t[0], t[2])
        with jax.disable_jit():
            jgrads = jside["grad"](jvars["params"], jvars,
                                   jnp.asarray(neighbors.numpy()),
                                   jnp.asarray(tpp), jnp.asarray(labels),
                                   jnp.asarray(valid), 1.7)
            jvars, jstate, jacc, jbm = jside["train"](
                jvars, jstate, jacc, jside["index_args"], jnp.asarray(tpp),
                jnp.asarray(labels), jnp.asarray(ids), jnp.asarray(valid),
                1.7, jax.random.PRNGKey(step))
        loss, logits, grads = steps.forward_backward(neighbors, t[0], t[1],
                                                     t[3], 1.7)
        tbm = steps.apply(tacc, neighbors, t[1], t[3], loss, logits, grads)
        assert abs(float(tbm["loss"]) - float(jbm["loss"])) <= 2e-3 * abs(
            float(jbm["loss"])), step
        for key in ("gn_proj", "gn_fuse", "gn_det"):
            assert abs(float(tbm[key]) - float(jbm[key])) <= 1e-2 * float(
                jbm[key]), (step, key)
        want = _flat(tmodel, _np(jvars["params"]))
        jg = _flat(tmodel, _np(jgrads))
        jst = adam_state_from_optax(_np(jstate), tmodel)
        for group, st in topt.state.items():
            for key, mine, ref in (
                    ("g", {n: grads[n] for n in st["mu"]},
                     {n: torch.as_tensor(jg[n]) for n in st["mu"]}),
                    ("mu", st["mu"], jst[group]["mu"]),
                    ("nu", st["nu"], jst[group]["nu"])):
                scale = max(float(v.abs().max()) for v in ref.values())
                for n in ref:
                    assert float((mine[n] - ref[n]).abs().max()) <= (
                        5e-2 * scale), (step, group, key, n)
            for n, mu in st["mu"].items():
                p = dict(tmodel.named_parameters())[n].detach().numpy()
                diff = np.abs(p - want[n])
                jmu = jst[group]["mu"][n].numpy()
                near_zero = np.abs(mu.numpy() - jmu) > 1e-3 * np.abs(jmu)
                bad = diff > 1e-6 + 1e-5 * np.abs(want[n])
                assert not (bad & ~near_zero).any(), (step, n, diff.max())
                assert (diff <= 2 * topt.lr + 1e-6).all(), (step, n)
                off += int(bad.sum())
                total += diff.size
        fusion_from_flax(tmodel, _np(jvars))
        topt.load_state_dict(adam_state_from_optax(_np(jstate), tmodel))
    assert off <= 0.05 * total, (off, total)
    assert (tside["index"].searches, tside["index"].fallbacks) == (3, 0)


# ------------------------------------------------------------ CLI, server
def test_server_bf16_predict(bf16_pair, synthetic_dataset):
    """The server's --mixed_precision flag sets the config, and a bf16
    pipeline answers a WAV upload on /api/predict with JAX's neighbors."""
    import json
    import threading
    import urllib.request

    from radad_tpu_torch.serve import app

    args = app.build_parser().parse_args(
        ["--data_path", synthetic_dataset, "--device", "cpu",
         "--mixed_precision"])
    assert app.config_from_args(args).use_mixed_precision
    assert not app.config_from_args(app.build_parser().parse_args(
        ["--data_path", synthetic_dataset])).use_mixed_precision
    jpipe, tpipe, splits = bf16_pair
    httpd = app.serve(tpipe.config.replace(train_data_path=synthetic_dataset),
                      host="127.0.0.1", port=0, pipeline=tpipe)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    try:
        path = splits["val"].paths[1]
        with open(path, "rb") as f:
            wav = f.read()
        boundary = "radadbf16boundary"
        body = (f"--{boundary}\r\nContent-Disposition: form-data; "
                f"name=\"file\"; filename=\"up.wav\"\r\nContent-Type: "
                f"audio/wav\r\n\r\n").encode() + wav + \
            f"\r\n--{boundary}--\r\n".encode()
        req = urllib.request.Request(
            f"http://127.0.0.1:{httpd.server_address[1]}/api/predict",
            data=body, method="POST", headers={
                "Content-Type": f"multipart/form-data; boundary={boundary}"})
        with urllib.request.urlopen(req, timeout=120) as resp:
            assert resp.status == 200
            out = json.loads(resp.read())
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=30)
    assert out["ok"] and len(out["neighbors"]) == tpipe.config.top_k
    with jax.disable_jit():
        want = jpipe.predict(path)
    assert [n["file"] for n in out["neighbors"]] == want["retrieved_files"]


def test_cli_bf16_train_resume_evaluate(synthetic_dataset, tmp_path, rng,
                                        capsys):
    """--mixed_precision --device cpu: train writes a checkpoint of f32
    parameters with optimizer state and finite losses, --resume continues
    from its step, evaluate prints its metrics."""
    import csv
    import json

    from radad_tpu_torch import cli
    from test_torch_encoder import _fake_hf_state_dict

    ckdir = tmp_path / "weights" / "org--tiny"
    ckdir.mkdir(parents=True)
    sd = _fake_hf_state_dict(rng, tw.Wav2Vec2Config(**TINY))
    torch.save({k: torch.as_tensor(v) for k, v in sd.items()},
               ckdir / "pytorch_model.bin")
    with open(ckdir / "config.json", "w") as f:
        json.dump({k: list(v) if isinstance(v, tuple) else v
                   for k, v in TINY.items()}, f)
    root = str(tmp_path / "run")
    common = ["--device", "cpu", "--data_path", synthetic_dataset,
              "--data_root", root, "--weights_dir", str(tmp_path / "weights"),
              "--model_name", "org/tiny", "--batch_size", "8",
              "--eval_batch_size", "8", "--db_batch_size", "8",
              "--epochs", "1", "--mixed_precision"]
    assert cli.main(["--mode", "train"] + common) == 0
    ckpt = os.path.join(root, "models", "final_model_radad.pt")
    first = torch.load(ckpt, weights_only=True)
    assert first["step"] == 3
    assert all(v.dtype == torch.float32 for v in first["model"].values()
               if v.is_floating_point())
    assert json.loads(first["config_json"])["use_mixed_precision"]
    with open(os.path.join(root, "metrics.csv")) as f:
        row = next(csv.DictReader(f))
    assert np.isfinite(float(row["train_loss"]))
    assert np.isfinite(float(row["val_loss"]))
    assert cli.main(["--mode", "train", "--resume"] + common) == 0
    second = torch.load(ckpt, weights_only=True)
    assert second["step"] == 6
    assert int(second["optimizer"]["fuse"]["count"]) == 6
    capsys.readouterr()
    assert cli.main(["--mode", "evaluate"] + common) == 0
    assert "eer_percent:" in capsys.readouterr().out
