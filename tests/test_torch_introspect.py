"""The port's introspection, debug, profiling and notebook helpers
(``radad_tpu_torch/models/introspect.py``, ``utils/debug.py``,
``utils/profiling.py``, ``train/notebook.py``) against the JAX package's on
the CPU: the same flax weights crossed by ``convert.fusion_from_flax``, the
same numpy inputs, at the width of ``tests/test_introspect_utils.py``."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radad_tpu.config import Config as JConfig
from radad_tpu.models import introspect as JI
from radad_tpu.models.fusion import build_radad_model as jbuild
from radad_tpu_torch.config import Config as TConfig
from radad_tpu_torch.models import introspect as TI
from radad_tpu_torch.models.convert import fusion_from_flax
from radad_tpu_torch.models.fusion import build_radad_model as tbuild

D, K, B = 7 * 16, 5, 4
HEADS = ("layer_norm", "batch_norm")


def _close(got, want, rtol=1e-5, atol=1e-5):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               rtol=rtol, atol=atol)


@pytest.fixture(scope="module", params=HEADS)
def pair(request):
    """(head, flax model, its numpy variables, the port's model with the
    same weights, neighbors [B, K, D], tpp [B, D]); the BatchNorm head
    with non-trivial running statistics."""
    rng = np.random.default_rng(42)
    bn = request.param == "batch_norm"
    over = dict(use_batch_norm=bn, use_layer_norm=not bn)
    jmodel = jbuild(JConfig().replace(**over), D)
    neighbors = rng.standard_normal((B, K, D)).astype(np.float32)
    tpp = rng.standard_normal((B, D)).astype(np.float32)
    variables = jmodel.init(jax.random.PRNGKey(0), jnp.asarray(neighbors),
                            jnp.asarray(tpp))
    variables = jax.tree_util.tree_map(np.asarray, variables)
    if bn:
        stats = variables["batch_stats"]["detection_model"]
        for name in stats:
            n = stats[name]["mean"].shape[0]
            stats[name] = {"mean": rng.standard_normal(n).astype(np.float32),
                           "var": rng.uniform(0.5, 2.0, n).astype(
                               np.float32)}
    tmodel = fusion_from_flax(tbuild(TConfig().replace(**over), D),
                              variables)
    return request.param, jmodel, variables, tmodel, neighbors, tpp


def _t(x):
    return torch.as_tensor(x)


def test_parameter_count_and_complexity_exact(pair):
    _, jmodel, variables, tmodel, *_ = pair
    assert TI.parameter_count(tmodel) == JI.parameter_count(variables)
    for batch in (1, 2, 64):
        assert TI.model_complexity(tmodel, batch=batch) == \
            JI.model_complexity(jmodel, variables, batch=batch)


def test_attention_weights_match_jax(pair):
    _, jmodel, variables, tmodel, neighbors, _ = pair
    got = TI.attention_weights(tmodel, _t(neighbors))
    want = JI.attention_weights(jmodel, variables, jnp.asarray(neighbors))
    assert got.shape == (B, K, 1)
    _close(got, want)
    _close(got.sum(1), np.ones((B, 1)))
    # the port's ProjectionLayer.attention_weights, in f32 the same
    # function (flax's method builds Dense layers inside ``nn.apply`` of a
    # plain function, which this flax refuses: an AssertionError, no scope)
    got_m = tmodel.projection_layer.attention_weights(_t(neighbors))
    _close(got_m, want)


def test_activations_match_jax(pair):
    _, jmodel, variables, tmodel, neighbors, tpp = pair
    tmodel.train()  # captured in eval mode whatever the model's mode
    got = TI.activations(tmodel, _t(neighbors), _t(tpp))
    assert tmodel.training
    tmodel.eval()
    want = JI.activations(jmodel, variables, jnp.asarray(neighbors),
                          jnp.asarray(tpp))
    assert list(got) == list(want)
    assert len(got) == 19
    for key, value in want.items():
        assert tuple(got[key].shape) == value.shape, key
        _close(got[key], value)
    np.testing.assert_array_equal(
        got["__call__"].numpy(), tmodel(_t(neighbors), _t(tpp)).numpy())


def test_activation_keys_follow_the_dropout_rule():
    """flax builds the detection head's Dropout_i only when its dropout
    is above 0 (the projection's Dropout_0 always); so do the keys."""
    over = dict(detection_dropout=0.0, use_batch_norm=False,
                use_layer_norm=False)
    jmodel = jbuild(JConfig().replace(**over), D)
    x = np.ones((2, K, D), np.float32), np.ones((2, D), np.float32)
    variables = jmodel.init(jax.random.PRNGKey(1), *map(jnp.asarray, x))
    tmodel = fusion_from_flax(tbuild(TConfig().replace(**over), D),
                              jax.tree_util.tree_map(np.asarray, variables))
    want = JI.activations(jmodel, variables, *map(jnp.asarray, x))
    assert list(TI.activations(tmodel, *map(_t, x))) == list(want)


def test_feature_importance_matches_jax(pair):
    _, jmodel, variables, tmodel, neighbors, tpp = pair
    got = TI.feature_importance(tmodel, _t(neighbors), _t(tpp))
    want = JI.feature_importance(jmodel, variables, jnp.asarray(neighbors),
                                 jnp.asarray(tpp))
    assert got.shape == (D,) and float(got.sum()) > 0
    _close(got, want, rtol=1e-4, atol=1e-6)
    assert not any(p.requires_grad or p.grad is not None
                   for p in tmodel.parameters())
    assert not tmodel.training


def test_fuse_batch_norm_matches_jax(pair):
    head, jmodel, variables, tmodel, neighbors, tpp = pair
    before = {k: v.clone() for k, v in tmodel.state_dict().items()}
    fused = TI.fuse_batch_norm(tmodel)
    for k, v in tmodel.state_dict().items():  # the input is left as it is
        assert torch.equal(v, before[k]), k
    jfused = JI.fuse_batch_norm(jmodel, variables)
    det_p = jfused["params"]["detection_model"]
    det = fused.detection_model
    for i, lin in enumerate(det.linears):
        _close(lin.weight.T, det_p[f"linear_{i}"]["kernel"], 1e-4, 1e-6)
        _close(lin.bias, det_p[f"linear_{i}"]["bias"], 1e-4, 1e-6)
    for i, nrm in enumerate(det.norms if head == "batch_norm" else ()):
        stats = jfused["batch_stats"]["detection_model"][f"norm_{i}"]
        _close(nrm.weight, det_p[f"norm_{i}"]["scale"], 0, 0)
        _close(nrm.bias, det_p[f"norm_{i}"]["bias"], 0, 0)
        _close(nrm.running_mean, stats["mean"], 0, 0)
        _close(nrm.running_var, stats["var"], 0, 0)
    got = fused(_t(neighbors), _t(tpp))
    want = jmodel.apply(jfused, jnp.asarray(neighbors), jnp.asarray(tpp),
                        deterministic=True, use_running_average=True)
    _close(got, want, 1e-4, 1e-6)
    _close(got, tmodel(_t(neighbors), _t(tpp)), 1e-4, 1e-5)


def test_predict_proba_matches_jax(pair):
    _, jmodel, variables, tmodel, neighbors, tpp = pair
    want = JI.predict_proba(jmodel, variables, jnp.asarray(neighbors),
                            jnp.asarray(tpp))
    got = TI.predict_proba(tmodel, _t(neighbors), _t(tpp))
    _close(got, want)
    want_b = JI.predict_batch_proba(jmodel, variables, jnp.asarray(neighbors),
                                    jnp.asarray(tpp), chunk=3)
    got_b = TI.predict_batch_proba(tmodel, _t(neighbors), _t(tpp), chunk=3)
    assert isinstance(got_b, np.ndarray) and got_b.shape == (B,)
    _close(got_b, want_b)


# -------------------------------------------------------------- debug
def test_sanitize_and_checked_match_jax():
    from radad_tpu.utils import debug as JD
    from radad_tpu_torch.utils import debug as TD

    x = np.asarray([1.0, np.nan, np.inf, -np.inf], np.float32)
    np.testing.assert_array_equal(TD.sanitize(_t(x)).numpy(),
                                  np.asarray(JD.sanitize(jnp.asarray(x))))

    def run_both(v):
        out = []
        for D_, lib in ((JD, jnp), (TD, torch)):
            def f(a, D_=D_):
                D_.assert_finite(a * 2, "doubled")
                D_.assert_finite(a, "v")
                return a * 2

            try:
                out.append(("ok", np.asarray(D_.checked(f)(
                    lib.asarray(v) if lib is jnp else _t(v)))))
            except ValueError as e:  # checkify's error is a ValueError
                out.append(("raised", str(e)))
        return out

    (jk, jv), (tk, tv) = run_both(np.ones(3, np.float32))
    assert jk == tk == "ok"
    np.testing.assert_array_equal(tv, jv)
    (jk, jv), (tk, tv) = run_both(np.asarray([1.0, np.nan], np.float32))
    assert jk == tk == "raised"
    assert "non-finite values in doubled" in jv
    assert tv == "non-finite values in doubled"
    # outside checked, both check at once
    for D_, arr in ((JD, jnp.asarray([np.nan])), (TD, _t([np.nan]))):
        with pytest.raises(ValueError, match="non-finite values in x"):
            D_.assert_finite(arr, "x")


def test_nan_debug_raises_inside_only_as_jax_debug_nans():
    """The JAX package's own ``nan_debug`` reads the flag with
    ``jax.config.read``, which this JAX refuses for a flag with a context
    manager; the flag itself (``jax.debug_nans``) is held here."""
    from radad_tpu_torch.utils.debug import nan_debug

    with jax.debug_nans(True):
        with pytest.raises(FloatingPointError):
            jnp.log(jnp.asarray(-1.0))
    assert np.isnan(float(jnp.log(jnp.asarray(-1.0))))
    with nan_debug():
        assert torch.is_anomaly_enabled()
        ok = torch.log(torch.tensor(2.0))  # no NaN: no error
        with pytest.raises(FloatingPointError, match="in log"):
            torch.log(torch.tensor(-1.0))
    assert float(ok) == pytest.approx(np.log(2.0))
    assert not torch.is_anomaly_enabled()
    assert torch.isnan(torch.log(torch.tensor(-1.0)))


# ---------------------------------------------------------- profiling
def test_profile_fn_matches_jax_keys():
    from radad_tpu.utils.profiling import profile_fn as jprofile
    from radad_tpu_torch.utils.profiling import profile_fn

    want = jprofile(jax.jit(lambda x: jnp.sum(x ** 2)), jnp.ones((64, 64)),
                    iterations=3, label="square")
    got = profile_fn(lambda x: (x ** 2).sum(), torch.ones((64, 64)),
                     iterations=3, label="square", device="cpu")
    assert list(got) == list(want)
    assert got["label"] == "square" and got["iterations"] == 3
    assert 0 < got["median_ms"] and got["median_ms"] <= got["p90_ms"]


def test_trace_writes_the_span(tmp_path):
    from radad_tpu_torch.utils.profiling import annotate, memory_stats, trace

    with trace(str(tmp_path), device="cpu"):
        with annotate("toy_span"):
            torch.ones((32, 32)).sum()
    files = [os.path.join(r, f) for r, _, fs in os.walk(tmp_path) for f in fs]
    assert any(f.endswith(".pt.trace.json") for f in files), files
    assert any("toy_span" in open(f).read() for f in files)
    assert memory_stats("cpu") == {}
    if not torch.cuda.is_available():  # an entry point needs a GPU
        for call in (memory_stats, lambda: trace(str(tmp_path)).__enter__()):
            with pytest.raises(RuntimeError, match="no CUDA device"):
                call()


# ----------------------------------------------------------- notebook
def _lines(fig):
    return [line.get_xydata() for ax in fig.axes for line in ax.get_lines()]


def test_notebook_figures_match_jax(tmp_path):
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    from radad_tpu.train import notebook as JN
    from radad_tpu_torch.train import notebook as TN

    csv_path = str(tmp_path / "metrics.csv")
    with open(csv_path, "w") as f:
        f.write("epoch,train_loss,train_acc,val_loss,val_acc,"
                "eer_percent,macro_eer_percent\n")
        f.write("1,0.7,0.5,0.69,0.5,40.0,42.0\n")
        f.write("2,0.5,0.8,0.55,0.75,,\n")
    rng = np.random.default_rng(0)
    labels = (rng.random(200) > 0.5).astype(np.float32)
    scores = labels + rng.standard_normal(200) * 0.7
    for make in (lambda N: N.plot_training_history(csv_path),
                 lambda N: N.plot_roc_det(scores, labels, title="t")):
        want, got = make(JN), make(TN)
        assert len(got.axes) == len(want.axes)
        assert [ax.get_title() for ax in got.axes] == \
            [ax.get_title() for ax in want.axes]
        assert len(_lines(got)) == len(_lines(want)) > 0
        for g, w in zip(_lines(got), _lines(want)):
            np.testing.assert_array_equal(g, w)
        plt.close(want)
        plt.close(got)
