"""The port's data-parallel train step and tensor-parallel encoder
(radad_tpu_torch/parallel) against the JAX package's on the CPU: gloo
worlds of 2 ranks (mesh 2 x 1; the TP encoder on 1 x 2) and 4 (2 x 2)
spawned under torch.multiprocessing, the JAX side on conftest's virtual
CPU mesh cut to the same shape. Mirrors tests/test_parallel.py's step
and TP cases: 3 steps with BatchNorm and dropout 0, each from JAX's state,
against JAX's mesh step and the one-device step, with a control that
skips BatchNorm's sync and must fail; the TP encoder against the
replicated one. Each world runs in one spawn (a module fixture) with a
60 s collective timeout and a join deadline; the rank-side code is
tests/test_torch_parallel_worlds.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from radad_tpu.parallel import make_mesh as jmake_mesh

from test_torch_encoder import TINY
from test_torch_wavlm import STABLE, TINY_LM
from test_torch_whisper import TINY as WHISPER_TINY
from test_torch_parallel_worlds import (STEP_ARCH, STEP_B, STEP_CFG, STEPS,
                                        _one_device_steps, _port_model,
                                        _step_tp_cases, adam_moments,
                                        run_world)


# ------------------------------------------------ the step and TP world
@pytest.fixture(scope="module")
def step_inputs():
    p = _step_inputs()
    p["tp_arch"] = TINY
    p["tp_wavlm_arch"] = TINY_LM
    p["tp_stable"] = STABLE
    p["tp_whisper_arch"] = WHISPER_TINY
    p["tp_audio"] = np.random.default_rng(3).standard_normal(
        (8, 16000)).astype(np.float32)
    return p


def _step_inputs():
    """Encoder and fusion weights (JAX), the DB (JAX's embeddings) and 3
    batches whose exclusion ids hit the DB, so the batch-wide set decides
    neighbors across the 'data' halves."""
    from radad_tpu.config import Config as JConfig
    from radad_tpu.models.wav2vec2 import Wav2Vec2Config as JW, init_params
    from radad_tpu.models.encoder import FrozenEncoder as JEnc
    from radad_tpu.train.pipeline import make_embed_fn

    from test_torch_train import _draw_variables

    rng = np.random.default_rng(1234)
    cfg = JConfig().replace(**STEP_CFG)
    params = init_params(jax.random.PRNGKey(0), JW(**STEP_ARCH))
    enc = JEnc(name="wav2vec2", model_name="tiny", arch_cfg=JW(**STEP_ARCH),
               params=params, pretrained=False, layers_to_use=(-1,))
    n = 40
    db_audio = rng.standard_normal((n, cfg.clip_samples)).astype(np.float32)
    db_vecs = np.asarray(make_embed_fn(enc, cfg)(params,
                                                 jnp.asarray(db_audio)))
    from radad_tpu.models.fusion import build_radad_model

    dtpp = 7 * STEP_ARCH["hidden_size"]
    variables = _draw_variables(build_radad_model(cfg, dtpp), dtpp, seed=3)
    batches = []
    for _ in range(STEPS):
        audio = rng.standard_normal((STEP_B, cfg.clip_samples)).astype(
            np.float32)
        pick = rng.choice(n, STEP_B, replace=False)
        audio[:24] = db_audio[pick[:24]] + 0.05 * audio[:24]
        excl = np.full((STEP_B,), -2, np.int32)
        excl[:24] = pick[:24]
        valid = np.arange(STEP_B) < STEP_B - 1  # one pad row
        labels = (rng.random(STEP_B) > 0.5).astype(np.float32)
        batches.append((audio, labels, excl, valid))
    return dict(params=jax.tree_util.tree_map(np.asarray, params),
                variables=jax.tree_util.tree_map(np.asarray, variables),
                db_vecs=db_vecs, db_labels=(np.arange(n) % 3 == 0).astype(
                    np.float32), db_ids=np.arange(n, dtype=np.int32),
                batches=batches, dtpp=dtpp)


def _jax_mesh_steps(p, data, index):
    """JAX's make_parallel_train_step on a mesh of the same shape: → (each
    step's starting state in the port's layout, each step's result)."""
    from radad_tpu.config import Config as JConfig
    from radad_tpu.models.encoder import FrozenEncoder as JEnc
    from radad_tpu.models.fusion import build_radad_model
    from radad_tpu.models.wav2vec2 import Wav2Vec2Config as JW
    from radad_tpu.parallel import ShardedIndex, make_parallel_train_step
    from radad_tpu.train import optim
    from radad_tpu_torch.models.convert import (adam_state_from_optax,
                                                fusion_from_flax)

    from test_torch_train import _flat

    cfg = JConfig().replace(**STEP_CFG)
    mesh = jmake_mesh(data=data, index=index,
                      devices=jax.devices()[:data * index])
    params = jax.tree_util.tree_map(jnp.asarray, p["params"])
    enc = JEnc(name="wav2vec2", model_name="tiny", arch_cfg=JW(**STEP_ARCH),
               params=params, pretrained=False, layers_to_use=(-1,))
    model = build_radad_model(cfg, p["dtpp"])
    opt = optim.make_optimizer(cfg.learning_rate, cfg.weight_decay)
    variables = jax.tree_util.tree_map(jnp.asarray, p["variables"])
    opt_state = opt.init(variables["params"])
    six = ShardedIndex(mesh, p["dtpp"], "L2")
    six.build(p["db_vecs"], p["db_labels"], p["db_ids"])
    step = make_parallel_train_step(model, enc, cfg, opt, mesh)
    _, _, tmodel, _ = _port_model(p)
    starts, out = [], []
    for i, (audio, labels, excl, valid) in enumerate(p["batches"]):
        host = jax.tree_util.tree_map(np.asarray, (variables, opt_state))
        fusion_from_flax(tmodel, host[0])
        starts.append(({k: v.numpy().copy() for k, v in
                        tmodel.state_dict().items()},
                       adam_state_from_optax(host[1], tmodel)))
        variables, opt_state, m = step(
            variables, opt_state, params,
            (six.vectors, six.labels, six.ids, six.row_valid),
            jnp.asarray(audio), jnp.asarray(labels), jnp.asarray(excl),
            jnp.asarray(valid), 1.0, jax.random.PRNGKey(i))
        stats = variables["batch_stats"]["detection_model"]
        out.append({"metrics": {k: float(v) for k, v in m.items()},
                    "params": _flat(tmodel, jax.tree_util.tree_map(
                        np.asarray, variables["params"])),
                    "adam": adam_moments(adam_state_from_optax(
                        jax.tree_util.tree_map(np.asarray, opt_state),
                        tmodel)),
                    "bn": [(np.asarray(stats[f"norm_{j}"]["mean"]),
                            np.asarray(stats[f"norm_{j}"]["var"]))
                           for j in range(len(stats))]})
    return starts, out


@pytest.fixture(scope="module", params=[2, 4], ids=["2x1", "2x2"])
def step_world(request, step_inputs, tmp_path_factory):
    """A world of 2 (mesh 2 x 1, TP on 1 x 2) or 4 (2 x 2) ranks, each step
    started from JAX's mesh step's state. → (world, JAX's records, the
    one-device port's records, the ranks' results)."""
    world = request.param
    starts, jax_records = _jax_mesh_steps(step_inputs, 2, world // 2)
    payload = dict(step_inputs, starts=starts)
    outs = run_world(_step_tp_cases, world,
                     tmp_path_factory.mktemp(f"step{world}"), payload)
    return world, jax_records, _one_device_steps(payload), outs


def _held(got, want, lr):
    """Step records held by the single-device trainer's rule
    (tests/test_torch_train.py ``_hold_step``): loss and the three
    gradient norms within 1e-5 relative; BatchNorm's running statistics
    within 1e-5; both Adam moments within 1e-4 of their group's largest
    value; parameters within 1e-6 + 1e-5 |p| except where Adam's input is
    rounding, seen as the two first moments disagreeing by more than 0.1 %
    (there a step may move a coordinate by up to 2 lr), at most 0.5 % of
    the coordinates such, and all within 2 lr (each step starts from the
    same state). → None, or what was not held."""
    for step, (g, w) in enumerate(zip(got, want)):
        for key, v in w["metrics"].items():
            if abs(g["metrics"][key] - v) > 1e-5 * max(abs(v), 1e-6):
                return f"step {step} {key}: {g['metrics'][key]} vs {v}"
        for i, ((gm, gv), (wm, wv)) in enumerate(zip(g["bn"], w["bn"])):
            if not (np.allclose(gm, wm, rtol=1e-5, atol=1e-5)
                    and np.allclose(gv, wv, rtol=1e-5, atol=1e-5)):
                return f"step {step} norm_{i} running statistics"
        if {n for st in w["adam"].values() for n in st["mu"]} \
                != set(w["params"]):
            return f"step {step}: Adam's groups do not cover the parameters"
        off = total = 0
        for group, wst in w["adam"].items():
            gst = g["adam"][group]
            for key in ("mu", "nu"):
                scale = max(np.abs(v).max() for v in wst[key].values())
                for name, v in wst[key].items():
                    if (np.abs(gst[key][name] - v) > 1e-4 * scale).any():
                        return f"step {step} {name}: Adam {key}"
            for name, wmu in wst["mu"].items():
                wp = w["params"][name]
                diff = np.abs(g["params"][name] - wp)
                bad = diff > 1e-6 + 1e-5 * np.abs(wp)
                near_zero = np.abs(gst["mu"][name] - wmu) > 1e-3 * np.abs(wmu)
                if (bad & ~near_zero).any():
                    return (f"step {step} {name}: max |diff| {diff.max()} "
                            f"where the first moments agree")
                if (diff > 2 * lr + 1e-6).any():
                    return f"step {step} {name}: max |diff| {diff.max()}"
                off += int(bad.sum())
                total += diff.size
        if off > 0.005 * total:
            return f"step {step}: {off} of {total} coordinates off"
    return None


def test_parallel_train_step_matches_jax_and_one_device(step_world):
    """3 steps of make_parallel_train_step with BatchNorm and dropout 0
    (2 x 1 and 2 x 2 meshes), each from JAX's state, against JAX's mesh
    step of the same shape and against the port's single-device step on
    the whole batch, at the single-device trainer's tolerance; parameters
    identical on every rank."""
    _, jax_records, one_device, outs = step_world
    steps = outs[0]["steps"]
    for o in outs[1:]:
        for a, b in zip(steps, o["steps"]):
            for name, v in a["params"].items():
                assert np.array_equal(v, b["params"][name]), name
    from radad_tpu.config import Config as JConfig
    lr = JConfig().learning_rate
    assert _held(steps, one_device, lr) is None
    assert _held(steps, jax_records, lr) is None


def test_unsynced_batchnorm_control_fails(step_world):
    """The control: BatchNorm's statistics taken over each rank's slice of
    the batch (the sync removed) fails the same check."""
    _, jax_records, one_device, outs = step_world
    assert _held(outs[0]["unsynced"], one_device, 1e-3) is not None
    assert _held(outs[0]["unsynced"], jax_records, 1e-3) is not None


def test_tp_encoder_matches_replicated(step_world):
    """The tensor-parallel encoder (over 'index': 1 x 2 on 2 ranks, 2 x 2
    on 4) gives the replicated encoder's embeddings within rtol 2e-4, atol
    1e-5 (JAX's tolerance, tests/test_parallel.py:254), with its
    parameters split and one all-reduce over 'index' a row-parallel
    product (2 a layer); the same for WavLM, post-LN and stable, whose
    gated position bias splits by head, and for Whisper (pre-LN, no k
    bias)."""
    outs = step_world[3]
    for o in outs:
        tp = o["tp"]
        np.testing.assert_allclose(tp["tp"], tp["ref"], rtol=2e-4,
                                   atol=1e-5)
        assert tp["w1_rows"] == TINY["intermediate_size"] // 2
        assert tp["ow_cols"] == TINY["hidden_size"] // 2
        assert tp["calls"] == {"all_reduce/index":
                               2 * TINY["num_hidden_layers"]}
        for name in ("wavlm", "wavlm_stable", "whisper"):
            ref, got = tp[name]
            np.testing.assert_allclose(got, ref, rtol=2e-4, atol=1e-5,
                                       err_msg=name)


def test_tp_specs_follow_jax_names():
    """encoder_param_specs splits exactly what JAX's name rules split."""
    from radad_tpu_torch.models.wav2vec2 import (Wav2Vec2Config,
                                                 Wav2Vec2Model)
    from radad_tpu_torch.parallel import encoder_param_specs

    specs = encoder_param_specs(Wav2Vec2Model(Wav2Vec2Config(**TINY)))
    split = {n.split(".", 2)[2]: s for n, s in specs.items() if s}
    assert split == {"attn.qw": ("index", None), "attn.kw": ("index", None),
                     "attn.vw": ("index", None), "attn.qb": ("index",),
                     "attn.kb": ("index",), "attn.vb": ("index",),
                     "attn.ow": (None, "index"), "ffn.w1": ("index", None),
                     "ffn.b1": ("index",), "ffn.w2": (None, "index")}
    assert all(not s for n, s in specs.items() if not n.startswith("layers"))
