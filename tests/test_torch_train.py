"""The port's trainer (radad_tpu_torch) against the JAX package on the CPU:
the optimizer, the loss, the fusion model's training forward, the train
step, train/evaluate with their artifacts, the curriculum, early stopping,
resume and the CLI. Weights cross with models/convert.py (fusion_from_flax,
adam_state_from_optax); dropout is 0 wherever the two are compared step for
step, because the two draw from different generators."""

import csv
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from radad_tpu.config import Config as JConfig
from radad_tpu.data.manifest import load_manifests
from radad_tpu.models.fusion import build_radad_model as jbuild
from radad_tpu.train import optim as joptim
from radad_tpu_torch.config import Config as TConfig
from radad_tpu_torch.models.convert import (_fusion_leaves,
                                            adam_state_from_optax,
                                            fusion_from_flax)
from radad_tpu_torch.models.fusion import build_radad_model as tbuild
from radad_tpu_torch.train import optim as toptim

from test_torch_encoder import TINY, _fake_hf_state_dict

NO_DROPOUT = dict(projection_dropout=0.0, detection_dropout=0.0)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _flat(model, params):
    """JAX fusion params → {port name: array in the port's layout}."""
    out = {}
    for path, name, transpose in _fusion_leaves(model):
        v = params
        for key in path:
            v = v[key]
        v = np.asarray(v)
        out[name] = v.T if transpose else v
    return out


def _draw_variables(jmodel, d, seed=0):
    """Seeded variables for a flax RADADModel: numpy draws into the shapes
    of ``init`` (tracing it is fast, running it eagerly is not)."""
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 5, d)), jnp.zeros((1, d)))
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name = jax.tree_util.keystr(path)
        if "batch_stats" in name:  # flax's init: mean 0, var 1
            return jnp.full(leaf.shape, float("var" in name), jnp.float32)
        scale = 1.0 / np.sqrt(leaf.shape[0]) if len(leaf.shape) == 2 else 0.1
        base = 1.0 if "scale" in name else 0.0
        return jnp.asarray(base + scale * rng.standard_normal(leaf.shape),
                           jnp.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def _models(d, seed=0, **over):
    """A flax RADADModel with seeded variables and the port's model with
    the same weights."""
    jmodel = jbuild(JConfig().replace(**over), d)
    variables = _draw_variables(jmodel, d, seed)
    tmodel = fusion_from_flax(tbuild(TConfig().replace(**over), d),
                              _np(variables))
    return jmodel, variables, tmodel


# ---------------------------------------------------------------- optimizer
def test_group_adam_matches_optax_five_steps(rng):
    """5 steps on the three groups of a fusion model's parameters, the
    projection group's gradient exploding (clipped) and wd > 0: parameters
    and per-group state within 1e-6 + 1e-5 |x| of optax's (the same
    gradients go into both; the difference is f32 rounding order)."""
    lr, wd = 1e-2, 1e-3
    _, variables, tmodel = _models(24, use_batch_norm=True,
                                   use_layer_norm=False)
    jparams = variables["params"]
    opt = joptim.make_optimizer(lr, wd)
    jstate = opt.init(jparams)
    params = {n: p.detach().clone() for n, p in tmodel.named_parameters()}
    topt = toptim.GroupAdam(lr, wd)
    topt.init(params)
    update = jax.jit(opt.update)
    for step in range(5):
        grads = jax.tree_util.tree_map(
            lambda p: jnp.asarray(rng.standard_normal(p.shape), jnp.float32),
            jparams)
        grads["projection_layer"] = jax.tree_util.tree_map(
            lambda g: g * 1e4, grads["projection_layer"])
        if step == 3:  # a step where detection's norm is below 1
            grads["detection_model"] = jax.tree_util.tree_map(
                lambda g: g * 1e-3, grads["detection_model"])
        upd, jstate = update(grads, jstate, jparams)
        jparams = optax.apply_updates(jparams, upd)
        tgrads = {n: torch.tensor(v)
                  for n, v in _flat(tmodel, _np(grads)).items()}
        topt.step(params, tgrads)
        want = _flat(tmodel, _np(jparams))
        for name, p in params.items():
            np.testing.assert_allclose(p.numpy(), want[name], rtol=1e-5,
                                       atol=1e-6, err_msg=f"{step} {name}")
    state = adam_state_from_optax(_np(jstate), tmodel)
    for group, entry in state.items():
        assert int(entry["count"]) == int(topt.state[group]["count"]) == 5
        for key in ("mu", "nu"):
            assert set(entry[key]) == set(topt.state[group][key])
            for name, v in entry[key].items():
                np.testing.assert_allclose(
                    topt.state[group][key][name].numpy(), v.numpy(),
                    rtol=1e-5, atol=1e-9, err_msg=f"{group} {key} {name}")
    # the converted counts are tensors of their own (GroupAdam.step adds to
    # them in place), so the JAX state keeps its count
    for entry in state.values():
        entry["count"] += 1
    again = adam_state_from_optax(_np(jstate), tmodel)
    assert all(int(e["count"]) == 5 for e in again.values())


def test_clip_is_optax_rule_not_clip_grad_norm():
    """One ``GroupAdam.step`` at wd = 0, the projection group's gradient
    at a global norm of exactly 2 and detection's at 0.8: each group's
    first moment (1 − b1)·clip(g) is bit-equal to optax's. optax's clip
    returns g / 2 there; ``clip_grad_norm_`` divides by 2 + 1e-6, and the
    moment it would give fails the same check. Below the threshold g is
    kept."""
    fills = {"projection_layer": 0.5, "detection_model": 0.2}  # ‖g‖ 2, 0.8
    jparams = {g: {"w": jnp.linspace(-1.0, 1.0, 16)} for g in fills}
    jgrads = {g: {"w": jnp.full((16,), v, jnp.float32)}
              for g, v in fills.items()}
    opt = joptim.make_optimizer(1e-3, 0.0)
    _, jstate = opt.update(jgrads, opt.init(jparams), jparams)
    params = {f"{g}.w": torch.tensor(np.asarray(jparams[g]["w"]))
              for g in fills}
    grads = {f"{g}.w": torch.full((16,), v) for g, v in fills.items()}
    topt = toptim.GroupAdam(1e-3, 0.0)
    topt.init(params)
    topt.step(params, grads)
    for g in fills:
        chain = jstate.inner_states[g].inner_state
        want = np.asarray(next(s for s in chain if hasattr(s, "nu")).mu[g]["w"])
        np.testing.assert_array_equal(topt.state[g]["mu"][f"{g}.w"].numpy(),
                                      want, err_msg=g)
        if g == "projection_layer":
            control = torch.nn.Parameter(torch.zeros(16))
            control.grad = grads[f"{g}.w"].clone()
            torch.nn.utils.clip_grad_norm_([control], 1.0)
            assert not np.array_equal(
                (control.grad * (1 - topt.b1)).numpy(), want)


def test_pos_weighted_bce_and_group_norms_match_jax(rng):
    logits = rng.standard_normal(12).astype(np.float32) * 3
    labels = (rng.random(12) > 0.4).astype(np.float32)
    valid = np.ones(12, bool)
    valid[9:] = False
    bce = jax.jit(joptim.pos_weighted_bce)
    for w in (0.5, 2.3):
        for v in (None, valid):
            want = float(bce(jnp.asarray(logits), jnp.asarray(labels), w,
                             None if v is None else jnp.asarray(v)))
            got = float(toptim.pos_weighted_bce(
                torch.as_tensor(logits), torch.as_tensor(labels), w,
                None if v is None else torch.as_tensor(v)))
            assert abs(got - want) < 1e-6 * max(1.0, abs(want))
    _, variables, tmodel = _models(24)
    grads = jax.tree_util.tree_map(
        lambda p: jnp.asarray(rng.standard_normal(p.shape), jnp.float32),
        variables["params"])
    want = jax.jit(joptim.group_grad_norms)(grads)
    got = toptim.group_grad_norms(
        {n: torch.as_tensor(v) for n, v in _flat(tmodel, _np(grads)).items()})
    for group in toptim.GROUPS:
        assert abs(float(got[group]) - float(want[group])) <= 1e-5 * float(
            want[group])


# ---------------------------------------------------------- training forward
def test_batchnorm_training_forward_matches_flax(rng):
    """Training forward with BatchNorm on a batch whose last 3 rows are pad
    rows (zero query, as the cached batches make them): logits within 1e-5
    and running statistics within 1e-6 of flax's ``mutable=["batch_stats"]``
    (momentum 0.9, biased variance). A default ``BatchNorm1d`` (momentum
    0.1, unbiased running variance) misses the running variance by
    B / (B - 1) = 8 / 7."""
    b, k, d = 8, 5, 24
    over = dict(use_batch_norm=True, use_layer_norm=False, **NO_DROPOUT)
    jmodel, variables, tmodel = _models(d, **over)
    neighbors = rng.standard_normal((b, k, d)).astype(np.float32)
    tpp = rng.standard_normal((b, d)).astype(np.float32)
    tpp[5:] = 0.0
    want, upd = jax.jit(lambda v, n, t: jmodel.apply(
        v, n, t, deterministic=False, use_running_average=False,
        mutable=["batch_stats"]))(variables, jnp.asarray(neighbors),
                                  jnp.asarray(tpp))
    tmodel.train()
    got = tmodel(torch.as_tensor(neighbors), torch.as_tensor(tpp))
    tmodel.detection_model.commit_batch_stats()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5)
    stats = upd["batch_stats"]["detection_model"]
    norms = tmodel.detection_model.norms
    for i, bn in enumerate(norms):
        np.testing.assert_allclose(bn.running_mean.numpy(),
                                   np.asarray(stats[f"norm_{i}"]["mean"]),
                                   rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(bn.running_var.numpy(),
                                   np.asarray(stats[f"norm_{i}"]["var"]),
                                   rtol=1e-6, atol=1e-6)
    # control: torch's own BatchNorm1d training update on the same input
    h = torch.relu(tmodel.fuse(torch.cat([
        torch.as_tensor(tpp),
        tmodel.projection_layer(torch.as_tensor(neighbors))], -1)))
    x0 = tmodel.detection_model.linears[0](h).detach()
    default = torch.nn.BatchNorm1d(x0.shape[1], eps=1e-5).train()
    default(x0)
    want_var = np.asarray(stats["norm_0"]["var"])
    assert not np.allclose(default.running_var.numpy(), want_var,
                           rtol=1e-6, atol=1e-6)


def test_dropout_rate_scale_and_eval_identity():
    """Keep rate 1 - p within 4 sigma, kept values scaled by 1 / (1 - p),
    the same generator state giving the same mask, and the identity in
    eval mode."""
    from radad_tpu_torch.models.fusion import dropout

    x = torch.ones(200_000)
    p = 0.1
    out = dropout(x, p, torch.Generator().manual_seed(3))
    kept = out != 0
    rate = float(kept.float().mean())
    assert abs(rate - (1 - p)) < 4 * (p * (1 - p) / x.numel()) ** 0.5
    assert torch.allclose(out[kept], torch.full_like(out[kept], 1 / (1 - p)))
    assert torch.equal(out, dropout(x, p, torch.Generator().manual_seed(3)))
    cfg = TConfig().replace(projection_dropout=0.5, detection_dropout=0.5,
                            use_batch_norm=False, use_layer_norm=True)
    model = tbuild(cfg, 24)
    n, t = torch.randn(4, 5, 24), torch.randn(4, 24)
    eval_out = model(n, t, torch.Generator().manual_seed(1))
    assert torch.equal(eval_out, model(n, t))
    model.train()
    train_out = model(n, t, torch.Generator().manual_seed(1))
    assert not torch.allclose(train_out, eval_out)
    assert torch.equal(train_out, model(n, t, torch.Generator().manual_seed(1)))


# ----------------------------------------------------------------- the step
def _step_setup(rng, d=24, n=40, k=5, lr=1e-3, wd=1e-5, **model_over):
    """The same index, model and optimizer state on both sides: n rows in
    near-duplicate pairs (rows 2i and 2i + 1), ids 1000 + row."""
    from radad_tpu.train.pipeline import (make_step_fns as jmake,
                                          retrieve_on_device as jret)
    from radad_tpu_torch.index.flat import FlatIndex
    from radad_tpu_torch.index.flat import retrieve_on_device as tret
    from radad_tpu_torch.train.pipeline import make_step_fns as tmake

    over = dict(use_batch_norm=True, use_layer_norm=False, **NO_DROPOUT)
    over.update(model_over)
    jmodel, variables, tmodel = _models(d, **over)
    base = rng.standard_normal((n // 2, d)).astype(np.float32)
    rows = np.repeat(base, 2, 0) + 0.01 * rng.standard_normal(
        (n, d)).astype(np.float32)
    labels = (np.arange(n) % 3 != 0).astype(np.float32)
    ids = (1000 + np.arange(n)).astype(np.int32)

    def jretrieve(index_args, tpp, exclude_ids, *, k, metric, n_valid):
        vec, lab, idc = index_args
        return jret(tpp, vec, lab, idc, exclude_ids, k=k, metric=metric,
                    n_valid=n_valid, exclude_mode="batch")

    opt = joptim.make_optimizer(lr, wd)
    jtrain, jeval = jmake(jmodel, opt, jretrieve, k=k, metric="L2",
                          n_valid=n)

    def jloss(params, variables, neighbors, tpp, labels, valid, pos_weight):
        logits, _ = jmodel.apply({**variables, "params": params}, neighbors,
                                 tpp, deterministic=False,
                                 use_running_average=False,
                                 mutable=["batch_stats"])
        return joptim.pos_weighted_bce(logits, labels, pos_weight, valid)

    jside = dict(train=jax.jit(jtrain), eval=jax.jit(jeval),
                 grad=jax.jit(jax.grad(jloss)),
                 index_args=(jnp.asarray(rows), jnp.asarray(labels),
                             jnp.asarray(ids)),
                 variables=variables, opt_state=opt.init(variables["params"]))
    index = FlatIndex(d, "L2", device="cpu")
    index.add(rows, labels.tolist(), [f"r{i}.wav" for i in range(n)],
              ids=ids.tolist())

    def tretrieve(tpp, exclude):
        out = tret(tpp, index.vectors, index.labels, index.ids, exclude,
                   k=k, metric="L2", n_valid=index.ntotal,
                   xsq=index.norms_sq, scan_bf16=index.scan_bf16,
                   resid_bf16=index.resid_bf16, exclude_mode="batch")
        index.count_search(out[4])
        return out

    topt = toptim.GroupAdam(lr, wd)
    topt.init(dict(tmodel.named_parameters()))
    tside = dict(steps=tmake(tmodel, topt, tretrieve), model=tmodel,
                 opt=topt, index=index)
    return jside, tside, rows


def _batch(rng, rows, b=8, pad=2):
    """A train batch of DB rows holding both rows of 3 near-duplicate pairs
    (so one exclusion set per batch, not per row, decides the neighbors)
    and ``pad`` pad rows (zero query, id -1, invalid)."""
    n, d = rows.shape
    pairs = rng.choice(n // 2, (b - pad + 1) // 2, replace=False)
    take = np.stack([2 * pairs, 2 * pairs + 1], 1).reshape(-1)[: b - pad]
    tpp = np.zeros((b, d), np.float32)
    tpp[: b - pad] = rows[take]
    ids = np.full((b,), -1, np.int32)
    ids[: b - pad] = 1000 + take
    labels = np.zeros((b,), np.float32)
    labels[: b - pad] = (take % 3 != 0)
    valid = np.arange(b) < b - pad
    return tpp, labels, ids, valid


def _hold_step(tmodel, opt, grads, jparams, jgrads, jstate, what):
    """One step's gradients, Adam moments and parameters against JAX's.

    Gradients and both moments: within 1e-4 of the group's largest value
    (JAX and PyTorch sum in other orders; a gradient that is 0 in exact
    arithmetic comes out as rounding). Parameters: within 1e-6 + 1e-5 |p|,
    except where Adam's input is within rounding of 0, seen as the two
    first moments
    disagreeing by more than 0.1 % (a gradient that is a cancellation
    residue, or clip(g) cancelling wd p): there the step m^ / (sqrt(v^) +
    eps) turns on the rounding and may move a coordinate by up to 2 lr on
    either side. At most 0.5 % of the coordinates may be such; returns
    their count."""
    want = _flat(tmodel, _np(jparams))
    jg = _flat(tmodel, _np(jgrads))
    jst = adam_state_from_optax(_np(jstate), tmodel)
    off, total = 0, 0
    for group, st in opt.state.items():
        assert int(st["count"]) == int(jst[group]["count"])
        refs = {"g": {n: jg[n] for n in st["mu"]},
                "mu": {n: v.numpy() for n, v in jst[group]["mu"].items()},
                "nu": {n: v.numpy() for n, v in jst[group]["nu"].items()}}
        scale = {key: max(np.abs(v).max() for v in r.values())
                 for key, r in refs.items()}
        for name, mu in st["mu"].items():
            jmu = refs["mu"][name]
            for key, got in (("g", grads[name].numpy()), ("mu", mu.numpy()),
                             ("nu", st["nu"][name].numpy())):
                assert (np.abs(got - refs[key][name])
                        <= 1e-4 * scale[key]).all(), (what, name, key)
            p = dict(tmodel.named_parameters())[name].detach().numpy()
            diff = np.abs(p - want[name])
            bad = diff > 1e-6 + 1e-5 * np.abs(want[name])
            near_zero = np.abs(mu.numpy() - jmu) > 1e-3 * np.abs(jmu)
            assert not (bad & ~near_zero).any(), (what, name, diff.max())
            assert (diff <= 2 * opt.lr + 1e-6).all(), (what, name)
            off += int(bad.sum())
            total += diff.size
    assert off <= 0.005 * total, (what, off, total)
    return off


def test_train_steps_match_jax(rng):
    """3 train steps against JAX's make_step_fns (dropout 0, BatchNorm, pad
    rows in every batch, batch exclusion), each from JAX's state: loss and
    per-group gradient norms within 1e-5 relative, gradients, Adam state and
    parameters by _hold_step, BatchNorm running statistics within 1e-5, the
    epoch sums within 1e-5; then an eval step's logits within 1e-4. The
    certified search ran one search a step and never fell back."""
    from radad_tpu.train.pipeline import ACC_KEYS
    from radad_tpu_torch.train.pipeline import new_accumulators

    jside, tside, rows = _step_setup(rng)
    steps, tmodel = tside["steps"], tside["model"]
    jvars, jstate = jside["variables"], jside["opt_state"]
    jacc = {key: jnp.float32(0.0) for key in ACC_KEYS}
    tacc = new_accumulators("cpu")
    for step in range(3):
        tpp, labels, ids, valid = _batch(rng, rows)
        t = [torch.as_tensor(a) for a in (tpp, labels, ids, valid)]
        neighbors, _ = steps.fetch(t[0], t[2])
        jgrads = jside["grad"](jvars["params"], jvars,
                               jnp.asarray(neighbors.numpy()),
                               jnp.asarray(tpp), jnp.asarray(labels),
                               jnp.asarray(valid), 1.7)
        jvars, jstate, jacc, jbm = jside["train"](
            jvars, jstate, jacc, jside["index_args"], jnp.asarray(tpp),
            jnp.asarray(labels), jnp.asarray(ids), jnp.asarray(valid), 1.7,
            jax.random.PRNGKey(step))
        loss, logits, grads = steps.forward_backward(neighbors, t[0], t[1],
                                                     t[3], 1.7)
        tbm = steps.apply(tacc, neighbors, t[1], t[3], loss, logits, grads)
        assert abs(float(tbm["loss"]) - float(jbm["loss"])) <= 1e-5 * abs(
            float(jbm["loss"])), step
        for key in ("gn_proj", "gn_fuse", "gn_det"):
            assert abs(float(tbm[key]) - float(jbm[key])) <= 1e-5 * float(
                jbm[key]), (step, key)
        _hold_step(tmodel, tside["opt"], grads, jvars["params"], jgrads,
                   jstate, step)
        stats = jvars["batch_stats"]["detection_model"]
        for i, bn in enumerate(tmodel.detection_model.norms):
            for key, buf in (("mean", bn.running_mean),
                             ("var", bn.running_var)):
                np.testing.assert_allclose(
                    buf.numpy(), np.asarray(stats[f"norm_{i}"][key]),
                    rtol=1e-5, atol=1e-5, err_msg=f"{step} norm_{i} {key}")
        # the next step starts from JAX's state: a coordinate that moved
        # by its near-zero rule must not carry into the next step's loss
        fusion_from_flax(tmodel, _np(jvars))
        tside["opt"].load_state_dict(adam_state_from_optax(_np(jstate),
                                                           tmodel))
    for key, v in tacc.items():
        assert abs(float(v) - float(jacc[key])) <= 1e-5 * max(
            1.0, abs(float(jacc[key]))), key
    tpp, _, ids, _ = _batch(rng, rows)
    jlogits, _ = jside["eval"](jvars, jside["index_args"], jnp.asarray(tpp),
                               jnp.asarray(ids))
    tlogits, _ = steps.eval_step(torch.as_tensor(tpp), torch.as_tensor(ids))
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits),
                               rtol=1e-4, atol=1e-4)
    assert not tmodel.training
    assert (tside["index"].searches, tside["index"].fallbacks) == (4, 0)


def test_gradient_checkpointing_changes_nothing(rng):
    """use_gradient_checkpointing: 2 steps with dropout 0.3 and BatchNorm
    give the same parameters, running statistics (moved once a step, not
    twice) and generator state as without it."""
    import copy

    from radad_tpu_torch.train.pipeline import (make_step_fns,
                                                new_accumulators)

    _, _, base = _models(24, use_batch_norm=True, use_layer_norm=False,
                         projection_dropout=0.3, detection_dropout=0.3)
    out = []
    for remat in (False, True):
        model = copy.deepcopy(base)
        opt = toptim.GroupAdam(1e-3, 1e-5)
        opt.init(dict(model.named_parameters()))
        steps = make_step_fns(model, opt, None, grad_checkpoint=remat)
        gen = torch.Generator().manual_seed(5)
        data = np.random.default_rng(1)
        for _ in range(2):
            n = torch.as_tensor(data.standard_normal((8, 5, 24)),
                                dtype=torch.float32)
            t = torch.as_tensor(data.standard_normal((8, 24)),
                                dtype=torch.float32)
            steps.update(new_accumulators("cpu"), n, t,
                         torch.as_tensor((np.arange(8) % 2).astype(
                             np.float32)), torch.ones(8, dtype=torch.bool),
                         1.0, gen)
        out.append((model.state_dict(), gen.get_state()))
    (a, ga), (b, gb) = out
    assert torch.equal(ga, gb)
    for key in a:
        torch.testing.assert_close(a[key], b[key], rtol=1e-6, atol=1e-7,
                                   msg=key)
    assert int(a["detection_model.norms.0.num_batches_tracked"]) == 2


def test_watch_grads_histograms(rng):
    """With wandb live, each step carries a 64-bin gradient histogram per
    group covering every gradient."""
    from radad_tpu_torch.train.pipeline import (make_step_fns,
                                                new_accumulators)

    _, _, model = _models(24, **NO_DROPOUT)
    opt = toptim.GroupAdam(1e-3, 1e-5)
    opt.init(dict(model.named_parameters()))
    steps = make_step_fns(model, opt, None, watch_grads=True)
    bm = steps.update(new_accumulators("cpu"), torch.randn(8, 5, 24),
                      torch.randn(8, 24), torch.ones(8),
                      torch.ones(8, dtype=torch.bool), 1.0)
    sizes = {g: 0 for g in toptim.GROUPS}
    for name, p in model.named_parameters():
        sizes[toptim.group_of(name)] += p.numel()
    for group, sub in (("projection_layer", "proj"), ("fuse", "fuse"),
                       ("detection_model", "det")):
        counts = bm[f"hist_counts_{sub}"]
        assert counts.shape == (64,) and bm[f"hist_edges_{sub}"].shape == (65,)
        assert int(counts.sum()) == sizes[group]


# ------------------------------------------------------------- the pipeline
def _encoders():
    """The tiny wav2vec2 encoder in both packages, same weights."""
    from radad_tpu.models.encoder import FrozenEncoder as JEnc
    from radad_tpu.models.wav2vec2 import Wav2Vec2Config as JW, init_params
    from radad_tpu_torch.models.convert import encoder_from_jax
    from radad_tpu_torch.models.encoder import FrozenEncoder as TEnc
    from radad_tpu_torch.models.wav2vec2 import Wav2Vec2Config as TW

    params = init_params(jax.random.PRNGKey(0), JW(**TINY))
    jenc = JEnc(name="wav2vec2", model_name="tiny", arch_cfg=JW(**TINY),
                params=params, pretrained=False, layers_to_use=(-2, -1))
    tenc = TEnc(name="wav2vec2", model_name="tiny", arch_cfg=TW(**TINY),
                model=encoder_from_jax(_np(params), TW(**TINY)),
                pretrained=False, layers_to_use=(-2, -1))
    return jenc, tenc


def _run_cfg(root, **over):
    cfg = dict(data_root=root, vector_db_path=os.path.join(root, "vdb"),
               batch_size=8, eval_batch_size=8, db_batch_size=8,
               num_epochs=2, **NO_DROPOUT)
    cfg.update(over)
    return cfg


@pytest.fixture(scope="module")
def tiny_encoders():
    return _encoders()


@pytest.fixture(scope="module")
def trained_pair(tmp_path_factory, synthetic_dataset, tiny_encoders):
    """JAX and the port each train 2 epochs on the synthetic set (shipped
    BatchNorm head, dropout 0) from the same fusion weights."""
    from radad_tpu.train.pipeline import DetectionPipeline as JPipe
    from radad_tpu_torch.train.pipeline import DetectionPipeline as TPipe

    jenc, tenc = tiny_encoders
    splits = load_manifests(synthetic_dataset)
    jroot = str(tmp_path_factory.mktemp("jax_train"))
    troot = str(tmp_path_factory.mktemp("torch_train"))
    jpipe = JPipe(JConfig().replace(**_run_cfg(jroot)), encoder=jenc)
    jpipe.variables = _draw_variables(jpipe.model, jpipe.tpp_dim)
    jpipe.opt_state = jpipe.opt.init(jpipe.variables["params"])
    tpipe = TPipe(TConfig().replace(**_run_cfg(troot)), encoder=tenc,
                  device="cpu")
    fusion_from_flax(tpipe.model, _np(jpipe.variables))
    jpipe.train(splits["train"], splits["val"])
    tpipe.train(splits["train"], splits["val"])
    return jpipe, tpipe, splits


def _csv(root):
    with open(os.path.join(root, "metrics.csv")) as f:
        return list(csv.DictReader(f))


def test_train_two_epochs_matches_jax(trained_pair):
    """metrics.csv has JAX's columns, and its numbers within 5e-3 relative
    (epoch time aside): each step's near-zero Adam coordinates
    (test_train_steps_match_jax) move by up to 2 lr and compound over the
    6 steps; the widest seen is 2e-3, an epoch's mean gradient norm.
    summary.json's best epochs, best_model and the final checkpoint with
    optimizer state; then evaluate() against JAX's."""
    jpipe, tpipe, splits = trained_pair
    jrows, trows = _csv(jpipe.config.data_root), _csv(tpipe.config.data_root)
    assert list(trows[0]) == list(jrows[0]) and len(trows) == len(jrows) == 2
    for jr, tr in zip(jrows, trows):
        for key, want in jr.items():
            if key == "epoch_time_sec":
                continue
            if want in ("", "inf", "nan") or not want.replace(
                    ".", "").replace("-", "").replace("e", "").isdigit():
                assert tr[key] == want, key
            else:
                assert abs(float(tr[key]) - float(want)) <= 5e-3 * max(
                    1.0, abs(float(want))), (key, tr[key], want)
    with open(os.path.join(jpipe.config.data_root, "summary.json")) as f:
        jsum = json.load(f)
    with open(os.path.join(tpipe.config.data_root, "summary.json")) as f:
        tsum = json.load(f)
    assert tsum["final_epoch"] == jsum["final_epoch"] == 2
    assert tsum["best_by_eer"]["epoch"] == jsum["best_by_eer"]["epoch"]
    assert tsum["best_by_val_loss"]["epoch"] == jsum["best_by_val_loss"][
        "epoch"]
    models = os.path.join(tpipe.config.data_root, "models")
    assert os.path.exists(os.path.join(models, "best_model_radad.pt"))
    final = torch.load(os.path.join(models, "final_model_radad.pt"),
                       weights_only=True)
    assert final["step"] == tpipe.step == jpipe.step == 6
    assert set(final["optimizer"]) == set(toptim.GROUPS)
    assert int(final["optimizer"]["fuse"]["count"]) == 6
    assert tpipe.index.searches >= 6 and tpipe.index.fallbacks == 0
    jres = jpipe.evaluate(splits["val"])
    tres = tpipe.evaluate(splits["val"])
    for key in ("loss", "accuracy", "auc", "eer_percent"):
        assert abs(tres[key] - jres[key]) <= 5e-3 * max(1.0, abs(jres[key]))
    assert tres["num_samples"] == jres["num_samples"] == len(splits["val"])
    assert _csv(tpipe.config.data_root)[-1]["epoch"] == "eval"


def _tpipe(root, tenc, **over):
    from radad_tpu_torch.train.pipeline import DetectionPipeline

    return DetectionPipeline(TConfig().replace(**_run_cfg(root, **over)),
                             encoder=tenc, device="cpu")


def _scripted_eer(monkeypatch, eers):
    """The trainer reads these validation EERs in order, one an epoch
    (metrics other than the EER are computed as usual)."""
    import types

    from radad_tpu_torch.train import pipeline

    it = iter(eers)
    monkeypatch.setattr(pipeline, "M", types.SimpleNamespace(**dict(
        vars(pipeline.M), compute_eer=lambda scores, labels: (next(it),
                                                               0.0))))


@pytest.mark.parametrize("eers,patience,want_rows,want_best", [
    # no improvement after epoch 1: stop once 2 epochs passed without one
    ((10.0, 20.0, 30.0, 40.0, 50.0), 2, 3, 1),
    # improvements keep it going to the last epoch
    ((30.0, 20.0, 25.0, 10.0, 40.0), 2, 5, 4),
])
def test_early_stopping(monkeypatch, tmp_path, synthetic_dataset,
                        tiny_encoders, eers, patience, want_rows, want_best):
    from radad_tpu_torch.data.manifest import load_manifests as tload

    _scripted_eer(monkeypatch, eers)
    pipe = _tpipe(str(tmp_path), tiny_encoders[1], num_epochs=5,
                  early_stopping_patience=patience)
    splits = tload(synthetic_dataset)
    pipe.train(splits["train"], splits["val"])
    assert len(pipe.writer.rows) == want_rows
    assert pipe.writer.best_by_eer["epoch"] == want_best


def test_freeze_query_curriculum_resets_bests(monkeypatch, tmp_path,
                                              synthetic_dataset,
                                              tiny_encoders):
    """freeze_query_epochs=2, patience 1: stage 1 trains with the query
    zeroed and never stops early (its epoch 2 is no better); at epoch 3 the
    steps are rebuilt for joint training and both best trackers reset, so
    epoch 3's EER of 30 is a new best although stage 1 reached 5, and
    best_model is rewritten; epoch 4 is worse and stops the run."""
    from radad_tpu_torch.data.manifest import load_manifests as tload
    from radad_tpu_torch.train import pipeline

    _scripted_eer(monkeypatch, (5.0, 10.0, 30.0, 40.0, 50.0))
    built = []
    real = pipeline.DetectionPipeline._build_steps

    def spy(self, ablate_query=None):
        built.append(ablate_query)
        return real(self, ablate_query)

    monkeypatch.setattr(pipeline.DetectionPipeline, "_build_steps", spy)
    pipe = _tpipe(str(tmp_path), tiny_encoders[1], num_epochs=5,
                  freeze_query_epochs=2, early_stopping_patience=1)
    splits = tload(synthetic_dataset)
    pipe.train(splits["train"], splits["val"])
    assert built == [True, None]
    assert len(pipe.writer.rows) == 4
    assert pipe.writer.best_by_eer == {"epoch": 3, "eer_percent": 30.0}
    best = torch.load(os.path.join(str(tmp_path), "models",
                                   "best_model_radad.pt"), weights_only=True)
    assert best["step"] == 9  # 3 steps an epoch, written after epoch 3


def test_resume_equals_an_unbroken_run(tmp_path, synthetic_dataset,
                                       tiny_encoders):
    """4 train steps in one pipeline equal 2 steps, save_models, a fresh
    pipeline's load_models (equal optimizer state and step), 2 more steps:
    parameters, BatchNorm statistics and optimizer state bit-equal."""
    from radad_tpu_torch.data.manifest import load_manifests as tload
    from radad_tpu_torch.train.pipeline import new_accumulators

    tenc = tiny_encoders[1]
    splits = tload(synthetic_dataset)

    def run(pipe, batches):
        steps = pipe._steps()
        for tpp, labels, ids, valid in batches:
            steps.train_step(new_accumulators("cpu"), tpp, labels, ids,
                             valid, 1.5, pipe.generator)
            pipe.step += 1

    whole = _tpipe(str(tmp_path / "whole"), tenc)
    whole.build_vector_database(splits["train"])
    batches = list(whole._query_batches(splits["train"], 8, shuffle=True,
                                        seed=3))
    batches.append(batches[0])
    run(whole, batches)
    first = _tpipe(str(tmp_path / "split"), tenc)
    first.build_vector_database(splits["train"])
    run(first, batches[:2])
    first.save_models("final_model")
    second = _tpipe(str(tmp_path / "split"), tenc)
    assert second.load_models("final_model")
    assert second.load_vector_database()
    assert second.step == 2
    for group in toptim.GROUPS:
        a, b = first.opt.state[group], second.opt.state[group]
        assert torch.equal(a["count"], b["count"])
        for key in ("mu", "nu"):
            for name in a[key]:
                assert torch.equal(a[key][name], b[key][name])
    run(second, batches[2:])
    assert second.step == whole.step == 4
    for key, v in whole.model.state_dict().items():
        assert torch.equal(v, second.model.state_dict()[key]), key
    for group in toptim.GROUPS:
        for name, v in whole.opt.state[group]["nu"].items():
            assert torch.equal(v, second.opt.state[group]["nu"][name])


def test_checkpoint_without_optimizer_loads(tmp_path, tiny_encoders,
                                            caplog):
    """A .pt of the serving-only format (model, step, config; no optimizer)
    loads with a warning; the optimizer starts fresh on the next step."""
    pipe = _tpipe(str(tmp_path), tiny_encoders[1])
    path = os.path.join(str(tmp_path), "models", "old_radad.pt")
    os.makedirs(os.path.dirname(path))
    state = {k: v * 0 + 0.5 if v.is_floating_point() else v
             for k, v in pipe.model.state_dict().items()}
    torch.save({"model": state, "step": 7,
                "config_json": pipe.config.to_json()}, path)
    assert pipe.load_models("old")
    assert "no optimizer state" in caplog.text
    assert pipe.step == 7 and pipe.opt.state is None
    assert float(pipe.model.fuse.bias[0]) == 0.5
    pipe._ensure_model_state()
    assert int(pipe.opt.state["fuse"]["count"]) == 0


def test_cli_train_resume_and_evaluate(synthetic_dataset, tmp_path, rng,
                                       capsys):
    """--mode train --device cpu writes metrics.csv, summary.json and the
    final checkpoint with optimizer state; --resume continues from its
    step; --mode evaluate prints the metrics."""
    from radad_tpu_torch import cli
    from radad_tpu_torch.models.wav2vec2 import Wav2Vec2Config as TW

    ckdir = tmp_path / "weights" / "org--tiny"
    ckdir.mkdir(parents=True)
    sd = _fake_hf_state_dict(rng, TW(**TINY))
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
              "--epochs", "1"]
    assert cli.main(["--mode", "train"] + common) == 0
    for name in ("metrics.csv", "summary.json",
                 os.path.join("models", "final_model_radad.pt")):
        assert os.path.exists(os.path.join(root, name)), name
    ckpt = os.path.join(root, "models", "final_model_radad.pt")
    first = torch.load(ckpt, weights_only=True)
    assert first["step"] == 3 and int(first["optimizer"]["fuse"]["count"]) == 3
    assert cli.main(["--mode", "train", "--resume"] + common) == 0
    second = torch.load(ckpt, weights_only=True)
    assert second["step"] == 6
    assert int(second["optimizer"]["detection_model"]["count"]) == 6
    capsys.readouterr()
    assert cli.main(["--mode", "evaluate"] + common) == 0
    out = capsys.readouterr().out
    assert "Evaluation metrics:" in out and "eer_percent:" in out
    empty = [a if a != root else str(tmp_path / "none") for a in common]
    assert cli.main(["--mode", "evaluate"] + empty) == 1
