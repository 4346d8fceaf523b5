"""Port RADADModel eval forward against the flax model on the CPU, with the
flax variables loaded through models/convert.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radad_tpu.config import Config as JConfig
from radad_tpu.models.fusion import build_radad_model as jbuild
from radad_tpu_torch.config import Config as TConfig
from radad_tpu_torch.models.convert import fusion_from_flax
from radad_tpu_torch.models.fusion import build_radad_model as tbuild


@pytest.mark.parametrize("batch_norm", [False, True])
def test_radad_model_eval_matches_flax(batch_norm, rng):
    b, k, d = 6, 5, 224
    over = dict(use_batch_norm=batch_norm, use_layer_norm=not batch_norm)
    jmodel = jbuild(JConfig().replace(**over), d)
    variables = jmodel.init(jax.random.PRNGKey(4), jnp.zeros((1, k, d)),
                            jnp.zeros((1, d)))
    variables = jax.tree_util.tree_map(np.asarray, variables)
    if batch_norm:  # non-trivial running statistics
        stats = variables["batch_stats"]["detection_model"]
        for name in stats:
            n = stats[name]["mean"].shape[0]
            stats[name] = {"mean": rng.standard_normal(n).astype(np.float32),
                           "var": rng.uniform(0.5, 2.0, n).astype(
                               np.float32)}
    neighbors = rng.standard_normal((b, k, d)).astype(np.float32)
    neighbors[1] = 0.0  # a row with no neighbors
    tpp = rng.standard_normal((b, d)).astype(np.float32)
    want = np.asarray(jmodel.apply(variables, jnp.asarray(neighbors),
                                   jnp.asarray(tpp), deterministic=True,
                                   use_running_average=True))

    tmodel = fusion_from_flax(tbuild(TConfig().replace(**over), d),
                              variables)
    got = tmodel(torch.as_tensor(neighbors), torch.as_tensor(tpp)).numpy()
    assert got.shape == (b,)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_seeded_init_is_deterministic_and_scaled():
    """Same seed, same weights; Xavier bound in the projection layer,
    He bound in the detection head, zero biases there."""
    cfg = TConfig().replace(use_batch_norm=False, use_layer_norm=True)
    a, b = tbuild(cfg, 224), tbuild(cfg, 224)
    for (na, pa), (_, pb) in zip(a.state_dict().items(),
                                 b.state_dict().items()):
        assert torch.equal(pa, pb), na
    w = a.projection_layer.attention_score.weight
    assert w.abs().max() <= (6.0 / (224 + 256)) ** 0.5
    assert a.projection_layer.attention_score.bias.abs().max() == 0
    w = a.detection_model.linears[0].weight
    assert w.abs().max() <= (6.0 / 128) ** 0.5
    assert not any(p.requires_grad for p in a.parameters())
    assert not a.training
    # mixed precision: the same f32 parameters, a bf16 forward, f32 logits
    mixed = tbuild(cfg.replace(use_mixed_precision=True), 224)
    assert mixed.compute_dtype == torch.bfloat16
    assert all(p.dtype == torch.float32 for p in mixed.parameters())
    for (na, pa), (_, pm) in zip(a.state_dict().items(),
                                 mixed.state_dict().items()):
        assert torch.equal(pa, pm), na
    logits = mixed(torch.randn(3, 5, 224), torch.randn(3, 224))
    assert logits.dtype == torch.float32 and logits.shape == (3,)
