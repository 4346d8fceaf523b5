"""Port attention (radad_tpu_torch/ops/attention.py) against the JAX package
on the CPU: ``fused_mha`` (its plain version here) against the Pallas
``fused_mha`` in interpret mode, with and without WavLM's gated bias, and
``mha_reference``'s materialized bias against its factored form. The CUDA
kernel's cases are in tests/test_torch_cuda.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radad_tpu.ops.attention import fused_mha as jfused_mha
from radad_tpu_torch.ops.attention import (fused_mha, mha_reference,
                                           use_fused_attention)


def _inputs(rng, b, t, d, h):
    q, k, v = (rng.standard_normal((b, t, d)).astype(np.float32)
               for _ in range(3))
    q *= (d // h) ** -0.5  # the callers pre-scale q
    gate = (1.0 + 2.0 * rng.random((b, t, h))).astype(np.float32)
    pos = rng.standard_normal((h, t, t)).astype(np.float32)
    return q, k, v, gate, pos


@pytest.mark.parametrize("bias", [False, True])
@pytest.mark.parametrize("b,t,d,h", [(3, 7, 128, 4), (2, 99, 128, 2),
                                     (1, 600, 64, 2), (2, 99, 160, 2)])
def test_fused_mha_matches_pallas_interpret(b, t, d, h, bias, rng):
    """Both Pallas bodies (``_mha_kernel``, ``_mha_bias_kernel``); T = 600
    crosses the JAX kernel's 512-row query tile; head width 80 is
    hubert-xlarge's (1,280 columns over 16 heads)."""
    q, k, v, gate, pos = _inputs(rng, b, t, d, h)
    extra = dict(gate=gate, pos_bias=pos) if bias else {}
    want = np.asarray(jfused_mha(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v), h, interpret=True,
                                 **{n: jnp.asarray(a)
                                    for n, a in extra.items()}))
    textra = {n: torch.as_tensor(a) for n, a in extra.items()}
    before = dict(fused_mha.body_launches), fused_mha.launches
    got = fused_mha(torch.as_tensor(q), torch.as_tensor(k),
                    torch.as_tensor(v), h, **textra).numpy()
    # the wrapper takes the plain version for CPU tensors: no launch
    assert (dict(fused_mha.body_launches), fused_mha.launches) == before
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(
        got, mha_reference(torch.as_tensor(q), torch.as_tensor(k),
                           torch.as_tensor(v), h, **textra).numpy())


def test_reference_bias_term_matches_factored_form(rng):
    """HF WavLM materializes ``bias[b, h, t, s] = gate[b, t, h] *
    pos[h, t, s]``; ``bias_term`` with it equals the factored form."""
    b, t, d, h = 2, 11, 64, 2
    q, k, v, gate, pos = (torch.as_tensor(a)
                          for a in _inputs(rng, b, t, d, h))
    factored = mha_reference(q, k, v, h, gate=gate, pos_bias=pos)
    bias = gate.transpose(1, 2)[..., None] * pos[None]
    materialized = mha_reference(q, k, v, h, bias_term=bias)
    torch.testing.assert_close(materialized, factored, rtol=1e-5, atol=1e-5)
    assert not torch.allclose(mha_reference(q, k, v, h), factored,
                              atol=1e-3)


def test_wrapper_rejects_what_the_kernel_does_not_take():
    x = torch.zeros(2, 5, 32)
    with pytest.raises(ValueError):
        fused_mha(x, x, torch.zeros(2, 5, 16), 4)
    with pytest.raises(ValueError):
        fused_mha(x, x, x, 5)
    with pytest.raises(ValueError):
        fused_mha(x, x, x, 4, gate=torch.zeros(2, 5, 4))
    with pytest.raises(ValueError):
        fused_mha(x, x, x, 4, gate=torch.zeros(2, 5, 3),
                  pos_bias=torch.zeros(4, 5, 5))


def test_use_fused_attention_gate(monkeypatch):
    """Off by default; with RADAD_FUSED_ATTENTION=1 on for CUDA tensors up
    to T = 2048 (read at call time); never for CPU tensors."""
    monkeypatch.delenv("RADAD_FUSED_ATTENTION", raising=False)
    assert not use_fused_attention(99, 768, "cuda")
    monkeypatch.setenv("RADAD_FUSED_ATTENTION", "1")
    assert use_fused_attention(99, 768, "cuda")
    assert use_fused_attention(2048, 768, torch.device("cuda", 0))
    assert not use_fused_attention(2049, 768, "cuda")
    assert not use_fused_attention(99, 768, "cpu")
    monkeypatch.setenv("RADAD_FUSED_ATTENTION", "0")
    assert not use_fused_attention(99, 768, "cuda")
