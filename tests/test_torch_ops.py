"""Port segmenter and TPP against radad_tpu, exact, on the CPU."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radad_tpu.ops import segmenter as jseg
from radad_tpu.ops import tpp as jtpp
from radad_tpu_torch.ops import segmenter as tseg
from radad_tpu_torch.ops import tpp as ttpp


@pytest.mark.parametrize("total,seg,hop", [
    (48000, 32000, 16000),  # the shipped 3 s clip: 2 windows
    (50000, 32000, 16000),  # ragged tail
    (20000, 32000, 16000),  # shorter than one window: zero-padded
    (1000, 100, 30),
])
def test_segment_audio_matches_jax(total, seg, hop, rng):
    audio = rng.standard_normal((3, total)).astype(np.float32)
    want = np.asarray(jseg.segment_audio(jnp.asarray(audio), seg, hop))
    got = tseg.segment_audio(torch.as_tensor(audio), seg, hop).numpy()
    np.testing.assert_array_equal(got, want)
    assert tseg.num_segments(total, seg, hop) == jseg.num_segments(
        total, seg, hop)


@pytest.mark.parametrize("t", [99, 7, 4, 1])
@pytest.mark.parametrize("pooling", ["max", "avg"])
def test_tpp_matches_jax(t, pooling, rng):
    feats = rng.standard_normal((2, 3, t, 16)).astype(np.float32)
    levels = (1, 2, 4)
    want = np.asarray(jtpp.temporal_pyramid_pool(jnp.asarray(feats), levels,
                                                 pooling))
    got = ttpp.temporal_pyramid_pool(torch.as_tensor(feats), levels,
                                     pooling).numpy()
    assert got.shape == (2, 3, ttpp.tpp_output_dim(levels, 16))
    if pooling == "max":
        np.testing.assert_array_equal(got, want)
    else:  # a mean sums in an order of its own
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    with pytest.raises(ValueError):
        ttpp.temporal_pyramid_pool(torch.as_tensor(feats), levels, "median")
