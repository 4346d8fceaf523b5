"""The designs of ``radad_tpu_torch/csrc/extract_candidates.cu`` and
``csrc/gather_rows.cu`` on the CPU, where the kernels cannot run.

* The select's order-preserving int keys (``order_key`` / ``key_value``),
  as torch int32 bit ops equal to the C formula.
* A plain-torch emulation of the kernel's select (key rounds, the lowest
  lane at the max key, the pop to the key of -inf, the [m][w] staging of a
  block of w tiles and its j-major write-out), held to JAX's Pallas
  ``extract_candidates`` in interpret mode and to
  ``extract_candidates_plain``. Values compare as floats: the reference's
  max keeps no rule for the sign of a zero maximum (torch's CPU amax gives
  the first zero it meets, XLA's max +0), and the kernel gives +0.
* The gather's (row, chunk) -> bytes map covers every output byte once.
* Every encoder preset's head width has a ``fused_mha`` build.

The kernels themselves are held to their plain versions on the card in
tests/test_torch_cuda.py.
"""

import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radad_tpu.ops.topk import extract_candidates as jextract
from radad_tpu_torch.models.encoder import _PRESETS, resolve_arch_config
from radad_tpu_torch.ops import _native
from radad_tpu_torch.ops.attention import _HEAD_DIMS
from radad_tpu_torch.ops.topk import extract_candidates_plain

LANES = 128


def _source(name: str) -> str:
    with open(os.path.join(_native.CSRC_DIR, f"{name}.cu")) as f:
        return f.read()


def _constant(source: str, name: str) -> int:
    """A ``constexpr int`` of a kernel source."""
    return int(re.search(rf"constexpr int {name} = (\d+);",
                         _source(source)).group(1))


MAX_TILES = _constant("extract_candidates", "kMaxTiles")


def order_key(v: torch.Tensor) -> torch.Tensor:
    """f32 -> int32 whose order is the floats' (-0 counts as +0)."""
    b = (v + 0.0).contiguous().view(torch.int32)
    return b ^ ((b >> 31) & 0x7FFFFFFF)


def key_value(k: torch.Tensor) -> torch.Tensor:
    """The inverse of ``order_key`` (the same map on the bits)."""
    return (k ^ ((k >> 31) & 0x7FFFFFFF)).contiguous().view(torch.float32)


def _floats(kind: str) -> torch.Tensor:
    f32 = np.finfo(np.float32)
    specials = np.array([np.inf, -np.inf, 0.0, -0.0, f32.max, -f32.max,
                         f32.tiny, -f32.tiny, f32.tiny / 2, -f32.tiny / 2,
                         f32.smallest_subnormal, -f32.smallest_subnormal,
                         1.0, -1.0], np.float32)
    if kind == "specials":
        return torch.as_tensor(specials)
    rng = np.random.default_rng(7)
    wide = (rng.standard_normal(20_000)
            * 10.0 ** rng.uniform(-44, 38, 20_000)).astype(np.float32)
    return torch.as_tensor(np.concatenate([wide, specials]))


@pytest.mark.parametrize("kind", ["specials", "random"])
def test_order_key_is_monotone_and_its_own_inverse(kind):
    v = _floats(kind)
    v = v[torch.argsort(v.double(), stable=True)]
    k = order_key(v).long()
    step = v.double().diff()
    assert bool((k.diff()[step > 0] > 0).all())  # strictly where v is
    assert bool((k.diff()[step == 0] == 0).all())  # -0 and +0 share a key
    back = key_value(order_key(v))
    assert torch.equal(back.view(torch.int32), (v + 0.0).view(torch.int32))
    # on the bits the map is an involution (NaN patterns included)
    bits = torch.as_tensor(np.random.default_rng(8).integers(
        -2 ** 31, 2 ** 31, 50_000, dtype=np.int64).astype(np.int32))
    twice = key_value(key_value(bits).view(torch.int32))
    assert torch.equal(twice.view(torch.int32), bits)


def test_emulation_follows_the_kernel_source():
    """The emulation's key bit ops and tiles a block are the ones the
    kernel compiles."""
    src = _source("extract_candidates")
    for line in ("const int b = __float_as_int(v + 0.f);",
                 "return b ^ ((b >> 31) & 0x7fffffff);",
                 "return __int_as_float(k ^ ((k >> 31) & 0x7fffffff));",
                 "const int blocks = (t + kMaxTiles - 1) / kMaxTiles;"):
        assert line in src, line
    assert MAX_TILES == 16
    assert [tiles_per_block(t) for t in (1, 8, 16, 17, 24, 40, 64, 65)] == [
        1, 8, 16, 9, 12, 14, 16, 13]


def tiles_per_block(t: int) -> int:
    """extract_candidates.cu: the fewest blocks of at most 16 tiles, evenly
    filled."""
    blocks = -(-t // MAX_TILES)
    return -(-t // blocks)


def emulate_extract(cand: torch.Tensor, tsel: torch.Tensor, m: int, nt: int,
                    w: int):
    """The kernel's select on ``[B, T, 128]``, a block at a time: every
    batch row's block of tiles t0 .. t0 + w - 1 (one warp a tile, 4 lanes a
    thread) runs its m rounds on int keys into the [m][w] staging, then
    writes element e of the block as round e // tiles, tile e % tiles.
    Returns the kernel's three outputs and how often each output element
    was written."""
    b, t, _ = cand.shape
    keys = order_key(cand).reshape(b, t, 32, 4)
    lane_of = torch.arange(LANES, dtype=torch.int32).reshape(32, 4)
    neg_inf = order_key(torch.tensor(float("-inf")))
    vals = torch.full((b, m * t), float("nan"))
    rows = torch.full((b, m * t), -1, dtype=torch.int32)
    left = torch.full((b, t), float("nan"))
    writes = torch.zeros((b, m * t + t), dtype=torch.int32)
    for t0 in range(0, t, w):
        tiles = min(w, t - t0)
        k = keys[:, t0:t0 + tiles].clone()  # [B, tiles, thread, lane]
        s_val = torch.empty((b, m, w))
        s_row = torch.empty((b, m, w), dtype=torch.int32)
        for j in range(m):
            best = k.amax(-1).amax(-1)  # each thread's best, redux max
            mine = torch.where(k == best[..., None, None], lane_of,
                               LANES).amin(-1)  # its lowest lane there
            bidx = mine.amin(-1)  # redux min
            s_val[:, j, :tiles] = key_value(best)
            s_row[:, j, :tiles] = bidx * nt + tsel[:, t0:t0 + tiles]
            flat = k.view(b, tiles, LANES)  # the owner pops the lane
            flat.scatter_(2, bidx[..., None].long(),
                          neg_inf.expand(b, tiles, 1).contiguous())
        e = torch.arange(m * tiles)
        j, i = e // tiles, e % tiles
        col = j * t + t0 + i
        vals[:, col] = s_val[:, j, i]
        rows[:, col] = s_row[:, j, i]
        left[:, t0:t0 + tiles] = key_value(k.amax(-1).amax(-1))
        writes[:, col] += 1
        writes[:, m * t + t0:m * t + t0 + tiles] += 1
    return vals, rows, left, writes


def _cand(rng, b, t, m):
    """randn tiles, and spread over the batch rows: an all-(-inf) tile, an
    exact tie, a whole tied tile, a partly-(-inf) tile, and a tile whose
    maximum is a -0 at lane 9 beside a +0 at lane 40 (at tile 1 of row 0,
    so the test can read its rounds)."""
    cand = rng.standard_normal((b, t, LANES)).astype(np.float32)
    cand[0, 0, :] = -np.inf
    cand[1 % b, t - 1, 7] = cand[1 % b, t - 1, 99]
    cand[2 % b, 2 % t, :] = 0.25
    cand[3 % b, 3 % t, 10:60] = -np.inf
    cand[0, 1, :] = -1.0 - rng.random(LANES).astype(np.float32)
    cand[0, 1, 9], cand[0, 1, 40] = -0.0, 0.0
    return cand


@pytest.mark.parametrize("w", ["kernel", 7])
@pytest.mark.parametrize("b,t,m", [(1, 24, 8), (64, 24, 8), (5, 40, 20),
                                   (3, 8, 128)])
def test_select_emulation_matches_jax_and_plain(b, t, m, w, rng):
    """The emulated kernel, with the kernel's tiles a block and with 7 (a w
    that does not divide T), against JAX's kernel in interpret mode and the
    plain version: values equal as floats, rows and leftover exactly, every
    output written once."""
    nt = 4 * t
    w = tiles_per_block(t) if w == "kernel" else w
    cand = _cand(rng, b, t, m)
    tsel = rng.integers(0, nt, size=(b, t)).astype(np.int32)
    vals, rows, left, writes = emulate_extract(
        torch.as_tensor(cand), torch.as_tensor(tsel), m, nt, w)
    assert bool((writes == 1).all())
    want_jax = [np.asarray(a) for a in jextract(
        jnp.asarray(cand), jnp.asarray(tsel), m, nt, interpret=True)]
    want_plain = [a.numpy() for a in extract_candidates_plain(
        torch.as_tensor(cand), torch.as_tensor(tsel), m, nt)]
    for want in (want_jax, want_plain):
        for got, ref in zip((vals, rows, left), want):
            np.testing.assert_array_equal(got.numpy(), ref)
    # the -0 at lane 9 goes before the +0 at lane 40, each as +0
    assert int(rows[0, 1]) == 9 * nt + tsel[0, 1]
    assert int(rows[0, t + 1]) == 40 * nt + tsel[0, 1]
    assert not np.signbit(vals[0, 1].item())
    # the all-(-inf) tile gives -inf at lane 0 in every round
    assert bool(torch.isneginf(vals[0, 0::t]).all())
    assert bool((rows[0, 0::t] == int(tsel[0, 0])).all())


@pytest.mark.parametrize("m", [1, 5, 1280])
@pytest.mark.parametrize("dtype,d", [(torch.float32, 5376),
                                     (torch.float32, 250),
                                     (torch.bfloat16, 7),
                                     (torch.bfloat16, 1)])
def test_gather_chunks_cover_every_byte_once(dtype, d, m):
    """The kernel's grid, (output row, chunk of the row) with kThreads
    threads each copying kUnroll vectors kThreads apart, the tail masked,
    writes each vector of the [M, D] output exactly once; the vectors (the
    widest of 16, 4 and 2 bytes that divides the row, on the allocator's
    256-byte aligned pointers) tile the row's bytes."""
    threads = _constant("gather_rows", "kThreads")
    unroll = _constant("gather_rows", "kUnroll")
    row_bytes = d * torch.tensor([], dtype=dtype).element_size()
    vec = next(v for v in (16, 4, 2) if row_bytes % v == 0)
    assert vec == {21504: 16, 1000: 4, 14: 2, 2: 2}[row_bytes]
    row_vecs = row_bytes // vec
    chunk = threads * unroll
    chunks = -(-row_vecs // chunk)
    y, tx, u = np.meshgrid(np.arange(chunks), np.arange(threads),
                           np.arange(unroll), indexing="ij")
    c = (y * chunk + tx + u * threads).ravel()
    c = c[c < row_vecs]
    dst = (np.arange(m)[:, None] * row_vecs + c[None, :]).ravel()
    assert np.array_equal(np.bincount(dst, minlength=m * row_vecs),
                          np.ones(m * row_vecs, np.int64))


@pytest.mark.parametrize("kind,name", [
    (kind, name) for kind, presets in _PRESETS.items() for name in presets])
def test_every_preset_head_width_has_a_kernel_build(kind, name):
    """The preset's head width is in ``_HEAD_DIMS``, and ``fused_mha.cu``
    dispatches it to an f32 and a bf16 instance (the mixed-precision
    encoders give the kernel bf16)."""
    cfg = resolve_arch_config(name, None, kind)
    hd, rest = divmod(cfg.feature_dim, cfg.num_attention_heads)
    assert rest == 0 and hd in _HEAD_DIMS, (name, cfg.feature_dim,
                                            cfg.num_attention_heads)
    src = _source("fused_mha")
    for launcher in ("launch", "launch_bf16"):
        assert re.search(rf"case {hd}: return {launcher}<{hd}, BIAS>", src), (
            name, launcher)
