"""The port's CUDA kernels and the certified scan's bf16 product on the card.

These import neither JAX nor ``radad_tpu`` and skip without a CUDA device.
On a machine with an NVIDIA GPU (where JAX need not be installed, hence
no conftest):

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_cuda.py
"""

import pytest
import torch

from radad_tpu_torch.index.flat import bf16_mm_f32
from radad_tpu_torch.ops.gather import gather_rows, gather_rows_plain
from radad_tpu_torch.ops.rerank import exact_dot, exact_dot_plain
from radad_tpu_torch.ops.topk import (extract_candidates,
                                      extract_candidates_plain)

I32 = torch.int32
pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    from radad_tpu_torch.utils.device import resolve_device

    return resolve_device("cuda")


def test_gather_rows_kernel_on_card(cuda):
    """Bit-equal to the plain version for 16-, 4- and 2-byte row widths,
    with out-of-range ids clamped; one launch per call."""
    g = torch.Generator(device=cuda).manual_seed(0)
    for dtype, d in ((torch.float32, 5376), (torch.bfloat16, 5376),
                     (torch.float32, 250), (torch.bfloat16, 7)):
        x = torch.randn((3000, d), generator=g, device=cuda).to(dtype)
        idx = torch.randint(-5, 3010, (517,), generator=g, device=cuda,
                            dtype=I32)
        before = gather_rows.launches
        got = gather_rows(x, idx)
        torch.cuda.synchronize()
        assert gather_rows.launches == before + 1
        assert torch.equal(got, gather_rows_plain(x, idx))
    with pytest.raises(TypeError):
        gather_rows(x, idx.long())


def test_exact_dot_kernel_on_card(cuda):
    """f32, bf16 and int8 rows within f32 summation-order error:
    |err| <= 1e-5 * sum_d |q_d x_d|."""
    g = torch.Generator(device=cuda).manual_seed(1)
    q = torch.randn((33, 5376), generator=g, device=cuda)
    x = torch.randn((2000, 5376), generator=g, device=cuda)
    idx = torch.randint(0, 2000, (33, 32), generator=g, device=cuda,
                        dtype=I32)
    for src in (x, x.to(torch.bfloat16),
                torch.randint(-127, 128, x.shape, generator=g, device=cuda,
                              dtype=torch.int8)):
        got = exact_dot(q, src, idx)
        want = exact_dot_plain(q, src, idx)
        scale = (src[idx.long()].float().abs() * q.abs()[:, None]).sum(-1)
        assert bool(((got - want).abs() <= 1e-5 * scale).all())
    with pytest.raises(TypeError):
        exact_dot(q.double(), x, idx)
    with pytest.raises(ValueError):
        exact_dot(q[:, :5375].contiguous(), x[:, :5375].contiguous(), idx)


def test_extract_candidates_kernel_on_card(cuda):
    """Bit-equal to the plain version, ties and -inf tiles included, from
    m = 8 to all 128 lanes."""
    g = torch.Generator(device=cuda).manual_seed(2)
    for b, t, m in ((256, 24, 8), (5, 40, 20), (3, 8, 128)):
        cand = torch.randn((b, t, 128), generator=g, device=cuda)
        cand[0, 0] = float("-inf")
        cand[b - 1, t - 1, 3] = cand[b - 1, t - 1, 64]
        tsel = torch.randint(0, 200, (b, t), generator=g, device=cuda,
                             dtype=I32)
        got = extract_candidates(cand, tsel, m, 200)
        want = extract_candidates_plain(cand, tsel, m, 200)
        for gv, wv in zip(got, want):
            assert torch.equal(gv, wv)


def test_bf16_scan_product_on_card(cuda):
    """aten::mm.dtype on the card: bf16 operands, f32 output, f32
    accumulation (allow_bf16_reduced_precision_reduction is off)."""
    g = torch.Generator(device=cuda).manual_seed(3)
    a = torch.randn((64, 5376), generator=g, device=cuda).to(torch.bfloat16)
    b = torch.randn((300, 5376), generator=g, device=cuda).to(torch.bfloat16)
    got = bf16_mm_f32(a, b)
    assert got.dtype == torch.float32
    want = a.double() @ b.double().t()
    assert float((got.double() - want).abs().max()) < 1e-3
