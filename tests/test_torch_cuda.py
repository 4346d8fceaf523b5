"""The port's CUDA kernels and the certified scan's bf16 product on the card:
each kernel against its plain PyTorch version.

These import neither JAX nor ``radad_tpu`` and skip without a CUDA device.
On a machine with an NVIDIA GPU (where JAX need not be installed, hence
no conftest):

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_cuda.py
"""

import pytest
import torch

from radad_tpu_torch.index.flat import bf16_mm_f32
from radad_tpu_torch.ops.attention import fused_mha, mha_reference
from radad_tpu_torch.ops.gather import gather_rows, gather_rows_plain
from radad_tpu_torch.ops.rerank import exact_dot, exact_dot_plain
from radad_tpu_torch.ops.topk import (extract_candidates,
                                      extract_candidates_plain, flat_topk,
                                      flat_topk_plain)
from radad_tpu_torch.ops.topk_check import (CHAIN, MMA, check_topk,
                                            compare_topk)

I32 = torch.int32
pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    from radad_tpu_torch.utils.device import resolve_device

    return resolve_device("cuda")


def test_gather_rows_kernel_on_card(cuda):
    """Bit-equal to the plain version for 16-, 4- and 2-byte row widths
    (f32 5,376 is 3 chunks a row, the last one masked), with out-of-range
    ids clamped, at M = 517 and at the serving M (1, 5, 40, 320, 2,048);
    one launch per call."""
    g = torch.Generator(device=cuda).manual_seed(0)
    for dtype, d in ((torch.float32, 5376), (torch.bfloat16, 5376),
                     (torch.float32, 250), (torch.bfloat16, 7)):
        x = torch.randn((3000, d), generator=g, device=cuda).to(dtype)
        for m in (517, 1, 5, 40, 320, 2048):
            idx = torch.randint(-5, 3010, (m,), generator=g, device=cuda,
                                dtype=I32)
            before = gather_rows.launches
            got = gather_rows(x, idx)
            torch.cuda.synchronize()
            assert gather_rows.launches == before + 1
            assert torch.equal(got, gather_rows_plain(x, idx)), (dtype, d, m)
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


@pytest.mark.parametrize("d", [3584, 5376])
@pytest.mark.parametrize("b", [1, 8, 64, 128, 256])
def test_exact_dot_forms_on_card(cuda, b, d):
    """The form the wrapper picks (``exact_dot_form``: split at B <= 64,
    per_query above), counted once a call in ``form_launches``, for f32,
    bf16 and int8 rows at the serving widths, with ids out of range and -1
    (clamped), within 1e-5 * sum_d |q_d x_d| of the plain version; two
    calls give bitwise-equal dots (a fixed summation order, no atomics)."""
    from radad_tpu_torch.ops.rerank import exact_dot_form

    g = torch.Generator(device=cuda).manual_seed(b + d)
    n = 3000
    q = torch.randn((b, d), generator=g, device=cuda)
    x = torch.randn((n, d), generator=g, device=cuda)
    idx = torch.randint(-5, n + 5, (b, 32), generator=g, device=cuda,
                        dtype=I32)
    idx[0, :3] = torch.tensor([-1, n, n - 1], dtype=I32)
    form = exact_dot_form(b, 32, d)
    assert form == ("split" if b <= 64 else "per_query")
    for src in (x, x.to(torch.bfloat16),
                torch.randint(-127, 128, x.shape, generator=g, device=cuda,
                              dtype=torch.int8)):
        forms = dict(exact_dot.form_launches)
        got = exact_dot(q, src, idx)
        again = exact_dot(q, src, idx)
        want = exact_dot_plain(q, src, idx)
        torch.cuda.synchronize()
        forms[form] += 2
        assert exact_dot.form_launches == forms, (b, d, src.dtype)
        assert torch.equal(got, again), (b, d, src.dtype)
        safe = idx.long().clamp(0, n - 1)
        scale = (src[safe].float().abs() * q.abs()[:, None]).sum(-1)
        assert bool(((got - want).abs() <= 1e-5 * scale).all()), (
            b, d, src.dtype, float((got - want).abs().max()))


def test_extract_candidates_kernel_on_card(cuda):
    """Equal to the plain version (values as floats, so a zero maximum may
    differ in sign; rows and leftover exactly), ties, -inf tiles and a -0
    at a lower lane than a +0 included (the lower lane goes first), from
    m = 8 to all 128 lanes, at B = 1 and 64 of the serving shape and with
    tiles that split over two blocks (T = 40)."""
    g = torch.Generator(device=cuda).manual_seed(2)
    for b, t, m in ((256, 24, 8), (1, 24, 8), (64, 24, 8), (5, 40, 20),
                    (3, 8, 128)):
        cand = torch.randn((b, t, 128), generator=g, device=cuda)
        cand[0, 0] = float("-inf")
        cand[b - 1, t - 1, 3] = cand[b - 1, t - 1, 64]
        zero = cand[0, 1]
        zero[:] = -1.0 - torch.rand(128, generator=g, device=cuda)
        zero[9], zero[40] = -0.0, 0.0
        tsel = torch.randint(0, 200, (b, t), generator=g, device=cuda,
                             dtype=I32)
        got = extract_candidates(cand, tsel, m, 200)
        want = extract_candidates_plain(cand, tsel, m, 200)
        torch.cuda.synchronize()
        for gv, wv in zip(got, want):
            assert torch.equal(gv, wv), (b, t, m)
        assert int(got[1][0, t + 1]) == 40 * 200 + int(tsel[0, 1])
        assert int(got[1][0, 1]) == 9 * 200 + int(tsel[0, 1])


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


@pytest.mark.parametrize("t,saturate", [
    (t, False) for t in (1, 7, 8, 63, 64, 65, 99, 128, 129, 600, 1500)
] + [(130, True)])
def test_fused_mha_kernel_on_card(cuda, t, saturate):
    """Both bodies within 1e-5 * (1 + |plain|) (3xTF32 products, f32
    softmax online over 32-key tiles): T at the edges of the 16-row warp
    tiles, the 128-row block and the key tiles, up to 1500 frames; head
    widths 64 (the base and large encoders), 80 (hubert-xlarge) and
    16 / 32 / 128 (the other builds; 64, 80 and 128 take more than 48 KB of
    shared memory). ``saturate``: logits from
    about -70 to 80 with one key dominating each row by at least ~10, that
    key spread over the five key tiles so the running max grows from tile
    to tile and exp underflows. One launch per call, counted per body."""
    g = torch.Generator(device=cuda).manual_seed(4)
    for b, h, hd in ((3, 12, 64), (2, 4, 16), (2, 4, 32), (2, 16, 80),
                     (2, 2, 128)):
        d = h * hd
        q, k, v = (torch.randn((b, t, d), generator=g, device=cuda)
                   for _ in range(3))
        q *= hd ** -0.5
        if saturate:  # keys of norm sqrt(hd); row t's query along key
            # (37 t mod T): logit 80 there, 80 cos(angle) at the others
            kh = k.view(b, t, h, hd)
            kh = kh * (hd ** 0.5 / kh.norm(dim=-1, keepdim=True))
            k = kh.reshape(b, t, d).contiguous()
            q = (80 / hd * kh[:, (37 * torch.arange(t, device=cuda)) % t]
                 ).reshape(b, t, d).contiguous()
        gate = 1.0 + 2.0 * torch.rand((b, t, h), generator=g, device=cuda)
        pos = torch.randn((h, t, t), generator=g, device=cuda)
        for extra in ({}, dict(gate=gate, pos_bias=pos)):
            body = "bias" if extra else "no_bias"
            before = fused_mha.body_launches[body]
            got = fused_mha(q, k, v, h, **extra)
            want = mha_reference(q, k, v, h, **extra)
            torch.cuda.synchronize()
            assert fused_mha.body_launches[body] == before + 1
            assert bool(((got - want).abs()
                         <= 1e-5 * (1 + want.abs())).all()), (
                t, hd, body, float((got - want).abs().max()))


def test_fused_mha_rejects_bf16_on_card(cuda):
    """bf16 mixed with f32 raises (no upcast to reach the f32 body), and so
    does a head width without a kernel build."""
    x = torch.randn((2, 9, 64), device=cuda).to(torch.bfloat16)
    with pytest.raises(TypeError):
        fused_mha(x, x, x.float(), 4)
    with pytest.raises(TypeError):
        fused_mha(x, x, x, 4, gate=torch.ones((2, 9, 4), device=cuda),
                  pos_bias=torch.zeros((4, 9, 9), device=cuda,
                                       dtype=torch.bfloat16))
    with pytest.raises(ValueError):  # head width 24: no kernel build
        fused_mha(*(torch.zeros((1, 5, 48), device=cuda),) * 3, 2)


@pytest.mark.parametrize("t,saturate", [
    (t, False) for t in (1, 7, 8, 15, 16, 17, 63, 64, 65, 99, 128, 129, 600,
                         1500)
] + [(130, True), (99, "last"), (128, "last")])
def test_fused_mha_bf16_kernel_on_card(cuda, t, saturate):
    """Both bf16 bodies against their plain version (f32 logits from the
    bf16 operands, normalized weights rounded to bf16, p·v in f32, bf16
    out) within BF16_TOL * (1 + |plain|) (the streamed form rounds the
    weights before the normalization): T at the edges of the k16 steps,
    the 16-row warp tiles, the 128-row block and the key tiles, up to 1,500
    frames; head widths 64, 80 and the other builds (16, 32, 128).
    ``saturate``: True as in the f32 test (the row max grows from tile to
    tile); "last": every row's dominant key in the last key fragment (the
    resident form's last fragment at T = 99 holds 3 keys, at T = 128 8).
    One launch per call, counted per body and dtype, and per form: the
    resident form at T <= 128 and head width <= 80, the streamed form
    (one pass over 64-key tiles) elsewhere."""
    from radad_tpu_torch.ops.attention import BF16_TOL, fused_mha_plain

    g = torch.Generator(device=cuda).manual_seed(8)
    for b, h, hd in ((3, 12, 64), (2, 16, 80), (2, 4, 16), (2, 4, 32),
                     (2, 2, 128)):
        d = h * hd
        q, k, v = (torch.randn((b, t, d), generator=g, device=cuda)
                   for _ in range(3))
        q *= hd ** -0.5
        if saturate:
            kh = k.view(b, t, h, hd)
            kh = kh * (hd ** 0.5 / kh.norm(dim=-1, keepdim=True))
            k = kh.reshape(b, t, d).contiguous()
            rows = torch.arange(t, device=cuda)
            last = 8 * ((t - 1) // 8)  # the last key fragment's first key
            top = ((37 * rows) % t if saturate is True
                   else last + rows % (t - last))
            q = (80 / hd * kh[:, top]).reshape(b, t, d).contiguous()
        gate = 1.0 + 2.0 * torch.rand((b, t, h), generator=g, device=cuda)
        pos = torch.randn((h, t, t), generator=g, device=cuda)
        q, k, v, gate, pos = (x.to(torch.bfloat16) for x in (q, k, v, gate,
                                                             pos))
        form = "resident" if t <= 128 and hd <= 80 else "streamed"
        for extra in ({}, dict(gate=gate, pos_bias=pos)):
            body = ("bias" if extra else "no_bias") + "_bf16"
            before = fused_mha.body_launches[body]
            forms = dict(fused_mha.form_launches)
            got = fused_mha(q, k, v, h, **extra)
            want = fused_mha_plain(q, k, v, h, **extra)
            torch.cuda.synchronize()
            assert fused_mha.body_launches[body] == before + 1
            forms[form] += 1
            assert fused_mha.form_launches == forms, (t, hd, form)
            assert got.dtype == torch.bfloat16
            err = (got.float() - want.float()).abs()
            assert bool((err <= BF16_TOL * (1 + want.float().abs())).all()), (
                t, hd, body, float(err.max()))


@pytest.mark.parametrize("t", [1, 15, 16, 17, 64, 99, 100, 104, 112, 113,
                               128])
def test_fused_mha_bf16_resident_wgmma_on_card(cuda, t):
    """The resident form's wgmma kernel (head width 64 without bias: T
    rounded up to 64, 104 or 128 keys of S, TMA loads and stores) against
    fused_mha_plain within BF16_TOL * (1 + |plain|), through the wrapper's
    own pick (one launch, counted as the resident form). B = 70 rows of 12
    heads, so each persistent block (2 an SM, spread over the heads) walks
    several batch rows through its 2-row ring; the logits saturate (each
    query row's dominant key at 80 / 64 |k|^2, anywhere in the row, in the
    last key fragment for every third batch row)."""
    from radad_tpu_torch.ops.attention import BF16_TOL, fused_mha_plain

    g = torch.Generator(device=cuda).manual_seed(t)
    b, h, hd = 70, 12, 64
    d = h * hd
    k = torch.randn((b, t, d), generator=g, device=cuda)
    v = torch.randn((b, t, d), generator=g, device=cuda)
    kh = k.view(b, t, h, hd)
    kh = kh * (hd ** 0.5 / kh.norm(dim=-1, keepdim=True))
    k = kh.reshape(b, t, d).contiguous()
    rows = torch.arange(t, device=cuda)
    last = 8 * ((t - 1) // 8)
    top = torch.where(torch.arange(b, device=cuda)[:, None] % 3 == 0,
                      last + rows % (t - last), (37 * rows) % t)  # [b, t]
    q = torch.stack([kh[i, top[i]] for i in range(b)]) * (80 / hd)
    q = q.reshape(b, t, d).contiguous()
    q, k, v = (x.to(torch.bfloat16) for x in (q, k, v))
    forms = dict(fused_mha.form_launches)
    got = fused_mha(q, k, v, h)
    want = fused_mha_plain(q, k, v, h)
    torch.cuda.synchronize()
    forms["resident"] += 1
    assert fused_mha.form_launches == forms, t
    err = (got.float() - want.float()).abs()
    assert bool((err <= BF16_TOL * (1 + want.float().abs())).all()), (
        t, float(err.max()))


@pytest.mark.parametrize("bias", [False, True])
@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("t", [129, 600, 1500])
def test_fused_mha_bf16_streamed_on_card(cuda, t, hd, bias):
    """The streamed form (one pass over 64-key tiles, online softmax)
    against fused_mha_plain within BF16_TOL * (1 + |plain|) at Whisper's
    width (8 heads of 64; 4 of 128), B = 3: T = 129 (a last tile of 1 key,
    a last block of 1 row), 600 and 1,500 (a last block of 92 rows). Each
    row's logits grow from tile to tile (q . k rises with the key's index,
    up to ~12 at the last key), so O and l are rescaled at every tile; one
    launch, counted as the streamed form."""
    from radad_tpu_torch.ops.attention import BF16_TOL, fused_mha_plain

    g = torch.Generator(device=cuda).manual_seed(11)
    b, h = 3, 512 // hd
    d = h * hd
    q, k, v = (torch.randn((b, t, d), generator=g, device=cuda)
               for _ in range(3))
    q *= hd ** -0.5
    u = torch.randn((h, hd), generator=g, device=cuda)
    u = (u / u.norm(dim=-1, keepdim=True)).reshape(1, 1, d)  # unit a head
    ramp = torch.linspace(0.0, 1.0, t, device=cuda)[None, :, None]
    q, k = q + u, k + 12.0 * ramp * u  # q . k gains ~12 s / T at key s
    extra = {}
    if bias:
        extra = dict(gate=1.0 + 2.0 * torch.rand((b, t, h), generator=g,
                                                 device=cuda),
                     pos_bias=torch.randn((h, t, t), generator=g,
                                          device=cuda))
    q, k, v = (x.to(torch.bfloat16) for x in (q, k, v))
    extra = {n: x.to(torch.bfloat16) for n, x in extra.items()}
    forms = dict(fused_mha.form_launches)
    got = fused_mha(q, k, v, h, **extra)
    want = fused_mha_plain(q, k, v, h, **extra)
    torch.cuda.synchronize()
    forms["streamed"] += 1
    assert fused_mha.form_launches == forms
    err = (got.float() - want.float()).abs()
    assert bool((err <= BF16_TOL * (1 + want.float().abs())).all()), (
        t, hd, bias, float(err.max()))


@pytest.mark.parametrize("metric", ["L2", "IP"])
def test_flat_topk_kernel_on_card(cuda, metric):
    """f32 and bf16 rows, both scan precisions, a ragged last tile, rows
    past n_valid, excluded ids and a whole 128-row tile masked out by
    exclusion: each result within the kernel's rounding bound of the exact
    scores (ops/topk_check.py; the tensor-core order for the bf16 body, the
    FMA chain for the f32 body), ids equal to the plain version's except
    near-ties within that bound; an unrounded scan fails the bf16 check."""
    g = torch.Generator(device=cuda).manual_seed(5)
    n, d, b = 3000, 516, 70  # 24 tiles, the last one ragged; 2 query blocks
    x = torch.randn((n, d), generator=g, device=cuda)
    q = torch.randn((b, d), generator=g, device=cuda)
    ids = torch.arange(n, device=cuda, dtype=I32) // 128  # one id per tile
    excl = torch.full((b,), -5, device=cuda, dtype=I32)
    excl[::3] = 7  # tile 7 masked for every third query
    for rows in (x, x.to(torch.bfloat16)):
        for fast, order, k in ((True, MMA, 32), (False, CHAIN, 5),
                               (True, MMA, 128)):
            kw = dict(metric=metric, n_valid=2900, ids=ids,
                      exclude_ids=excl, fast_scan=fast)
            before = flat_topk.launches
            got = flat_topk(q, rows, k, **kw)
            want = flat_topk_plain(q, rows, k, **kw)
            torch.cuda.synchronize()
            assert flat_topk.launches == before + 1
            held = check_topk(q, rows, got, order=order, **kw)
            assert held["ok"], (rows.dtype, fast, k, held)
            agree = compare_topk(q, rows, got, want, metric=metric,
                                 fast_scan=fast, order=order)
            assert agree["ok"], (rows.dtype, fast, k, agree)
    kw = dict(metric=metric, n_valid=2900, ids=ids, exclude_ids=excl)
    unrounded = flat_topk(q, x, 32, fast_scan=False, **kw)
    assert not check_topk(q, x, unrounded, fast_scan=True, order=MMA,
                          **kw)["ok"]
    # every row masked: all slots empty
    v, i = flat_topk(q, x, 5, metric=metric, n_valid=0)
    assert bool((i == -1).all()) and bool(torch.isinf(v).all())


@pytest.mark.parametrize("n,d,b,dtype", [
    (1000, 512, 8, torch.bfloat16),  # 16-byte copies of bf16 rows
    (1000, 5376, 1, torch.float32),  # one query: one n8 fragment
    (700, 200, 64, torch.float32),   # a full query block, a ragged stage
    (129, 4, 3, torch.float32),      # 4 columns; a 1-row last tile
    (300, 36, 65, torch.bfloat16),   # 8-byte copies; 2 query blocks
])
def test_flat_topk_bf16_body_shapes_on_card(cuda, n, d, b, dtype):
    """The bf16 body at the ring's and the fragments' edges: within the
    tensor-core order's bound of the exact scores, ids equal to the plain
    version's except near-ties, every unmasked row found when k covers
    them."""
    g = torch.Generator(device=cuda).manual_seed(6)
    x = torch.randn((n, d), generator=g, device=cuda).to(dtype)
    q = torch.randn((b, d), generator=g, device=cuda)
    k = min(128, n)
    for metric in ("L2", "IP"):
        kw = dict(metric=metric, n_valid=n - 1, fast_scan=True)
        got = flat_topk(q, x, k, **kw)
        want = flat_topk_plain(q, x, k, **kw)
        torch.cuda.synchronize()
        held = check_topk(q, x, got, order=MMA, **kw)
        assert held["ok"], (n, d, b, metric, held)
        agree = compare_topk(q, x, got, want, metric=metric, order=MMA)
        assert agree["ok"], (n, d, b, metric, agree)


def test_train_step_on_card_matches_cpu(cuda):
    """One train step at tiny width (D = 256, 2,048 rows, B = 16 with 3 pad
    rows, BatchNorm head, dropout 0) on the card against the same step on
    the CPU: the certified retrieval finds the same neighbors and launches
    its three kernels; loss within 1e-5 relative, per-group gradient norms
    within 1e-4 relative, BatchNorm running statistics within 1e-5;
    parameters within 1e-6 + 1e-5 |p| except at most 0.5 % of coordinates
    (Adam's input within rounding of 0), each within 2 lr."""
    import copy

    from radad_tpu_torch.config import Config
    from radad_tpu_torch.index.flat import FlatIndex, retrieve_on_device
    from radad_tpu_torch.models.fusion import build_radad_model
    from radad_tpu_torch.train.optim import GroupAdam
    from radad_tpu_torch.train.pipeline import (make_step_fns,
                                                new_accumulators)

    g = torch.Generator().manual_seed(7)
    n, d, b = 2048, 256, 16
    rows = torch.randn((n, d), generator=g)
    cfg = Config().replace(projection_dropout=0.0, detection_dropout=0.0)
    base = build_radad_model(cfg, d)
    take = torch.randperm(n, generator=g)[: b - 3]
    tpp = torch.zeros((b, d))
    tpp[: b - 3] = rows[take] + 0.1 * torch.randn((b - 3, d), generator=g)
    ids = torch.full((b,), -1, dtype=I32)
    ids[: b - 3] = take.to(I32)
    labels = (torch.arange(b) % 2).float()
    valid = torch.arange(b) < b - 3
    before = (gather_rows.launches, exact_dot.launches,
              extract_candidates.launches)
    out = {}
    for dev in ("cpu", cuda):
        index = FlatIndex(d, "L2", device=dev)
        index.add(rows, labels=[0.0] * n, paths=[f"{i}.wav" for i in range(n)],
                  ids=list(range(n)))
        model = copy.deepcopy(base).to(dev)
        opt = GroupAdam(1e-3, 1e-5)
        opt.init(dict(model.named_parameters()))

        def retrieve(q, ex, index=index):
            return retrieve_on_device(
                q, index.vectors, index.labels, index.ids, ex, k=5,
                metric="L2", n_valid=index.ntotal, xsq=index.norms_sq,
                scan_bf16=index.scan_bf16, resid_bf16=index.resid_bf16)

        steps = make_step_fns(model, opt, retrieve)
        neighbors, _ = steps.fetch(tpp.to(dev), ids.to(dev))
        bm = steps.update(new_accumulators(dev), neighbors, tpp.to(dev),
                          labels.to(dev), valid.to(dev), 1.3)
        out[str(dev)] = (neighbors.cpu(), {k: float(v) for k, v in bm.items()},
                         {k: v.cpu() for k, v in model.state_dict().items()})
    torch.cuda.synchronize()
    after = (gather_rows.launches, exact_dot.launches,
             extract_candidates.launches)
    assert all(a > bb for a, bb in zip(after, before)), (before, after)
    (n_cpu, bm_cpu, sd_cpu), (n_gpu, bm_gpu, sd_gpu) = out.values()
    assert torch.equal(n_cpu, n_gpu)
    assert abs(bm_gpu["loss"] - bm_cpu["loss"]) <= 1e-5 * abs(bm_cpu["loss"])
    for key in ("gn_proj", "gn_fuse", "gn_det"):
        assert abs(bm_gpu[key] - bm_cpu[key]) <= 1e-4 * bm_cpu[key], key
    off, total = 0, 0
    for key, want in sd_cpu.items():
        got = sd_gpu[key]
        if "running" in key:
            torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
        elif want.is_floating_point():
            diff = (got - want).abs()
            bad = diff > 1e-6 + 1e-5 * want.abs()
            assert bool((diff <= 2e-3 + 1e-6).all()), key
            off += int(bad.sum())
            total += diff.numel()
    assert off <= 0.005 * total, (off, total)


@pytest.mark.parametrize("pad", [30.0, None])
def test_whisper_fused_attention_on_card(cuda, pad, monkeypatch):
    """The tiny Whisper of tests/test_torch_whisper.py (64 wide, 2 layers,
    4 heads of 16; seeded port weights) with RADAD_FUSED_ATTENTION=1 on
    the card against the port on the CPU, padded to 30 s (T = 1,500) and
    trimmed (T = 100): f32 features within 1e-4 relative per window, one
    bias-free f32 launch a layer; bf16 features no further from the CPU's
    f32 ones than twice the CPU's bf16 features are (the card's attention
    takes f32 logits, the CPU's default path bf16 ones), one bias-free
    bf16 launch a layer, all in the streamed form at T = 1,500 and the
    resident form at T = 100."""
    import copy

    from radad_tpu_torch.models import whisper
    from radad_tpu_torch.models.encoder import FrozenEncoder

    cfg = whisper.WhisperConfig(d_model=64, num_hidden_layers=2,
                                num_attention_heads=4, ffn_dim=128)
    g = torch.Generator().manual_seed(5)
    model = whisper.init_params(whisper.WhisperEncoder(cfg), g)
    segs = 0.3 * torch.randn((3, 32000), generator=g)

    def feats(dev, dtype):
        enc = FrozenEncoder(name="whisper", model_name="tiny", arch_cfg=cfg,
                            model=copy.deepcopy(model).to(dev),
                            pretrained=False, compute_dtype=dtype,
                            whisper_pad_seconds=pad)
        out = enc.segment_features(segs.to(dev))
        assert out.shape == (3, 1500 if pad else 100, 64)
        return out.double().cpu()

    def rel(a, b):
        return float(((a - b).flatten(1).norm(dim=1)
                      / b.flatten(1).norm(dim=1)).max())

    cpu32, cpu16 = feats("cpu", torch.float32), feats("cpu", torch.bfloat16)
    monkeypatch.setenv("RADAD_FUSED_ATTENTION", "1")
    body, form = dict(fused_mha.body_launches), dict(fused_mha.form_launches)
    card32 = feats(cuda, torch.float32)
    card16 = feats(cuda, torch.bfloat16)
    torch.cuda.synchronize()
    ran = {k: fused_mha.body_launches[k] - n for k, n in body.items()}
    forms = {k: fused_mha.form_launches[k] - n for k, n in form.items()}
    want = "streamed" if pad else "resident"
    assert ran == {"bias": 0, "no_bias": 2, "bias_bf16": 0,
                   "no_bias_bf16": 2}, ran
    assert forms == {f: 2 if f == want else 0 for f in forms}, forms
    assert rel(card32, cpu32) <= 1e-4
    assert rel(card16, cpu32) <= 2 * rel(cpu16, cpu32)


@pytest.mark.parametrize("b", [1, 8, 16, 17, 33, 64, 256])
def test_int8_scan_on_card(cuda, b):
    """torch._int_mm through int8_scan: exact int32 against an int64
    product at every serving and training B (the batch padded to at least
    32 rows, then sliced); a D or a capacity off a multiple of 8 raises,
    never a float product."""
    from radad_tpu_torch.index.quantized import int8_scan

    g = torch.Generator(device=cuda).manual_seed(b)
    q8 = torch.randint(-127, 128, (b, 5376), generator=g, device=cuda,
                       dtype=torch.int8)
    codes = torch.randint(-127, 128, (2048, 5376), generator=g, device=cuda,
                          dtype=torch.int8)
    q8[0], codes[3] = 127, 127
    got = int8_scan(q8, codes)
    assert got.dtype == torch.int32 and got.shape == (b, 2048)
    want = q8.cpu().long() @ codes.cpu().long().t()
    assert torch.equal(got.cpu().long(), want)
    with pytest.raises(ValueError):
        int8_scan(q8[:, :5372].contiguous(), codes[:, :5372].contiguous())
    with pytest.raises(ValueError):
        int8_scan(q8, codes[:2044])


@pytest.mark.parametrize("variant", ["plain", "residual", "refine"])
@pytest.mark.parametrize("b", [8, 128])
def test_sq8_search_on_card_matches_cpu(cuda, variant, b):
    """The SQ8 index's accelerated route on the card (int8 scan, tile
    select at T = 8, m = 5, exact_dot on int8 rows in the form the wrapper
    picks) against the same index on the CPU with the plain kernels:
    distances within 1e-5 relative (queries off the stored rows), ids equal
    up to neighbors tied within f32 rounding;
    each search launches exact_dot once on int8 rows and
    extract_candidates once at T = 8, m = 5."""
    from radad_tpu_torch.data.manifest import file_id
    from radad_tpu_torch.index.quantized import QuantizedIndex
    from radad_tpu_torch.ops import rerank

    g = torch.Generator().manual_seed(3)
    n, d = 3000, 512
    centres = 3.0 * torch.randn((16, d), generator=g)
    x = centres[torch.randint(0, 16, (n,), generator=g)] + torch.randn(
        (n, d), generator=g)
    q = x[:b] + 0.5 * torch.randn((b, d), generator=g)
    kw = {"plain": {}, "residual": dict(residual_nlist=32),
          "refine": dict(refine_bits=4)}[variant]
    paths = [f"r{i}.wav" for i in range(n)]
    idx_cpu = QuantizedIndex(d, "L2", device="cpu", **kw)
    idx_cpu.add(x, [0.0] * n, paths)
    idx_gpu = QuantizedIndex(d, "L2", device=cuda, **kw)
    if variant == "residual":  # the CPU's codebook: no training on the card
        idx_gpu.centroids = idx_cpu.centroids.to(cuda)
        idx_gpu._centroids_host = idx_cpu._centroids_host
    idx_gpu.add(x, [0.0] * n, paths)
    for name in ("codes", "scales", "norm_sq", "cells", "codes2"):
        if getattr(idx_cpu, name) is not None:
            assert torch.equal(getattr(idx_gpu, name).cpu(),
                               getattr(idx_cpu, name)), name
    rerank.reset_launches()
    before = (extract_candidates.launches,
              extract_candidates.shape_launches.get("T=8 m=5", 0))
    ex = [file_id(p) for p in paths[:b]]
    d_gpu, i_gpu = idx_gpu.search(q.numpy(), 5, exclude_ids=ex)
    d_cpu, i_cpu = idx_cpu.search(q.numpy(), 5, exclude_ids=ex)
    assert abs(d_gpu - d_cpu).max() <= 1e-5 * abs(d_cpu).max()
    # ids may differ only between neighbors whose f64 distances to the
    # dequantized rows tie within twice the f32 rounding of the distance's
    # sums, sqrt(D) 2^-24 (|q|^2 + |x|^2 + 2 sum |q_d x_d|)
    qd = q.double()
    for row in (i_gpu != i_cpu).any(-1).nonzero()[0]:
        xs = [torch.as_tensor(idx_cpu.reconstruct_batch(i[row])).double()
              for i in (i_gpu, i_cpu)]
        both = torch.cat(xs)
        tol = 2 * d ** 0.5 * 2.0 ** -24 * float(
            (qd[row] @ qd[row] + both.square().sum(-1)
             + 2 * (both.abs() @ qd[row].abs())).max())
        g, w = ((x - qd[row]).square().sum(-1).sort().values for x in xs)
        assert float((g - w).abs().max()) <= tol, (row, g, w, tol)
    form = "split" if b <= 64 else "per_query"
    assert exact_dot.kind_launches["int8"] == 1 == exact_dot.launches
    assert exact_dot.form_launches[form] == 1
    assert (extract_candidates.launches - before[0],
            extract_candidates.shape_launches["T=8 m=5"] - before[1]) == (1, 1)


@pytest.mark.parametrize("route", ["span", "chunked", "masked"])
@pytest.mark.parametrize("b", [1, 8, 64])
def test_ivf_search_on_card_matches_cpu(cuda, tmp_path, route, b):
    """An IVF index trained on the CPU and loaded on the card: each route
    (the two gather searches, FlatIndex's masked route) against the same
    search on the CPU with the plain path. The queries' probe margins
    exceed 10 times the f32 rounding of the centroid distances, so both
    probe the same cells; ids equal up to neighbors tied within f32
    rounding, distances within 1e-5 relative; the gather routes launch
    no kernel, the masked route exact_dot and extract_candidates."""
    from radad_tpu_torch.data.manifest import file_id
    from radad_tpu_torch.index.flat import FlatIndex
    from radad_tpu_torch.index.ivf_gather import (ivf_gather_search,
                                                  ivf_gather_search_chunked)

    g = torch.Generator().manual_seed(5)
    n, d, nlist, nprobe = 6000, 512, 64, 4
    centres = 3.0 * torch.randn((48, d), generator=g)
    x = centres[torch.randint(0, 48, (n,), generator=g)] + torch.randn(
        (n, d), generator=g)
    q = x[:b] + 0.5 * torch.randn((b, d), generator=g)
    paths = [f"r{i}.wav" for i in range(n)]
    cpu = FlatIndex(d, "IVF", nlist=nlist, nprobe=nprobe, device="cpu")
    cpu.add(x, [0.0] * n, paths)
    cpu.save(str(tmp_path))
    card = FlatIndex.load(str(tmp_path), device=cuda)
    # probe margins: the nprobe-th and next centroid distances (f64) apart
    q64, c64 = q.double(), cpu.centroids.double()
    dist = (q64[:, None] - c64[None]).square().sum(-1).sort(-1).values
    csq = c64.square().sum(-1)
    tol_c = (2.0 ** -21 * (q64.square().sum(-1) + csq.max())
             + 2 * d ** 0.5 * 2.0 ** -24 * (csq[None] + 2 * q64.abs()
                                            @ c64.abs().t()).amax(-1))
    assert bool((dist[:, nprobe] - dist[:, nprobe - 1] > 10 * tol_c).all())
    ex = torch.as_tensor([file_id(p) for p in paths[:b]], dtype=I32)
    launches = (exact_dot.launches, extract_candidates.launches,
                gather_rows.launches)

    def run(ix, qq, ee):
        if route == "masked":
            return [torch.as_tensor(a) for a in ix.search(
                qq.cpu().numpy(), 5, exclude_ids=ee.cpu().numpy(),
                gather=False)]
        head = (qq, ix.vectors, ix.norms_sq, ix.ids, ee, ix.centroids)
        if route == "span":
            return ivf_gather_search(*head, ix.ivf_table, ix.ivf_overflow, 5,
                                     nprobe=nprobe)
        return ivf_gather_search_chunked(
            *head, ix.ivf_chunk_rows, ix.ivf_cell_chunks, ix.cells, 5,
            nprobe=nprobe, budget=ix.chunk_budget(nprobe), n_valid=ix.n)[:2]

    d_gpu, i_gpu = (a.cpu() for a in run(card, q.to(cuda), ex.to(cuda)))
    torch.cuda.synchronize()
    d_cpu, i_cpu = run(cpu, q, ex)
    moved = [a - b_ for a, b_ in zip((exact_dot.launches,
                                      extract_candidates.launches,
                                      gather_rows.launches), launches)]
    assert moved == ([1, 1, 0] if route == "masked" else [0, 0, 0]), moved
    assert float((d_gpu - d_cpu).abs().max()) <= 1e-5 * float(
        d_cpu.abs().max())
    qd = q.double()
    for row in (i_gpu != i_cpu).any(-1).nonzero()[:, 0].tolist():
        xs = [x[i[row].long()].double() for i in (i_gpu, i_cpu)]
        both = torch.cat(xs)
        tol = 2 * d ** 0.5 * 2.0 ** -24 * float(
            (qd[row] @ qd[row] + both.square().sum(-1)
             + 2 * (both.abs() @ qd[row].abs())).max())
        gd, wd = ((xx - qd[row]).square().sum(-1).sort().values
                  for xx in xs)
        assert float((gd - wd).abs().max()) <= tol, (row, gd, wd, tol)


def test_predict_batch_uploads_its_page_locked_batch_on_card(cuda, tmp_path):
    """``predict_batch`` on the card decodes into a page-locked batch and
    uploads it with ``non_blocking=True``: the device tensor the encoder
    is given equals ``torch.as_tensor`` of the serially decoded, stacked
    clips; a second call, made as the first returns, on other clips of
    the same shape gets its own clips."""
    import numpy as np

    from radad_tpu_torch.config import Config
    from radad_tpu_torch.data import audio
    from radad_tpu_torch.models.encoder import FrozenEncoder
    from radad_tpu_torch.models.wav2vec2 import (Wav2Vec2Config,
                                                 Wav2Vec2Model, init_params)
    from radad_tpu_torch.train.pipeline import DetectionPipeline

    arch = Wav2Vec2Config(
        hidden_size=32, num_hidden_layers=2, num_attention_heads=4,
        intermediate_size=64, conv_dim=(16, 16, 16, 16),
        conv_kernel=(10, 8, 4, 4), conv_stride=(5, 4, 4, 4),
        num_conv_pos_embeddings=16, num_conv_pos_embedding_groups=4)
    model = init_params(Wav2Vec2Model(arch),
                        torch.Generator().manual_seed(0)).to(cuda).eval()
    enc = FrozenEncoder(name="wav2vec2", model_name="tiny", arch_cfg=arch,
                        model=model, pretrained=False, layers_to_use=(-2, -1))
    cfg = Config().replace(data_root=str(tmp_path),
                           vector_db_path=str(tmp_path / "vdb"),
                           use_layer_norm=True, use_batch_norm=False)
    pipe = DetectionPipeline(cfg, encoder=enc, device=cuda)
    rng = np.random.default_rng(3)
    paths = []
    for i in range(16):
        p = str(tmp_path / f"c{i}.wav")
        audio.write_wav(p, rng.uniform(-0.5, 0.5, 48000 - 997 * i)
                        .astype(np.float32))
        paths.append(p)
    given = []
    inner = pipe._embed

    def record(waves, lengths=None):
        given.append(waves.clone())
        return inner(waves, lengths)

    pipe._embed = record
    host = []
    tensors = pipe._predict_tensors

    def record_host(waves, *a):
        host.append(waves.is_pinned())
        return tensors(waves, *a)

    pipe._predict_tensors = record_host
    pinned = audio.decode_counts.pinned
    for batch in (paths[:8], paths[8:]):
        pipe.predict_batch(batch)
    assert host == [True, True]
    assert audio.decode_counts.pinned == pinned + 2
    for batch, got in zip((paths[:8], paths[8:]), given):
        want = torch.as_tensor(np.stack([audio.load_audio(p) for p in batch]),
                               device=cuda)
        assert got.device == want.device
        assert torch.equal(got, want)
