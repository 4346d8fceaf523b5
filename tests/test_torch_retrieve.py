"""The pipeline's search seam on one device: ``DetectionPipeline._retrieve``
is one call of its index's ``retrieve``, which returns, bit for bit, what
the module-level retrieval of its route returns on the index's own arrays
(``retrieve_on_device``, ``retrieve_on_device_ivf_gather_chunked``,
``retrieve_on_device_sq8``), and counts each search on that route's
counters: flat L2, IVF on both sides of the serving gate (2 B budget chunk
< n), SQ8 plain and residual."""

import numpy as np
import pytest
import torch

from radad_tpu_torch.config import Config
from radad_tpu_torch.index.flat import retrieve_on_device
from radad_tpu_torch.index.ivf_gather import \
    retrieve_on_device_ivf_gather_chunked
from radad_tpu_torch.index.quantized import retrieve_on_device_sq8
from radad_tpu_torch.train.pipeline import DetectionPipeline

N, K = 2048, 5
COUNTS = ("searches", "fallbacks", "ivf_gather_searches",
          "ivf_gather_fallbacks")


class _TinyEncoder:
    """The attributes DetectionPipeline reads of an encoder, no weights."""

    feature_dim = 8
    compute_dtype = torch.float32


def _module_level(ix, tpp, ex, mode, route):
    """The route's module-level retrieval on ``ix``'s arrays → (neighbors,
    labels, dists, idx, fell_back)."""
    if route == "sq8":
        return retrieve_on_device_sq8(
            tpp, ix.codes, ix.scales, ix.norm_sq, ix.labels, ix.ids, ex, k=K,
            metric=ix.metric, n_valid=ix.ntotal, accel=ix.build_accel,
            exclude_mode=mode, centroids=ix.centroids, cells=ix.cells,
            codes2=ix.codes2, scales2=ix.scales2,
            rerank_depth=ix.rerank_depth) + (False,)
    if route == "gather":
        nprobe = min(ix.nprobe, ix.ivf_cell_chunks.shape[0])
        return retrieve_on_device_ivf_gather_chunked(
            tpp, ix.vectors, ix.norms_sq, ix.labels, ix.ids, ex,
            ix.centroids, ix.ivf_chunk_rows, ix.ivf_cell_chunks, ix.cells,
            k=K, nprobe=nprobe, budget=ix.chunk_budget(nprobe),
            n_valid=ix.ntotal, exclude_mode=mode)
    return retrieve_on_device(
        tpp, ix.vectors, ix.labels, ix.ids, ex, k=K, metric=ix.metric,
        n_valid=ix.ntotal, xsq=ix.norms_sq, scan_bf16=ix.scan_bf16,
        resid_bf16=ix.resid_bf16, exclude_mode=mode,
        use_pallas=ix.use_pallas)


@pytest.mark.parametrize("kind,over,b,mode,route", [
    ("l2", {"vector_db_index_type": "L2"}, 16, "batch", "unprobed"),
    ("ivf_gather", {"vector_db_index_type": "IVF", "vector_db_nlist": 64,
                    "vector_db_nprobe": 4}, 1, "self", "gather"),
    ("ivf_unprobed", {"vector_db_index_type": "IVF", "vector_db_nlist": 64,
                      "vector_db_nprobe": 4}, 16, "self", "unprobed"),
    ("sq8", {"vector_db_index_type": "SQ8"}, 16, "batch", "sq8"),
    ("sq8_residual", {"vector_db_index_type": "SQ8",
                      "sq8_residual_nlist": 4}, 8, "self", "sq8"),
])
def test_pipeline_retrieve_is_the_index_retrieve(tmp_path, kind, over, b,
                                                 mode, route):
    cfg = Config(data_root=str(tmp_path), top_k=K,
                 vector_db_path=str(tmp_path / "db"), **over)
    pipe = DetectionPipeline(cfg, device="cpu", encoder=_TinyEncoder())
    ix = pipe.index
    rng = np.random.default_rng(3)
    # clustered rows, so that IVF's cells differ in size
    centers = rng.standard_normal((32, pipe.tpp_dim)).astype(np.float32)
    rows = (centers[rng.integers(0, 32, N)]
            + 0.3 * rng.standard_normal((N, pipe.tpp_dim))).astype(
        np.float32)
    ix.add(rows, (rng.random(N) > 0.5).astype(np.float32).tolist(),
           [f"c{i}.wav" for i in range(N)], ids=list(range(N)))
    take = rng.choice(N, b, replace=False)
    tpp = torch.as_tensor(rows[take] + 0.05 * rng.standard_normal(
        (b, pipe.tpp_dim)).astype(np.float32))
    ex = torch.as_tensor(take.astype(np.int32))  # each query's own row

    def counted(fn):
        before = [getattr(ix, c, 0) for c in COUNTS]
        out = fn()
        return out, [getattr(ix, c, 0) - v for c, v in zip(COUNTS, before)]

    got, by_pipe = counted(lambda: pipe._retrieve(
        tpp, ex, mode, prefer_ivf_gather=route == "gather"))
    own, by_index = counted(lambda: ix.retrieve(
        tpp, ex, k=K, exclude_mode=mode, serving=route == "gather"))
    want = _module_level(ix, tpp, ex, mode, route)
    assert len(got) == len(own) == 4
    for a, c, w in zip(got, own, want[:4]):
        assert torch.equal(a, w) and torch.equal(c, w)
    fell_back = int(want[4])
    expected = ([0, 0, 1, fell_back] if route == "gather"
                else [1, fell_back, 0, 0])
    assert by_pipe == by_index == expected
    # self-exclusion held: no query returns its own row
    assert not bool((got[3] == ex[:, None]).any())
