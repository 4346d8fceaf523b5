"""DetectionPipeline on a mesh (radad_tpu_torch) on the CPU: gloo worlds of
2 ranks (meshes 1 x 2, then 2 x 1) and 4 (2 x 2) build, save, load,
evaluate, serve and train, held to the one-device pipeline on the same
clips and weights, each search to the plain single-process form of its
sharded search; the index files against one device's and JAX's; the SQ8
refinement and a batch off the 'data' axis refused as JAX refuses them;
the CLI under torch.distributed.run. The rank-side code is
tests/test_torch_parallel_worlds.py."""

import json
import os
import socket
import subprocess
import sys
import types

import jax
import numpy as np
import pytest
import torch

from radad_tpu_torch.data.manifest import load_manifests

from test_torch_encoder import TINY, _fake_hf_state_dict
from test_torch_parallel_worlds import (pipe_config, pipeline_cases,
                                        run_world, serve_record,
                                        tiny_encoder)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPES = {2: [(1, 2), (2, 1)], 4: [(2, 2)]}


@pytest.fixture(scope="module")
def one_device(tmp_path_factory, synthetic_dataset):
    """The one-device port pipeline on the same clips and weights (its DB
    saved), the same DB written by the JAX package, and a refined SQ8 DB."""
    from radad_tpu.index.flat import FlatIndex as JFlat
    from radad_tpu_torch.index.quantized import QuantizedIndex
    from radad_tpu_torch.train.pipeline import DetectionPipeline

    root = tmp_path_factory.mktemp("one_device")
    splits = load_manifests(synthetic_dataset)
    val = [os.path.join(synthetic_dataset, x)
           for x in splits["val"].paths[:3]]
    pipe = DetectionPipeline(pipe_config(str(root / "flat"),
                                         synthetic_dataset),
                             encoder=tiny_encoder(TINY), device="cpu")
    pipe.build_vector_database(splits["train"], save=True)
    scores = pipe.evaluate_with_scores(splits["val"])
    rec = dict(serve_record(pipe, val), scores=scores[2], labels=scores[3],
               embed=pipe.get_embeddings(splits["train"]).numpy())
    jax_vdb = str(root / "jax_vdb")
    JFlat.load(pipe.config.vector_db_path).save(jax_vdb)
    refined = QuantizedIndex(pipe.tpp_dim, "L2", refine_bits=4,
                             device="cpu")
    refined.add(rec["embed"], splits["train"].labels.tolist(),
                list(splits["train"].paths))
    refined.save(str(root / "refined_vdb"))
    return dict(rec, vdb=pipe.config.vector_db_path, jax_vdb=jax_vdb,
                root=str(root), cap=int(pipe.index.ids.shape[0]))


@pytest.fixture(scope="module", params=[2, 4], ids=["world2", "world4"])
def mesh_runs(request, one_device, synthetic_dataset, tmp_path_factory):
    """{mesh shape: rank 0's results} of one world (every rank's results
    must agree, since every rank returns the whole answers)."""
    world = request.param
    root = str(tmp_path_factory.mktemp(f"mesh{world}"))
    os.symlink(os.path.join(one_device["root"], "refined_vdb"),
               os.path.join(root, "refined_vdb"))
    outs = run_world(pipeline_cases, world, root,
                     dict(arch=TINY, data=synthetic_dataset, root=root,
                          jax_vdb=one_device["jax_vdb"]))
    for o in outs[1:]:
        for shape, res in o.items():
            for key in ("flat", "loaded", "from_jax"):
                assert res[key]["files"] == outs[0][shape][key]["files"]
    return root, outs[0]


def _same_serving(got, want):
    """predict_batch and predict: the same neighbors, logits within 1e-4
    relative (the one-device pipeline's parity with JAX,
    tests/test_torch_pipeline.py), distances within 1e-5 relative."""
    assert got["files"] == want["files"]
    assert got["predict_files"] == want["predict_files"]
    np.testing.assert_allclose(got["logits"], want["logits"], rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(got["predict_logit"], want["predict_logit"],
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got["dists"], want["dists"], rtol=1e-5)


def test_mesh_pipeline_matches_one_device(mesh_runs, one_device):
    """build, evaluate_with_scores, predict_batch (3 clips: padded to the
    'data' axis) and predict on every mesh shape give the one-device
    pipeline's answers; each rank holds its block of the padded
    capacity."""
    _, res = mesh_runs
    for (data, index), r in res.items():
        f = r["flat"]
        _same_serving(f, one_device)
        np.testing.assert_array_equal(f["labels"], one_device["labels"])
        np.testing.assert_allclose(f["scores"], one_device["scores"],
                                   rtol=1e-4, atol=1e-5)
        assert f["rows_a_rank"] == one_device["cap"] // index


@pytest.mark.parametrize("kind", ["flat_plain", "sq8", "sq8_residual",
                                  "ivf"])
def test_mesh_search_held_to_plain_form(mesh_runs, kind):
    """predict_batch's neighbors on the mesh equal the plain single-process
    form of its sharded search over the whole index (flat; SQ8 plain and
    residual; IVF, whose predict calls take the gather route)."""
    _, res = mesh_runs
    for shape, r in res.items():
        assert r[kind]["got"] == r[kind]["plain"], (shape, kind)
        if kind == "ivf":
            assert r["ivf_gather_searches"] > 0, shape
            assert np.isfinite(r["ivf_loss"])
        if kind.startswith("sq8"):
            assert np.isfinite(r[kind + "_loss"])


def test_mesh_serving_collectives(mesh_runs):
    """predict_batch on a mesh: the merge's 4 all-gathers over 'index', the
    retry decision's all-reduce over 'data', the results' 4 all-gathers
    over 'data'."""
    _, res = mesh_runs
    for r in res.values():
        assert r["serve_calls"] == {"all_gather/index": 4,
                                    "all_reduce/data": 1,
                                    "all_gather/data": 4}


def test_mesh_train_end_to_end(mesh_runs):
    """train() on every mesh shape: one epoch with validation, finite
    losses, metrics.csv and the final checkpoint written once (rank 0)."""
    root, res = mesh_runs
    for (data, index), r in res.items():
        row = r["train_row"]
        assert np.isfinite(row["train_loss"]) and np.isfinite(
            row["val_loss"])
        run = os.path.join(root, f"{data}x{index}", "flat")
        assert os.path.exists(os.path.join(run, "metrics.csv"))
        assert os.path.exists(os.path.join(run, "models",
                                           "final_model_radad.pt"))


def test_mesh_load_builds_no_accel_arrays(mesh_runs, one_device):
    """load_vector_database on a mesh builds no accelerator arrays (JAX's
    build_accel = mesh is None), keeps the whole index on the host, and
    serves the one-device answers."""
    _, res = mesh_runs
    for r in res.values():
        lo = r["loaded"]
        assert lo["build_accel"] is False and lo["scan_bf16"]
        assert lo["device"] == "cpu"
        _same_serving(lo, one_device)


def test_sharded_db_build_embed(mesh_runs, one_device):
    """shard_db_build=True: each DB-build batch that divides 'data' is
    embedded a slice a rank and all-gathered; the embeddings are the
    one-device ones within 1e-5."""
    _, res = mesh_runs
    for r in res.values():
        np.testing.assert_allclose(r["embed"], one_device["embed"],
                                   rtol=1e-5, atol=1e-5)


def test_index_files_byte_for_byte(mesh_runs, one_device):
    """Rank 0's saved DB is one device's, byte for byte; it loads in the
    JAX package with the same rows; a DB written by JAX loads on the mesh
    and serves the one-device answers."""
    from radad_tpu.index.flat import FlatIndex as JFlat

    root, res = mesh_runs
    for (data, index), r in res.items():
        vdb = os.path.join(root, f"{data}x{index}", "flat", "vdb")
        for name in ("index_meta.json", "index_host.pkl"):
            with open(os.path.join(vdb, name), "rb") as a, open(
                    os.path.join(one_device["vdb"], name), "rb") as b:
                assert a.read() == b.read(), name
        got, want = (np.load(os.path.join(d, "index_arrays.npz"))
                     for d in (vdb, one_device["vdb"]))
        assert sorted(got.files) == sorted(want.files)
        for key in got.files:
            assert got[key].dtype == want[key].dtype
            assert got[key].tobytes() == want[key].tobytes(), key
        jix = JFlat.load(vdb)
        np.testing.assert_array_equal(np.asarray(jix.vectors)[:jix.n],
                                      want["vectors"])
        _same_serving(r["from_jax"], one_device)


def test_refined_sq8_refused_on_mesh(mesh_runs):
    """A refined SQ8 config raises at _make_index on a mesh, and a refined
    SQ8 DB raises at load_vector_database (JAX pipeline.py:409-413,
    1589-1597)."""
    _, res = mesh_runs
    for r in res.values():
        assert "single-chip" in r["errors"]["make_index"]
        assert "refine_bits=4" in r["errors"]["load"]


def test_batch_off_the_data_axis_refused_as_jax(mesh_runs):
    """A train or eval batch that does not divide the 'data' axis raises
    ValueError on the port's mesh, as JAX's device_put of the batch does
    (its dense fallthrough in _retrieve is never reached from train or
    evaluate); serving batches are padded instead (3 clips above)."""
    from radad_tpu.parallel import make_mesh as jmake_mesh
    from radad_tpu.train.pipeline import DetectionPipeline as JPipe

    _, res = mesh_runs
    for (data, _), r in res.items():
        if data > 1:
            assert "not divisible" in r["errors"]["batch"]
    jmesh = jmake_mesh(data=2, index=1, devices=jax.devices()[:2])
    with pytest.raises(ValueError, match="divisible by 2"):
        JPipe._shard_batch(types.SimpleNamespace(mesh=jmesh),
                           np.zeros((5,), np.float32))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_cli_trains_under_torchrun(synthetic_dataset, tmp_path, rng):
    """python -m torch.distributed.run --standalone --nproc_per_node 2 -m
    radad_tpu_torch.cli --mode train --device cpu --index_shards 2 trains
    on a 1 x 2 gloo mesh and rank 0 writes metrics.csv; --data_shards 2
    --index_shards 2 in that world of 2 raises make_mesh's ValueError."""
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
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")

    def run(*mesh_args):
        return subprocess.run(
            [sys.executable, "-m", "torch.distributed.run", "--standalone",
             "--nproc_per_node", "2", "-m", "radad_tpu_torch.cli",
             "--mode", "train", "--device", "cpu", *mesh_args,
             "--data_path", synthetic_dataset, "--data_root", root,
             "--weights_dir", str(tmp_path / "weights"), "--model_name",
             "org/tiny", "--batch_size", "8", "--eval_batch_size", "8",
             "--db_batch_size", "8", "--epochs", "1"],
            cwd=REPO, env=env, capture_output=True, text=True, timeout=240)

    proc = run("--index_shards", "2")
    assert proc.returncode == 0, proc.stderr[-3000:]
    with open(os.path.join(root, "metrics.csv")) as f:
        assert len(f.read().strip().splitlines()) == 2  # header + epoch 1
    assert os.path.exists(os.path.join(root, "models",
                                       "final_model_radad.pt"))
    bad = run("--data_shards", "2", "--index_shards", "2")
    assert bad.returncode != 0
    assert "mesh 2x2 != 2" in bad.stderr
