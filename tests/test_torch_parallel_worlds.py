"""Rank-side code of the port's mesh tests: a world of gloo ranks spawned
under torch.multiprocessing (``run_world``) and the cases each world runs
(the sharded searches, the data-parallel step, the tensor-parallel
encoder, the pipeline on a mesh). It imports torch and the port only: each
spawned rank imports this module, and JAX would add seconds a rank. The
JAX references run in the pytest process (tests/test_torch_parallel.py,
tests/test_torch_parallel_pipeline.py).

Every world has a collective timeout (``COLLECTIVE_TIMEOUT_S``, given to
``init_process_group``) and a join deadline after which ``run_world``
kills the ranks still running and fails; the tests below show both."""

import datetime
import os
import pickle
import time

import numpy as np
import pytest
import torch

from radad_tpu_torch.parallel import sharded_index as tsi

COLLECTIVE_TIMEOUT_S = 60
WORLD_DEADLINE_S = 240
K = 5


def _rank_entry(rank, fn, world, tmp, payload):
    """One rank: a gloo process group over a file store, ``fn(rank,
    payload)``, its result pickled for the parent."""
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method=f"file://{tmp}/store", rank=rank,
        world_size=world,
        timeout=datetime.timedelta(seconds=COLLECTIVE_TIMEOUT_S))
    try:
        # every rank's connections are up before any rank can finish and
        # close its own: a rank still in init_process_group would see its
        # peer gone
        dist.barrier()
        out = fn(rank, payload)
        with open(os.path.join(tmp, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(out, f)
    finally:
        dist.destroy_process_group()


def run_world(fn, world: int, tmp, payload,
              deadline_s: float = WORLD_DEADLINE_S):
    """``fn(rank, payload)`` on ``world`` spawned gloo ranks → their
    results by rank. A rank that raises fails the call; ranks still
    running at the deadline are killed and the call fails."""
    import torch.multiprocessing as mp

    tmp = str(tmp)
    ctx = mp.start_processes(_rank_entry, args=(fn, world, tmp, payload),
                             nprocs=world, join=False, start_method="spawn")
    end = time.monotonic() + deadline_s
    try:
        while not ctx.join(timeout=max(0.1, end - time.monotonic())):
            if time.monotonic() >= end:
                raise TimeoutError(f"world of {world} ranks passed its "
                                   f"{deadline_s} s deadline")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
            p.join(5)
    out = []
    for r in range(world):
        with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as f:
            out.append(pickle.load(f))
    return out


def _gathered(mesh, ret):
    """A sharded search's results over the whole batch (all-gathered over
    'data') as numpy."""
    from radad_tpu_torch.parallel.mesh import DATA_AXIS

    return {name: mesh.all_gather(t, DATA_AXIS).flatten(0, 1).numpy()
            for name, t in zip(("neighbors", "labels", "dists", "indices"),
                               ret)}


def _np_ret(ret):
    return {name: np.asarray(t) for name, t in
            zip(("neighbors", "labels", "dists", "indices"), ret)}


STEP_ARCH = dict(hidden_size=16, num_hidden_layers=1, num_attention_heads=2,
                 intermediate_size=32, conv_dim=(8, 8), conv_kernel=(10, 8),
                 conv_stride=(8, 8), num_conv_pos_embeddings=8,
                 num_conv_pos_embedding_groups=2)
STEP_CFG = dict(clip_duration=0.5, segment_length=0.25, segment_overlap=0.5,
                use_layer_norm=False, use_batch_norm=True, top_k=3,
                projection_dropout=0.0, detection_dropout=0.0)
STEP_B, STEPS = 32, 3



# ----------------------------------------------------- the index world
def _index_cases(rank, p):
    """Every sharded-search case on a 2 x 2 mesh: flat (3 metrics x 2
    modes), collective counts, SQ8, IVF masked and gather-probed, each
    beside its plain single-process form."""
    from radad_tpu_torch.parallel import make_mesh
    from radad_tpu_torch.parallel.mesh import index_sharding

    mesh = make_mesh(2, 2)
    t = torch.as_tensor
    out = {"coords": (mesh.coord("data"), mesh.coord("index"))}

    def local(x):  # this rank's slice of a batch
        from radad_tpu_torch.parallel.mesh import batch_sharding
        return batch_sharding(mesh, t(x))

    f = p["flat"]
    for metric in ("L2", "IP", "COSINE"):
        six = tsi.ShardedIndex(mesh, f["vecs"].shape[1], metric)
        six.build(f["vecs"], f["labels"], f["ids"])
        for mode in ("batch", "self"):
            mesh.reset_counts()
            ret = six.retrieve(local(f["q"]), local(f["excl"]), k=K,
                               exclude_mode=mode)
            out[("calls", metric, mode)] = dict(mesh.calls)
            out[("flat", metric, mode)] = _gathered(mesh, ret)
    # the plain form over the same padded table (L2)
    vec_p = tsi.pad_rows(f["vecs"], 334)
    out["plain_flat"] = _np_ret(tsi.plain_sharded_retrieve(
        t(f["q"]), t(vec_p), t(tsi.pad_rows(f["labels"], 334)),
        t(tsi.pad_rows(f["ids"], 334, -1)), t(np.arange(334) < 333),
        t(f["excl"]), shards=2, k=K))

    s = p["sq8"]
    for name in ("plain", "residual"):
        a = s[name]
        blk = {key: index_sharding(mesh, t(v)) for key, v in a.items()
               if key != "centroids"}
        cents = t(a["centroids"]) if "centroids" in a else None
        ret = tsi.sharded_retrieve_sq8(
            mesh, local(s["q"]), blk["codes"], blk["scales"],
            blk["norm_sq"], blk["labels"], blk["ids"], local(s["excl"]),
            k=K, centroids=cents, cells=blk.get("cells"))
        out[("sq8", name)] = _gathered(mesh, ret)
        out[("sq8_plain", name)] = _np_ret(tsi.plain_sharded_retrieve_sq8(
            t(s["q"]), t(a["codes"]), t(a["scales"]), t(a["norm_sq"]),
            t(a["labels"]), t(a["ids"]), t(s["excl"]), shards=2, k=K,
            centroids=cents, cells=t(a["cells"]) if cents is not None
            else None))

    v = p["ivf"]
    ret = tsi.sharded_retrieve(
        mesh, local(v["q"]), index_sharding(mesh, t(v["cap_vectors"])),
        index_sharding(mesh, t(v["cap_labels"])),
        index_sharding(mesh, t(v["cap_ids"])),
        index_sharding(mesh, t(v["cap_ids"]) >= 0),
        local(np.full(8, -2, np.int32)), k=K, centroids=t(v["centroids"]),
        cells=index_sharding(mesh, t(v["cells"])), nprobe=8)
    out["ivf_masked"] = _gathered(mesh, ret)
    six = tsi.ShardedIndex(mesh, v["vecs"].shape[1], "L2")
    six.build(v["vecs"], v["labels"], v["ids"])
    six.build_ivf(v["centroids"], v["cells"])
    for mode, q, excl, nprobe in (("batch", v["q"], v["excl"], 8),
                                  ("self", v["q_self"], v["excl_self"], 16)):
        out[("gather", mode)] = _gathered(mesh, six.retrieve_gather(
            local(q), local(excl), K, nprobe, exclude_mode=mode))
        ret, scanned = tsi.sharded_retrieve_ivf_gather(
            mesh, local(q), six.vectors, six.labels, six.ids, local(excl),
            six.centroids, six.cells, six.chunk_rows, six.cell_chunks,
            six.n_valid_shard, k=K, nprobe=nprobe, budget=1,
            exclude_mode=mode)
        out[("gather_budget1", mode)] = _gathered(mesh, ret)
        out[("gather_budget1_scanned", mode)] = scanned
        out[("gather_budget", mode)] = six.gather_budget(nprobe)
    cells_p = np.zeros((500,), np.int32)
    cells_p[:500] = v["cells"][:500]
    cr, cc, nvs, _ = tsi.build_sharded_chunk_tables(cells_p, 500, 16, 2)
    out["gather_plain"] = _np_ret(tsi.plain_sharded_retrieve_ivf_gather(
        t(v["q"]), t(tsi.pad_rows(v["vecs"], 500)),
        t(tsi.pad_rows(v["labels"], 500)),
        t(tsi.pad_rows(v["ids"], 500, -1)), t(v["excl"]),
        t(v["centroids"]), t(cells_p), t(cr), t(cc), nvs, shards=2, k=K,
        nprobe=8, budget=six.gather_budget(8)))
    return out


def _port_model(p):
    """The port's encoder, fusion model and optimizer from the JAX
    weights."""
    from radad_tpu_torch.config import Config as TConfig
    from radad_tpu_torch.models.convert import (encoder_from_jax,
                                                fusion_from_flax)
    from radad_tpu_torch.models.encoder import FrozenEncoder
    from radad_tpu_torch.models.fusion import build_radad_model
    from radad_tpu_torch.models.wav2vec2 import Wav2Vec2Config
    from radad_tpu_torch.train.optim import GroupAdam

    arch = Wav2Vec2Config(**STEP_ARCH)
    enc = FrozenEncoder(name="wav2vec2", model_name="tiny", arch_cfg=arch,
                        model=encoder_from_jax(p["params"], arch),
                        pretrained=False, layers_to_use=(-1,))
    cfg = TConfig().replace(**STEP_CFG)
    model = fusion_from_flax(build_radad_model(cfg, p["dtpp"]),
                             p["variables"])
    opt = GroupAdam(cfg.learning_rate, cfg.weight_decay)
    opt.init(dict(model.named_parameters()))
    return enc, cfg, model, opt


def adam_moments(state):
    """Adam's first and second moments by group, as numpy:
    ``{group: {"mu": {name: array}, "nu": {...}}}`` from an optimizer state
    (the port's, or JAX's converted by ``adam_state_from_optax``)."""
    return {g: {key: {n: np.asarray(t).copy() for n, t in st[key].items()}
                for key in ("mu", "nu")} for g, st in state.items()}


def _snapshot(model, opt, metrics):
    det = model.detection_model
    return {"metrics": {k: float(v) for k, v in metrics.items()},
            "params": {n: p.detach().numpy().copy()
                       for n, p in model.named_parameters()},
            "adam": adam_moments(opt.state),
            "bn": [(bn.running_mean.numpy().copy(),
                    bn.running_var.numpy().copy()) for bn in det.norms]}


def _restart(model, opt, start):
    """The model's and optimizer's state from ``start`` (a step's starting
    state, JAX's converted): each compared step starts from JAX's state,
    as in tests/test_torch_train.py, so a coordinate that Adam moved by
    rounding does not carry into the next step."""
    model_sd, opt_sd = start
    model.load_state_dict({k: torch.as_tensor(v) for k, v in
                           model_sd.items()})
    opt.load_state_dict(opt_sd)


def _mesh_steps(mesh, p):
    """3 steps of make_parallel_train_step on this rank's slices, each from
    the given starting state."""
    from radad_tpu_torch.parallel import make_parallel_train_step
    from radad_tpu_torch.parallel.mesh import batch_sharding

    enc, cfg, model, opt = _port_model(p)
    six = tsi.ShardedIndex(mesh, p["dtpp"], "L2")
    six.build(p["db_vecs"], p["db_labels"], p["db_ids"])
    step = make_parallel_train_step(model, enc, cfg, opt, mesh)
    out = []
    for batch, start in zip(p["batches"], p["starts"]):
        _restart(model, opt, start)
        loc = [batch_sharding(mesh, torch.as_tensor(a)) for a in batch]
        m = step((six.vectors, six.labels, six.ids, six.row_valid), *loc,
                 1.0)
        out.append(_snapshot(model, opt, m))
    return out


def _tp_embed(mesh, p):
    """Embeddings of the replicated tiny encoder and of its tensor-parallel
    shard (over 'index') on this rank's slice of the clips."""
    from radad_tpu_torch.config import Config as TConfig
    from radad_tpu_torch.models.encoder import FrozenEncoder
    from radad_tpu_torch.models.wav2vec2 import (Wav2Vec2Config,
                                                 Wav2Vec2Model, init_params)
    from radad_tpu_torch.parallel import shard_encoder_params
    from radad_tpu_torch.parallel.mesh import batch_sharding
    from radad_tpu_torch.train.pipeline import make_embed_fn

    arch = Wav2Vec2Config(**p["tp_arch"])
    model = init_params(Wav2Vec2Model(arch), torch.Generator().manual_seed(0))
    cfg = TConfig().replace(clip_duration=1.0, segment_length=0.5,
                            segment_overlap=0.5)

    def enc(m):
        return FrozenEncoder(name="wav2vec2", model_name="tiny",
                             arch_cfg=arch, model=m, pretrained=False,
                             layers_to_use=(-2, -1))

    audio = batch_sharding(mesh, torch.as_tensor(p["tp_audio"]))
    tp_model = shard_encoder_params(model, mesh)
    mesh.reset_counts()
    got = make_embed_fn(enc(tp_model), cfg)(audio)
    calls = dict(mesh.calls)
    out = {"ref": make_embed_fn(enc(model), cfg)(audio).numpy(),
           "tp": got.numpy(), "calls": calls,
           "w1_rows": tp_model.layers[0]["ffn"]["w1"].shape[0],
           "ow_cols": tp_model.layers[0]["attn"]["ow"].shape[1]}
    # WavLM (post-LN base and stable pre-LN): each rank's heads of the
    # gated relative position bias
    from radad_tpu_torch.models import wavlm

    for name, over in (("wavlm", {}), ("wavlm_stable", p["tp_stable"])):
        arch = wavlm.WavLMConfig(**dict(p["tp_wavlm_arch"], **over))
        model = wavlm.init_params(wavlm.WavLMModel(arch),
                                  torch.Generator().manual_seed(1))

        def lm(m):
            return FrozenEncoder(name="wavlm", model_name="tiny",
                                 arch_cfg=arch, model=m, pretrained=False)

        out[name] = (make_embed_fn(lm(model), cfg)(audio).numpy(),
                     make_embed_fn(lm(shard_encoder_params(model, mesh)),
                                   cfg)(audio).numpy())
    # Whisper (pre-LN, no k bias), the real frames only
    from radad_tpu_torch.models import whisper

    arch = whisper.WhisperConfig(**p["tp_whisper_arch"])
    model = whisper.init_params(whisper.WhisperEncoder(arch),
                                torch.Generator().manual_seed(2))

    def wh(m):
        return FrozenEncoder(name="whisper", model_name="tiny",
                             arch_cfg=arch, model=m, pretrained=False,
                             whisper_pad_seconds=None)

    out["whisper"] = (make_embed_fn(wh(model), cfg)(audio).numpy(),
                      make_embed_fn(wh(shard_encoder_params(model, mesh)),
                                    cfg)(audio).numpy())
    return out


def _step_tp_cases(rank, p):
    """On 2 ranks: the train step on a 2 x 1 mesh (and again with
    BatchNorm's statistics left unsynced, the control), the TP encoder on
    1 x 2. On 4 ranks: the step on 2 x 2 and the TP encoder on it."""
    import torch.distributed as dist

    from radad_tpu_torch.models import fusion
    from radad_tpu_torch.parallel import make_mesh

    world = dist.get_world_size()
    shape = (2, 1) if world == 2 else (2, 2)
    mesh = make_mesh(*shape)
    out = {"steps": _mesh_steps(mesh, p)}
    synced = fusion.batch_stats
    fusion.batch_stats = lambda x, stats_sum=None: synced(x)
    try:
        out["unsynced"] = _mesh_steps(mesh, p)
    finally:
        fusion.batch_stats = synced
    tp_mesh = make_mesh(1, 2) if world == 2 else mesh
    out["tp"] = _tp_embed(tp_mesh, p)
    return out


def _one_device_steps(p):
    """The port's single-device trainer (make_step_fns, exact f32 scan) on
    the whole batches, each step from the given starting state."""
    from radad_tpu_torch.index.flat import FlatIndex, retrieve_on_device
    from radad_tpu_torch.train.pipeline import (make_embed_fn, make_step_fns,
                                                new_accumulators)

    enc, cfg, model, opt = _port_model(p)
    ix = FlatIndex(p["dtpp"], "L2", build_accel=False, device="cpu")
    n = len(p["db_ids"])
    ix.add(p["db_vecs"], p["db_labels"].tolist(),
           [f"r{i}.wav" for i in range(n)], ids=p["db_ids"].tolist())

    def retrieve(tpp, exclude):
        return retrieve_on_device(
            tpp, ix.vectors, ix.labels, ix.ids, exclude, k=cfg.top_k,
            metric="L2", n_valid=ix.ntotal, xsq=ix.norms_sq, scan_bf16=None)

    steps = make_step_fns(model, opt, retrieve)
    embed = make_embed_fn(enc, cfg)
    out = []
    for (audio, labels, excl, valid), start in zip(p["batches"],
                                                   p["starts"]):
        _restart(model, opt, start)
        bm = steps.train_step(new_accumulators("cpu"),
                              embed(torch.as_tensor(audio)).clone(),
                              torch.as_tensor(labels),
                              torch.as_tensor(excl), torch.as_tensor(valid),
                              1.0)
        out.append(_snapshot(model, opt, {
            "loss": bm["loss"], "acc": bm["acc"],
            "grad_norm_projection": bm["gn_proj"],
            "grad_norm_fuse": bm["gn_fuse"],
            "grad_norm_detection": bm["gn_det"]}))
    return out


def _hang_rank(rank, p):
    """Rank 1 waits on a collective that rank 0 never joins."""
    import torch.distributed as dist

    if rank == 1:
        dist.all_reduce(torch.zeros(1))
    else:
        time.sleep(p["sleep"])
    return rank


def _raise_rank(rank, p):
    if rank == 1:
        raise RuntimeError("rank 1 fails")
    return rank


def test_world_deadline_kills_a_hung_world(tmp_path):
    """A world whose collective never completes fails at its join deadline
    with every rank killed, long before the collective timeout."""
    t0 = time.monotonic()
    with pytest.raises(TimeoutError, match="deadline"):
        run_world(_hang_rank, 2, tmp_path, {"sleep": 30.0}, deadline_s=8.0)
    assert time.monotonic() - t0 < 25.0


def test_world_fails_when_a_rank_raises(tmp_path):
    """A rank that raises fails the world, with its error."""
    import torch.multiprocessing as mp

    with pytest.raises(mp.ProcessRaisedException, match="rank 1 fails"):
        run_world(_raise_rank, 2, tmp_path, {})


def test_world_runs_every_rank(tmp_path):
    assert run_world(_ok_rank, 2, tmp_path, {}) == [0, 1]


def _ok_rank(rank, p):
    return rank


# ------------------------------------------------ the pipeline on a mesh
PIPE_CFG = dict(db_batch_size=8, batch_size=8, eval_batch_size=8,
                num_epochs=1, top_k=3, use_layer_norm=True,
                use_batch_norm=False)


def tiny_encoder(arch: dict):
    """The tiny wav2vec2 encoder, seeded: the same weights in every
    process."""
    from radad_tpu_torch.models.encoder import FrozenEncoder
    from radad_tpu_torch.models.wav2vec2 import (Wav2Vec2Config,
                                                 Wav2Vec2Model, init_params)

    cfg = Wav2Vec2Config(**arch)
    return FrozenEncoder(name="wav2vec2", model_name="tiny", arch_cfg=cfg,
                         model=init_params(Wav2Vec2Model(cfg),
                                           torch.Generator().manual_seed(0)),
                         pretrained=False, layers_to_use=(-2, -1))


def pipe_config(root: str, data_path: str, **over):
    from radad_tpu_torch.config import Config

    over = {**PIPE_CFG, "vector_db_path": os.path.join(root, "vdb"), **over}
    return Config().replace(data_root=root, train_data_path=data_path,
                            test_data_path=data_path, **over)


def serve_record(pipe, paths):
    """predict_batch and predict of ``paths`` as comparable values."""
    outs = pipe.predict_batch(paths)
    one = pipe.predict(paths[0])
    return {"files": [o["retrieved_files"] for o in outs],
            "logits": [o["logit"] for o in outs],
            "dists": [[r["distance"] for r in o["retrieved"]] for o in outs],
            "predict_files": one["retrieved_files"],
            "predict_logit": one["logit"]}


def _padded_index(ix, shards: int):
    """The host index's arrays at the mesh's padded capacity (as
    ``ShardedIndex.from_index``)."""
    cap = -(-ix.ids.shape[0] // (8 * shards)) * 8 * shards

    def pad(t, fill=0):
        if t is None or t.shape[0] >= cap:
            return t
        return torch.cat([t, t.new_full((cap - t.shape[0],) + t.shape[1:],
                                        fill)])
    return pad


def _hold_to_plain(pipe, paths, mesh) -> dict:
    """predict_batch's neighbor rows against the plain single-process form
    of the pipeline's sharded search over the whole (host) index, on the
    same embeddings, "self" exclusion; → {"equal": ..., "route": ...}."""
    from radad_tpu_torch.data.audio import load_audio
    from radad_tpu_torch.data.manifest import file_id

    cfg, ix = pipe.config, pipe.index
    rows = {os.path.basename(p): i for i, p in enumerate(ix.paths)}
    got = [[rows[f] for f in o["retrieved_files"]]
           for o in pipe.predict_batch(paths)]
    waves = np.stack([load_audio(p, sample_rate=cfg.sample_rate,
                                 duration=cfg.clip_duration) for p in paths])
    tpp = pipe._embed(torch.as_tensor(waves))
    excl = torch.as_tensor([file_id(p) for p in paths], dtype=torch.int32)
    pad = _padded_index(ix, mesh.index)
    if pipe.sharded.codes is not None:  # the rank's block is SQ8
        ret = tsi.plain_sharded_retrieve_sq8(
            tpp, pad(ix.codes), pad(ix.scales), pad(ix.norm_sq),
            pad(ix.labels), pad(ix.ids, -1), excl, shards=mesh.index,
            k=cfg.top_k, centroids=ix.centroids, cells=pad(ix.cells),
            exclude_mode="self")
    else:
        ids = pad(ix.ids, -1)
        ret = tsi.plain_sharded_retrieve(
            tpp, pad(ix.vectors), pad(ix.labels), ids, ids >= 0, excl,
            shards=mesh.index, k=cfg.top_k, centroids=ix.centroids,
            cells=pad(ix.cells), nprobe=ix.nprobe, exclude_mode="self")
    return {"got": got, "plain": ret.indices.tolist()}


def _pipeline_on_mesh(mesh, p, tag: str) -> dict:
    """Every pipeline case on one mesh: the flat pipeline (build and save,
    evaluate, serve, train one epoch, load without accelerator arrays, a
    JAX-written DB), the sharded DB-build embed, SQ8 plain and residual,
    IVF, a refined SQ8 refused, a batch that does not divide 'data'."""
    from radad_tpu_torch.data.manifest import load_manifests
    from radad_tpu_torch.train.pipeline import DetectionPipeline

    enc = tiny_encoder(p["arch"])
    splits = load_manifests(p["data"])
    val = [os.path.join(p["data"], x) for x in splits["val"].paths[:3]]
    root = os.path.join(p["root"], tag)
    out = {}

    def pipe_for(sub, **over):
        cfg = pipe_config(os.path.join(root, sub), p["data"], **over)
        return DetectionPipeline(cfg, encoder=enc, device="cpu", mesh=mesh)

    flat = pipe_for("flat")
    flat.build_vector_database(splits["train"], save=True)
    shard = flat.sharded.vectors.shape[0]
    scores = flat.evaluate_with_scores(splits["val"])
    out["flat"] = dict(serve_record(flat, val), rows_a_rank=shard,
                       scores=scores[2], labels=scores[3],
                       val_loss=scores[0])
    out["flat_plain"] = _hold_to_plain(flat, val, mesh)
    mesh.reset_counts()
    flat.predict_batch(val)
    out["serve_calls"] = dict(mesh.calls)
    row = flat.train(splits["train"], splits["val"])
    out["train_row"] = {k: row[k] for k in ("train_loss", "val_loss",
                                             "eer_percent")}
    loaded = pipe_for("flat")
    assert loaded.load_vector_database()
    out["loaded"] = dict(serve_record(loaded, val),
                         build_accel=loaded.index.build_accel,
                         scan_bf16=loaded.index.scan_bf16 is None,
                         device=str(loaded.index.device))
    from_jax = pipe_for("from_jax", vector_db_path=p["jax_vdb"])
    assert from_jax.load_vector_database()
    out["from_jax"] = serve_record(from_jax, val)

    sharded = pipe_for("embed", shard_db_build=True)
    out["embed"] = sharded.get_embeddings(splits["train"]).numpy()

    for name, over in (("sq8", {}), ("sq8_residual",
                                     {"sq8_residual_nlist": 4})):
        sq = pipe_for(name, vector_db_index_type="SQ8", **over)
        sq.build_vector_database(splits["train"], save=False)
        out[name] = _hold_to_plain(sq, val, mesh)
        out[name + "_loss"] = sq.evaluate_with_scores(splits["val"])[0]

    ivf = pipe_for("ivf", vector_db_index_type="IVF", vector_db_nlist=4,
                   vector_db_nprobe=2)
    ivf.build_vector_database(splits["train"], save=False)
    out["ivf"] = _hold_to_plain(ivf, val, mesh)
    out["ivf_gather_searches"] = ivf.index.ivf_gather_searches
    out["ivf_loss"] = ivf.evaluate_with_scores(splits["val"])[0]

    errors = {}
    try:
        pipe_for("refined", vector_db_index_type="SQ8", sq8_refine_bits=4)
    except ValueError as e:
        errors["make_index"] = str(e)
    refined_db = os.path.join(p["root"], "refined_vdb")
    try:
        pipe_for("load_refined", vector_db_index_type="SQ8",
                 vector_db_path=refined_db).load_vector_database()
    except ValueError as e:
        errors["load"] = str(e)
    if mesh.data > 1:
        try:
            next(flat._query_batches(splits["val"], 5, shuffle=False))
        except ValueError as e:
            errors["batch"] = str(e)
    out["errors"] = errors
    return out


def pipeline_cases(rank, p):
    """A world of 4: the 2 x 2 mesh; of 2: 1 x 2, then 2 x 1."""
    import torch.distributed as dist

    from radad_tpu_torch.parallel import make_mesh

    shapes = [(2, 2)] if dist.get_world_size() == 4 else [(1, 2), (2, 1)]
    out = {}
    for shape in shapes:
        mesh = make_mesh(*shape)
        out[shape] = _pipeline_on_mesh(mesh, p, f"{shape[0]}x{shape[1]}")
    return out
