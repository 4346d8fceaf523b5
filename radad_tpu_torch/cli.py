"""Command-line entry point of the port: train, evaluate, predict and
build_db.

Counterpart: ``radad_tpu/cli.py`` (same flag names, SQ8's and IVF's
included). ``--device`` defaults to ``cuda`` and the run fails when no GPU
is present unless ``--device cpu`` is given.

Run: ``python -m radad_tpu_torch.cli --mode train --data_path <dir>
[--resume]``, then ``--mode evaluate`` or ``--mode predict --audio_path
<wav>``.

A mesh (``--data_shards`` / ``--index_shards``) runs one process a rank
under ``torchrun``, whose environment names the process group: NCCL and a
GPU a rank, or gloo with ``--device cpu``, e.g. ``python -m
torch.distributed.run --standalone --nproc_per_node 2 -m
radad_tpu_torch.cli --mode train --device cpu --index_shards 2 ...``.
``--data_shards`` defaults to the world size over ``--index_shards``; a
world of another size than data x index raises ``ValueError``. Rank 0
alone writes and prints results. The JAX CLI builds a mesh only with
``--data_shards``; the port also builds one for ``--index_shards`` > 1
alone, so that a torchrun world can be split over the index axis.
"""

from __future__ import annotations

import argparse
import logging
import os
import sys


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="Audio Deepfake Detection (PyTorch/CUDA port)")
    p.add_argument("--mode", type=str, required=True,
                   choices=["train", "evaluate", "predict", "build_db"])
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default) or cpu")
    p.add_argument("--data_fraction", type=float, default=1.0)
    p.add_argument("--model_prefix", type=str, default="final_model")
    p.add_argument("--audio_path", type=str, default=None,
                   help="Audio file for predict mode")
    p.add_argument("--max_duration", type=float, default=None,
                   help="predict: analyze up to this many seconds instead "
                        "of the 3 s truncation")
    p.add_argument("--feature_extractor", type=str, default="wav2vec2",
                   help="whisper, wavlm, wav2vec2, or hubert")
    p.add_argument("--model_name", type=str, default=None,
                   help="HF model id overriding the encoder family's "
                        "default size (e.g. microsoft/wavlm-large, "
                        "openai/whisper-small); the architecture comes from "
                        "a local config.json or the preset table, the "
                        "weights from a local checkpoint under "
                        "--weights_dir")
    p.add_argument("--whisper_fast", action="store_true",
                   help="whisper: encode only the real frames instead of "
                        "padding every segment to 30 s (the reference's "
                        "default, kept as the parity mode)")
    p.add_argument("--data_path", type=str, default=None,
                   help="Directory containing meta.csv + audio files")
    p.add_argument("--data_root", type=str, default=None,
                   help="Output root for models and index")
    p.add_argument("--batch_size", type=int, default=256)
    p.add_argument("--eval_batch_size", type=int, default=256)
    p.add_argument("--db_batch_size", type=int, default=64)
    p.add_argument("--epochs", type=int, default=None)
    p.add_argument("--top_k", type=int, default=None)
    p.add_argument("--index_type", type=str, default=None,
                   help="L2, IP, COSINE, IVF or SQ8")
    p.add_argument("--nprobe", type=int, default=None,
                   help="IVF cells probed per search (reference "
                        "config.py:53/76 vector_db_nprobe)")
    p.add_argument("--ivf_balance", type=float, default=None,
                   help="IVF centroid split-refinement strength (0 = plain "
                        "Lloyd, FAISS's; ~1.0 balances cell sizes for a "
                        "cheaper gather-probed search)")
    p.add_argument("--ivf_no_retrain_on_add", action="store_true",
                   help="IVF: never retrain the coarse quantizer on an add; "
                        "assign the new rows to the trained cells (FAISS "
                        "IndexIVFFlat.add; for --mode build_db ingestion)")
    p.add_argument("--sq8_residual_nlist", type=int, default=None,
                   help="SQ8 residual-encoding codebook size (0 = plain "
                        "per-row SQ8; ~1024 recovers recall on clustered "
                        "embeddings at unchanged scan cost)")
    p.add_argument("--sq8_refine_bits", type=int, default=None,
                   choices=[0, 4],
                   help="int4 refinement level for SQ8 (+0.5 B/dim: "
                        "~12-bit re-score and neighbor fidelity)")
    p.add_argument("--weights_dir", type=str, default=None)
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--data_shards", type=int, default=0,
                   help="mesh 'data' axis size (0 = single device, or the "
                        "world size over --index_shards under torchrun)")
    p.add_argument("--index_shards", type=int, default=1,
                   help="mesh 'index' axis size (DB row sharding)")
    p.add_argument("--use_float16", action="store_true",
                   help="store the vector DB in bf16")
    p.add_argument("--rebuild_db", action="store_true",
                   help="build_db: discard any saved index and re-embed")
    p.add_argument("--wandb", action="store_true",
                   help="Enable Weights & Biases logging")
    p.add_argument("--no_cache_embeddings", action="store_true",
                   help="recompute encoder features every epoch")
    p.add_argument("--mixed_precision", action="store_true",
                   help="encoder and fusion model compute in bfloat16 "
                        "(config.compute_dtype); parameters stay f32 and the "
                        "clip embeddings f32, so the index is the f32 one")
    p.add_argument("--resume", action="store_true",
                   help="train: resume from the --model_prefix checkpoint "
                        "(model, optimizer state and step)")
    return p


def config_from_args(args):
    from radad_tpu_torch.config import Config

    over = dict(data_fraction=args.data_fraction,
                feature_extractor_type=args.feature_extractor.lower(),
                usewandb=bool(args.wandb),
                batch_size=args.batch_size,
                eval_batch_size=args.eval_batch_size,
                db_batch_size=args.db_batch_size,
                # reference main.py:65-66 forces LayerNorm over BatchNorm
                use_batch_norm=False, use_layer_norm=True,
                cache_embeddings=not args.no_cache_embeddings,
                use_float16=args.use_float16,
                use_mixed_precision=args.mixed_precision)
    if args.data_path:
        over.update(train_data_path=args.data_path,
                    test_data_path=args.data_path)
    if args.data_root:
        over.update(data_root=args.data_root,
                    vector_db_path=os.path.join(args.data_root, "vector_db"))
    if args.epochs is not None:
        over["num_epochs"] = args.epochs
    if args.top_k is not None:
        over["top_k"] = args.top_k
    if args.model_name is not None:
        over[f"{args.feature_extractor.lower()}_model_name"] = args.model_name
    if args.whisper_fast:
        over["whisper_pad_seconds"] = None
    if args.nprobe is not None:
        over["vector_db_nprobe"] = args.nprobe
    if args.index_type is not None:
        over["vector_db_index_type"] = args.index_type.upper()
    if args.ivf_balance is not None:
        over["vector_db_ivf_balance"] = args.ivf_balance
    if args.ivf_no_retrain_on_add:
        over["vector_db_ivf_retrain_on_add"] = False
    if args.sq8_residual_nlist is not None:
        over["sq8_residual_nlist"] = args.sq8_residual_nlist
    if args.sq8_refine_bits is not None:
        over["sq8_refine_bits"] = args.sq8_refine_bits
    if args.seed is not None:
        over["random_seed"] = args.seed
    if args.max_duration is not None and args.mode != "predict":
        # long-audio mode for train/evaluate; in predict mode the flag
        # stays a per-call argument
        over["max_duration"] = args.max_duration
    return Config().replace(**over)


def _init_mesh(args):
    """The mesh of ``--data_shards`` / ``--index_shards`` over the process
    group (initialized here from torchrun's environment when none is: NCCL,
    or gloo with ``--device cpu``). → (mesh, whether this call initialized
    the group)."""
    import torch.distributed as dist

    from radad_tpu_torch.parallel import make_mesh

    created = not dist.is_initialized()
    if created:
        dist.init_process_group("gloo" if args.device == "cpu" else "nccl")
    try:
        mesh = make_mesh(data=args.data_shards or None,
                         index=args.index_shards,
                         device="cpu" if args.device == "cpu" else None)
    except BaseException:
        if created:
            dist.destroy_process_group()
        raise
    return mesh, created


def main(argv=None) -> int:
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s - %(name)s - %(levelname)s - %(message)s")
    args = build_parser().parse_args(argv)
    cfg = config_from_args(args)
    if not (args.data_shards or args.index_shards > 1):
        return _run(args, cfg, None)
    mesh, created = _init_mesh(args)  # before the encoder is built
    logging.info("mesh: %s, rank %d of %d on %s (%s)", mesh.shape,
                 mesh.rank, mesh.world, mesh.device, mesh.backend)
    if mesh.rank:
        logging.getLogger().setLevel(logging.WARNING)
    try:
        return _run(args, cfg, mesh)
    finally:
        if created:
            import torch.distributed as dist

            dist.destroy_process_group()


def _run(args, cfg, mesh) -> int:
    from radad_tpu_torch.data.manifest import load_manifests
    from radad_tpu_torch.models.encoder import build_encoder
    from radad_tpu_torch.train.pipeline import (DetectionPipeline,
                                                print_dataset_statistics)

    device = args.device if mesh is None else mesh.device
    encoder = build_encoder(cfg, weights_dir=args.weights_dir, device=device)
    pipeline = DetectionPipeline(cfg, encoder=encoder, device=device,
                                 mesh=mesh)
    lead = pipeline.lead  # rank 0 of a mesh prints
    if args.mode == "train":
        splits = load_manifests(
            cfg.train_data_path, data_fraction=cfg.data_fraction,
            train_split=cfg.train_split, seed=cfg.random_seed)
        if lead:
            print_dataset_statistics(splits)
        if args.resume:
            if pipeline.load_models(args.model_prefix):
                pipeline.load_vector_database()
                logging.info("resumed from %s at step %d",
                             args.model_prefix, pipeline.step)
            else:
                logging.warning("--resume: no checkpoint found, training "
                                "from scratch")
        pipeline.train(splits["train"], splits["val"])
        return 0
    if args.mode == "evaluate":
        if not pipeline.load_models(args.model_prefix):
            return 1
        if not pipeline.load_vector_database():
            return 1
        splits = load_manifests(
            cfg.test_data_path, data_fraction=cfg.data_fraction,
            train_split=cfg.train_split, seed=cfg.random_seed)
        results = pipeline.evaluate(splits["val"])
        if lead:
            print("Evaluation metrics:")
            for key, value in results.items():
                print(f"{key}: {value}")
        return 0
    if args.mode == "build_db":
        splits = load_manifests(
            cfg.train_data_path, data_fraction=cfg.data_fraction,
            train_split=cfg.train_split, seed=cfg.random_seed)
        added = pipeline.update_vector_database(
            splits["train"], append=not args.rebuild_db)
        if lead:
            print(f"Vector DB: {pipeline.index.ntotal} vectors "
                  f"({added} added this run)")
        return 0
    if not args.audio_path:
        raise ValueError("Audio path must be provided for predict mode")
    prefix = (args.model_prefix if args.model_prefix != "final_model"
              else "best_model")
    if not pipeline.load_models(prefix):
        logging.info("falling back to final_model checkpoint")
        if not pipeline.load_models("final_model"):
            return 1
    if not pipeline.load_vector_database():
        return 1
    result = pipeline.predict(args.audio_path,
                              max_duration=args.max_duration)
    logging.info("Prediction  : %s", result["prediction"])
    logging.info("Probability(spoof)     : %.4f", result["probability_spoof"])
    logging.info("Probability(bona-fide) : %.4f",
                 1.0 - result["probability_spoof"])
    logging.info("Retrieved   : %s", result["retrieved_labels"])
    return 0


if __name__ == "__main__":
    sys.exit(main())
