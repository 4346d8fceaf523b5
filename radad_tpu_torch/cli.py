"""Command-line entry point of the port: build_db and predict.

Counterpart: ``radad_tpu/cli.py`` (same flag names). Modes ``train`` and
``evaluate`` raise "not yet ported". ``--device`` defaults to ``cuda`` and
the run fails when no GPU is present unless ``--device cpu`` is given.

Run: ``python -m radad_tpu_torch.cli --mode build_db --data_path <dir>``.
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
                   help="wav2vec2 or hubert")
    p.add_argument("--model_name", type=str, default=None)
    p.add_argument("--data_path", type=str, default=None,
                   help="Directory containing meta.csv + audio files")
    p.add_argument("--data_root", type=str, default=None,
                   help="Output root for models and index")
    p.add_argument("--db_batch_size", type=int, default=64)
    p.add_argument("--top_k", type=int, default=None)
    p.add_argument("--index_type", type=str, default=None,
                   help="L2, IP or COSINE")
    p.add_argument("--weights_dir", type=str, default=None)
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--use_float16", action="store_true",
                   help="store the vector DB in bf16")
    p.add_argument("--rebuild_db", action="store_true",
                   help="build_db: discard any saved index and re-embed")
    return p


def config_from_args(args):
    from radad_tpu_torch.config import Config

    over = dict(data_fraction=args.data_fraction,
                feature_extractor_type=args.feature_extractor.lower(),
                db_batch_size=args.db_batch_size,
                # reference main.py:65-66 forces LayerNorm over BatchNorm
                use_batch_norm=False, use_layer_norm=True,
                use_float16=args.use_float16)
    if args.data_path:
        over.update(train_data_path=args.data_path,
                    test_data_path=args.data_path)
    if args.data_root:
        over.update(data_root=args.data_root,
                    vector_db_path=os.path.join(args.data_root, "vector_db"))
    if args.top_k is not None:
        over["top_k"] = args.top_k
    if args.model_name is not None:
        over[f"{args.feature_extractor.lower()}_model_name"] = args.model_name
    if args.index_type is not None:
        over["vector_db_index_type"] = args.index_type.upper()
    if args.seed is not None:
        over["random_seed"] = args.seed
    return Config().replace(**over)


def main(argv=None) -> int:
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s - %(name)s - %(levelname)s - %(message)s")
    args = build_parser().parse_args(argv)
    if args.mode in ("train", "evaluate"):
        raise NotImplementedError(f"--mode {args.mode}: not yet ported")
    cfg = config_from_args(args)

    from radad_tpu_torch.data.manifest import load_manifests
    from radad_tpu_torch.models.encoder import build_encoder
    from radad_tpu_torch.train.pipeline import DetectionPipeline

    encoder = build_encoder(cfg, weights_dir=args.weights_dir,
                            device=args.device)
    pipeline = DetectionPipeline(cfg, encoder=encoder, device=args.device)
    if args.mode == "build_db":
        splits = load_manifests(
            cfg.train_data_path, data_fraction=cfg.data_fraction,
            train_split=cfg.train_split, seed=cfg.random_seed)
        added = pipeline.update_vector_database(
            splits["train"], append=not args.rebuild_db)
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
